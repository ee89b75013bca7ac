"""Gated MLP (SwiGLU / GeGLU) — the dense FFN block."""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.models.common import Axes, TreeMaker

__all__ = ["mlp_params", "mlp"]


def mlp_params(tm: TreeMaker, cfg, d_ff: int = 0) -> Dict[str, Any]:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    return {"wi_gate": tm.param((d, f), (Axes.EMBED, Axes.MLP)),
            "wi_up": tm.param((d, f), (Axes.EMBED, Axes.MLP)),
            "wo": tm.param((f, d), (Axes.MLP, Axes.EMBED))}


def mlp(p: Dict[str, Any], x: torch.Tensor, act: str = "silu"
        ) -> torch.Tensor:
    gate = x @ p["wi_gate"]
    up = x @ p["wi_up"]
    a = F.gelu(gate, approximate="tanh") if act == "gelu" else F.silu(gate)
    return (a * up) @ p["wo"]
