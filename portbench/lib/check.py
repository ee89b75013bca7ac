"""How ``correct`` is decided: every served request's logits against the
plain reference over the same images, with weights the reference draws
again from the seed itself.

The number compared is ``logit_rel_gap``: over every served image, the
largest |served - reference| of its logits over the largest |reference|
of its logits.  ``requests_not_served`` counts the requests that never
answered or answered without logits; its limit is 0.
"""
from __future__ import annotations

import sys
from typing import Dict, Tuple

import numpy as np
import torch

from portbench.lib.weights import make_params

BLOCK_ROWS = 32           # reference rows a call


def reference_table(ref, cfg: dict, pool: np.ndarray, w_seed: int,
                    device, round_tf32: bool = False,
                    tf32_paths: bool = False) -> torch.Tensor:
    """(pool, classes) fp32 logits of every pool image, in blocks of
    rows, with the parameters drawn anew from ``w_seed``; the TF32
    switches give the control (``reference/common.py``)."""
    params = make_params(ref.param_specs(cfg), w_seed, device)
    out = torch.empty((len(pool), cfg["classes"]), device=device)
    with torch.inference_mode():
        for i in range(0, len(pool), BLOCK_ROWS):
            x = torch.from_numpy(pool[i:i + BLOCK_ROWS]).to(device)
            out[i:i + BLOCK_ROWS] = ref.forward(
                params, x, cfg, round_tf32=round_tf32, tf32_paths=tf32_paths)
    return out


def rel_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """max over rows of max|got - want| / max|want| (a non-finite or
    missing row reads as the largest float)."""
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        return sys.float_info.max
    if not len(got):
        return 0.0
    gap = (got - want).abs().amax(dim=1) / want.abs().amax(dim=1)
    return float(gap.max())


def served_logits(served) -> Tuple[np.ndarray, np.ndarray]:
    ok = [s for s in served if s.ok]
    if not ok:
        return np.zeros(0, np.int64), np.zeros((0, 0), np.float32)
    return (np.concatenate([s.idx for s in ok]),
            np.concatenate([np.asarray(s.req.logits, np.float32)
                            for s in ok]))


def compare(served, table: torch.Tensor) -> Dict[str, float]:
    idx, logits = served_logits(served)
    want = table[torch.from_numpy(idx).to(table.device)]
    got = torch.from_numpy(logits).to(table.device) if len(idx) else want
    return {"logit_rel_gap": rel_gap(got, want),
            "requests_not_served": float(sum(not s.ok for s in served))}


def verdict(values: Dict[str, float], limits: Dict[str, float]
            ) -> Tuple[bool, Dict[str, dict]]:
    checks = {k: {"value": v, "limit": float(limits[k])}
              for k, v in values.items()}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks
