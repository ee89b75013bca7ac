"""Mixture-of-Experts FFN: top-k token-choice routing with GShard-style
einsum dispatch, and the always-on shared experts of qwen2-moe (the JAX
package's ``models/moe.py``, its quirks included).

* Tokens are routed in groups of ``group_size``; an expert's buffer holds
  C = min(max(int(S * top_k * cf / n_experts), 1), S) tokens of a group,
  counted over the *real* experts.
* The expert dim is padded to a multiple of 16 (the JAX package pads it
  for an even expert-parallel split); the dead experts get -1e30 router
  logits and so never a token.
* A token's slot in its expert's buffer is its rank among that expert's
  selections, scanning tokens, then k-slots; the tokens past C are
  dropped.  ``capacity_factor >= n_experts / top_k`` makes routing
  lossless.
* The router runs in fp32; the load-balance auxiliary loss comes back
  beside the output (training's ``lm_loss`` reads it).

The capacity is a Python int and the one-hots are built against fixed
class counts, so a step with this FFN syncs nothing with the host and can
be captured as a CUDA graph.  The dispatch einsums cover every expert, so
a decode step reads the whole expert stack.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import constrain
from repro_torch.models.common import Axes, TreeMaker
from repro_torch.models.mlp import mlp, mlp_params

__all__ = ["moe_params", "moe_ffn", "padded_experts"]


def padded_experts(cfg, multiple: int = 16) -> int:
    e = cfg.n_experts
    return (e + multiple - 1) // multiple * multiple


def moe_params(tm: TreeMaker, cfg) -> Dict[str, Any]:
    d, f = cfg.d_model, cfg.d_ff
    e = padded_experts(cfg)
    p = {"router": tm.param((d, e), (Axes.EMBED, Axes.EXPERTS),
                             dtype=torch.float32),
         "wi_gate": tm.param((e, d, f), (Axes.EXPERTS, Axes.EMBED,
                                         Axes.EXPERT_MLP)),
         "wi_up": tm.param((e, d, f), (Axes.EXPERTS, Axes.EMBED,
                                       Axes.EXPERT_MLP)),
         "wo": tm.param((e, f, d), (Axes.EXPERTS, Axes.EXPERT_MLP,
                                    Axes.EMBED))}
    if cfg.shared_experts:
        p["shared"] = mlp_params(tm, cfg, d_ff=cfg.shared_experts * f)
    return p


def _one_hot(idx: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    """``idx``'s one-hot over ``n`` classes, by comparison (no check of
    the indices on the host, so nothing syncs)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def moe_ffn(p: Dict[str, Any], cfg, x: torch.Tensor, *,
            group_size: int = 512,
            capacity_factor: float = 1.25,
            renorm_topk: bool = True,
            dispatch_dtype: Optional[torch.dtype] = None,
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, T, D) -> (out (B, T, D), the load-balance aux loss, 0-d
    fp32).

    ``dispatch_dtype``: the type of the dispatch / combine one-hots and
    their einsums; fp32 (None) is GShard's, bf16 rounds the gates to bf16
    in the combine (``cfg.moe_dispatch_dtype == "bf16"``).  With
    ``cfg.moe_ep_constraint`` the expert buffers carry the experts-axis
    constraint (``distributed/sharding.constrain``)."""
    b, t, d = x.shape
    e = p["router"].shape[1]
    k = cfg.top_k
    n = b * t
    gs = min(group_size, t)
    if n % gs:
        raise ValueError(f"{n} tokens do not split into groups of {gs}")
    g = n // gs
    # capacity w.r.t. the REAL experts: the dead padded ones receive nothing
    cap = min(max(int(gs * k * capacity_factor / cfg.n_experts), 1), gs)

    xf = x.reshape(g, gs, d)
    logits = xf.float() @ p["router"]                         # (G,S,E)
    if e > cfg.n_experts:
        neg = torch.full((e,), -1e30, dtype=torch.float32, device=x.device)
        neg[:cfg.n_experts] = 0.0
        logits = logits + neg
    probs = torch.softmax(logits, dim=-1)
    topk_p, topk_i = torch.topk(probs, k, dim=-1, sorted=True)  # (G,S,K)
    if renorm_topk:
        topk_p = topk_p / topk_p.sum(dim=-1, keepdim=True)

    # rank of each (token, k) among its expert's selections, scanning
    # tokens then k-slots: its slot in that expert's buffer
    sel = _one_hot(topk_i, e, torch.float32)                  # (G,S,K,E)
    flat = sel.reshape(g, gs * k, e)
    pos = (torch.cumsum(flat, dim=1) - flat).reshape(g, gs, k, e)
    pos = (pos * sel).sum(dim=-1)                             # (G,S,K)
    keep = pos < cap
    pos = torch.where(keep, pos, 0).long()

    dd = dispatch_dtype or torch.float32
    gate = topk_p * keep
    cap_oh = _one_hot(pos, cap, dd)                           # (G,S,K,C)
    seld = sel.to(dd)
    dispatch = torch.einsum("gske,gskc->gsec", seld,
                            cap_oh * keep[..., None].to(dd))
    combine = torch.einsum("gske,gskc->gsec",
                           seld * gate[..., None].to(dd), cap_oh)

    cd = x.dtype
    xe = torch.einsum("gsec,gsd->egcd", dispatch.to(cd), xf)
    if cfg.moe_ep_constraint:
        xe = constrain(xe, ("experts", "batch", None, None))
    hg = torch.einsum("egcd,edf->egcf", xe, p["wi_gate"])
    hu = torch.einsum("egcd,edf->egcf", xe, p["wi_up"])
    he = torch.einsum("egcf,efd->egcd", F.silu(hg) * hu, p["wo"])
    if cfg.moe_ep_constraint:
        he = constrain(he, ("experts", "batch", None, None))
    out = torch.einsum("gsec,egcd->gsd", combine.to(cd), he)
    if cfg.shared_experts:
        out = out + mlp(p["shared"], xf)

    # Switch / GShard load-balance aux loss (fp32)
    density = sel.sum(dim=2).mean(dim=1)                      # (G,E)
    prob_mean = probs.mean(dim=1)                             # (G,E)
    aux = (density * prob_mean).sum(dim=-1).mean() * e
    return out.reshape(b, t, d), aux
