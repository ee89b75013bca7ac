"""RWKV-6 ("Finch") block — attention-free linear RNN with data-dependent
decay (rwkv6-1.6b; the JAX package's ``models/rwkv.py``).

The pieces: ddlerp token shift (LoRA-modulated mixing), the data-dependent
per-channel decay w_t = exp(-exp(.)), the per-channel bonus u, the WKV6
matrix-state recurrence S <- diag(w) S + k^T v, the per-head group norm,
and the squared-ReLU channel mix.

The WKV core is an exact loop over time with the state (B, H, hd, hd) in
fp32, in the JAX scan's per-step order.  Under autograd it walks 16-step
chunks, each under a checkpoint that saves nothing but its inputs, as the
JAX function's ``jax.checkpoint(nothing_saveable)`` chunks do: the
backward recomputes a chunk's steps, residuals are kept per chunk instead
of per step, and no value changes.  Decode is the same loop over one step.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import Axes, TreeMaker
from repro_torch.models.layers import group_rms_norm

__all__ = ["rwkv_params", "rwkv_time_mix", "rwkv_channel_mix",
           "init_rwkv_cache"]

_LORA_MIX = 32
_LORA_DECAY = 64


def rwkv_params(tm: TreeMaker, cfg) -> Dict[str, Any]:
    d, f = cfg.d_model, cfg.d_ff
    h, hd = cfg.n_heads, cfg.head_dim_
    return {
        # time-mix (wkv)
        "mu_x": tm.param((d,), (Axes.EMBED,), init="zeros"),
        "mu": tm.param((5, d), (None, Axes.EMBED), init="zeros"),
        "tm_w1": tm.param((d, 5 * _LORA_MIX), (Axes.EMBED, None),
                          scale=0.01),
        "tm_w2": tm.param((5, _LORA_MIX, d), (None, None, Axes.EMBED),
                          scale=0.01),
        "td_w1": tm.param((d, _LORA_DECAY), (Axes.EMBED, None), scale=0.01),
        "td_w2": tm.param((_LORA_DECAY, d), (None, Axes.EMBED), scale=0.01),
        "decay_base": tm.param((d,), (Axes.EMBED,), init="zeros",
                               dtype=torch.float32),
        "u": tm.param((h, hd), (Axes.HEADS, Axes.HEAD_DIM), init="zeros",
                      dtype=torch.float32),
        "wr": tm.param((d, d), (Axes.EMBED, Axes.HEADS)),
        "wk": tm.param((d, d), (Axes.EMBED, Axes.HEADS)),
        "wv": tm.param((d, d), (Axes.EMBED, Axes.HEADS)),
        "wg": tm.param((d, d), (Axes.EMBED, Axes.HEADS)),
        "wo": tm.param((d, d), (Axes.HEADS, Axes.EMBED)),
        "ln_x": tm.param((d,), (Axes.EMBED,), init="ones"),
        # channel-mix
        "cmu_k": tm.param((d,), (Axes.EMBED,), init="zeros"),
        "cmu_r": tm.param((d,), (Axes.EMBED,), init="zeros"),
        "ck": tm.param((d, f), (Axes.EMBED, Axes.MLP)),
        "cv": tm.param((f, d), (Axes.MLP, Axes.EMBED)),
        "cr": tm.param((d, d), (Axes.EMBED, Axes.HEADS)),
    }


def _token_shift(x: torch.Tensor, last: Optional[torch.Tensor]
                 ) -> torch.Tensor:
    """x_{t-1} stream: right-shift by one; ``last`` seeds t=0 (decode)."""
    if last is None:
        pad = torch.zeros_like(x[:, :1])
    else:
        pad = last[:, None, :].to(x.dtype)
    return torch.cat([pad, x[:, :-1]], dim=1)


def _ddlerp(p, x, dx):
    """Data-dependent lerp: five mixed streams (w, k, v, r, g)."""
    base = x + dx * p["mu_x"]
    lora = torch.tanh(base @ p["tm_w1"])
    lora = lora.reshape(*lora.shape[:-1], 5, _LORA_MIX)
    off = torch.einsum("btsk,skd->bstd", lora, p["tm_w2"])     # (B,5,T,D)
    mix = p["mu"][None, :, None, :] + off
    return x[:, None] + dx[:, None] * mix                      # (B,5,T,D)


def _wkv_steps(r32, k32, v32, w32, u4, s):
    """The recurrence over every step of fp32 (B, T, H, hd) inputs from
    the state ``s``; returns (out (B, T, H, hd), the state after)."""
    outs = []
    for t in range(r32.shape[1]):
        kv = k32[:, t, :, :, None] * v32[:, t, :, None, :]
        outs.append((r32[:, t, :, None, :] @ (s + u4 * kv))[:, :, 0])
        s = s * w32[:, t, :, :, None] + kv
    return torch.stack(outs, dim=1), s


def _wkv_scan(r, k, v, w, u, s0, chunk: int = 16):
    """Exact WKV6 recurrence.

    r, k, v, w: (B, T, H, hd), w the decay in (0, 1); u: (H, hd) fp32;
    s0: (B, H, hd, hd) fp32 [k-dim x v-dim].  Per step, in this order:
    ``kv = k (x) v``, ``out = r . (S + u * kv)``, ``S = S * w + kv``.
    Returns (out (B, T, H, hd) fp32, the final state).

    Under autograd, where ``chunk`` divides T, the steps run in chunks of
    ``chunk``, each under a checkpoint that keeps only its inputs (the
    JAX function's chunked ``jax.checkpoint``): the same ops, so the same
    values, with the per-step residuals recomputed in the backward."""
    r32, k32, v32, w32 = (a.float() for a in (r, k, v, w))
    u4 = u[None, :, :, None]
    t = r.shape[1]
    trains = torch.is_grad_enabled() and any(
        a.requires_grad for a in (r32, k32, v32, w32, u4, s0))
    if not trains or chunk <= 1 or t % chunk:
        return _wkv_steps(r32, k32, v32, w32, u4, s0)
    from torch.utils.checkpoint import checkpoint
    s, outs = s0, []
    for c0 in range(0, t, chunk):
        o, s = checkpoint(_wkv_steps, *(a[:, c0:c0 + chunk]
                                        for a in (r32, k32, v32, w32)),
                          u4, s, use_reentrant=False,
                          preserve_rng_state=False)
        outs.append(o)
    return torch.cat(outs, dim=1), s


def rwkv_time_mix(p: Dict[str, Any], cfg, x: torch.Tensor, *,
                  last_x: Optional[torch.Tensor] = None,
                  s0: Optional[torch.Tensor] = None,
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B, T, D) -> (out, s_final, x_last)."""
    b, t, d = x.shape
    h, hd = cfg.n_heads, cfg.head_dim_
    dx = _token_shift(x, last_x) - x
    xw, xk, xv, xr, xg = _ddlerp(p, x, dx).unbind(dim=1)
    # data-dependent decay (fp32): w = exp(-exp(base + lora))
    dd = p["decay_base"] + torch.tanh(
        xw.float() @ p["td_w1"].float()) @ p["td_w2"].float()
    w = torch.exp(-torch.exp(dd)).reshape(b, t, h, hd)
    r = (xr @ p["wr"]).reshape(b, t, h, hd)
    k = (xk @ p["wk"]).reshape(b, t, h, hd)
    v = (xv @ p["wv"]).reshape(b, t, h, hd)
    g = F.silu(xg @ p["wg"])
    if s0 is None:
        s0 = torch.zeros((b, h, hd, hd), dtype=torch.float32,
                         device=x.device)
    out, sf = _wkv_scan(r, k, v, w, p["u"].float(), s0)
    out = out.reshape(b, t, d).to(x.dtype)
    out = group_rms_norm(out, p["ln_x"], groups=h, eps=cfg.norm_eps * 64)
    return (out * g) @ p["wo"], sf, x[:, -1, :]


def rwkv_channel_mix(p: Dict[str, Any], cfg, x: torch.Tensor, *,
                     last_x: Optional[torch.Tensor] = None,
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Squared-ReLU channel mix.  Returns (out, x_last)."""
    dx = _token_shift(x, last_x) - x
    xk = x + dx * p["cmu_k"]
    xr = x + dx * p["cmu_r"]
    kk = torch.relu(xk @ p["ck"]).square()
    return torch.sigmoid(xr @ p["cr"]) * (kk @ p["cv"]), x[:, -1, :]


def init_rwkv_cache(cfg, batch: int, dtype: torch.dtype = torch.bfloat16,
                    device: Any = "cuda",
                    abstract: bool = False) -> Dict[str, torch.Tensor]:
    """One layer's recurrent state: the WKV state (fp32) and the last
    token-shift input of the time and channel mixes; ``abstract``:
    ``meta`` tensors of their shapes."""
    device = "meta" if abstract else device
    h, hd, d = cfg.n_heads, cfg.head_dim_, cfg.d_model
    return {"s": torch.zeros((batch, h, hd, hd), dtype=torch.float32,
                             device=device),
            "x_tm": torch.zeros((batch, d), dtype=dtype, device=device),
            "x_cm": torch.zeros((batch, d), dtype=dtype, device=device)}
