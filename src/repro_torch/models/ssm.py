"""Mamba2 (SSD) block — used by zamba2-1.2b (the JAX package's
``models/ssm.py``).

The selective-state-space layer with scalar-per-head decay, computed with
the chunked SSD algorithm: intra-chunk work is parallel (the decay matrix
exp(cum_t - cum_s) is bounded in (0, 1]), inter-chunk state is carried by
a short loop over T/chunk steps.  The SSD contractions are
``torch.einsum`` in fp32, as the JAX package leaves them to XLA.  The
causal depthwise conv1d in front of (x, B, C) is the fold kernel
(``kernels/ops.py:conv1d_causal``: the CUDA kernel on the card).

Decode is O(1) in sequence length: cache = {conv tail (K-1 tokens), SSD
state (H, state, head_dim)}; its conv is a window einsum, no kernel.  The
donated decode writes the new tail and state into the cache it is given.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.dtensor import (is_dtensor, place_like,
                                             placements_as, replicated_like,
                                             run_local)
from repro_torch.kernels.ops import conv1d_causal
from repro_torch.models.common import Axes, TreeMaker
from repro_torch.models.layers import group_rms_norm

__all__ = ["mamba_params", "mamba_block", "mamba_decode", "init_mamba_cache"]


def _dims(cfg):
    d_in = cfg.ssm_expand * cfg.d_model
    heads = d_in // cfg.ssm_head_dim
    conv_dim = d_in + 2 * cfg.ssm_groups * cfg.ssm_state
    return d_in, heads, conv_dim


def mamba_params(tm: TreeMaker, cfg) -> Dict[str, Any]:
    d = cfg.d_model
    d_in, heads, conv_dim = _dims(cfg)
    gs = cfg.ssm_groups * cfg.ssm_state
    f32 = torch.float32
    return {
        "wz": tm.param((d, d_in), (Axes.EMBED, Axes.SSM_INNER)),
        "wx": tm.param((d, d_in), (Axes.EMBED, Axes.SSM_INNER)),
        "wB": tm.param((d, gs), (Axes.EMBED, Axes.STATE)),
        "wC": tm.param((d, gs), (Axes.EMBED, Axes.STATE)),
        "wdt": tm.param((d, heads), (Axes.EMBED, Axes.HEADS)),
        "dt_bias": tm.param((heads,), (Axes.HEADS,), init="ssm_dt",
                            dtype=f32),
        "A_log": tm.param((heads,), (Axes.HEADS,), init="ssm_a", dtype=f32),
        "D": tm.param((heads,), (Axes.HEADS,), init="ones", dtype=f32),
        "conv_w": tm.param((cfg.ssm_conv, conv_dim),
                           (Axes.CONV_K, Axes.SSM_INNER)),
        "norm": tm.param((d_in,), (Axes.SSM_INNER,), init="ones"),
        "wo": tm.param((d_in, d), (Axes.SSM_INNER, Axes.EMBED)),
    }


def _ssd_chunked(xh, dt, a_log, B, C, h0, chunk: int):
    """Chunked SSD scan.

    xh: (B,T,H,hd)  dt: (B,T,H) fp32  a_log = A*dt: (B,T,H) fp32 (<0)
    B, C: (B,T,G,state) fp32 (G broadcast over heads)
    h0: (B,H,state,hd) fp32 initial state.
    Returns y (B,T,H,hd) fp32, h_final.  On DTensors every rank runs its
    own batch rows and heads.
    """
    if is_dtensor(xh):
        if B.shape[2] > 1 and any(getattr(p, "dim", None) == 2
                                  for p in xh.placements):
            raise NotImplementedError(
                "the SSD with heads split across ranks takes one B / C "
                f"group, got {B.shape[2]}")
        xh = place_like(xh, xh, {0: 0, 2: 2})
        dt, a_log = (place_like(x, xh, {0: 0, 2: 2}) for x in (dt, a_log))
        B, C = (place_like(x, xh, {0: 0}) for x in (B, C))
        h0 = place_like(replicated_like(h0, xh), xh, {0: 0, 2: 1})
        return run_local(lambda *a: _ssd_chunked(*a, chunk),
                         xh, dt, a_log, B, C, h0,
                         out_placements=[xh.placements,
                                         placements_as(xh, {0: 0, 2: 1})])
    b, t, h, hd = xh.shape
    g = B.shape[2]
    nc = t // chunk
    rep = h // g

    def csplit(x):  # (B,T,...) -> (B,nc,L,...)
        return x.reshape(b, nc, chunk, *x.shape[2:])

    xh_, dt_, la_, B_, C_ = map(csplit, (xh, dt, a_log, B, C))
    Bh = B_.repeat_interleave(rep, dim=3)    # (B,nc,L,H,s), group -> heads
    Ch = C_.repeat_interleave(rep, dim=3)
    cum = torch.cumsum(la_, dim=2)           # (B,nc,L,H)
    # decay from step s (exclusive) to step t (inclusive): exp(cum_t - cum_s)
    # for s <= t, and 0 above the diagonal.  The exponent is masked before
    # the exp (exp(-inf) = 0, the JAX package's values bit for bit): above
    # the diagonal cum_t - cum_s > 0 overflows to inf at full width, and
    # masking after the exp, as the JAX function does, gives the backward
    # 0 * inf = NaN there
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=xh.device))
    dmat = torch.exp(torch.where(
        mask[None, None, :, :, None],
        cum[:, :, :, None, :] - cum[:, :, None, :, :], float("-inf")))
    cb = torch.einsum("bnlhs,bnmhs->bnlmh", Ch, Bh)          # C_t . B_s
    scores = cb * dmat * dt_[:, :, None, :, :]               # (B,nc,L,L,H)
    xf = xh_.float()
    y_intra = torch.einsum("bnlmh,bnmhd->bnlhd", scores, xf)
    # inter-chunk: a loop over chunks carrying h (B,H,s,hd)
    dec_in = torch.exp(cum)                                  # to chunk end
    # state ingest weights: exp(cum_L - cum_s) * dt_s
    wL = torch.exp(cum[:, :, -1:, :] - cum) * dt_            # (B,nc,L,H)
    hprev, y_inter = h0, []
    for n in range(nc):
        # y_inter_t = C_t . (exp(cum_t) h_prev)
        y_inter.append(torch.einsum("blhs,bhsd->blhd",
                                    Ch[:, n] * dec_in[:, n, ..., None],
                                    hprev))
        dh = torch.einsum("blhs,blhd->bhsd", Bh[:, n] * wL[:, n, ..., None],
                          xf[:, n])
        hprev = hprev * torch.exp(la_[:, n].sum(1))[:, :, None, None] + dh
    y = y_intra + torch.stack(y_inter, dim=1)
    return y.reshape(b, t, h, hd), hprev


def mamba_block(p: Dict[str, Any], cfg, x: torch.Tensor, *,
                chunk: int = 64,
                h0: Optional[torch.Tensor] = None,
                conv_init: Optional[torch.Tensor] = None,
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-sequence Mamba2 mixer.  x: (B,T,D) -> (y (B,T,D), h_f,
    conv_tail).  With ``conv_init`` (the cached K-1 inputs) those rows go
    in front of the conv input, the conv runs over them with its own K-1
    zeros in front, and their K-1 outputs are dropped."""
    b, t, d = x.shape
    d_in, heads, conv_dim = _dims(cfg)
    g, s = cfg.ssm_groups, cfg.ssm_state
    hd = cfg.ssm_head_dim
    if t % chunk:
        chunk = 1 if t < chunk else max(c for c in (1, 2, 4, 8, 16, 32, 64)
                                        if t % c == 0)

    z = x @ p["wz"]
    xin = x @ p["wx"]
    Bp = x @ p["wB"]
    Cp = x @ p["wC"]
    dt = x.float() @ p["wdt"].float() + p["dt_bias"]
    dt = F.softplus(dt)                                        # (B,T,H) fp32

    conv_in = torch.cat([xin, Bp, Cp], dim=-1)
    if conv_init is not None:
        conv_in = torch.cat([conv_init, conv_in], dim=1)
    conv_out = F.silu(conv1d_causal(conv_in, p["conv_w"]))
    conv_tail = conv_in[:, -(cfg.ssm_conv - 1):, :]
    if conv_init is not None:
        conv_out = conv_out[:, cfg.ssm_conv - 1:, :]
    xc, Bc, Cc = torch.split(conv_out, [d_in, g * s, g * s], dim=-1)

    xh = xc.reshape(b, t, heads, hd)
    Bc = Bc.reshape(b, t, g, s).float()
    Cc = Cc.reshape(b, t, g, s).float()
    A = -torch.exp(p["A_log"])                                 # (H,) < 0
    a_log = dt * A                                             # (B,T,H)
    if h0 is None:
        h0 = torch.zeros((b, heads, s, hd), dtype=torch.float32,
                         device=x.device)
    y, hf = _ssd_chunked(xh, dt, a_log, Bc, Cc, h0, chunk)
    y = y + p["D"][None, None, :, None] * xh.float()
    y = y.reshape(b, t, d_in).to(x.dtype)
    y = group_rms_norm(y * F.silu(z), p["norm"], groups=heads,
                       eps=cfg.norm_eps)
    return y @ p["wo"], hf, conv_tail


def _ssd_step(h_prev, a, b_dt, xh, c):
    """One SSD step: ``h = h_prev * a + (B dt) (x) x``, ``y = C . h``.
    h_prev: (B, H, state, hd), a: (B, H), b_dt and c: (B, H, state), xh:
    (B, H, hd).  On DTensors every rank steps its own rows and heads."""
    if is_dtensor(xh):
        xh = place_like(xh, xh, {0: 0, 1: 1})
        a, b_dt, c = (place_like(t, xh, {0: 0, 1: 1}) for t in (a, b_dt, c))
        h_prev = place_like(h_prev, xh, {0: 0, 1: 1})
        return run_local(_ssd_step, h_prev, a, b_dt, xh, c,
                         out_placements=[xh.placements, xh.placements])
    h = h_prev * a[:, :, None, None] \
        + torch.einsum("bhs,bhd->bhsd", b_dt, xh)
    return h, torch.einsum("bhs,bhsd->bhd", c, h)


def mamba_decode(p: Dict[str, Any], cfg, x: torch.Tensor,
                 cache: Dict[str, torch.Tensor], donate: bool = False
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Single-token step.  x: (B,1,D); cache = {"conv": (B,K-1,convdim),
    "h": (B,H,state,hd)}.  Returns (out, a new cache), or with ``donate``
    (out, ``cache``) with the new conv tail and state written into it."""
    b = x.shape[0]
    d_in, heads, conv_dim = _dims(cfg)
    g, s, hd = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_head_dim

    z = x @ p["wz"]
    xin = x @ p["wx"]
    Bp = x @ p["wB"]
    Cp = x @ p["wC"]
    dt = x.float() @ p["wdt"].float() + p["dt_bias"]
    dt = F.softplus(dt)[:, 0]                                  # (B,H)

    conv_in = torch.cat([xin, Bp, Cp], dim=-1)                 # (B,1,convdim)
    window = torch.cat([cache["conv"], conv_in], dim=1)        # (B,K,convdim)
    wt = torch.promote_types(window.dtype, p["conv_w"].dtype)
    conv_out = F.silu(torch.einsum("bkc,kc->bc", window.to(wt),
                                   p["conv_w"].to(wt)))
    xc, Bc, Cc = torch.split(conv_out, [d_in, g * s, g * s], dim=-1)
    xh = xc.reshape(b, heads, hd).float()
    Bc = Bc.reshape(b, g, s).float().repeat_interleave(heads // g, dim=1)
    Cc = Cc.reshape(b, g, s).float().repeat_interleave(heads // g, dim=1)

    A = -torch.exp(p["A_log"])
    a = torch.exp(dt * A)                                      # (B,H)
    h, y = _ssd_step(cache["h"], a, Bc * dt[..., None], xh, Cc)
    y = y + p["D"][None, :, None] * xh
    y = y.reshape(b, 1, d_in).to(x.dtype)
    y = group_rms_norm(y * F.silu(z), p["norm"], groups=heads,
                       eps=cfg.norm_eps)
    if donate:
        # window and h are new tensors: the copies read nothing they write
        cache["conv"].copy_(window[:, 1:])
        cache["h"].copy_(h)
        return y @ p["wo"], cache
    return y @ p["wo"], {"conv": window[:, 1:], "h": h}


def init_mamba_cache(cfg, batch: int, dtype: torch.dtype = torch.bfloat16,
                     device: Any = "cuda",
                     abstract: bool = False) -> Dict[str, torch.Tensor]:
    """One layer's conv window and SSD state (fp32); ``abstract``:
    ``meta`` tensors of their shapes."""
    device = "meta" if abstract else device
    d_in, heads, conv_dim = _dims(cfg)
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_dim),
                            dtype=dtype, device=device),
        "h": torch.zeros((batch, heads, cfg.ssm_state, cfg.ssm_head_dim),
                         dtype=torch.float32, device=device),
    }
