"""GQA attention with qk-norm, QKV bias, RoPE, sliding-window/global masks
and a position-indexed KV cache for decode (the JAX package's
``models/attention.py``, with its sharding constraints:
``distributed/sharding.constrain``).

Attention is the 5-D loop nest (B, H, Tq, Tkv, D): Q stationary, K/V
streamed.  ``_mha`` materializes the (T, S) scores; ``_mha_blockwise`` is
the flash-style online softmax over KV blocks; under autograd it runs
inside a checkpoint that keeps only q, k and v, as the JAX package's
``jax.checkpoint(nothing_saveable)`` does, so the backward recomputes the
block scores instead of holding them.  Both are plain torch, as in the JAX
package; the fold-attention kernel (``kernels/attention_fold``)
is an op no model calls.  ``ring_decode_attention`` is the one-token
decode of a sliding-window layer against a ring buffer of W slots (gemma3's
local layers under ``window_cache``).  Cross-attention (``kv_x=``) serves
the enc-dec family.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.distributed.sharding import constrain
from repro_torch.models.common import Axes, TreeMaker
from repro_torch.models.layers import apply_rope, rms_norm
from repro_torch.models.settings import get_attn_impl

__all__ = ["attn_params", "attention", "init_kv_cache", "make_mask",
           "device_position", "ring_decode_attention"]

_NEG = -1e30


def attn_params(tm: TreeMaker, cfg) -> Dict[str, Any]:
    d, kv, hd = cfg.d_model, cfg.kv_heads, cfg.head_dim_
    h = cfg.padded_heads     # padded for even TP; padded heads are masked
    e, hh, kvh, hdh = Axes.EMBED, Axes.HEADS, Axes.KV_HEADS, Axes.HEAD_DIM
    p = {"wq": tm.param((d, h, hd), (e, hh, hdh)),
         "wk": tm.param((d, kv, hd), (e, kvh, hdh)),
         "wv": tm.param((d, kv, hd), (e, kvh, hdh)),
         "wo": tm.param((h, hd, d), (hh, hdh, e))}
    if cfg.qkv_bias:
        p["bq"] = tm.param((h, hd), (hh, hdh), init="zeros")
        p["bk"] = tm.param((kv, hd), (kvh, hdh), init="zeros")
        p["bv"] = tm.param((kv, hd), (kvh, hdh), init="zeros")
    if cfg.qk_norm:
        p["q_norm"] = tm.param((hd,), (Axes.HEAD_DIM,), init="ones")
        p["k_norm"] = tm.param((hd,), (Axes.HEAD_DIM,), init="ones")
    return p


def make_mask(q_pos: torch.Tensor, kv_pos: torch.Tensor, *,
              causal: bool = True, window: int = 0,
              kv_len=None) -> torch.Tensor:
    """Boolean (Tq, Tkv) mask.  window > 0 limits lookback (sliding);
    ``kv_len`` (an int or a 0-d tensor) masks the cache entries past it."""
    q = q_pos[:, None]
    k = kv_pos[None, :]
    mask = torch.ones((q_pos.shape[0], kv_pos.shape[0]), dtype=torch.bool,
                      device=q_pos.device)
    if causal:
        mask &= k <= q
    if window > 0:
        mask &= k > q - window
    if kv_len is not None:
        mask &= k < kv_len
    return mask


def _project_kv(p, cfg, x):
    k = torch.einsum("btd,dkh->btkh", x, p["wk"])
    v = torch.einsum("btd,dkh->btkh", x, p["wv"])
    if cfg.qkv_bias:
        k, v = k + p["bk"], v + p["bv"]
    if cfg.qk_norm:
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return k, v


def _project_q(p, cfg, x):
    q = torch.einsum("btd,dhk->bthk", x, p["wq"])
    if cfg.qkv_bias:
        q = q + p["bq"]
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
    return q


def _project_qkv(p, cfg, x, positions, inv_freq):
    """q, k and v of ``x``: the projections, QKV biases, qk-norm, and RoPE
    at ``positions`` on q and k."""
    q = _project_q(p, cfg, x)
    k, v = _project_kv(p, cfg, x)
    if inv_freq is not None:
        q = apply_rope(q, positions, inv_freq)
        k = apply_rope(k, positions, inv_freq)
    return q, k, v


def _project_out(p, cfg, out):
    """The heads' outputs, padded heads zeroed (exactness), through wo."""
    if cfg.padded_heads != cfg.n_heads:
        hmask = torch.arange(cfg.padded_heads, device=out.device) \
            < cfg.n_heads
        out = out * hmask[None, None, :, None].to(out.dtype)
    return torch.einsum("bthk,hkd->btd", out, p["wo"])


def _mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         mask: Optional[torch.Tensor], head_dim: int) -> torch.Tensor:
    """Grouped-query core.  q: (B,T,H,hd), k/v: (B,S,KV,hd) -> (B,T,H,hd).

    Scores and the weighted sum in fp32 (the JAX package's
    ``preferred_element_type=float32``), softmax in fp32.  Materializes
    the (T, S) score tensor.
    """
    b, t, h, hd = q.shape
    kv = k.shape[2]
    if t == 1 and kv != h:
        # decode: grouped-Q einsum, no g x copy of the cache
        g = h // kv
        qg = q.reshape(b, t, kv, g, hd)
        scores = torch.einsum("btkgh,bskh->bkgts", qg.float(), k.float())
        scores = scores * (head_dim ** -0.5)
        if mask is not None:
            scores = torch.where(mask[None, None, None], scores, _NEG)
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("bkgts,bskh->btkgh", probs.to(v.dtype).float(),
                           v.float())
        return out.reshape(b, t, h, hd).to(q.dtype)
    k, v = _expand_kv(k, v, h)
    scores = torch.einsum("bthd,bshd->bhts", q.float(), k.float())
    scores = scores * (head_dim ** -0.5)
    if mask is not None:
        scores = torch.where(mask[None, None], scores, _NEG)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhts,bshd->bthd", probs.to(v.dtype).float(),
                       v.float())
    return out.to(q.dtype)


def _expand_kv(k, v, h):
    """GQA K/V -> the full query-head count (head h reads kv head
    h // (H / KV))."""
    kv = k.shape[2]
    if kv == h:
        return k, v
    g = h // kv
    names = ("batch", None, "heads", None)
    return (constrain(k.repeat_interleave(g, dim=2), names),
            constrain(v.repeat_interleave(g, dim=2), names))


def _mha_blockwise(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   q_pos: torch.Tensor, kv_pos: torch.Tensor, *,
                   head_dim: int, causal: bool = True, window: int = 0,
                   kv_len=None,
                   block: int = 1024) -> torch.Tensor:
    """Flash-style online-softmax attention: a loop over KV blocks
    carrying (running max, denom, weighted accumulator).  The same math as
    ``_mha`` up to fp regrouping, with an O(T x block) score footprint."""
    b, t, h, hd = q.shape
    s = k.shape[1]
    k, v = _expand_kv(k, v, h)
    if s % block:
        block = s if s <= block else max(
            bs for bs in (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)
            if s % bs == 0)
    qs = (q * (head_dim ** -0.5)).to(q.dtype)
    m = torch.full((b, h, t), _NEG, dtype=torch.float32, device=q.device)
    d = torch.zeros((b, h, t), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, t, h, hd), dtype=torch.float32, device=q.device)
    for k0 in range(0, s, block):
        kblk, vblk = k[:, k0:k0 + block], v[:, k0:k0 + block]
        sc = torch.einsum("bthd,bshd->bhts", qs.float(), kblk.float())
        msk = make_mask(q_pos, kv_pos[k0:k0 + block], causal=causal,
                        window=window, kv_len=kv_len)
        sc = torch.where(msk[None, None], sc, _NEG)
        m_new = torch.maximum(m, sc.amax(dim=-1))
        p = torch.exp(sc - m_new[..., None])
        corr = torch.exp(m - m_new)
        d = d * corr + p.sum(dim=-1)
        pv = torch.einsum("bhts,bshd->bthd", p.to(vblk.dtype).float(),
                          vblk.float())
        acc = acc * corr.transpose(1, 2)[..., None] + pv
        m = m_new
    out = acc / torch.clamp(d.transpose(1, 2)[..., None], min=1e-30)
    return out.to(q.dtype)


def _flash(q, k, v, q_pos, kv_pos, **kw) -> torch.Tensor:
    """``_mha_blockwise``; under autograd inside a checkpoint that saves
    nothing of the KV-block loop (its inputs only): the backward
    recomputes the block scores (twice the attention flops) instead of
    keeping O(T x S) probabilities.  Values are unchanged."""
    if not (torch.is_grad_enabled()
            and any(a.requires_grad for a in (q, k, v))):
        return _mha_blockwise(q, k, v, q_pos, kv_pos, **kw)
    from torch.utils.checkpoint import checkpoint
    return checkpoint(_mha_blockwise, q, k, v, q_pos, kv_pos,
                      use_reentrant=False, preserve_rng_state=False, **kw)


def device_position(pos, device) -> torch.Tensor:
    """``pos`` (an int or an integer tensor) as a 0-d int64 tensor on
    ``device``.  An int is filled in on the device (a kernel argument, no
    host-to-device copy), so a CUDA-graph capture may take one."""
    if isinstance(pos, torch.Tensor):
        return pos.to(device=device, dtype=torch.long).reshape(())
    return torch.full((), int(pos), dtype=torch.long, device=device)


def _write_rows(cache: torch.Tensor, new: torch.Tensor, pos: torch.Tensor,
                donate: bool) -> torch.Tensor:
    """``cache`` with ``new``'s T rows written at sequence index ``pos`` (a
    0-d device tensor), the start clamped on the device so the block fits,
    as ``lax.dynamic_update_slice`` clamps it.  With ``donate`` the rows go
    into ``cache`` itself, else into a copy (the one passed in is not
    changed)."""
    t = new.shape[1]
    start = pos.clamp(0, cache.shape[1] - t)
    idx = start + torch.arange(t, device=cache.device)
    new = new.to(cache.dtype)
    if donate:
        return cache.index_copy_(1, idx, new)
    return cache.index_copy(1, idx, new)


def attention(p: Dict[str, Any], cfg, x: torch.Tensor, *,
              positions: torch.Tensor,
              inv_freq: Optional[torch.Tensor],
              causal: bool = True,
              window: int = 0,
              cache: Optional[Dict[str, torch.Tensor]] = None,
              cache_pos=None,
              kv_x: Optional[torch.Tensor] = None,
              kv_positions: Optional[torch.Tensor] = None,
              donate: bool = False,
              ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Self- or cross-attention.

    * train/prefill: cache=None, full sequence in ``x``.
    * decode / cached prefill: ``cache`` holds (k, v) of shape
      (B, S_max, KV, hd); the T new tokens' k/v are written at
      ``cache_pos`` (an int, or a 0-d integer tensor on x's device), the
      start clamped on the device, and attention runs over the first
      ``cache_pos + T`` entries (unclamped, as in the JAX package).  The
      rows go into a new cache (the one passed in is not changed), or
      with ``donate`` into ``cache``'s own tensors, which come back.
    * cross-attention: ``kv_x`` (B, S, D) is the encoder output, the keys'
      and values' source; every row of it is visible (no mask), k gets no
      RoPE, q gets it only when ``inv_freq`` is given, and no cache is
      written.  As in the JAX package, the unmasked ``_mha`` takes it
      whatever the attention impl, so ``kv_positions`` (the encoder rows'
      positions) changes no value.

    Returns (output (B,T,D), the new cache or None).
    """
    if kv_x is not None:
        q = _project_q(p, cfg, x)
        if inv_freq is not None:
            q = apply_rope(q, positions, inv_freq)
        k, v = _project_kv(p, cfg, kv_x)
        out = _mha(q, k.to(q.dtype), v.to(q.dtype), None, cfg.head_dim_)
        return _project_out(p, cfg, out), None
    q, k, v = _project_qkv(p, cfg, x, positions, inv_freq)
    if cache is None:
        kv_pos, kv_len, new_cache = positions, None, None
    else:
        # write T tokens at cache_pos (T=1 decode, T=S prefill), expanded
        # to the cache's head count
        pos = device_position(cache_pos, x.device)
        k = _write_rows(cache["k"], _to_cache_heads(cfg, k), pos, donate)
        v = _write_rows(cache["v"], _to_cache_heads(cfg, v), pos, donate)
        new_cache = {"k": k, "v": v}
        kv_pos = torch.arange(k.shape[1], device=x.device)
        kv_len = pos + x.shape[1]
    if get_attn_impl() == "blockwise" and x.shape[1] > 1:
        out = _flash(q, k.to(q.dtype), v.to(q.dtype), positions, kv_pos,
                     head_dim=cfg.head_dim_, causal=causal, window=window,
                     kv_len=kv_len)
    else:
        mask = make_mask(positions, kv_pos, causal=causal, window=window,
                         kv_len=kv_len)
        out = _mha(q, k.to(q.dtype), v.to(q.dtype), mask, cfg.head_dim_)
    return _project_out(p, cfg, out), new_cache


def init_kv_cache(cfg, batch: int, max_len: int,
                  dtype: torch.dtype = torch.bfloat16,
                  device: Any = "cuda",
                  abstract: bool = False) -> Dict[str, torch.Tensor]:
    """One layer's KV cache (kv heads expanded to cfg.cache_kv_heads);
    ``abstract``: ``meta`` tensors of its shapes, nothing allocated."""
    device = "meta" if abstract else device
    shape = (batch, max_len, cfg.cache_kv_heads, cfg.head_dim_)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _to_cache_heads(cfg, kv: torch.Tensor) -> torch.Tensor:
    """Duplicate KV heads up to the cache head count (pure replication —
    the q->kv group mapping is preserved by the repeat order)."""
    rep = cfg.cache_kv_heads // kv.shape[2]
    return kv.repeat_interleave(rep, dim=2) if rep > 1 else kv


def ring_decode_attention(p: Dict[str, Any], cfg, x: torch.Tensor, *,
                          pos: torch.Tensor,
                          inv_freq: Optional[torch.Tensor],
                          cache: Dict[str, torch.Tensor],
                          donate: bool = False
                          ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Single-token decode against a RING buffer of W slots (sliding-window
    layers).  Slot i holds the K/V of the newest position p <= pos with
    p = i (mod W); RoPE is applied at write time, so ring order is
    irrelevant to the attention math.  Memory: O(W) instead of O(seq).

    ``pos`` is a 0-d integer tensor on x's device (a CUDA graph replays
    it): the slot ``pos mod W``, each slot's absolute position
    ``pos - ((pos - i) mod W)`` and the warm-up mask ``slot_pos >= 0`` are
    computed on the device from it, never on the host.  The new K/V go
    into a copy of the ring (the one passed in is not changed), or with
    ``donate`` into ``cache``'s own tensors, which come back.
    """
    w = cache["k"].shape[1]
    q, k_new, v_new = _project_qkv(p, cfg, x, pos.reshape(1), inv_freq)
    slot = torch.remainder(pos, w)
    k = _write_rows(cache["k"], _to_cache_heads(cfg, k_new), slot, donate)
    v = _write_rows(cache["v"], _to_cache_heads(cfg, v_new), slot, donate)
    # per-slot absolute position: latest p <= pos with p = i (mod W)
    idx = torch.arange(w, device=x.device)
    slot_pos = pos - torch.remainder(pos - idx, w)
    mask = (slot_pos >= 0)[None, :]               # (1, W): warm-up guard
    out = _mha(q, k.to(q.dtype), v.to(q.dtype), mask, cfg.head_dim_)
    return _project_out(p, cfg, out), {"k": k, "v": v}
