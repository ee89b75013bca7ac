"""Decoder-only LM (the JAX package's ``models/transformer.py``): the dense
attention family (GQA, qk-norm, QKV bias, RoPE, per-layer sliding windows,
gemma3's local:global pattern with its ring-buffer window cache) and the
zamba2 hybrid (groups of Mamba2 layers with one *shared* attention block
applied between groups: weights reused, one KV cache per application),
with position-indexed caches and the fused prefill and decode paths.

The layers are stacked on a leading "layers" axis, as in the JAX package,
and walked by a Python loop where it scans.  Caches are returned new and
the ones passed in are not changed, except in the donated decode step,
which writes into the cache it is given.  The other families (rwkv6, MoE,
VLM, enc-dec) raise ``NotImplementedError`` naming their ROADMAP item.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import DTypePolicy, TreeMaker
from repro_torch.models.layers import rms_norm, rope_freqs
from repro_torch.models.mlp import mlp, mlp_params

__all__ = ["init_params", "forward", "init_cache", "decode_step", "prefill",
           "uses_window_cache"]


def _unported(cfg) -> None:
    """Raise for a family the port has not reached: every one but the
    dense attention family and the Mamba2 hybrid, each naming its ROADMAP
    item."""
    what = None
    if cfg.is_encdec:
        what = "the enc-dec family", "4c"
    elif cfg.frontend == "vlm":
        what = "the VLM frontend", "4c"
    elif cfg.block == "rwkv6":
        what = "the rwkv6 family", "4b"
    elif cfg.is_moe:
        what = "the MoE family", "4b"
    if what is not None:
        raise NotImplementedError(f"{what[0]} is not ported yet (ROADMAP "
                                  f"queue A item {what[1]})")


# ---------------------------------------------------------------------------
# parameter construction
# ---------------------------------------------------------------------------

def _attn_layer_tree(tm: TreeMaker, cfg):
    d = cfg.d_model
    return {"ln1": tm.param((d,), init="ones"),
            "attn": attn_mod.attn_params(tm, cfg),
            "ln2": tm.param((d,), init="ones"),
            "mlp": mlp_params(tm, cfg)}


def _mamba_layer_tree(tm: TreeMaker, cfg):
    return {"ln1": tm.param((cfg.d_model,), init="ones"),
            "mamba": ssm_mod.mamba_params(tm, cfg)}


def _stack(trees):
    """Stack identically structured trees along a new leading axis."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees, dim=0)


def _stack_layers(trees):
    """``_stack`` for freshly drawn layer trees, leaf by leaf, dropping
    each leaf from ``trees`` once it is stacked: the peak holds one copy
    of the weights and one stacked leaf (12B parameters fit on one
    card)."""
    if isinstance(trees[0], dict):
        return {k: _stack_layers([t.pop(k) for t in trees])
                for k in list(trees[0])}
    stacked = torch.stack(trees, dim=0)
    trees.clear()
    return stacked


def init_params(cfg, gen: Optional[torch.Generator] = None,
                dtype_policy: Optional[DTypePolicy] = None,
                device: Any = "cuda") -> Dict[str, Any]:
    """Random parameters on ``device``: the JAX package's laws (other
    random bits), drawn from ``gen`` (a generator on ``device`` seeded 0
    when None)."""
    _unported(cfg)
    dev = resolve_device(device)
    if gen is None:
        gen = torch.Generator(device=dev).manual_seed(0)
    tm = TreeMaker(gen, dev, dtype_policy or DTypePolicy())
    d, v = cfg.d_model, cfg.padded_vocab
    layer = _attn_layer_tree if cfg.block == "attn" else _mamba_layer_tree
    p = {"embed": tm.param((v, d), scale=0.02),
         "final_norm": tm.param((d,), init="ones"),
         "blocks": _stack_layers([layer(tm, cfg)
                                  for _ in range(cfg.n_layers)])}
    if not cfg.tie_embeddings:
        p["lm_head"] = tm.param((d, v))
    if cfg.shared_attn_every:
        p["shared_attn"] = _attn_layer_tree(tm, cfg)
    return p


# ---------------------------------------------------------------------------
# block application
# ---------------------------------------------------------------------------

def _attn_block(lp, cfg, x, *, positions, inv_freq, window, cache=None,
                cache_pos=None, donate=False):
    h = rms_norm(x, lp["ln1"], cfg.norm_eps, plus_one=cfg.rms_plus_one)
    a, new_kv = attn_mod.attention(
        lp["attn"], cfg, h, positions=positions, inv_freq=inv_freq,
        window=window, cache=cache, cache_pos=cache_pos, donate=donate)
    return _ffn(lp, cfg, x + a), new_kv


def _ffn(lp, cfg, x):
    """The residual MLP half of an attention layer."""
    h = rms_norm(x, lp["ln2"], cfg.norm_eps, plus_one=cfg.rms_plus_one)
    return x + mlp(lp["mlp"], h, act="gelu" if cfg.rms_plus_one else "silu")


def _mamba_layer(lp, cfg, x, *, h0=None, conv_init=None):
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    o, hf, tail = ssm_mod.mamba_block(lp["mamba"], cfg, h, h0=h0,
                                      conv_init=conv_init)
    return x + o, hf, tail


# ---------------------------------------------------------------------------
# full-sequence forward (eval / prefill)
# ---------------------------------------------------------------------------

def _embed(params, cfg, tokens):
    x = params["embed"][tokens]
    if cfg.embed_scale:
        x = x * math.sqrt(cfg.d_model)
    return x


def _layer(tree, i):
    """Entry ``i`` of a tree stacked on a leading axis."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _layer_windows(cfg):
    """Per-layer attention window (0 = global).  gemma3: every Nth global."""
    n = cfg.n_layers
    if cfg.global_every and cfg.sliding_window:
        ge = cfg.global_every
        return [0 if i % ge == ge - 1 else cfg.sliding_window
                for i in range(n)]
    return [cfg.sliding_window] * n


def _run_attn_stack(params, cfg, x, *, positions, cache=None,
                    cache_pos=None, donate=False):
    """Walk the dense attention stack (a full sequence, or one decode
    token).  Returns (x, the new cache, or None without one); with
    ``donate`` every layer writes into ``cache``, which comes back."""
    inv_freq = rope_freqs(cfg.head_dim_, cfg.rope_theta, device=x.device)
    blocks = params["blocks"]
    new_kv = []
    for i, win in enumerate(_layer_windows(cfg)):
        kv = _layer(cache, i) if cache is not None else None
        x, nkv = _attn_block(_layer(blocks, i), cfg, x, positions=positions,
                             inv_freq=inv_freq, window=win, cache=kv,
                             cache_pos=cache_pos, donate=donate)
        new_kv.append(nkv)
    if cache is None or donate:
        return x, cache
    return x, _stack(new_kv)


def _run_stack(params, cfg, x, *, positions, cache=None, cache_pos=None):
    run = _run_attn_stack if cfg.block == "attn" else _run_zamba_stack
    return run(params, cfg, x, positions=positions, cache=cache,
               cache_pos=cache_pos)


def _zamba_groups(cfg):
    """Group sizes for [N mamba, shared-attn] x k (+ remainder)."""
    if not cfg.shared_attn_every:
        return [(0, cfg.n_layers, False)]
    out, lo = [], 0
    while lo < cfg.n_layers:
        hi = min(lo + cfg.shared_attn_every, cfg.n_layers)
        out.append((lo, hi, hi - lo == cfg.shared_attn_every))
        lo = hi
    return out


def _run_zamba_stack(params, cfg, x, *, positions, cache=None,
                     cache_pos=None):
    """Walk the hybrid stack over a full sequence.  Returns (x, the new
    cache, or None without one)."""
    inv_freq = rope_freqs(cfg.head_dim_, cfg.rope_theta, device=x.device)
    blocks = params["blocks"]
    new_mamba, new_attn_kv = [], []
    for gi, (lo, hi, has_attn) in enumerate(_zamba_groups(cfg)):
        for i in range(lo, hi):
            lp = _layer(blocks, i)
            if cache is None:
                x, _, _ = _mamba_layer(lp, cfg, x)
                continue
            c = _layer(cache["mamba"], i)
            x, hf, tail = _mamba_layer(lp, cfg, x, h0=c["h"],
                                       conv_init=c["conv"])
            new_mamba.append({"h": hf, "conv": tail.to(c["conv"].dtype)})
        if has_attn:
            kv = _layer(cache["attn"], gi) if cache is not None else None
            x, new_kv = _attn_block(
                params["shared_attn"], cfg, x, positions=positions,
                inv_freq=inv_freq, window=0, cache=kv, cache_pos=cache_pos)
            if new_kv is not None:
                new_attn_kv.append(new_kv)
    new_cache = None
    if cache is not None:
        new_cache = {"mamba": _stack(new_mamba),
                     "attn": (_stack(new_attn_kv) if new_attn_kv
                              else cache["attn"])}
    return x, new_cache


def _mask_logits(logits, cfg):
    """-1e30 on the padded vocab rows (exact softmax/argmax semantics)."""
    if cfg.padded_vocab != cfg.vocab:
        neg = torch.full((cfg.padded_vocab,), -1e30, dtype=logits.dtype,
                         device=logits.device)
        neg[:cfg.vocab] = 0.0
        logits = logits + neg
    return logits


def _head(params, cfg):
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def _logits(x, head):
    """fp32 logits of (.., D) activations (``preferred_element_type``)."""
    return x.float() @ head.float()


def forward(params, cfg, tokens: torch.Tensor) -> torch.Tensor:
    """Full-sequence logits.  tokens: (B, S) -> (B, S, padded vocab) fp32.
    (The JAX function's MoE auxiliary loss is always 0 here.)"""
    _unported(cfg)
    x = _embed(params, cfg, tokens)
    positions = torch.arange(x.shape[1], device=x.device)
    x, _ = _run_stack(params, cfg, x, positions=positions)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps,
                 plus_one=cfg.rms_plus_one)
    return _mask_logits(_logits(x, _head(params, cfg)), cfg)


# ---------------------------------------------------------------------------
# serving: cache init / prefill / decode
# ---------------------------------------------------------------------------

def uses_window_cache(cfg) -> bool:
    """Local layers decode on W-slot rings and each group's global layer on
    the full-length cache (gemma3's 5:1 pattern with ``window_cache``)."""
    return bool(cfg.window_cache and cfg.global_every and cfg.sliding_window
                and cfg.n_layers % cfg.global_every == 0
                and cfg.block == "attn")


def init_cache(cfg, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16,
               device: Any = "cuda") -> Dict[str, Any]:
    """The decode cache of the whole model, stacked over layers: (L, B,
    max_len, cache KV heads, head dim) per k and v for the dense family;
    with ``uses_window_cache``, ``{"local": (groups, ge-1, B, W, ...),
    "global": (groups, B, max_len, ...)}``; the Mamba2 states and the
    shared block's KV caches for zamba2."""
    _unported(cfg)
    dev = resolve_device(device)

    def kv(length):
        return attn_mod.init_kv_cache(cfg, batch, length, dtype, dev)
    if uses_window_cache(cfg):
        ge = cfg.global_every
        ng = cfg.n_layers // ge
        return {"local": _stack([_stack([kv(cfg.sliding_window)] * (ge - 1))]
                                * ng),
                "global": _stack([kv(max_len)] * ng)}
    if cfg.block == "attn":
        return _stack([kv(max_len)] * cfg.n_layers)
    n_attn = sum(1 for _, _, has in _zamba_groups(cfg) if has)
    return {
        "mamba": _stack([ssm_mod.init_mamba_cache(cfg, batch, dtype, dev)]
                        * cfg.n_layers),
        "attn": _stack([attn_mod.init_kv_cache(cfg, batch, max_len, dtype,
                                               dev)] * max(n_attn, 1)),
    }


def _decode_stack(params, cfg, x, cache, pos: torch.Tensor, donate: bool):
    """One-token step through the stack (decode fast path) at the 0-d
    device position ``pos``.  With ``donate`` every layer writes its new
    cache into ``cache``'s own tensors, which come back; otherwise the new
    per-layer caches are stacked into new tensors."""
    inv_freq = rope_freqs(cfg.head_dim_, cfg.rope_theta, device=x.device)
    positions = pos.reshape(1)
    blocks = params["blocks"]
    if cfg.block == "attn":
        if uses_window_cache(cfg):
            return _decode_window_cache(params, cfg, x, cache, pos,
                                        inv_freq, donate)
        return _run_attn_stack(params, cfg, x, positions=positions,
                               cache=cache, cache_pos=pos, donate=donate)
    new_mamba, new_attn = [], []
    for gi, (lo, hi, has_attn) in enumerate(_zamba_groups(cfg)):
        for i in range(lo, hi):
            lp = _layer(blocks, i)
            o, nc = ssm_mod.mamba_decode(
                lp["mamba"], cfg, rms_norm(x, lp["ln1"], cfg.norm_eps),
                _layer(cache["mamba"], i), donate=donate)
            x = x + o
            new_mamba.append(nc)
        if has_attn:
            x, nkv = _attn_block(
                params["shared_attn"], cfg, x, positions=positions,
                inv_freq=inv_freq, window=0, cache=_layer(cache["attn"], gi),
                cache_pos=pos, donate=donate)
            new_attn.append(nkv)
    if donate:
        return x, cache
    return x, {"mamba": _stack(new_mamba),
               "attn": _stack(new_attn) if new_attn else cache["attn"]}


def _decode_window_cache(params, cfg, x, cache, pos, inv_freq, donate):
    """Grouped decode for local:global patterns (gemma3 5:1): per group of
    ``global_every`` layers, ge-1 local layers attend over W-slot ring
    buffers and the group's global layer over the full-length cache.
    Cache memory: ng*(ge-1)*W + ng*S tokens instead of L*S."""
    ge = cfg.global_every
    blocks = params["blocks"]
    positions = pos.reshape(1)
    new_local, new_global = [], []
    for g in range(cfg.n_layers // ge):
        rings = []
        for j in range(ge - 1):
            lp = _layer(blocks, g * ge + j)
            h = rms_norm(x, lp["ln1"], cfg.norm_eps,
                         plus_one=cfg.rms_plus_one)
            o, nkv = attn_mod.ring_decode_attention(
                lp["attn"], cfg, h, pos=pos, inv_freq=inv_freq,
                cache=_layer(_layer(cache["local"], g), j), donate=donate)
            x = _ffn(lp, cfg, x + o)
            rings.append(nkv)
        x, ngc = _attn_block(
            _layer(blocks, g * ge + ge - 1), cfg, x, positions=positions,
            inv_freq=inv_freq, window=0, cache=_layer(cache["global"], g),
            cache_pos=pos, donate=donate)
        new_local.append(rings)
        new_global.append(ngc)
    if donate:
        return x, cache
    return x, {"local": _stack([_stack(r) for r in new_local]),
               "global": _stack(new_global)}


def decode_step(params, cfg, token: torch.Tensor, cache, pos,
                donate: bool = False) -> Tuple[torch.Tensor, Any]:
    """token: (B,) integer ids; pos: the cache write index, a 0-d integer
    tensor on the token's device (an int is moved there).  Returns
    (logits (B, padded vocab) fp32, the new cache).  With ``donate`` the
    step writes the new cache into ``cache``'s tensors and returns
    ``cache`` (the counterpart of ``jax.jit(..., donate_argnums=...)``):
    its addresses stay fixed and nothing syncs with the host, so the step
    can be captured as a CUDA graph."""
    _unported(cfg)
    x = _embed(params, cfg, token[:, None])
    pos = attn_mod.device_position(pos, x.device)
    x, ncache = _decode_stack(params, cfg, x, cache, pos, donate)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps,
                 plus_one=cfg.rms_plus_one)
    logits = _mask_logits(_logits(x, _head(params, cfg)), cfg)
    return logits[:, 0], ncache


def prefill(params, cfg, tokens: torch.Tensor, cache
            ) -> Tuple[torch.Tensor, Any]:
    """Fill the cache with a full prompt; returns (last-token logits, new
    cache).  For attention the whole prompt is written at cache slots
    [0, S); for the Mamba2 layers the state after the prompt is stored.

    A ring-buffer window cache (``uses_window_cache``) is not prefilled,
    as in the JAX package: step the prompt through ``decode_step``, as
    ``BatchEngine`` does."""
    _unported(cfg)
    if uses_window_cache(cfg):
        raise ValueError(
            f"{cfg.name}: prefill fills a full-length cache, not the "
            "{'local', 'global'} ring-buffer window cache; step the prompt "
            "through decode_step (as BatchEngine does) or prefill with "
            "window_cache=False")
    x = _embed(params, cfg, tokens)
    positions = torch.arange(x.shape[1], device=x.device)
    x, ncache = _run_stack(params, cfg, x, positions=positions, cache=cache,
                           cache_pos=0)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps,
                 plus_one=cfg.rms_plus_one)
    logits = _mask_logits(_logits(x[:, -1], _head(params, cfg)), cfg)
    return logits, ncache
