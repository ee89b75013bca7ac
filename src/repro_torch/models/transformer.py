"""Decoder-only LM (the JAX package's ``models/transformer.py``): the dense
attention family (GQA, qk-norm, QKV bias, RoPE, per-layer sliding windows,
gemma3's local:global pattern with its ring-buffer window cache), the MoE
family (the attention layer with ``models/moe.py``'s FFN), RWKV-6
(``models/rwkv.py``), the zamba2 hybrid (groups of Mamba2 layers with one
*shared* attention block applied between groups: weights reused, one KV
cache per application) and the VLM frontend (projected patch embeddings
prepended to the tokens), with position-indexed caches and the fused
prefill and decode paths.  The enc-dec family is ``models/encdec.py``.

The layers are stacked on a leading "layers" axis, as in the JAX package,
and walked by a Python loop where it scans; a full-sequence pass splits
each stacked leaf once (``_layers``), so the backward stacks the layers'
gradients in one op.  Caches are returned new and the ones passed in are
not changed, except in the donated decode step, which writes into the
cache it is given.  ``forward`` returns the logits; ``lm_loss`` is the
training loss: the masked token cross entropy plus ``aux_coef`` times the
MoE auxiliary loss summed over the layers, as the JAX package's.  Under
``settings.remat`` each layer body of a full-sequence pass is
checkpointed (``settings.maybe_remat``), where the JAX package wraps its
scan bodies; zamba2's shared attention block is not, as there.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.device import resolve_device
from repro_torch.distributed.dtensor import (arange_like, is_dtensor,
                                             placed_like, replicated_like)
from repro_torch.distributed.sharding import constrain
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import (Axes, DTypePolicy, TreeMaker,
                                       stack_abstract, stack_axes)
from repro_torch.models.layers import embed_rows, rms_norm, rope_freqs
from repro_torch.models.mlp import mlp, mlp_params
from repro_torch.models.settings import maybe_remat

__all__ = ["init_params", "param_axes", "forward", "lm_loss", "init_cache",
           "decode_step", "prefill", "uses_window_cache"]


# ---------------------------------------------------------------------------
# parameter construction
# ---------------------------------------------------------------------------

def _attn_layer_tree(tm: TreeMaker, cfg):
    d = cfg.d_model
    t = {"ln1": tm.param((d,), (Axes.EMBED,), init="ones"),
         "attn": attn_mod.attn_params(tm, cfg),
         "ln2": tm.param((d,), (Axes.EMBED,), init="ones")}
    if cfg.is_moe:
        t["moe"] = moe_mod.moe_params(tm, cfg)
    else:
        t["mlp"] = mlp_params(tm, cfg)
    return t


def _layer_tree(tm: TreeMaker, cfg):
    d = cfg.d_model
    if cfg.block == "rwkv6":
        return {"ln1": tm.param((d,), (Axes.EMBED,), init="ones"),
                "ln2": tm.param((d,), (Axes.EMBED,), init="ones"),
                "rwkv": rwkv_mod.rwkv_params(tm, cfg)}
    if cfg.block == "mamba2":
        return {"ln1": tm.param((d,), (Axes.EMBED,), init="ones"),
                "mamba": ssm_mod.mamba_params(tm, cfg)}
    return _attn_layer_tree(tm, cfg)


def _stack(trees):
    """Stack identically structured trees along a new leading axis."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees, dim=0)


def _laid_out_as(state, cache):
    """A layer's new recurrent state (a dict of tensors) laid out as its
    layer of the cache passed in, the identity on plain tensors: the
    stacked cache keeps its layout at every depth, as a scan's carry
    does (DTensor's ``stack`` would otherwise choose by the count of
    layers)."""
    return {k: placed_like(v, cache[k]) for k, v in state.items()}


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


def _model_tree(cfg, tm: TreeMaker, layer_maker):
    d, v = cfg.d_model, cfg.padded_vocab
    p = {"embed": tm.param((v, d), (Axes.VOCAB, Axes.EMBED), scale=0.02),
         "final_norm": tm.param((d,), (Axes.EMBED,), init="ones"),
         "blocks": layer_maker()}
    if not cfg.tie_embeddings:
        p["lm_head"] = tm.param((d, v), (Axes.EMBED, Axes.VOCAB))
    if cfg.shared_attn_every:
        p["shared_attn"] = _attn_layer_tree(tm, cfg)
    if cfg.frontend == "vlm":
        p["frontend_proj"] = tm.param((d, d), (Axes.EMBED, Axes.EMBED))
    return p


def init_params(cfg, gen: Optional[torch.Generator] = None,
                dtype_policy: Optional[DTypePolicy] = None,
                device: Any = "cuda", abstract: bool = False
                ) -> Dict[str, Any]:
    """Random parameters on ``device``: the JAX package's laws (other
    random bits), drawn from ``gen`` (a generator on ``device`` seeded 0
    when None).  ``abstract``: the tree of ``meta`` tensors of the
    parameters' shapes and types (no device, nothing drawn or
    allocated)."""
    dp = dtype_policy or DTypePolicy()
    if abstract:
        tm = TreeMaker(dtype_policy=dp, mode="abstract")
        return _model_tree(cfg, tm, lambda: stack_abstract(
            _layer_tree(tm, cfg), cfg.n_layers))
    dev = resolve_device(device)
    if gen is None:
        gen = torch.Generator(device=dev).manual_seed(0)
    tm = TreeMaker(gen, dev, dp)
    return _model_tree(cfg, tm, lambda: _stack_layers(
        [_layer_tree(tm, cfg) for _ in range(cfg.n_layers)]))


def param_axes(cfg) -> Dict[str, Any]:
    """The parameters' logical axes: a tree of ``init_params``'s
    structure whose leaves are tuples of axis names."""
    tm = TreeMaker(mode="axes")
    return _model_tree(cfg, tm, lambda: stack_axes(_layer_tree(tm, cfg)))


# ---------------------------------------------------------------------------
# block application
# ---------------------------------------------------------------------------

def _attn_block(lp, cfg, x, *, positions, inv_freq, window, cache=None,
                cache_pos=None, donate=False):
    """Returns (x, the new KV cache or None, the MoE aux loss or None)."""
    h = rms_norm(x, lp["ln1"], cfg.norm_eps, plus_one=cfg.rms_plus_one)
    a, new_kv = attn_mod.attention(
        lp["attn"], cfg, h, positions=positions, inv_freq=inv_freq,
        window=window, cache=cache, cache_pos=cache_pos, donate=donate)
    x, aux = _ffn(lp, cfg, x + constrain(a, ("batch", None, None)))
    return x, new_kv, aux


def _ffn(lp, cfg, x):
    """The residual FFN half of an attention layer: the MLP, or the MoE
    FFN.  Returns (x, the MoE aux loss, or None for the MLP)."""
    h = rms_norm(x, lp["ln2"], cfg.norm_eps, plus_one=cfg.rms_plus_one)
    if cfg.is_moe:
        f, aux = moe_mod.moe_ffn(
            lp["moe"], cfg, h, group_size=cfg.moe_group_size,
            capacity_factor=cfg.moe_capacity_factor,
            renorm_topk=cfg.shared_experts == 0,
            dispatch_dtype=(torch.bfloat16
                            if cfg.moe_dispatch_dtype == "bf16" else None))
        return x + constrain(f, ("batch", None, None)), aux
    f = mlp(lp["mlp"], h, act="gelu" if cfg.rms_plus_one else "silu")
    return x + constrain(f, ("batch", None, None)), None


def _add_aux(total, aux):
    """The running sum of the layers' aux losses (None: none yet)."""
    if aux is None:
        return total
    return aux if total is None else total + aux


def _aux_or_zero(total, x):
    """The aux loss sum, or a 0-d fp32 zero beside ``x``."""
    return (total if total is not None
            else replicated_like(torch.zeros((), dtype=torch.float32,
                                             device=x.device), x))


def _rwkv_block(lp, cfg, x, *, state=None, x_tm=None, x_cm=None):
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    o, sf, xl_tm = rwkv_mod.rwkv_time_mix(lp["rwkv"], cfg, h, last_x=x_tm,
                                          s0=state)
    x = x + o
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    o, xl_cm = rwkv_mod.rwkv_channel_mix(lp["rwkv"], cfg, h, last_x=x_cm)
    return x + o, sf, xl_tm, xl_cm


def _mamba_layer(lp, cfg, x, *, h0=None, conv_init=None):
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    o, hf, tail = ssm_mod.mamba_block(lp["mamba"], cfg, h, h0=h0,
                                      conv_init=conv_init)
    return x + o, hf, tail


# ---------------------------------------------------------------------------
# full-sequence forward (train / eval / prefill)
# ---------------------------------------------------------------------------

def _embed(params, cfg, tokens, extra_embeds=None):
    """Token embeddings; for the VLM, ``extra_embeds`` (B, L, D) projected
    by ``frontend_proj`` and put in front of them."""
    x = embed_rows(params["embed"], tokens)
    if cfg.embed_scale:
        x = x * math.sqrt(cfg.d_model)
    if cfg.frontend == "vlm" and extra_embeds is not None:
        patches = extra_embeds.to(x.dtype) @ params["frontend_proj"]
        x = torch.cat([patches, x], dim=1)
    return constrain(x, ("batch", None, None))


def _layer(tree, i):
    """Entry ``i`` of a tree stacked on a leading axis."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _layers(tree):
    """Every entry of a tree stacked on a leading axis, each leaf split
    once (``torch.unbind``).  Under autograd the split's one backward
    stacks the entries' gradients, where ``_layer`` per entry would give
    each entry's backward a zero tensor the size of the whole stack."""
    if isinstance(tree, dict):
        per = {k: _layers(v) for k, v in tree.items()}
        n = len(next(iter(per.values())))
        return [{k: v[i] for k, v in per.items()} for i in range(n)]
    return list(torch.unbind(tree, 0))


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
    token).  Returns (x, the summed MoE aux loss or None, the new cache
    or None without one); with ``donate`` every layer writes into
    ``cache``, which comes back.  A cached pass (prefill, decode) is not
    trained and sums no aux loss."""
    inv_freq = rope_freqs(cfg.head_dim_, cfg.rope_theta, device=x.device)
    blocks, aux = params["blocks"], None
    if cache is None:
        def body(lp, xc, win):
            xc, _, a = _attn_block(lp, cfg, xc, positions=positions,
                                   inv_freq=inv_freq, window=win)
            return xc, a
        run = maybe_remat(body)
        for lp, win in zip(_layers(blocks), _layer_windows(cfg)):
            x, a = run(lp, x, win)
            aux = _add_aux(aux, a)
        return x, aux, None
    new_kv = []
    for i, win in enumerate(_layer_windows(cfg)):
        x, nkv, _ = _attn_block(_layer(blocks, i), cfg, x,
                                positions=positions, inv_freq=inv_freq,
                                window=win, cache=_layer(cache, i),
                                cache_pos=cache_pos, donate=donate)
        new_kv.append(nkv)
    return x, None, (cache if donate else _stack(new_kv))


def _run_stack(params, cfg, x, *, positions, cache=None, cache_pos=None):
    """Returns (x, the summed MoE aux loss or None, the new cache or
    None)."""
    if cfg.block == "rwkv6":
        return _run_rwkv_stack(params, cfg, x, cache=cache)
    run = _run_attn_stack if cfg.block == "attn" else _run_zamba_stack
    return run(params, cfg, x, positions=positions, cache=cache,
               cache_pos=cache_pos)


def _run_rwkv_stack(params, cfg, x, *, cache=None):
    """Walk the RWKV-6 stack over a full sequence, from the states in
    ``cache`` when given.  Returns (x, None: no aux loss, the states after
    it or None), the last token-shift inputs in the cache's type."""
    blocks, new = params["blocks"], []
    if cache is None:
        run = maybe_remat(lambda lp, xc: _rwkv_block(lp, cfg, xc)[0])
        for lp in _layers(blocks):
            x = run(lp, x)
        return x, None, None
    for i in range(cfg.n_layers):
        c = _layer(cache, i)
        x, sf, xl_tm, xl_cm = _rwkv_block(_layer(blocks, i), cfg, x,
                                          state=c["s"], x_tm=c["x_tm"],
                                          x_cm=c["x_cm"])
        new.append({"s": sf, "x_tm": xl_tm.to(c["x_tm"].dtype),
                    "x_cm": xl_cm.to(c["x_cm"].dtype)})
    return x, None, _stack(new)


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
    """Walk the hybrid stack over a full sequence.  Returns (x, the summed
    aux loss of the shared block or None, the new cache or None without
    one).  The shared block's weights serve every application, so their
    gradients sum over the applications."""
    inv_freq = rope_freqs(cfg.head_dim_, cfg.rope_theta, device=x.device)
    blocks = params["blocks"]
    if cache is None:
        layers = _layers(blocks)
        run = maybe_remat(lambda lp, xc: _mamba_layer(lp, cfg, xc)[0])
    aux, new_mamba, new_attn_kv = None, [], []
    for gi, (lo, hi, has_attn) in enumerate(_zamba_groups(cfg)):
        for i in range(lo, hi):
            if cache is None:
                x = run(layers[i], x)
                continue
            c = _layer(cache["mamba"], i)
            x, hf, tail = _mamba_layer(_layer(blocks, i), cfg, x, h0=c["h"],
                                       conv_init=c["conv"])
            new_mamba.append({"h": hf, "conv": tail.to(c["conv"].dtype)})
        if has_attn:
            kv = _layer(cache["attn"], gi) if cache is not None else None
            x, new_kv, a = _attn_block(
                params["shared_attn"], cfg, x, positions=positions,
                inv_freq=inv_freq, window=0, cache=kv, cache_pos=cache_pos)
            aux = _add_aux(aux, a)
            if new_kv is not None:
                new_attn_kv.append(new_kv)
    new_cache = None
    if cache is not None:
        new_cache = {"mamba": _stack(new_mamba),
                     "attn": (_stack(new_attn_kv) if new_attn_kv
                              else cache["attn"])}
    return x, aux, new_cache


def _mask_logits(logits, cfg):
    """-1e30 on the padded vocab rows (exact softmax/argmax semantics)."""
    if cfg.padded_vocab != cfg.vocab:
        neg = torch.full((cfg.padded_vocab,), -1e30, dtype=logits.dtype,
                         device=logits.device)
        neg[:cfg.vocab] = 0.0
        logits = logits + replicated_like(neg, logits)
    return logits


def _head(params, cfg):
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def _logits(x, head):
    """fp32 logits of (.., D) activations (``preferred_element_type``)."""
    return x.float() @ head.float()


def _forward(params, cfg, tokens, extra_embeds=None):
    """(logits, the summed MoE aux loss: a 0-d fp32 tensor) of a full
    sequence."""
    x = _embed(params, cfg, tokens, extra_embeds)
    positions = torch.arange(x.shape[1], device=x.device)
    x, aux, _ = _run_stack(params, cfg, x, positions=positions)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps,
                 plus_one=cfg.rms_plus_one)
    return (_mask_logits(_logits(x, _head(params, cfg)), cfg),
            _aux_or_zero(aux, x))


def forward(params, cfg, tokens: torch.Tensor, *,
            extra_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence logits.  tokens: (B, S) -> (B, S_total, padded vocab)
    fp32, S_total = S plus, for the VLM, the L rows of ``extra_embeds``
    (B, L, D) in front.  The JAX function returns the MoE aux loss beside
    them; here ``lm_loss`` reads it."""
    return _forward(params, cfg, tokens, extra_embeds)[0]


def masked_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token cross entropy (fp32) of (B, S, V) logits against (B, S)
    labels, over the labels >= 0 (a label < 0 is masked out).

    On ``DTensor`` logits (a sharded step, the vocab split over the model
    axis) it is the vocab-parallel form, ``logsumexp(x) - x[label]``, with
    the max and the sums reduced across the vocab shards and the label's
    logit picked by a one-hot product, where a log-softmax and a gather
    would first gather every shard's logits on every rank."""
    mask = (labels >= 0).float()
    lab = labels.clamp(min=0).long()
    x = logits.float()
    if is_dtensor(x):
        m = x.detach().amax(dim=-1, keepdim=True)
        lse = torch.log(torch.exp(x - m).sum(dim=-1)) + m[..., 0]
        vocab = arange_like(x)
        picked = (x * (lab[..., None] == vocab).float()).sum(dim=-1)
        nll = lse - picked
    else:
        logp = torch.log_softmax(x, dim=-1)
        nll = -torch.gather(logp, -1, lab[..., None])[..., 0]
    return (nll * mask).sum() / mask.sum().clamp(min=1.0)


def lm_loss(params, cfg, batch: Dict[str, torch.Tensor],
            aux_coef: float = 0.01) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Causal-LM cross entropy (fp32), masked on labels >= 0, plus
    ``aux_coef`` times the MoE aux loss.  ``batch``: "tokens" and
    "labels" (B, S), and for the VLM "patches" (B, L, D), whose L logit
    rows are dropped before the loss.  Returns (total, {"loss",
    "aux_loss"})."""
    logits, aux = _forward(params, cfg, batch["tokens"],
                           extra_embeds=batch.get("patches"))
    if cfg.frontend == "vlm":
        logits = logits[:, cfg.frontend_len:]
    loss = masked_nll(logits, batch["labels"])
    return loss + aux_coef * aux, {"loss": loss, "aux_loss": aux}


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
               device: Any = "cuda", abstract: bool = False
               ) -> Dict[str, Any]:
    """The decode cache of the whole model, stacked over layers: (L, B,
    max_len, cache KV heads, head dim) per k and v for the dense family;
    with ``uses_window_cache``, ``{"local": (groups, ge-1, B, W, ...),
    "global": (groups, B, max_len, ...)}``; the Mamba2 states and the
    shared block's KV caches for zamba2; the WKV states (fp32) and the
    token-shift inputs for rwkv6.  ``abstract``: ``meta`` tensors of
    those shapes and types, nothing allocated."""
    dev = torch.device("meta") if abstract else resolve_device(device)

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
    if cfg.block == "rwkv6":
        return _stack([rwkv_mod.init_rwkv_cache(cfg, batch, dtype, dev)]
                      * cfg.n_layers)
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
    if cfg.block == "rwkv6":
        return _decode_rwkv(params, cfg, x, cache, donate)
    inv_freq = rope_freqs(cfg.head_dim_, cfg.rope_theta, device=x.device)
    positions = pos.reshape(1)
    blocks = params["blocks"]
    if cfg.block == "attn":
        if uses_window_cache(cfg):
            return _decode_window_cache(params, cfg, x, cache, pos,
                                        inv_freq, donate)
        x, _, ncache = _run_attn_stack(params, cfg, x, positions=positions,
                                       cache=cache, cache_pos=pos,
                                       donate=donate)
        return x, ncache
    new_mamba, new_attn = [], []
    for gi, (lo, hi, has_attn) in enumerate(_zamba_groups(cfg)):
        for i in range(lo, hi):
            lp = _layer(blocks, i)
            o, nc = ssm_mod.mamba_decode(
                lp["mamba"], cfg, rms_norm(x, lp["ln1"], cfg.norm_eps),
                _layer(cache["mamba"], i), donate=donate)
            x = x + o
            new_mamba.append(_laid_out_as(nc, _layer(cache["mamba"], i)))
        if has_attn:
            x, nkv, _ = _attn_block(
                params["shared_attn"], cfg, x, positions=positions,
                inv_freq=inv_freq, window=0, cache=_layer(cache["attn"], gi),
                cache_pos=pos, donate=donate)
            new_attn.append(nkv)
    if donate:
        return x, cache
    return x, {"mamba": _stack(new_mamba),
               "attn": _stack(new_attn) if new_attn else cache["attn"]}


def _decode_rwkv(params, cfg, x, cache, donate):
    """One token through the RWKV-6 stack.  The new states come back in
    the activations' type, as the JAX decode step's do; with ``donate``
    they are written into ``cache``'s tensors (in the cache's type)."""
    blocks, new = params["blocks"], []
    for i in range(cfg.n_layers):
        c = _layer(cache, i)
        x, sf, xl_tm, xl_cm = _rwkv_block(_layer(blocks, i), cfg, x,
                                          state=c["s"], x_tm=c["x_tm"],
                                          x_cm=c["x_cm"])
        new.append(_laid_out_as({"s": sf, "x_tm": xl_tm, "x_cm": xl_cm}, c))
        if donate:
            for name, t in new[-1].items():
                c[name].copy_(t)
    return x, (cache if donate else _stack(new))


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
            x, _ = _ffn(lp, cfg, x + o)
            rings.append(nkv)
        x, ngc, _ = _attn_block(
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
    x = _embed(params, cfg, token[:, None])
    pos = attn_mod.device_position(pos, x.device)
    x, ncache = _decode_stack(params, cfg, x, cache, pos, donate)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps,
                 plus_one=cfg.rms_plus_one)
    logits = _mask_logits(_logits(x, _head(params, cfg)), cfg)
    return logits[:, 0], ncache


def prefill(params, cfg, tokens: torch.Tensor, cache, *,
            extra_embeds: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Any]:
    """Fill the cache with a full prompt; returns (last-token logits, new
    cache).  For attention the whole prompt is written at cache slots
    [0, S); for the Mamba2 and RWKV-6 layers the state after the prompt is
    stored.  The VLM's ``extra_embeds`` (B, L, D) go in front of the
    prompt, at slots [0, L).

    A ring-buffer window cache (``uses_window_cache``) is not prefilled,
    as in the JAX package: step the prompt through ``decode_step``, as
    ``BatchEngine`` does."""
    if uses_window_cache(cfg):
        raise ValueError(
            f"{cfg.name}: prefill fills a full-length cache, not the "
            "{'local', 'global'} ring-buffer window cache; step the prompt "
            "through decode_step (as BatchEngine does) or prefill with "
            "window_cache=False")
    x = _embed(params, cfg, tokens, extra_embeds)
    positions = torch.arange(x.shape[1], device=x.device)
    x, _, ncache = _run_stack(params, cfg, x, positions=positions,
                              cache=cache, cache_pos=0)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps,
                 plus_one=cfg.rms_plus_one)
    logits = _mask_logits(_logits(x[:, -1], _head(params, cfg)), cfg)
    return logits, ncache
