"""Encoder-decoder transformer (the seamless-m4t backbone; the JAX
package's ``models/encdec.py``).

The speech frontend is a stub, as in the JAX package: ``src_embeds``
(B, T_src, d_model) are precomputed frame embeddings that feed the encoder
through a projection.  The decoder is a causal stack with cross-attention.
``prefill`` encodes the source and caches each layer's cross K/V, sized by
the source it was given; ``decode_step`` attends over the cached cross K/V
directly (``_mha`` on the decoder's q, with no q bias and no RoPE: the JAX
decode branch's).  ``lm_loss`` is the teacher-forced cross entropy with no
aux loss; as in the JAX package, no layer body is rematerialized.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import constrain
from repro_torch.models import attention as attn_mod
from repro_torch.models.common import (Axes, DTypePolicy, TreeMaker,
                                       stack_abstract, stack_axes)
from repro_torch.models.layers import rms_norm, rope_freqs
from repro_torch.models.mlp import mlp, mlp_params
from repro_torch.models.transformer import (_layer, _layers, _logits,
                                            _mask_logits, _stack,
                                            _stack_layers, masked_nll)

__all__ = ["init_params", "param_axes", "encode", "forward", "lm_loss",
           "init_cache", "prefill", "decode_step"]


def _enc_layer(tm: TreeMaker, cfg):
    d = cfg.d_model
    return {"ln1": tm.param((d,), (Axes.EMBED,), init="ones"),
            "attn": attn_mod.attn_params(tm, cfg),
            "ln2": tm.param((d,), (Axes.EMBED,), init="ones"),
            "mlp": mlp_params(tm, cfg)}


def _dec_layer(tm: TreeMaker, cfg):
    d = cfg.d_model
    return {"ln1": tm.param((d,), (Axes.EMBED,), init="ones"),
            "self_attn": attn_mod.attn_params(tm, cfg),
            "ln_x": tm.param((d,), (Axes.EMBED,), init="ones"),
            "cross_attn": attn_mod.attn_params(tm, cfg),
            "ln2": tm.param((d,), (Axes.EMBED,), init="ones"),
            "mlp": mlp_params(tm, cfg)}


def _model_tree(cfg, tm: TreeMaker, stack):
    d, v = cfg.d_model, cfg.padded_vocab
    return {
        "embed": tm.param((v, d), (Axes.VOCAB, Axes.EMBED), scale=0.02),
        "src_proj": tm.param((d, d), (Axes.EMBED, Axes.EMBED)),
        "enc": stack(lambda: _enc_layer(tm, cfg), cfg.enc_layers),
        "enc_norm": tm.param((d,), (Axes.EMBED,), init="ones"),
        "dec": stack(lambda: _dec_layer(tm, cfg), cfg.n_layers),
        "final_norm": tm.param((d,), (Axes.EMBED,), init="ones"),
        "lm_head": tm.param((d, v), (Axes.EMBED, Axes.VOCAB)),
    }


def init_params(cfg, gen: Optional[torch.Generator] = None,
                dtype_policy: Optional[DTypePolicy] = None,
                device: Any = "cuda", abstract: bool = False
                ) -> Dict[str, Any]:
    """Random parameters on ``device``: the JAX package's laws (other
    random bits), drawn from ``gen`` (a generator on ``device`` seeded 0
    when None).  ``abstract``: ``meta`` tensors of the parameters' shapes
    and types, nothing drawn or allocated."""
    dp = dtype_policy or DTypePolicy()
    if abstract:
        tm = TreeMaker(dtype_policy=dp, mode="abstract")
        return _model_tree(cfg, tm, lambda mk, n: stack_abstract(mk(), n))
    dev = resolve_device(device)
    if gen is None:
        gen = torch.Generator(device=dev).manual_seed(0)
    tm = TreeMaker(gen, dev, dp)
    return _model_tree(cfg, tm,
                       lambda mk, n: _stack_layers([mk() for _ in range(n)]))


def param_axes(cfg) -> Dict[str, Any]:
    """The parameters' logical axes (``init_params``'s structure, tuples
    of axis names at the leaves)."""
    tm = TreeMaker(mode="axes")
    return _model_tree(cfg, tm, lambda mk, n: stack_axes(mk()))


def encode(params, cfg, src_embeds: torch.Tensor) -> torch.Tensor:
    """src_embeds: (B, Ts, D) stub frame embeddings -> the encoder output
    (non-causal self-attention)."""
    x = constrain(src_embeds.to(params["src_proj"].dtype)
                  @ params["src_proj"], ("batch", None, None))
    inv_freq = rope_freqs(cfg.head_dim_, cfg.rope_theta, device=x.device)
    positions = torch.arange(x.shape[1], device=x.device)
    for lp in _layers(params["enc"]):
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        a, _ = attn_mod.attention(lp["attn"], cfg, h, positions=positions,
                                  inv_freq=inv_freq, causal=False)
        x = x + a
        h = rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + mlp(lp["mlp"], h)
    return rms_norm(x, params["enc_norm"], cfg.norm_eps)


def _dec_block(lp, cfg, x, *, positions, inv_freq, enc_out=None,
               self_cache=None, cross_kv=None, cache_pos=None,
               donate=False):
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    a, new_kv = attn_mod.attention(
        lp["self_attn"], cfg, h, positions=positions, inv_freq=inv_freq,
        cache=self_cache, cache_pos=cache_pos, donate=donate)
    x = x + a
    h = rms_norm(x, lp["ln_x"], cfg.norm_eps)
    ca = lp["cross_attn"]
    if cross_kv is not None:     # decode: the cached encoder K/V
        q = torch.einsum("btd,dhk->bthk", h, ca["wq"])
        if cfg.qk_norm:
            q = rms_norm(q, ca["q_norm"], cfg.norm_eps)
        a = attn_mod._mha(q, cross_kv["k"].to(q.dtype),
                          cross_kv["v"].to(q.dtype), None, cfg.head_dim_)
        a = torch.einsum("bthk,hkd->btd", a, ca["wo"])
    else:
        a, _ = attn_mod.attention(ca, cfg, h, positions=positions,
                                  inv_freq=None, kv_x=enc_out)
    x = x + a
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + mlp(lp["mlp"], h), new_kv


def _head_logits(params, cfg, x):
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _mask_logits(_logits(x, params["lm_head"]), cfg)


def forward(params, cfg, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Teacher-forced logits (B, S, padded vocab) fp32 of ``batch``'s
    "tokens" (B, S) over the encoded "src_embeds" (B, Ts, D)."""
    enc_out = encode(params, cfg, batch["src_embeds"])
    x = constrain(params["embed"][batch["tokens"]], ("batch", None, None))
    inv_freq = rope_freqs(cfg.head_dim_, cfg.rope_theta, device=x.device)
    positions = torch.arange(x.shape[1], device=x.device)
    for lp in _layers(params["dec"]):
        x, _ = _dec_block(lp, cfg, x, positions=positions,
                          inv_freq=inv_freq, enc_out=enc_out)
    return _head_logits(params, cfg, x)


def lm_loss(params, cfg, batch: Dict[str, torch.Tensor],
            aux_coef: float = 0.0) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Teacher-forced cross entropy (fp32) of ``batch``'s "tokens" against
    its "labels" (masked on labels >= 0) over the encoded "src_embeds".
    The enc-dec has no aux loss: ``aux_coef`` is taken and reads nothing.
    Returns (loss, {"loss", "aux_loss": 0})."""
    loss = masked_nll(forward(params, cfg, batch), batch["labels"])
    return loss, {"loss": loss,
                  "aux_loss": torch.zeros((), dtype=torch.float32,
                                          device=loss.device)}


def init_cache(cfg, batch: int, max_len: int, src_len: int,
               dtype: torch.dtype = torch.bfloat16,
               device: Any = "cuda", abstract: bool = False
               ) -> Dict[str, Any]:
    """Per decoder layer, stacked: the self-attention KV cache of
    ``max_len`` rows and the cross K/V of ``src_len`` rows; ``abstract``:
    ``meta`` tensors of those shapes."""
    dev = torch.device("meta") if abstract else resolve_device(device)
    shape = (batch, src_len, cfg.cache_kv_heads, cfg.head_dim_)
    return _stack([{
        "self": attn_mod.init_kv_cache(cfg, batch, max_len, dtype, dev),
        "cross": {"k": torch.zeros(shape, dtype=dtype, device=dev),
                  "v": torch.zeros(shape, dtype=dtype, device=dev)}}
        for _ in range(cfg.n_layers)])


def prefill(params, cfg, batch: Dict[str, torch.Tensor], cache
            ) -> Tuple[torch.Tensor, Any]:
    """Encode the source, cache each layer's cross K/V (sized by the
    source given, whatever ``init_cache``'s ``src_len``), and write the
    prompt into the self caches at slots [0, S).  Returns (last-token
    logits, the new cache)."""
    enc_out = encode(params, cfg, batch["src_embeds"])
    x = params["embed"][batch["tokens"]]
    inv_freq = rope_freqs(cfg.head_dim_, cfg.rope_theta, device=x.device)
    positions = torch.arange(x.shape[1], device=x.device)
    new = []
    for i in range(cfg.n_layers):
        lp, c = _layer(params["dec"], i), _layer(cache, i)
        k, v = attn_mod._project_kv(lp["cross_attn"], cfg, enc_out)
        x, new_kv = _dec_block(lp, cfg, x, positions=positions,
                               inv_freq=inv_freq, enc_out=enc_out,
                               self_cache=c["self"], cache_pos=0)
        new.append({"self": new_kv, "cross": {
            "k": attn_mod._to_cache_heads(cfg, k).to(c["cross"]["k"].dtype),
            "v": attn_mod._to_cache_heads(cfg, v).to(
                c["cross"]["v"].dtype)}})
    return _head_logits(params, cfg, x[:, -1]), _stack(new)


def decode_step(params, cfg, token: torch.Tensor, cache, pos,
                donate: bool = False) -> Tuple[torch.Tensor, Any]:
    """token: (B,) integer ids; pos: the self-cache write index (an int
    or a 0-d integer tensor).  Returns (logits (B, padded vocab) fp32, the
    new cache); with ``donate`` the self caches are written in place and
    ``cache`` comes back (``transformer.decode_step``)."""
    x = params["embed"][token[:, None]]
    pos = attn_mod.device_position(pos, x.device)
    inv_freq = rope_freqs(cfg.head_dim_, cfg.rope_theta, device=x.device)
    new = []
    for i in range(cfg.n_layers):
        c = _layer(cache, i)
        x, new_kv = _dec_block(_layer(params["dec"], i), cfg, x,
                               positions=pos.reshape(1), inv_freq=inv_freq,
                               self_cache=c["self"], cross_kv=c["cross"],
                               cache_pos=pos, donate=donate)
        new.append({"self": new_kv, "cross": c["cross"]})
    return (_head_logits(params, cfg, x)[:, 0],
            cache if donate else _stack(new))
