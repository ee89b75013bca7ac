"""Family-dispatch facade over the LM models (the JAX package's
``models/api.py``): the train and serve steps and the tests go through
these functions.  The decoder-only families (dense attention, MoE, RWKV-6, the
zamba2 hybrid, the VLM) are ``models/transformer.py``, the enc-dec family
``models/encdec.py``."""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.models import encdec, transformer
from repro_torch.models.common import Axes, DTypePolicy

__all__ = ["init_params", "param_axes", "lm_loss", "init_cache", "prefill",
           "decode_step", "cache_axes"]


def _mod(cfg):
    return encdec if cfg.is_encdec else transformer


def init_params(cfg, gen: Optional[torch.Generator] = None,
                dtype_policy: Optional[DTypePolicy] = None,
                device: Any = "cuda", abstract: bool = False):
    """``abstract``: ``meta`` tensors of the parameters' shapes and
    types (nothing allocated: a full config's tree for planning)."""
    return _mod(cfg).init_params(cfg, gen, dtype_policy=dtype_policy,
                                 device=device, abstract=abstract)


def param_axes(cfg):
    """The parameters' logical axes, leaf for leaf with ``init_params``."""
    return _mod(cfg).param_axes(cfg)


def lm_loss(params, cfg, batch, aux_coef: float = 0.01):
    """(total loss, {"loss", "aux_loss"}) of a training batch: "tokens",
    "labels", and the frontend's "patches" (VLM) or "src_embeds"
    (enc-dec)."""
    return _mod(cfg).lm_loss(params, cfg, batch, aux_coef=aux_coef)


def init_cache(cfg, batch: int, max_len: int, *, src_len: int = 0,
               dtype: torch.dtype = torch.bfloat16, device: Any = "cuda",
               abstract: bool = False):
    """The decode cache; the enc-dec's cross K/V hold ``src_len`` rows
    (0: ``max_len``).  ``abstract``: ``meta`` tensors."""
    if cfg.is_encdec:
        return encdec.init_cache(cfg, batch, max_len, src_len or max_len,
                                 dtype=dtype, device=device,
                                 abstract=abstract)
    return transformer.init_cache(cfg, batch, max_len, dtype=dtype,
                                  device=device, abstract=abstract)


def prefill(params, cfg, batch: Dict[str, torch.Tensor], cache):
    """``batch``: the prompt under "tokens"; the enc-dec's source frames
    under "src_embeds", the VLM's patch embeddings under "patches"."""
    if cfg.is_encdec:
        return encdec.prefill(params, cfg, batch, cache)
    return transformer.prefill(params, cfg, batch["tokens"], cache,
                               extra_embeds=batch.get("patches"))


def decode_step(params, cfg, token, cache, pos, donate: bool = False):
    """``pos`` is an int or a 0-d integer tensor on the device; with
    ``donate`` the new cache is written into ``cache``
    (``transformer.decode_step``)."""
    return _mod(cfg).decode_step(params, cfg, token, cache, pos,
                                 donate=donate)


def cache_axes(cfg):
    """Logical axes of the decode cache, leaf for leaf with
    ``init_cache``."""
    def kv():
        return {"k": (Axes.LAYERS, Axes.BATCH, "seq_kv", "cache_kv",
                      Axes.HEAD_DIM),
                "v": (Axes.LAYERS, Axes.BATCH, "seq_kv", "cache_kv",
                      Axes.HEAD_DIM)}
    if cfg.is_encdec:
        return {"self": kv(),
                "cross": {"k": (Axes.LAYERS, Axes.BATCH, None, "cache_kv",
                                Axes.HEAD_DIM),
                          "v": (Axes.LAYERS, Axes.BATCH, None, "cache_kv",
                                Axes.HEAD_DIM)}}
    if cfg.block == "rwkv6":
        return {"s": (Axes.LAYERS, Axes.BATCH, Axes.HEADS, None, None),
                "x_tm": (Axes.LAYERS, Axes.BATCH, Axes.EMBED),
                "x_cm": (Axes.LAYERS, Axes.BATCH, Axes.EMBED)}
    if cfg.block == "mamba2":
        return {"mamba": {"conv": (Axes.LAYERS, Axes.BATCH, None,
                                   Axes.SSM_INNER),
                          "h": (Axes.LAYERS, Axes.BATCH, None, None, None)},
                "attn": kv()}
    if transformer.uses_window_cache(cfg):
        ring = {"k": (None, Axes.LAYERS, Axes.BATCH, None, "cache_kv",
                      Axes.HEAD_DIM),
                "v": (None, Axes.LAYERS, Axes.BATCH, None, "cache_kv",
                      Axes.HEAD_DIM)}
        return {"local": ring, "global": kv()}
    return kv()
