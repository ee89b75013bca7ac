"""Family-dispatch facade over the LM models (the JAX package's
``models/api.py``): the serve steps and the tests go through these
functions.  The port has the decoder-only zamba2 hybrid
(``models/transformer.py``); the enc-dec family raises, naming its ROADMAP
item."""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.models import transformer
from repro_torch.models.common import DTypePolicy

__all__ = ["init_params", "init_cache", "prefill", "decode_step"]


def _mod(cfg):
    if cfg.is_encdec:
        raise NotImplementedError("the enc-dec family is not ported yet "
                                  "(ROADMAP queue A item 15c)")
    return transformer


def init_params(cfg, gen: Optional[torch.Generator] = None,
                dtype_policy: Optional[DTypePolicy] = None,
                device: Any = "cuda"):
    return _mod(cfg).init_params(cfg, gen, dtype_policy=dtype_policy,
                                 device=device)


def init_cache(cfg, batch: int, max_len: int, *,
               dtype: torch.dtype = torch.bfloat16, device: Any = "cuda"):
    return _mod(cfg).init_cache(cfg, batch, max_len, dtype=dtype,
                                device=device)


def prefill(params, cfg, batch: Dict[str, torch.Tensor], cache):
    if batch.get("patches") is not None:
        raise NotImplementedError("the VLM frontend is not ported yet "
                                  "(ROADMAP queue A item 15c)")
    return _mod(cfg).prefill(params, cfg, batch["tokens"], cache)


def decode_step(params, cfg, token, cache, pos, donate: bool = False):
    """``pos`` is an int or a 0-d integer tensor on the device; with
    ``donate`` the new cache is written into ``cache``
    (``transformer.decode_step``)."""
    return _mod(cfg).decode_step(params, cfg, token, cache, pos,
                                 donate=donate)
