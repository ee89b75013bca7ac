"""Serving steps: prefill and single-token decode, greedy or temperature
sampling folded into the step (the JAX package's ``serve/steps.py``;
sampling draws from a ``torch.Generator`` where it takes a key)."""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.models import api
from repro_torch.models.settings import attn_impl as attn_ctx

__all__ = ["make_prefill_step", "make_decode_step"]


def make_prefill_step(cfg, attn_impl: str = "naive") -> Callable:
    """step(params, batch, cache) -> (next token, last logits, new cache);
    ``batch`` holds the (B, S) prompt under "tokens"."""
    def step(params, batch, cache):
        with attn_ctx(attn_impl):
            logits, cache = api.prefill(params, cfg, batch, cache)
        return logits.argmax(dim=-1), logits, cache
    return step


def make_decode_step(cfg, temperature: float = 0.0,
                     donate: bool = False) -> Callable:
    """step(params, token, cache, pos, gen=None) -> (next token, logits,
    new cache): argmax, or with ``temperature > 0`` and a generator one
    draw per row from softmax(logits / temperature).  ``pos`` is an int or
    a 0-d integer tensor on the device.  With ``donate`` (the JAX
    package's ``donate_argnums=(2,)``) the step writes the new cache into
    the one passed in and returns it: the step ``BatchEngine`` captures."""
    def step(params, token, cache, pos,
             gen: Optional[torch.Generator] = None):
        logits, cache = api.decode_step(params, cfg, token, cache, pos,
                                        donate=donate)
        if temperature > 0.0 and gen is not None:
            probs = torch.softmax(logits / temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=gen)[:, 0]
        else:
            nxt = logits.argmax(dim=-1)
        return nxt, logits, cache
    return step
