"""Model settings read while a step runs: the attention implementation
(``naive`` materializes the score tensor, ``blockwise`` is the flash-style
online softmax), set by the serve steps (``serve/steps.py``).  The
activation-checkpoint policy of the JAX package is training-only and
comes with the training slice."""
from __future__ import annotations

import contextlib

__all__ = ["set_attn_impl", "get_attn_impl", "attn_impl"]

ATTN_IMPLS = ("naive", "blockwise")
_ATTN = "naive"


def set_attn_impl(mode: str) -> None:
    global _ATTN
    if mode not in ATTN_IMPLS:
        raise ValueError(f"unknown attention impl {mode!r} (want one of "
                         f"{ATTN_IMPLS})")
    _ATTN = mode


def get_attn_impl() -> str:
    return _ATTN


@contextlib.contextmanager
def attn_impl(mode: str):
    old = _ATTN
    set_attn_impl(mode)
    try:
        yield
    finally:
        set_attn_impl(old)
