"""Model settings read while a step runs (the JAX package's
``models/settings.py``): the attention implementation (``naive``
materializes the score tensor, ``blockwise`` is the flash-style online
softmax), set by the serve and train steps, and the activation-checkpoint
(remat) policy, set by the train step:

  * ``none``: every activation the backward reads is kept;
  * ``full``: each layer body keeps only its inputs and is recomputed in
    the backward (``torch.utils.checkpoint``, non-reentrant);
  * ``dots``: the outputs of the non-batched matrix products
    (``aten.mm`` / ``aten.addmm``, the counterpart of JAX's
    ``dots_with_no_batch_dims_saveable``) are kept and the rest of the
    body is recomputed (a selective checkpoint).

Remat changes no value: the recompute runs the same ops on the same
inputs.
"""
from __future__ import annotations

import contextlib
import functools

import torch

__all__ = ["set_attn_impl", "get_attn_impl", "attn_impl", "set_remat",
           "get_remat", "remat", "maybe_remat", "ATTN_IMPLS", "REMAT_MODES"]

ATTN_IMPLS = ("naive", "blockwise")
REMAT_MODES = ("none", "full", "dots")
_ATTN = "naive"
_REMAT = "none"


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


def set_remat(mode: str) -> None:
    global _REMAT
    if mode not in REMAT_MODES:
        raise ValueError(f"unknown remat mode {mode!r} (want one of "
                         f"{REMAT_MODES})")
    _REMAT = mode


def get_remat() -> str:
    return _REMAT


@contextlib.contextmanager
def remat(mode: str):
    old = _REMAT
    set_remat(mode)
    try:
        yield
    finally:
        set_remat(old)


_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _dots_context():
    from torch.utils.checkpoint import create_selective_checkpoint_contexts
    return create_selective_checkpoint_contexts(_dots_policy)


def maybe_remat(fn):
    """``fn`` (a layer body) under the active checkpoint policy, read when
    this is called; ``fn`` itself under ``none``.  The forward holds no
    random op, so the RNG state is not stashed."""
    if _REMAT == "none":
        return fn
    from torch.utils.checkpoint import checkpoint
    kw = {"use_reentrant": False, "preserve_rng_state": False}
    if _REMAT == "dots":
        kw["context_fn"] = _dots_context
    return functools.partial(checkpoint, fn, **kw)
