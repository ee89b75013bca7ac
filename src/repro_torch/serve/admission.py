"""Request lifecycle for the serving runtime: the terminal outcomes of a
request and the poison filter applied at submit.

* ``RequestOutcome`` — the terminal states of the request state machine
  (``pending -> ok | rejected | expired | failed``).  This slice reaches
  ``ok`` and ``expired``; admission control, quarantine and the
  degradation ladder come later (ROADMAP queue A item 9).
* ``BadRequestError`` — typed rejection for malformed payloads, raised at
  ``submit`` time so a poison request never reaches a device batch.
"""
from __future__ import annotations

import enum

import numpy as np

__all__ = ["RequestOutcome", "BadRequestError", "validate_images"]


class RequestOutcome(enum.Enum):
    """Terminal states of the request lifecycle state machine.

    ``PENDING`` is the only non-terminal state; a request leaves it exactly
    once (``ImageRequest.finish`` enforces the single transition):

        pending --admission reject--> rejected      (never queued)
        pending --deadline at form--> expired       (dropped, never batched)
        pending --served----------->  ok            (logits attached)
        pending --quarantined------>  failed        (fault isolated to it)
    """
    PENDING = "pending"
    OK = "ok"
    REJECTED = "rejected"
    EXPIRED = "expired"
    FAILED = "failed"

    @property
    def terminal(self) -> bool:
        return self is not RequestOutcome.PENDING


class BadRequestError(ValueError):
    """A malformed request payload, refused at ``submit`` time.

    Subclasses ``ValueError`` so pre-existing callers catching the old
    untyped rejections keep working; new callers should catch this type.
    """


def validate_images(images, *, chan: int, img: int, max_images: int,
                    dtype=np.float32) -> np.ndarray:
    """Canonicalize and validate a request payload.

    Returns the (n, chan, img, img) float array a well-formed request
    carries; raises ``BadRequestError`` for anything else — wrong rank,
    wrong spatial/channel shape, an un-castable dtype, zero images, more
    images than the largest bucket, or any non-finite value.  This is the
    poison filter: a NaN/Inf image admitted here would propagate NaN
    through its batch row and read as a device fault downstream, so it is
    refused at the door instead.
    """
    try:
        arr = np.asarray(images, dtype)
    except (TypeError, ValueError) as e:
        raise BadRequestError(
            f"request images are not castable to {np.dtype(dtype).name}: "
            f"{type(e).__name__}: {e}") from e
    if arr.ndim == 3:
        arr = arr[None]
    want = (chan, img, img)
    if arr.ndim != 4 or arr.shape[1:] != want:
        raise BadRequestError(
            f"request images must be (n, {chan}, {img}, {img}), "
            f"got {arr.shape}")
    if arr.shape[0] < 1:
        raise BadRequestError("request carries zero images")
    if arr.shape[0] > max_images:
        raise BadRequestError(
            f"request of {arr.shape[0]} images exceeds the largest "
            f"bucket ({max_images}); split it client-side")
    if not np.isfinite(arr).all():
        bad = int((~np.isfinite(arr)).sum())
        raise BadRequestError(
            f"request images contain {bad} non-finite value(s) "
            "(NaN/Inf rejected at submit)")
    return arr
