"""Host-side continuous batching for image serving.

The paper's KIPS figure is a *serving* metric: images arrive as a stream
and the accelerator keeps its image-fold pipeline full.  This module is
the host half of that discipline — a FIFO request queue packed into
**bucketed** device batches:

* An ``ImageRequest`` carries 1..k images (a client mini-batch) plus its
  lifecycle state: an optional absolute deadline and a
  ``RequestOutcome`` that moves exactly once from ``pending`` to one of
  ``ok / rejected / expired / failed`` (``serve/admission.py``).  The
  image is the fold unit, so a request occupies as many batch *slots* as
  it has images.
* ``BucketPolicy`` fixes the small set of batch widths the device ever
  sees.  One compiled forward exists per width (``core/engine.py:
  BucketCompiler``), so padding requests up to the nearest bucket trades
  a few wasted slots for a stable compiled program — the standard
  continuous-batching bargain.  Widths are validated strictly: positive,
  duplicate-free, ascending — a silently "fixed" policy would change
  which compiled forwards exist behind the caller's back.
* ``ImageBatcher.form`` first drops requests whose deadline has already
  passed (they move to ``expired`` and land on the ``expired`` list for
  the engine to account — spending device time on a response nobody is
  waiting for is the definition of overload collapse), then packs the
  queue greedily *in arrival order* — drain order is strictly FIFO — and
  zero-pads the batch up to the chosen bucket.  Padding rows are dead
  slots, sliced away after the forward; correctness needs no masking
  inside the network because every batch row's computation is independent.
* ``submit`` validates shape/dtype/finiteness up front and raises a typed
  ``BadRequestError`` for anything malformed — a poison payload is
  refused at the door, never discovered mid-batch.

Everything here is numpy + plain Python with an injectable clock and an
optional tracer (``obs/trace.py``: an ``expire`` instant per request
dropped at form time): the device side (staging, compiled forwards,
metrics, recovery) lives in ``serve/vision.py``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.obs.trace import NULL_TRACER, TID_ENGINE
from repro_torch.serve.admission import (BadRequestError, RequestOutcome,
                                         validate_images)

__all__ = ["ImageRequest", "BucketPolicy", "FormedBatch", "ImageBatcher",
           "BadRequestError", "RequestOutcome"]


@dataclasses.dataclass
class ImageRequest:
    """One client request: ``images`` is (n, C, H, W); ``logits`` is filled
    with the (n, classes) result when the outcome is ``ok``.

    ``t_deadline`` is an absolute clock value (``t_submit + deadline``) or
    ``None`` for no SLO.  ``outcome`` is the lifecycle state machine —
    ``finish`` performs the single pending->terminal transition and is the
    only way state changes.  ``served_by`` records which ladder rung
    produced the logits (``primary`` or ``reference``)."""
    rid: int
    images: np.ndarray
    t_submit: float = 0.0
    t_done: float = 0.0
    t_deadline: Optional[float] = None
    logits: Optional[np.ndarray] = None
    done: bool = False
    outcome: RequestOutcome = RequestOutcome.PENDING
    served_by: Optional[str] = None
    error: Optional[str] = None
    # the admission controller's predicted queue wait at submit time
    predicted_wait_s: Optional[float] = None

    @property
    def n(self) -> int:
        return int(self.images.shape[0])

    @property
    def latency_s(self) -> float:
        if not self.done:
            raise ValueError(f"request {self.rid} is not done")
        return self.t_done - self.t_submit

    def finish(self, outcome: RequestOutcome, *, t: Optional[float] = None,
               error: Optional[str] = None) -> None:
        """The one pending -> terminal transition.  Double transitions are
        state-machine bugs and raise."""
        if not outcome.terminal:
            raise ValueError(f"cannot finish request {self.rid} into "
                             f"non-terminal {outcome}")
        if self.outcome.terminal:
            raise ValueError(
                f"request {self.rid} is already {self.outcome.value}; "
                f"refusing second transition to {outcome.value}")
        self.outcome = outcome
        self.error = error
        self.t_done = time.monotonic() if t is None else t
        self.done = outcome is RequestOutcome.OK

    @property
    def deadline_met(self) -> Optional[bool]:
        """True/False once terminal (None while pending or without a
        deadline): did this request complete OK before its deadline?"""
        if self.t_deadline is None or not self.outcome.terminal:
            return None
        return self.done and self.t_done <= self.t_deadline


class BucketPolicy:
    """The fixed, ascending set of batch widths served to the device.

    ``bucket_for(n)`` is a pure function of ``n`` (the smallest width that
    fits) — bucket selection is deterministic by construction, which is
    what keeps the compiled-forward set closed.  Construction is strict:
    non-positive, duplicate, or out-of-order widths are configuration
    errors and raise — a policy that silently re-sorted or deduped would
    serve different compiled forwards than the ones the caller listed."""

    def __init__(self, widths: Sequence[int] = (1, 2, 4, 8)):
        ws = tuple(int(w) for w in widths)
        if not ws:
            raise ValueError("bucket policy needs at least one width")
        bad = [w for w in ws if w < 1]
        if bad:
            raise ValueError(f"bucket widths must be >= 1, got {bad} "
                             f"in {widths}")
        dups = sorted({w for w in ws if ws.count(w) > 1})
        if dups:
            raise ValueError(f"duplicate bucket widths {dups} in {widths}")
        if list(ws) != sorted(ws):
            raise ValueError(f"bucket widths must be ascending, "
                             f"got {widths}")
        self.widths: Tuple[int, ...] = ws

    @property
    def max_width(self) -> int:
        return self.widths[-1]

    def bucket_for(self, n: int) -> int:
        if n < 1:
            raise ValueError(f"need at least one image, got {n}")
        for w in self.widths:
            if w >= n:
                return w
        raise ValueError(f"{n} images exceed the largest bucket "
                         f"({self.max_width})")

    def aligned(self, multiple: int) -> "BucketPolicy":
        """Every width rounded up to ``multiple`` (for a batch that must
        divide across devices).  Rounding
        can collide widths; the result is deduped and re-sorted here (an
        explicitly derived policy, unlike user-supplied widths)."""
        m = max(1, int(multiple))
        return BucketPolicy(sorted({-(-w // m) * m for w in self.widths}))

    def __repr__(self) -> str:
        return f"BucketPolicy{self.widths}"


@dataclasses.dataclass(frozen=True)
class FormedBatch:
    """One device batch: ``x`` is (bucket, C, H, W), rows ``[n_images:]``
    are zero padding."""
    requests: Tuple[ImageRequest, ...]
    x: np.ndarray
    bucket: int
    n_images: int

    @property
    def occupancy(self) -> float:
        """Real rows / bucket width — the slot-occupancy serving metric."""
        return self.n_images / self.bucket


class ImageBatcher:
    """FIFO request queue → ``FormedBatch``.

    Packing is greedy in arrival order: requests join the batch while
    their images still fit in ``policy.max_width`` (the head request
    always fits, since ``submit`` rejects anything larger), then the
    batch pads up to ``bucket_for(total)``.  No request is ever skipped
    or reordered, so completion order equals submission order — except
    that expired requests leave the queue at form time (onto ``expired``,
    which the engine drains for accounting) instead of wasting a slot.
    """

    def __init__(self, policy: BucketPolicy, img: int, chan: int = 3,
                 dtype=np.float32,
                 clock: Callable[[], float] = time.monotonic,
                 tracer=None):
        self.policy = policy
        self.img = int(img)
        self.chan = int(chan)
        self.dtype = dtype
        self.queue: List[ImageRequest] = []
        self.expired: List[ImageRequest] = []   # drained by the engine
        self._clock = clock
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self._next_rid = 0

    def __len__(self) -> int:
        return len(self.queue)

    @property
    def pending_images(self) -> int:
        return sum(r.n for r in self.queue)

    def make_request(self, images: np.ndarray,
                     deadline_s: Optional[float] = None) -> ImageRequest:
        """Validate and build a request *without* queueing it (the engine
        uses this for the admission-reject path, which must still hand the
        caller a terminal request object).  Raises ``BadRequestError`` on a
        malformed payload."""
        images = validate_images(images, chan=self.chan, img=self.img,
                                 max_images=self.policy.max_width,
                                 dtype=self.dtype)
        now = self._clock()
        req = ImageRequest(
            rid=self._next_rid, images=images, t_submit=now,
            t_deadline=None if deadline_s is None else now + deadline_s)
        self._next_rid += 1
        return req

    def submit(self, images: np.ndarray,
               deadline_s: Optional[float] = None) -> ImageRequest:
        req = self.make_request(images, deadline_s)
        self.queue.append(req)
        return req

    def form(self) -> Optional[FormedBatch]:
        # deadline enforcement at form time: a request whose deadline has
        # already passed gets no device time — it moves to `expired` for
        # the engine to account, wherever it sits in the queue
        now = self._clock()
        live: List[ImageRequest] = []
        for req in self.queue:
            if req.t_deadline is not None and now > req.t_deadline:
                req.finish(RequestOutcome.EXPIRED, t=now,
                           error="deadline passed before batch formation")
                self.tracer.instant("expire", cat="error", tid=TID_ENGINE,
                                    request_id=req.rid,
                                    overshoot_s=now - req.t_deadline)
                self.expired.append(req)
            else:
                live.append(req)
        self.queue = live
        if not self.queue:
            return None
        take: List[ImageRequest] = []
        total = 0
        while self.queue and total + self.queue[0].n <= self.policy.max_width:
            req = self.queue.pop(0)
            take.append(req)
            total += req.n
        bucket = self.policy.bucket_for(total)
        x = np.zeros((bucket, self.chan, self.img, self.img), self.dtype)
        x[:total] = np.concatenate([r.images for r in take])
        return FormedBatch(requests=tuple(take), x=x, bucket=bucket,
                           n_images=total)

    @staticmethod
    def scatter(batch: FormedBatch, logits: np.ndarray,
                t_done: Optional[float] = None,
                served_by: str = "primary") -> None:
        """Slice bucket-width logits back to per-request outputs (padding
        rows are simply never read) and move each request to ``ok``."""
        t_done = time.monotonic() if t_done is None else t_done
        off = 0
        for req in batch.requests:
            req.logits = logits[off:off + req.n]
            off += req.n
            req.served_by = served_by
            req.finish(RequestOutcome.OK, t=t_done)
