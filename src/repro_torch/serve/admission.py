"""Request lifecycle, admission control and dispatch watchdog for the
fault-tolerant serving runtime.

The schedule stays static; everything dynamic — overload, deadlines,
stragglers, faults — is absorbed by a thin host-side runtime.  This
module is that runtime's control half:

* ``RequestOutcome`` — the terminal states of the request state machine
  (``pending -> ok | rejected | expired | failed``).  Every submitted
  request reaches exactly one terminal outcome; nothing is silently lost.
* ``BadRequestError`` — typed rejection for malformed payloads, raised at
  ``submit`` time so a poison request never reaches a device batch
  through the front door.
* ``AdmissionController`` — SLO-aware load shedding: per-bucket service
  EWMAs (measured, not modeled) predict the queue delay a new request
  would see; a request whose deadline the prediction already blows is
  rejected at submit.
* ``DispatchWatchdog`` — hang/straggler detection for dispatches, built
  on ``ft/fault_tolerance.py`` (``HeartbeatMonitor``,
  ``StragglerDetector``).

Everything here is plain Python + numpy with injectable clocks — the
decision logic is unit-testable without a device.
"""
from __future__ import annotations

import dataclasses
import enum
import math
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.ft.fault_tolerance import HeartbeatMonitor, StragglerDetector

__all__ = ["RequestOutcome", "BadRequestError", "validate_images",
           "AdmissionController", "DispatchWatchdog", "WatchdogVerdict"]


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


class AdmissionController:
    """SLO-aware admission: shed work whose deadline the measured queue
    already blows.

    The controller learns an EWMA of *measured* per-bucket batch service
    time (``observe`` is fed by the engine at every batch completion) and
    predicts what a new request would wait:

        wait ~= (batches ahead of it) * service(max bucket)
                + service(its own bucket)

    where "batches ahead" is the pending image count packed at the widest
    bucket — the drain rate the FIFO actually achieves under load.  A
    request with deadline ``d`` seconds is rejected when
    ``slack * wait > d``.  With no measurements yet (cold start) or no
    deadline, everything is admitted: shedding is strictly evidence-based,
    never speculative.
    """

    def __init__(self, widths: Sequence[int], *, alpha: float = 0.25,
                 slack: float = 1.0, registry=None):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"EWMA alpha must be in (0, 1], got {alpha}")
        self.widths: Tuple[int, ...] = tuple(widths)
        self.alpha = alpha
        self.slack = slack
        self._ewma: Dict[int, float] = {}
        self.observations = 0
        # optional live metrics (obs/metrics.py MetricsRegistry): the
        # per-bucket EWMAs as gauges, admit/shed decisions as counters.
        # None (the default) costs one attribute check per call.
        self.registry = registry

    def observe(self, bucket: int, service_s: float) -> None:
        """Fold one measured batch service time into the bucket's EWMA."""
        service_s = max(float(service_s), 0.0)
        prev = self._ewma.get(bucket)
        self._ewma[bucket] = (service_s if prev is None
                              else prev + self.alpha * (service_s - prev))
        self.observations += 1
        if self.registry is not None:
            self.registry.gauge(
                "admission_service_ewma_seconds",
                "Measured per-bucket batch service EWMA",
                bucket=str(bucket)).set(self._ewma[bucket])

    def estimate_s(self, bucket: int) -> Optional[float]:
        """Best service-time estimate for ``bucket``: its own EWMA, else
        the nearest measured bucket's (wider preferred — conservative)."""
        if bucket in self._ewma:
            return self._ewma[bucket]
        if not self._ewma:
            return None
        wider = [w for w in self._ewma if w >= bucket]
        return self._ewma[min(wider)] if wider else self._ewma[max(self._ewma)]

    def predicted_wait_s(self, pending_images: int, n: int) -> float:
        """Predicted queue delay + service time for an ``n``-image request
        arriving behind ``pending_images`` queued images (0.0 when no
        measurements exist yet)."""
        if not self._ewma:
            return 0.0
        widest = max(self.widths)
        ahead = math.ceil(pending_images / widest)
        drain = self.estimate_s(widest) or 0.0
        own_bucket = min((w for w in self.widths if w >= n),
                         default=widest)
        own = self.estimate_s(own_bucket) or drain
        return ahead * drain + own

    def admit(self, n: int, pending_images: int,
              deadline_s: Optional[float]) -> Tuple[bool, float]:
        """(admit?, predicted wait) for a candidate request.  ``deadline_s``
        is relative seconds from now; ``None`` means no SLO — always
        admitted."""
        predicted = self.predicted_wait_s(pending_images, n)
        ok = (deadline_s is None
              or self.slack * predicted <= deadline_s)
        if self.registry is not None:
            self.registry.counter(
                "admission_decisions_total", "Admission outcomes",
                decision="admitted" if ok else "shed").inc()
        return ok, predicted


@dataclasses.dataclass(frozen=True)
class WatchdogVerdict:
    """What the watchdog concluded about one completed dispatch."""
    hung: bool
    straggler: bool


class DispatchWatchdog:
    """Hang + straggler detection over the serving dispatch stream, built
    on the seed fault-tolerance control plane.

    Two views of the same dispatches, because the double-buffered feeder
    keeps two in flight at once:

    * **liveness** — one ``HeartbeatMonitor`` rank stands for the dispatch
      loop, beaten at every completion.  While a dispatch is stuck in its
      blocking readback nothing beats, so ``healthy()`` goes false after
      ``hang_timeout_s`` — the signal an external supervisor (or the
      launcher's drain loop) polls to notice a wedged engine *while* it is
      wedged.
    * **post-hoc flagging** — each completed dispatch whose own duration
      exceeded ``hang_timeout_s`` is counted hung (the host cannot preempt
      a stuck kernel, but it can flag it, count it, and let the caller
      degrade), and the ``StragglerDetector`` tracks *per-image* service
      time per bucket lane (duration normalized by bucket width, so wide
      and narrow buckets are comparable), flagging lanes that drift above
      the cross-lane median.
    """

    def __init__(self, widths: Sequence[int], *,
                 hang_timeout_s: float = 30.0, window: int = 20,
                 threshold: float = 3.0,
                 clock: Callable[[], float] = time.monotonic):
        self.hang_timeout_s = float(hang_timeout_s)
        self._rank = {int(w): i for i, w in enumerate(sorted(set(widths)))}
        self.monitor = HeartbeatMonitor(1, timeout_s=self.hang_timeout_s,
                                        clock=clock)
        self.detector = StragglerDetector(len(self._rank), window=window,
                                          threshold=threshold)
        self._step = 0
        self.hung = 0
        self.straggler_events = 0

    def healthy(self) -> bool:
        """False while no dispatch has completed within the hang timeout —
        the live view of a wedged engine."""
        return self.monitor.healthy()

    def observe(self, bucket: int, duration_s: float) -> WatchdogVerdict:
        """A dispatch completed after ``duration_s``: classify it and beat
        the liveness monitor."""
        self.monitor.beat(0, self._step)
        self._step += 1
        hung = duration_s > self.hang_timeout_s
        rank = self._rank.get(int(bucket))
        straggler = False
        if rank is not None and bucket > 0:
            self.detector.record(rank, duration_s / bucket)
            straggler = rank in self.detector.stragglers()
        if hung:
            self.hung += 1
        if straggler:
            self.straggler_events += 1
        return WatchdogVerdict(hung=hung, straggler=straggler)
