"""What the loops (``loops/<name>.py``) share: a request as served, the
window they return, and the hook that stands in for the engine's
``batcher.form`` (the benchmark's place between batches): a loop's top-up,
the counters read when the window closes, and the profiler's start and
stop run there, on the thread that does the engine's work.  Every
request's due time is on ``time.monotonic``, the clock the engine stamps
``t_done`` with.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional

import numpy as np

from portbench.lib.profile import FORM_SPAN, Profiler

DRAIN_S = 60.0


@dataclasses.dataclass
class Served:
    idx: np.ndarray                 # pool indices of its images
    due: float                      # when it was due (monotonic)
    req: object = None              # the terminal ImageRequest, or None
    error: Optional[str] = None     # why there is none

    @property
    def n(self) -> int:
        return len(self.idx)

    @property
    def ok(self) -> bool:
        return self.req is not None and self.req.outcome.value == "ok"


@dataclasses.dataclass
class Window:
    t0: float
    t_end: float
    served: List[Served]
    counters: dict                  # the engine's counters at the close
    profiled: List[tuple]           # (bucket, images) of the traced batches
    drained_at: float
    lateness_s: Optional[np.ndarray] = None   # scheduled: submit - due

    @property
    def seconds(self) -> float:
        return self.t_end - self.t0


def take(pool: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """The request's images: a view where its run does not wrap."""
    if idx[-1] == idx[0] + len(idx) - 1:
        return pool[idx[0]:idx[-1] + 1]
    return pool[idx]


class FormHook:
    """Stands in for ``engine.batcher.form`` for the window."""

    def __init__(self, system, t_end: float,
                 topup: Optional[Callable[[], None]] = None,
                 profiler: Optional[Profiler] = None):
        self.system = system
        self.batcher = system.engine.batcher
        self._form = self.batcher.form
        self.t_end = t_end
        self.topup = topup
        self.profiler = profiler
        self.at_close: Optional[dict] = None
        self.profiled: List[tuple] = []

    def __enter__(self):
        self.batcher.form = self
        return self

    def __exit__(self, *exc):
        del self.batcher.form
        if self.profiler is not None:
            self.profiler.stop()

    def __call__(self):
        now = time.monotonic()
        if now < self.t_end:
            if self.topup is not None:
                self.topup()
        elif self.at_close is None:
            self.at_close = self.system.counters()
        prof = self.profiler
        if prof is None:
            return self._form()
        prof.tick(now, len(self.profiled))
        if not prof.active:
            return self._form()
        import torch
        with torch.profiler.record_function(FORM_SPAN):
            fb = self._form()
        if fb is not None:
            self.profiled.append((fb.bucket, fb.n_images))
        return fb
