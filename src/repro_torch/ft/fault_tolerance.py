"""Fault tolerance for 1000+ node runs: heartbeats, straggler detection,
preemption-safe checkpointing, and elastic re-meshing.  Pure Python, no
torch: the serving watchdog (``serve/admission.py``) builds on the first
two, ``serving_summary(guard=)`` on ``PreemptionGuard``.

The control plane here is deliberately transport-agnostic (callables +
in-memory state) so it is unit-testable on one process, while the decision
logic — what actually matters at scale — is real:

  * HeartbeatMonitor: workers report (rank, step, t); a worker silent for
    ``timeout_s`` is declared dead -> triggers restart-from-checkpoint with
    a shrunk device set.
  * StragglerDetector: per-step durations; ranks slower than
    ``threshold x median`` over a window are flagged (operator hook: swap
    the node, or drop it at the next elastic boundary).
  * ElasticPlan: given the surviving device count, re-solve the mesh
    (keep `model` fixed — TP degree is baked into shardings — shrink
    `data`/`pod`), and rescale batch or grad-accum so global batch is
    preserved exactly.
  * PreemptionGuard: SIGTERM -> synchronous checkpoint -> clean exit.
"""
from __future__ import annotations

import dataclasses
import signal
import time
from typing import Callable, Dict, List, Optional, Tuple

__all__ = ["HeartbeatMonitor", "StragglerDetector", "ElasticPlan",
           "solve_elastic_mesh", "PreemptionGuard"]


class HeartbeatMonitor:
    def __init__(self, n_ranks: int, timeout_s: float = 60.0,
                 clock: Callable[[], float] = time.monotonic):
        self.timeout_s = timeout_s
        self._clock = clock
        self._last: Dict[int, float] = {r: clock() for r in range(n_ranks)}
        self._steps: Dict[int, int] = {r: -1 for r in range(n_ranks)}

    def beat(self, rank: int, step: int) -> None:
        self._last[rank] = self._clock()
        self._steps[rank] = step

    def dead_ranks(self) -> List[int]:
        now = self._clock()
        return [r for r, t in self._last.items()
                if now - t > self.timeout_s]

    def healthy(self) -> bool:
        return not self.dead_ranks()


class StragglerDetector:
    """Flag ranks whose step time exceeds threshold x median over a window."""

    def __init__(self, n_ranks: int, window: int = 20,
                 threshold: float = 1.5):
        self.window = window
        self.threshold = threshold
        self._times: Dict[int, List[float]] = {r: [] for r in range(n_ranks)}

    def record(self, rank: int, step_time_s: float) -> None:
        buf = self._times[rank]
        buf.append(step_time_s)
        if len(buf) > self.window:
            buf.pop(0)

    def stragglers(self) -> List[int]:
        means = {r: sum(b) / len(b) for r, b in self._times.items() if b}
        if len(means) < 2:
            return []
        vals = sorted(means.values())
        median = vals[len(vals) // 2]
        return [r for r, m in means.items() if m > self.threshold * median]


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    mesh_shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    per_device_batch: int
    grad_accum: int
    dropped_devices: int

    @property
    def devices_used(self) -> int:
        n = 1
        for s in self.mesh_shape:
            n *= s
        return n


def solve_elastic_mesh(available_devices: int, model_parallel: int,
                       global_batch: int,
                       max_per_device_batch: int = 64) -> ElasticPlan:
    """Re-plan after failures: keep TP degree (shardings stay valid), use
    the largest DP degree that divides the global batch, absorb the
    remainder with gradient accumulation.

    Invariant (tested): dp * per_device_batch * grad_accum == global_batch.
    """
    if available_devices < model_parallel:
        raise ValueError(
            f"cannot keep model_parallel={model_parallel} with only "
            f"{available_devices} devices")
    dp_max = available_devices // model_parallel
    # largest dp <= dp_max that divides global_batch
    dp = next(d for d in range(dp_max, 0, -1) if global_batch % d == 0)
    per_dev = global_batch // dp
    accum = 1
    while per_dev > max_per_device_batch:
        # fold microbatches into grad accumulation
        for f in range(2, per_dev + 1):
            if per_dev % f == 0:
                accum *= f
                per_dev //= f
                break
    used = dp * model_parallel
    return ElasticPlan(mesh_shape=(dp, model_parallel),
                       axis_names=("data", "model"),
                       per_device_batch=per_dev,
                       grad_accum=accum,
                       dropped_devices=available_devices - used)


class PreemptionGuard:
    """SIGTERM/SIGINT -> request a clean stop at the next step boundary.

    Training drains to a checkpoint; serving (``launch/serve.py --vision``)
    stops admitting, flushes in-flight batches, and still emits metrics.
    Usable as a context manager: ``with PreemptionGuard() as guard: ...``
    installs on entry and always restores the original handlers on exit.
    """

    def __init__(self):
        self.requested = False
        self._orig: Dict[int, object] = {}

    def install(self) -> "PreemptionGuard":
        for sig in (signal.SIGTERM, signal.SIGINT):
            self._orig[sig] = signal.signal(sig, self._handler)
        return self

    def _handler(self, signum, frame):
        self.requested = True

    def uninstall(self) -> None:
        for sig, h in self._orig.items():
            signal.signal(sig, h)
        self._orig.clear()

    def __enter__(self) -> "PreemptionGuard":
        return self.install()

    def __exit__(self, exc_type, exc, tb) -> None:
        self.uninstall()
