"""Fixed-memory metrics for the serving engine: ``LogHistogram``, the
HDR-style log-bucketed histogram behind ``ServingMetrics``' latency and
occupancy percentiles.  Recording is O(1) and allocation-free; memory
never changes after construction; a quantile estimate lands inside the
bucket holding the true quantile (relative error at most ``rel_error``).
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np

__all__ = ["LogHistogram"]


class LogHistogram:
    """Fixed-memory log-bucketed histogram (HDR-style).

    Bucket ``i`` covers ``[lo * g**i, lo * g**(i+1))`` with
    ``g = 10 ** (1 / buckets_per_decade)``; two extra buckets catch
    underflow (values below ``lo``, including zero/negative) and
    overflow (values at or above ``hi``).  ``quantile`` walks the
    cumulative counts to the target rank and returns the geometric
    midpoint of the bucket it lands in, clamped to the exact observed
    ``[min, max]`` — the estimate is always inside the true quantile's
    bucket, so its relative error is at most ``rel_error``.
    """

    __slots__ = ("lo", "hi", "bpd", "_g", "_n", "counts", "count",
                 "total", "min", "max")

    def __init__(self, lo: float = 1e-6, hi: float = 1e4,
                 buckets_per_decade: int = 48) -> None:
        if not (0 < lo < hi):
            raise ValueError(f"need 0 < lo < hi, got lo={lo} hi={hi}")
        if buckets_per_decade < 1:
            raise ValueError("buckets_per_decade must be >= 1")
        self.lo = float(lo)
        self.hi = float(hi)
        self.bpd = int(buckets_per_decade)
        self._g = 10.0 ** (1.0 / self.bpd)
        self._n = int(math.ceil(
            (math.log10(self.hi) - math.log10(self.lo)) * self.bpd))
        # [0] underflow, [1.._n] log buckets, [_n+1] overflow
        self.counts = np.zeros(self._n + 2, dtype=np.int64)
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf

    @property
    def rel_error(self) -> float:
        """Worst-case relative quantile error: one bucket width."""
        return self._g - 1.0

    @property
    def nbytes(self) -> int:
        """Memory of the bucket array — constant for the lifetime."""
        return int(self.counts.nbytes)

    def _bucket(self, v: float) -> int:
        if v < self.lo:
            return 0
        if v >= self.hi:
            return self._n + 1
        i = int(math.log10(v / self.lo) * self.bpd)
        return min(max(i, 0), self._n - 1) + 1

    def record(self, v: float) -> None:
        v = float(v)
        if math.isnan(v):
            return                       # NaN is not a latency
        self.counts[self._bucket(v)] += 1
        self.count += 1
        self.total += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    def record_many(self, values) -> None:
        for v in np.asarray(values, dtype=np.float64).ravel():
            self.record(float(v))

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def bucket_edges(self, i: int) -> Tuple[float, float]:
        """(lower, upper) value bounds of bucket index ``i``."""
        if i == 0:
            return (0.0, self.lo)
        if i == self._n + 1:
            return (self.hi, math.inf)
        return (self.lo * self._g ** (i - 1), self.lo * self._g ** i)

    def quantile(self, q: float) -> float:
        """The ``q`` in [0, 1] quantile estimate (0.0 when empty)."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        if not self.count:
            return 0.0
        # nearest-rank; the endpoints are the exact tracked extremes
        rank = max(1, int(math.ceil(q * self.count)))
        if rank <= 1:
            return float(self.min)
        if rank >= self.count:
            return float(self.max)
        cum = 0
        idx = self._n + 1
        for i, c in enumerate(self.counts):
            cum += int(c)
            if cum >= rank:
                idx = i
                break
        lo_e, hi_e = self.bucket_edges(idx)
        if idx == 0:
            est = self.min
        elif idx == self._n + 1:
            est = self.max
        else:
            est = math.sqrt(lo_e * hi_e)       # geometric midpoint
        return float(min(max(est, self.min), self.max))

    def percentile(self, p: float) -> float:
        return self.quantile(p / 100.0)

    def snapshot(self) -> dict:
        occupied = {str(i): int(c) for i, c in enumerate(self.counts) if c}
        return {
            "count": self.count,
            "sum": self.total,
            "min": self.min if self.count else 0.0,
            "max": self.max if self.count else 0.0,
            "mean": self.mean,
            "p50": self.quantile(0.50),
            "p95": self.quantile(0.95),
            "p99": self.quantile(0.99),
            "buckets": occupied,
            "rel_error": self.rel_error,
        }
