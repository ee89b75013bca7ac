"""Bounded metrics registry: counters, gauges, and
log-bucketed latency histograms with Prometheus text exposition and a
JSON snapshot.

Design constraints, in order:

* **Fixed memory.**  A serving process lives for days; a metric whose
  footprint grows with traffic is a slow OOM.  ``LogHistogram`` is the
  HDR-histogram discipline: geometric bucket boundaries over a fixed
  range, one int64 count per bucket, exact ``count/sum/min/max`` on the
  side.  Recording is O(1) and allocation-free; memory never changes
  after construction.  Quantile estimates land inside the bucket that
  contains the true quantile, so the relative error is bounded by one
  bucket width (``rel_error`` — ~4.9% at the default 48 buckets per
  decade).
* **Bounded cardinality.**  Labeled series are capped per family
  (``max_series``); blowing the cap is a configuration error and raises
  rather than silently growing an unbounded label set.
* **Two exports, one source.**  ``to_prometheus()`` emits the text
  exposition format (histograms as cumulative ``_bucket{le=...}`` series
  over the *occupied* buckets plus ``+Inf``); ``snapshot()`` emits a
  plain-JSON dict that ``launch/serve.py --metrics-json`` writes.  ``validate_metrics_snapshot`` is the
  schema check CI's observability smoke runs against the artifact.

Everything here is numpy + plain Python — no torch, no device.
"""
from __future__ import annotations

import math
import re
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["Counter", "Gauge", "LogHistogram", "MetricsRegistry",
           "validate_metrics_snapshot"]

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


class Counter:
    """Monotonic event count.  ``set_total`` exists for snapshot-time
    synchronization from an external tally (e.g. ``ServingMetrics``)
    and still refuses to go backwards."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0

    def inc(self, n: int = 1) -> None:
        if n < 0:
            raise ValueError(f"counter increments must be >= 0, got {n}")
        self.value += n

    def set_total(self, total: int) -> None:
        if total < self.value:
            raise ValueError(f"counter cannot decrease ({self.value} -> "
                             f"{total}); use a gauge for that")
        self.value = int(total)


class Gauge:
    """A value that can go both ways (occupancy, EWMA, queue depth)."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def dec(self, n: float = 1.0) -> None:
        self.value -= n


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


_Labels = Tuple[Tuple[str, str], ...]


class _Family:
    """One named metric family: a type, a help string, and its labeled
    series (the empty label set is a series like any other)."""

    __slots__ = ("name", "kind", "help", "series")

    def __init__(self, name: str, kind: str, help: str) -> None:
        self.name = name
        self.kind = kind
        self.help = help
        self.series: Dict[_Labels, object] = {}


def _label_key(labels: Dict[str, str]) -> _Labels:
    for k in labels:
        if not _LABEL_RE.match(k):
            raise ValueError(f"invalid label name {k!r}")
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _series_name(name: str, key: _Labels) -> str:
    if not key:
        return name
    inner = ",".join(f'{k}="{v}"' for k, v in key)
    return f"{name}{{{inner}}}"


class MetricsRegistry:
    """Name -> metric family registry with bounded label cardinality.

    ``counter`` / ``gauge`` / ``histogram`` are get-or-create: the first
    call fixes the family's type (and, for histograms, its range), later
    calls return the existing series.  Re-registering a name as a
    different type raises — one name, one meaning.
    """

    def __init__(self, max_series: int = 256) -> None:
        self.max_series = int(max_series)
        self._families: Dict[str, _Family] = {}

    def __len__(self) -> int:
        return sum(len(f.series) for f in self._families.values())

    def _family(self, name: str, kind: str, help: str) -> _Family:
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        fam = self._families.get(name)
        if fam is None:
            fam = _Family(name, kind, help)
            self._families[name] = fam
        elif fam.kind != kind:
            raise ValueError(f"metric {name!r} is a {fam.kind}, "
                             f"not a {kind}")
        return fam

    def _series(self, fam: _Family, labels: Dict[str, str], factory):
        key = _label_key(labels)
        s = fam.series.get(key)
        if s is None:
            if len(fam.series) >= self.max_series:
                raise ValueError(
                    f"metric {fam.name!r} exceeded {self.max_series} "
                    "label sets — unbounded label cardinality is a bug")
            s = factory()
            fam.series[key] = s
        return s

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._series(self._family(name, "counter", help),
                            labels, Counter)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._series(self._family(name, "gauge", help),
                            labels, Gauge)

    def histogram(self, name: str, help: str = "", *, lo: float = 1e-6,
                  hi: float = 1e4, buckets_per_decade: int = 48,
                  **labels) -> LogHistogram:
        fam = self._family(name, "histogram", help)
        return self._series(
            fam, labels,
            lambda: LogHistogram(lo=lo, hi=hi,
                                 buckets_per_decade=buckets_per_decade))

    def register_histogram(self, name: str, hist: LogHistogram,
                           help: str = "", **labels) -> LogHistogram:
        """Adopt an externally-owned histogram (e.g. the serving
        engine's live latency histogram) as a registry series — no copy,
        no double accounting."""
        fam = self._family(name, "histogram", help)
        key = _label_key(labels)
        fam.series[key] = hist
        return hist

    # -- exports -----------------------------------------------------------
    def to_prometheus(self) -> str:
        """The Prometheus text exposition format (version 0.0.4)."""
        lines: List[str] = []
        for name in sorted(self._families):
            fam = self._families[name]
            if fam.help:
                lines.append(f"# HELP {name} {fam.help}")
            lines.append(f"# TYPE {name} {fam.kind}")
            for key in sorted(fam.series):
                s = fam.series[key]
                if isinstance(s, (Counter, Gauge)):
                    lines.append(f"{_series_name(name, key)} "
                                 f"{_fmt(s.value)}")
                    continue
                assert isinstance(s, LogHistogram)
                cum = 0
                for i, c in enumerate(s.counts):
                    if not c:
                        continue
                    cum += int(c)
                    le = s.bucket_edges(i)[1]
                    le_s = "+Inf" if math.isinf(le) else _fmt(le)
                    bkey = key + (("le", le_s),)
                    lines.append(f"{_series_name(name + '_bucket', bkey)}"
                                 f" {cum}")
                inf_key = key + (("le", "+Inf"),)
                if cum == 0 or not s.counts[-1]:
                    lines.append(f"{_series_name(name + '_bucket', inf_key)}"
                                 f" {s.count}")
                lines.append(f"{_series_name(name + '_sum', key)} "
                             f"{_fmt(s.total)}")
                lines.append(f"{_series_name(name + '_count', key)} "
                             f"{s.count}")
        return "\n".join(lines) + "\n"

    def snapshot(self) -> dict:
        """Plain-JSON snapshot: the artifact ``--metrics-json`` writes."""
        out: dict = {"counters": {}, "gauges": {}, "histograms": {}}
        for name in sorted(self._families):
            fam = self._families[name]
            sec = {"counter": "counters", "gauge": "gauges",
                   "histogram": "histograms"}[fam.kind]
            for key in sorted(fam.series):
                s = fam.series[key]
                sname = _series_name(name, key)
                if isinstance(s, Counter):
                    out[sec][sname] = int(s.value)
                elif isinstance(s, Gauge):
                    out[sec][sname] = float(s.value)
                else:
                    out[sec][sname] = s.snapshot()
        return out


def _fmt(v: float) -> str:
    """Prometheus sample values: integers render bare, floats use repr
    (full precision, parseable)."""
    if isinstance(v, int) or (isinstance(v, float) and v == int(v)
                              and abs(v) < 1e15):
        return str(int(v))
    return repr(float(v))


def validate_metrics_snapshot(snap) -> List[str]:
    """Every schema problem in a ``snapshot()``-shaped object (empty
    list = valid).  CI's observability smoke runs this against the
    ``--metrics-json`` artifact."""
    problems: List[str] = []
    if not isinstance(snap, dict):
        return [f"snapshot must be a JSON object, got "
                f"{type(snap).__name__}"]
    for sec in ("counters", "gauges", "histograms"):
        if sec not in snap:
            problems.append(f"missing section {sec!r}")
        elif not isinstance(snap[sec], dict):
            problems.append(f"section {sec!r} must be an object, got "
                            f"{type(snap[sec]).__name__}")
    for name, v in (snap.get("counters") or {}).items():
        if isinstance(v, bool) or not isinstance(v, int) or v < 0:
            problems.append(f"counter {name!r}: {v!r} is not a "
                            "non-negative integer")
    for name, v in (snap.get("gauges") or {}).items():
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            problems.append(f"gauge {name!r}: {v!r} is not a number")
    want_h = ("count", "sum", "min", "max", "mean", "p50", "p95", "p99")
    for name, h in (snap.get("histograms") or {}).items():
        if not isinstance(h, dict):
            problems.append(f"histogram {name!r}: not an object")
            continue
        for k in want_h:
            v = h.get(k)
            if v is None:
                problems.append(f"histogram {name!r}: missing {k!r}")
            elif isinstance(v, bool) or not isinstance(v, (int, float)):
                problems.append(f"histogram {name!r}: {k}={v!r} is not "
                                "a number")
        cnt = h.get("count")
        if isinstance(cnt, int) and isinstance(h.get("buckets"), dict):
            if sum(int(c) for c in h["buckets"].values()) != cnt:
                problems.append(f"histogram {name!r}: bucket counts do "
                                f"not sum to count={cnt}")
    return problems
