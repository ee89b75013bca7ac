"""The traced run's device trace: ``torch.profiler`` (CUPTI) over the
steady middle of a segment of traffic that follows the measured window,
started and stopped between batches on the thread that does the engine's
work, with the device drained at both ends, so the trace holds exactly
the batches formed inside it.  ``reduce`` turns the exported
trace into what the per-layer readers and the result line take."""
from __future__ import annotations

import bisect
import collections
import dataclasses
import json
import os
import re
import tempfile
from typing import Dict, List, Optional, Tuple

ACTIVITIES = ("CPU", "CUDA")    # torch.profiler.ProfilerActivity names
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
FORM_SPAN = "portbench.form"
SHORT_GAP_S = 10e-6       # gaps below this are the device's own, not host's
SHORT_GAP = "device: gaps under 10 us between queued work"
IDLE_HOST = "host: Python outside any recorded op"


class Profiler:
    """Starts ``start_s`` and stops ``stop_s`` seconds into the segment,
    or once ``max_batches`` batches are traced (at the first ``tick``
    after either), once ``anchor`` has given the segment's start on the
    host's monotonic clock.  The cap keeps a trace of many short batches
    small enough to export and read in seconds."""

    def __init__(self, start_s: float, stop_s: float, max_batches: int):
        self.start_s, self.stop_s = start_s, stop_s
        self.max_batches = max_batches
        self.active = self.done = False
        self._prof = None

    def anchor(self, t0: float) -> None:
        self.start_s += t0
        self.stop_s += t0

    @staticmethod
    def _profile():
        from torch.profiler import ProfilerActivity, profile
        return profile(activities=[getattr(ProfilerActivity, a)
                                   for a in ACTIVITIES])

    @staticmethod
    def warm(device) -> None:
        """One short session before the traced segment, so that CUPTI's
        start-up (seconds) is not paid inside it."""
        import torch
        with Profiler._profile():
            torch.ones(1, device=device).add_(1)
            torch.cuda.synchronize(device)

    def tick(self, now: float, batches: int) -> None:
        """Between batches: ``batches`` traced so far."""
        import torch
        if not self.active and not self.done and now >= self.start_s:
            torch.cuda.synchronize()
            self._prof = self._profile()
            self._prof.start()
            self.active = True
        elif self.active and (now >= self.stop_s
                              or batches >= self.max_batches):
            self.stop()

    def stop(self) -> None:
        import torch
        if not self.active:
            return
        torch.cuda.synchronize()
        self._prof.stop()
        self.active, self.done = False, True

    def export(self) -> Optional[str]:
        """Writes the trace to a temporary file (after the segment: the
        export takes the interpreter for a while) and returns its path."""
        if self._prof is None or not self.done:
            return None
        fd, path = tempfile.mkstemp(prefix="portbench_trace_",
                                    suffix=".json")
        os.close(fd)
        self._prof.export_chrome_trace(path)
        self._prof = None
        return path


@dataclasses.dataclass
class Trace:
    kernels: List[Tuple[str, float]]     # (name, seconds) of each launch
    busy_s: float
    span_s: float
    device_ops: List[Tuple[str, float]]  # top 10 by summed seconds
    idle_gaps: List[Tuple[str, float]]   # top 10: idle seconds by host op

    def kernel_seconds(self, pattern: str) -> Tuple[float, int]:
        """Summed seconds and count of the launches whose name matches."""
        rx = re.compile(pattern)
        hits = [d for name, d in self.kernels if rx.search(name)]
        return sum(hits), len(hits)


def _merge(intervals: List[Tuple[float, float]]) -> List[List[float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _innermost(events: List[dict]) -> Tuple[List[float], List[float],
                                            List[str]]:
    """A thread's properly nested host events flattened to segments
    (start, end, innermost event's name)."""
    evs = sorted(events, key=lambda e: (e["ts"], -e["dur"]))
    starts, ends, names = [], [], []
    stack: List[Tuple[float, str]] = []        # (end, name)
    cursor = None

    def emit(a, b, name):
        if b > a:
            starts.append(a)
            ends.append(b)
            names.append(name)
    for e in evs:
        ts, end = e["ts"], e["ts"] + e["dur"]
        while stack and stack[-1][0] <= ts:
            top_end, top_name = stack.pop()
            emit(cursor, top_end, top_name)
            cursor = top_end
        if stack:
            emit(cursor, ts, stack[-1][1])
            end = min(end, stack[-1][0])
        cursor = ts
        stack.append((end, e["name"]))
    while stack:
        top_end, top_name = stack.pop()
        emit(cursor, top_end, top_name)
        cursor = top_end
    return starts, ends, names


def reduce(path: str, top: int = 10) -> Optional[Trace]:
    """The trace at ``path`` reduced, or None where it holds no device
    activity.  Times in the file are microseconds."""
    with open(path) as f:
        events = [e for e in json.load(f).get("traceEvents", [])
                  if e.get("ph") == "X" and "dur" in e]
    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
    if not dev:
        return None
    ivals = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
             for e in dev]
    merged = _merge(ivals)
    t0, t1 = merged[0][0], merged[-1][1]
    busy = sum(b - a for a, b in merged)
    by_name: Dict[str, float] = {}
    for e in dev:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"] * 1e-6
    # the engine's thread: the one that formed the batches, or, in a
    # trace of device activity alone, the one that called CUDA most
    tids = [e["tid"] for e in events if e.get("name") == FORM_SPAN] or [
        t for t, _ in collections.Counter(
            e["tid"] for e in events
            if e.get("cat") == "cuda_runtime").most_common(1)]
    host = [e for e in events if e.get("cat") in HOST_CATS
            and tids and e.get("tid") == tids[0]]
    for e in host:
        e["ts"], e["dur"] = float(e["ts"]), float(e["dur"])
    starts, ends, names = _innermost(host)
    idle: Dict[str, float] = {}

    def add(label: str, us: float) -> None:
        idle[label] = idle.get(label, 0.0) + us * 1e-6
    for (_, a), (b, _) in zip(merged, merged[1:]):
        if (b - a) * 1e-6 < SHORT_GAP_S:
            add(SHORT_GAP, b - a)
            continue
        # the gap split over the host's innermost ops while it lasted
        covered = 0.0
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        while i < len(starts) and starts[i] < b:
            part = min(ends[i], b) - max(starts[i], a)
            if part > 0:
                add(names[i], part)
                covered += part
            i += 1
        add(IDLE_HOST, (b - a) - covered)
    kernels = [(e["name"], e["dur"] * 1e-6) for e in dev
               if e.get("cat") == "kernel"]
    return Trace(
        kernels=kernels, busy_s=busy * 1e-6, span_s=(t1 - t0) * 1e-6,
        device_ops=sorted(by_name.items(), key=lambda kv: -kv[1])[:top],
        idle_gaps=sorted(idle.items(), key=lambda kv: -kv[1])[:top])
