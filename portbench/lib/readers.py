"""Arithmetic the metric readers share.  ``art``, the artefacts of one
run, carries:

* ``seconds``, ``setup_s``, ``images_in_window``, ``latencies_ms`` (each
  request due in the window, due time to outcome; one that never answered
  counts to the end of the drain);
* ``counters``: the engine's ``images``, ``batches`` and ``host_s`` when
  the window closed;
* ``flops_per_image``, ``peak_flops`` (None on a card without a peak in
  ``lib/cost.py``), ``precision``, ``device_kind``;
* with ``--trace 1``: ``trace`` (``lib/profile.Trace`` of the traced
  segment that follows the window, or None where the profiler saw no
  device work), ``profiled`` ((bucket, images) of each batch in the
  trace), ``dataflows`` (bucket -> (layer, dataflow) of its compiled
  network) and ``layers(batch)`` (the reference's layer geometry by
  name).
"""
from __future__ import annotations

from typing import Optional

from portbench.lib import cost


def per_batch(art, key: str, scale: float = 1.0) -> Optional[float]:
    c = art.counters
    return scale * c[key] / c["batches"] if c["batches"] else None


def roofline_pct(art, dataflow: str, pattern: str) -> Optional[float]:
    """Bound time of the layers that the traced batches' networks run on
    ``dataflow`` over the device time of the kernels matching
    ``pattern``, in percent; None where the trace has no such kernel."""
    trace = getattr(art, "trace", None)
    if trace is None:
        return None
    device_s, launches = trace.kernel_seconds(pattern)
    if not launches or not device_s:
        return None
    bound = 0.0
    for bucket, _ in art.profiled:
        geometry = art.layers(bucket)
        for name, flow in art.dataflows[bucket]:
            if flow == dataflow:
                b = cost.bound_s(geometry[name], art.precision,
                                 art.device_kind)
                if b is None:
                    return None
                bound += b
    return 100.0 * bound / device_s if bound else None


def idle_pct(art) -> Optional[float]:
    trace = getattr(art, "trace", None)
    if trace is None or not trace.span_s:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.span_s)
