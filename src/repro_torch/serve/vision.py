"""Continuous-batching image-inference engine over the compiled
fold-schedule engine, hardened into a fault-tolerant serving runtime.

* batches form from a FIFO queue with **bucketed** widths
  (``serve/batcher.py``) — one compiled forward per bucket, all buckets
  sharing one ``ScheduleCache`` via ``BucketCompiler``, so fold planning
  and (optional) measured autotuning are pay-once across buckets; on a
  CUDA device each bucket's forward is one CUDA graph (``BucketCompiler``'s
  default ``jit``), captured at ``warmup`` and replayed for every batch;
* execution **shards across a mesh** (``mesh=``) by binding the batch
  (image-fold) axis and the N_F (filter-fold) axis to mesh axes through
  ``core/mapping.py:serving_conv_plan``'s ``partition_spec``
  (``distributed/sharding.py:vision_shardings``): each data rank runs its
  rows of every batch and the logits are gathered; each model rank holds
  its N_F slice of every conv whose filter count divides the model axis,
  runs the fold kernel on it and gathers the output channels before the
  next layer.  Every rank runs the same request stream (one process a
  rank) and gets every request's logits;
* host→device staging **overlaps compute** with a double-buffered
  feeder: while the device runs batch k, batch k+1 is formed, copied into
  pinned host memory and sent with a non-blocking copy; the blocking point
  is the readback of batch k's logits at completion;
* the **fault-tolerant runtime** wraps the dispatch path: per-request
  deadlines with measured-EWMA admission control and form-time expiry
  (``serve/admission.py``), a degradation ladder that retries a failed or
  non-finite primary batch on the reference forward and bisects a
  still-failing batch to quarantine exactly the poisoned request, a
  watchdog (built on ``ft/fault_tolerance.py``) flagging hung and
  straggling dispatches, and an optional deterministic fault injector
  (``serve/chaos.py``).  The static fold schedules are never touched —
  all dynamism lives in this host runtime;
* observability: a request-lifecycle tracer (``obs/trace.py``; the no-op
  ``NULL_TRACER`` by default), the per-schedule fold counters
  (``obs/folds.py``) and ``snapshot_registry`` into a ``MetricsRegistry``
  (``obs/metrics.py``);
* ``ServingMetrics``: images/s, p50/p95/p99 request latency, slot
  occupancy, the schedule cache's fold-reuse counters and the robustness
  counters (shed / expired / failed / degraded / hung / deadline hit rate).

What the ladder recovers from: an injected fault (``ChaosKernelFault``:
a scheduled kernel fault or a poisoned input) and non-finite logits, read
on the host copy after the readback.  Nothing else: a kernel library that
fails to build, a launch a wrapper refuses, a CUDA error (asynchronous,
it surfaces at the readback) propagate out of ``run``, so no fallback
hides a broken kernel.  A *sticky* CUDA error (an illegal address, a
device-side assert) poisons the CUDA context besides: no rung could run
after it, and nothing here pretends to recover a lost context.

``serving_summary`` serves a deterministic mixed-size request stream
through any registered conv model (``models/zoo.py``), in fp32 or int8,
and is what ``launch/serve.py --vision`` runs, with ``mesh=`` on a
``launch/mesh.py`` mesh.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.engine import (BucketCompiler, ScheduleCache,
                                     resolve_execution)
from repro_torch.core.mapping import serving_conv_plan
from repro_torch.obs.folds import FoldStreamCounters
from repro_torch.obs.metrics import LogHistogram, MetricsRegistry
from repro_torch.obs.trace import (NULL_TRACER, REQ_TID0, TID_COMPLETE,
                                   TID_DISPATCH, TID_ENGINE)
from repro_torch.serve.admission import (AdmissionController,
                                         DispatchWatchdog, RequestOutcome)
from repro_torch.serve.batcher import (BucketPolicy, FormedBatch,
                                       ImageBatcher, ImageRequest)
from repro_torch.serve.chaos import ChaosKernelFault

__all__ = ["ServingMetrics", "VisionEngine", "serving_summary"]


def _latency_hist() -> LogHistogram:
    """1µs .. 10ks range — any serving latency this host can produce."""
    return LogHistogram(lo=1e-6, hi=1e4, buckets_per_decade=48)


def _occupancy_hist() -> LogHistogram:
    """Slot occupancy lives in (0, 1]."""
    return LogHistogram(lo=1e-3, hi=2.0, buckets_per_decade=48)


@dataclasses.dataclass
class ServingMetrics:
    """Accumulated over ``VisionEngine.run``/``step`` calls (warmup
    excluded).  The throughput and latency fields count served work; the
    robustness counters track the request lifecycle — every submitted
    request ends in exactly one of ``outcomes`` or is still queued."""
    images: int = 0
    requests: int = 0
    batches: int = 0
    elapsed_s: float = 0.0
    latency_hist: LogHistogram = dataclasses.field(
        default_factory=_latency_hist)
    occupancy_hist: LogHistogram = dataclasses.field(
        default_factory=_occupancy_hist)
    per_bucket: Dict[int, int] = dataclasses.field(default_factory=dict)
    # -- robustness -------------------------------------------------------
    submitted: int = 0            # requests entering the engine (any fate)
    shed: int = 0                 # admission-rejected at submit
    expired: int = 0              # deadline passed before batch formation
    failed: int = 0               # quarantined by the degradation ladder
    degraded_batches: int = 0     # primary batch fell back to reference
    nonfinite_batches: int = 0    # primary output failed the finite check
    hung_batches: int = 0         # dispatch outlived the hang timeout
    straggler_events: int = 0     # bucket lane flagged by the detector
    deadline_total: int = 0       # terminal requests that carried an SLO
    deadline_hits: int = 0        # ... that completed OK in time
    outcomes: Dict[str, int] = dataclasses.field(default_factory=dict)
    # host seconds of ``_complete`` after the readback (the watchdog,
    # admission, fold counters, finite check, scatter, accounting and the
    # tracer's spans), the ladder's rungs excluded; the port's own field
    host_s: float = 0.0

    @property
    def kips(self) -> float:
        """Measured kilo-images per second: the paper's eq (13) unit, from
        the wall clock rather than the cycle model."""
        return self.images / self.elapsed_s / 1e3 if self.elapsed_s else 0.0

    @property
    def images_per_s(self) -> float:
        return self.images / self.elapsed_s if self.elapsed_s else 0.0

    @property
    def slot_occupancy(self) -> float:
        return self.occupancy_hist.mean

    @property
    def deadline_hit_rate(self) -> float:
        """Fraction of SLO-carrying requests that completed in time (1.0
        when nothing carried a deadline)."""
        return (self.deadline_hits / self.deadline_total
                if self.deadline_total else 1.0)

    def latency_percentiles(self) -> Dict[str, float]:
        h = self.latency_hist
        if not h.count:
            return {"p50_s": 0.0, "p95_s": 0.0, "p99_s": 0.0, "mean_s": 0.0}
        return {"p50_s": round(h.percentile(50), 6),
                "p95_s": round(h.percentile(95), 6),
                "p99_s": round(h.percentile(99), 6),
                "mean_s": round(h.mean, 6)}

    def as_dict(self) -> dict:
        """The JAX package's keys, nesting and rounding."""
        return {
            "images": self.images,
            "requests": self.requests,
            "batches": self.batches,
            "elapsed_s": round(self.elapsed_s, 4),
            "kips": round(self.kips, 6),
            "images_per_s": round(self.images_per_s, 3),
            "latency": self.latency_percentiles(),
            "slot_occupancy": round(self.slot_occupancy, 4),
            "per_bucket_batches": {str(k): v for k, v
                                   in sorted(self.per_bucket.items())},
            "robustness": {
                "submitted": self.submitted,
                "shed": self.shed,
                "expired": self.expired,
                "failed": self.failed,
                "degraded_batches": self.degraded_batches,
                "nonfinite_batches": self.nonfinite_batches,
                "hung_batches": self.hung_batches,
                "straggler_events": self.straggler_events,
                "deadline_total": self.deadline_total,
                "deadline_hits": self.deadline_hits,
                "deadline_hit_rate": round(self.deadline_hit_rate, 4),
                "outcomes": {k: self.outcomes[k]
                             for k in sorted(self.outcomes)},
            },
        }


def _local(leaf, sharding):
    """This rank's shard of a parameter entry (a tensor or a dict of
    them) under its ``NamedSharding``(s)."""
    if isinstance(leaf, dict):
        return {k: _local(v, sharding[k]) for k, v in leaf.items()}
    return sharding.local(leaf)


class _NonFiniteOutput(RuntimeError):
    """A primary forward completed but produced NaN/Inf in active rows."""


class VisionEngine:
    """Serve a stream of image requests through bucketed compiled forwards.

    ``submit`` then ``run`` (or ``step`` one batch at a time).  Outputs land
    on each request's ``logits``, bitwise equal to a direct forward of the
    same images: neither the fold kernels nor the head kernel
    (``kernels/dense.py``) let a row's sum order depend on the batch, so
    the bucket a batch is padded to changes no bit.

    ``jit`` (default True) goes to the ``BucketCompiler``: on a CUDA device
    each bucket's forward is a CUDA graph, captured by ``warmup`` (or a
    bucket's first batch); ``autotune`` / ``tuning_path`` /
    ``autotune_timer`` too (the first bucket's compile measures, in the
    constructor, before any capture).  A staged batch is copied into the
    graph's static input on the current stream, after the previous replay,
    and each replay's logits come back as a tensor of their own, so batch
    k's logits survive the dispatch of k + 1.

    **Degradation ladder**: a primary dispatch that raises an injected
    fault, or whose active rows come back non-finite, is retried on the bucket's
    *reference* compiled forward (counted ``degraded_batches``).  If the
    reference batch also fails, it is bisected — halves retried
    recursively — until the poisoned request fails alone (``failed``,
    quarantined) and every batchmate is served.  Requests carry
    ``served_by`` (primary/reference).  The reference rung runs each
    request on its own (``_reference_forward``), so a request served on
    that rung equals a direct reference forward of its images bitwise.

    With ``mesh`` (a ``launch/mesh.py`` mesh with ranks; one engine per
    rank, each fed the same requests), bucket widths round up to the
    ``data_axis`` size and ``plan`` is the ``serving_conv_plan`` of the
    widest bucket and the largest filter count.  The parameters are
    placed by ``vision_shardings``: each ``model_axis`` rank keeps its N_F
    slice of every conv whose filter count divides the axis (the weights
    never move; ``params`` is then this rank's tree), everything else is
    replicated.  Each data rank runs its bucket width / data rows of a
    batch and the logits are gathered over the data axis; a split conv's
    output channels are gathered over the model axis after its kernel
    (``core/engine.compile_network``'s ``shard``), so a split network runs
    eager.  The reference rung runs a request's whole rows on every data
    rank.  A collective that fails raises out of ``run``: a rank's failure
    fails the run.
    """

    def __init__(self, params: Dict[str, Any], graph, *,
                 img: int, chan: int = 3, policy: str = "auto",
                 buckets: Sequence[int] = (1, 2, 4, 8),
                 mesh=None, data_axis: str = "data",
                 model_axis: str = "model",
                 cache: Optional[ScheduleCache] = None,
                 head: Optional[Callable] = None, jit: bool = True,
                 fuse_epilogues: bool = True, autotune: bool = False,
                 tuning_path: Optional[str] = None,
                 autotune_timer: Optional[Callable] = None,
                 chaos=None, hang_timeout_s: float = 30.0,
                 admission: Optional[AdmissionController] = None,
                 tracer=None, registry: Optional[MetricsRegistry] = None,
                 fold_pe=None, device: Any = "cuda",
                 precision: str = "fp32"):
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.registry = registry
        bucket_policy = BucketPolicy(buckets)
        self.mesh = mesh
        self.plan = None
        self._data_group, self._data, self._data_index = None, 1, 0
        shard = quant = None
        if mesh is not None:
            from repro_torch.distributed.sharding import (filter_shard,
                                                          vision_shardings)
            self._data = mesh.shape.get(data_axis, 1)
            if self._data > 1:
                self._data_group = mesh.group(data_axis)
                self._data_index = mesh.axis_index(data_axis)
            bucket_policy = bucket_policy.aligned(self._data)
            nf_max = max((int(leaf["w"].shape[0])
                          for leaf in params.values()
                          if isinstance(leaf, dict) and "w" in leaf
                          and getattr(leaf["w"], "ndim", 0) == 4),
                         default=1)
            self.plan = serving_conv_plan(bucket_policy.max_width, nf_max,
                                          data_axis=data_axis,
                                          model_axis=model_axis)
            shard = filter_shard(params, mesh, self.plan, graph,
                                 model_axis)
            if shard is not None:
                if precision == "int8":
                    # one recipe from the whole weights, as without a mesh
                    from repro_torch.core.graph import as_graph
                    from repro_torch.core.quant import default_recipe
                    _, dev = resolve_execution(policy, device)
                    quant = default_recipe(as_graph(graph), params,
                                           (1, chan, img, img), device=dev)
                shardings = vision_shardings(params, mesh, self.plan)
                params = {k: _local(v, shardings[k]) if k in shard.names
                          else v for k, v in params.items()}
        self.params = params
        self.batcher = ImageBatcher(bucket_policy, img, chan,
                                    tracer=self.tracer)
        self.compiler = BucketCompiler(
            params, graph, img, chan=chan, policy=policy, cache=cache,
            head=head, jit=jit, fuse_epilogues=fuse_epilogues,
            autotune=autotune, tuning_path=tuning_path,
            autotune_timer=autotune_timer,
            tracer=self.tracer if self.tracer.enabled else None,
            device=device, precision=precision, quant=quant, shard=shard)
        self.metrics = ServingMetrics()
        self.chaos = chaos
        if chaos is not None and getattr(chaos, "tracer", None) in \
                (None, NULL_TRACER):
            chaos.tracer = self.tracer   # injected faults land in the trace
        self.admission = admission if admission is not None else \
            AdmissionController(bucket_policy.widths, registry=registry)
        self.watchdog = DispatchWatchdog(bucket_policy.widths,
                                         hang_timeout_s=hang_timeout_s)
        self._ref_compiler: Optional[BucketCompiler] = None
        # per-ScheduleKey streaming counters (obs/folds.py): always on; a
        # batch costs one pass over the layers, their shares computed once
        # per bucket (at warmup); tracing stays behind the tracer check
        self.folds = FoldStreamCounters(pe=fold_pe)
        self._req_spans: Dict[int, Any] = {}   # rid -> open lifetime span
        # compile the first bucket now: it resolves the device (raising
        # when a requested GPU is absent) before any request is taken
        first = self._net(bucket_policy.widths[0])
        self.device = first.device
        # requests arrive as fp32; a bf16 network takes them rounded to
        # bf16 on the device, and its logits come back widened to fp32
        self.input_dtype = first.dtype

    # -- request side ------------------------------------------------------
    def submit(self, images: np.ndarray,
               deadline_s: Optional[float] = None) -> ImageRequest:
        """Validate, admission-check, and enqueue one request.

        Malformed payloads raise ``BadRequestError``.  A well-formed
        request whose ``deadline_s`` the measured queue already blows is
        returned un-queued with ``outcome == REJECTED`` (counted ``shed``);
        one whose deadline passes before its batch forms ends
        ``expired``."""
        tr = self.tracer
        sub = tr.begin("submit", tid=TID_ENGINE)
        try:
            req = self.batcher.make_request(images, deadline_s)
        except Exception as e:
            # malformed payload: no request object, no lifetime span
            tr.end(sub, error=repr(e))
            raise
        self.metrics.submitted += 1
        if tr.enabled:
            # the request's lifetime span, on its own track, closed with
            # the terminal outcome in ``_account``
            self._req_spans[req.rid] = tr.begin(
                f"request-{req.rid}", cat="request",
                tid=REQ_TID0 + req.rid, request_id=req.rid,
                n_images=req.n, deadline_s=deadline_s)
        adm = tr.begin("admit", tid=TID_ENGINE)
        ok, predicted = self.admission.admit(
            req.n, self.batcher.pending_images, deadline_s)
        req.predicted_wait_s = predicted
        tr.end(adm, admitted=ok, predicted_wait_s=predicted)
        if not ok:
            req.finish(RequestOutcome.REJECTED,
                       error=f"admission: predicted wait {predicted:.4f}s "
                             f"exceeds deadline {deadline_s:.4f}s")
            self.metrics.shed += 1
            self._account(req)
            tr.end(sub, request_id=req.rid, shed=True)
            return req
        self.batcher.queue.append(req)
        tr.end(sub, request_id=req.rid, shed=False)
        return req

    @property
    def pending(self) -> int:
        return len(self.batcher)

    # -- lifecycle accounting ---------------------------------------------
    def _account(self, req: ImageRequest) -> None:
        """Fold one terminal request into the outcome/deadline counters —
        called exactly once per request, at its terminal transition."""
        m = self.metrics
        key = req.outcome.value
        m.outcomes[key] = m.outcomes.get(key, 0) + 1
        if req.t_deadline is not None:
            m.deadline_total += 1
            if req.deadline_met:
                m.deadline_hits += 1
        span = self._req_spans.pop(req.rid, None)
        if span is not None:
            self.tracer.end(span, outcome=key, served_by=req.served_by,
                            **({"error": req.error} if req.error else {}))

    def _drain_expired(self) -> None:
        for req in self.batcher.expired:
            self.metrics.expired += 1
            self._account(req)
        self.batcher.expired.clear()

    # -- device side -------------------------------------------------------
    def _net(self, bucket: int):
        """The compiled forward of a bucket: at this data rank's rows."""
        return self.compiler.network_for(bucket // self._data)

    def _rows(self, x: np.ndarray) -> np.ndarray:
        """This data rank's rows of a bucket batch."""
        if self._data == 1:
            return x
        n = x.shape[0] // self._data
        return x[self._data_index * n:(self._data_index + 1) * n]

    def _forward(self, net, x: torch.Tensor) -> torch.Tensor:
        """A bucket forward on this rank's rows, the logits gathered over
        the data axis."""
        out = net(self.params, x)
        if self._data_group is None:
            return out
        from repro_torch.distributed.comm import all_gather_cat
        return all_gather_cat(out, self._data_group, 0)

    def _to_device(self, x: np.ndarray) -> torch.Tensor:
        """Stage a host batch: into pinned memory, then a non-blocking copy
        on the current stream (the caching host allocator keeps the pinned
        block alive until that copy has run)."""
        if self.device.type != "cuda":
            return torch.from_numpy(x).to(self.input_dtype)
        host = torch.empty(x.shape, dtype=torch.float32, pin_memory=True)
        host.numpy()[...] = x
        return host.to(self.device, non_blocking=True).to(self.input_dtype)

    def _stage(self) -> Optional[Tuple[FormedBatch, torch.Tensor]]:
        """Form the next batch and start its host→device copy (the front
        half of the double buffer).  Form-time expiries are accounted
        here."""
        span = self.tracer.begin("form", tid=TID_ENGINE)
        fb = self.batcher.form()
        self._drain_expired()
        if fb is None:
            self.tracer.end(span, discard=True)   # idle poll: no noise
            return None
        self.tracer.end(span, bucket=fb.bucket, n_images=fb.n_images,
                        n_requests=len(fb.requests),
                        occupancy=fb.occupancy)
        return fb, self._to_device(self._rows(fb.x))

    def _dispatch(self, staged: Tuple[FormedBatch, torch.Tensor]):
        """Enqueue the bucket's forward and return without waiting: the
        kernels run while the host forms and stages the next batch.  A
        dispatch-time fault is carried in the inflight tuple instead of
        raised, so the feeder keeps feeding and recovery happens at
        completion time.  Only an injected fault is carried: any other
        exception propagates."""
        fb, x = staged
        net = self._net(fb.bucket)
        span = self.tracer.begin("dispatch", tid=TID_DISPATCH,
                                 bucket=fb.bucket, n_images=fb.n_images)
        t0 = time.monotonic()
        try:
            with torch.inference_mode():
                if self.chaos is not None:
                    out = self.chaos.call(lambda a: self._forward(net, a), x)
                else:
                    out = self._forward(net, x)
            self.tracer.end(span)
            return fb, out, t0, None
        except ChaosKernelFault as e:
            self.tracer.end(span, error=repr(e))
            return fb, None, t0, e

    def _complete(self, inflight) -> None:
        fb, out, t0, exc = inflight
        tr = self.tracer
        logits = None
        if exc is None:
            # blocks until the device is done; a CUDA error raises here
            logits = out.float().cpu().numpy()
        t_done = time.monotonic()
        h0 = time.perf_counter()
        duration = t_done - t0
        verdict = self.watchdog.observe(fb.bucket, duration)
        self.admission.observe(fb.bucket, duration)
        m = self.metrics
        m.hung_batches += verdict.hung
        m.straggler_events += verdict.straggler
        m.batches += 1
        m.occupancy_hist.record(fb.occupancy)
        m.per_bucket[fb.bucket] = m.per_bucket.get(fb.bucket, 0) + 1
        # the measured interval: dispatch start -> readback done.  The
        # per-layer children carve it up by each layer's share of the
        # modeled T_Ops (the forward is one graph replay), tagged
        # ``apportioned`` so nobody mistakes them for measurements
        kernel_id = None
        if tr.enabled:
            kernel_id = tr.add_span(
                "kernel", "device", TID_DISPATCH, t0, duration,
                bucket=fb.bucket, n_images=fb.n_images,
                **({"error": repr(exc)} if exc is not None else {}))
        if exc is None:
            layers = self._net(fb.bucket).layer_schedules
            self.folds.record(layers, fb.n_images, duration)
            if tr.enabled:
                ts = t0
                for name, key, dur in self.folds.apportion(layers, duration):
                    tr.add_span(name, "layer", TID_DISPATCH, ts, dur,
                                parent=kernel_id, schedule=key,
                                apportioned=True)
                    ts += dur
        if exc is None and not np.isfinite(logits[:fb.n_images]).all():
            m.nonfinite_batches += 1
            tr.instant("nonfinite", cat="error", tid=TID_DISPATCH,
                       bucket=fb.bucket)
            exc = _NonFiniteOutput(
                f"primary batch (bucket {fb.bucket}) produced non-finite "
                "logits")
        if exc is not None:
            m.degraded_batches += 1
            m.host_s += time.perf_counter() - h0
            self._serve_degraded(list(fb.requests))
            return
        epi = tr.begin("epilogue", tid=TID_COMPLETE, bucket=fb.bucket)
        ImageBatcher.scatter(fb, logits, t_done)
        m.images += fb.n_images
        m.requests += len(fb.requests)
        for r in fb.requests:
            m.latency_hist.record(r.latency_s)
        tr.end(epi)
        comp = tr.begin("complete", tid=TID_COMPLETE,
                        n_requests=len(fb.requests))
        for req in fb.requests:
            self._account(req)
        tr.end(comp)
        m.host_s += time.perf_counter() - h0

    # -- degradation ladder ------------------------------------------------
    @property
    def reference_compiler(self) -> BucketCompiler:
        """The fallback rung: reference-policy compiled forwards per
        bucket, built on first use, sharing the primary compiler's
        ``ScheduleCache``.  It takes the same precision and the same
        ``QuantRecipe`` object, so a request run on the reference rung sees
        the same activation scales.  When the primary policy already is
        the reference, the primary compiler is returned."""
        c = self.compiler
        if c.policy == "reference":
            return c
        if self._ref_compiler is None:
            self._ref_compiler = BucketCompiler(
                self.params, c.graph, c.img, chan=c.chan,
                policy="reference", cache=c.cache, head=c.head, jit=c.jit,
                device=c.device, precision=c.precision, quant=c.quant,
                shard=c.shard)
        return self._ref_compiler

    def _reference_forward(self, reqs: List[ImageRequest]) -> np.ndarray:
        """The reference rung over ``reqs``: each request's images through
        the reference-policy forward compiled at its own width (no
        padding, no batchmates), their logits stacked in order; it raises
        at the first request that fails.  The reference conv's GEMMs may
        pick their algorithm by the batch's size, so a request computed
        alone is what makes its logits equal a direct reference forward
        of its images bitwise.  Chaos wraps each call, on the ``recovery``
        stream — scheduled faults never fire here, but a poisoned input
        still does, once per attempt, as for the JAX package's one packed
        batch."""
        outs = []
        for r in reqs:
            xd = self._to_device(r.images)
            net = self.reference_compiler.network_for(r.n)
            with torch.inference_mode():
                if self.chaos is not None:
                    out = self.chaos.call(lambda a: net(self.params, a), xd,
                                          stream="recovery")
                else:
                    out = net(self.params, xd)
            outs.append(out.float().cpu().numpy())
        return np.concatenate(outs)

    def _serve_degraded(self, reqs: List[ImageRequest]) -> None:
        """The ladder below a failed primary batch: reference retry, then
        recursive bisection, then single-request quarantine.  Every
        request in ``reqs`` is terminal when this returns."""
        tr = self.tracer
        span = tr.begin("degrade", tid=TID_COMPLETE, n_requests=len(reqs))
        try:
            logits = self._reference_forward(reqs)
        except ChaosKernelFault as e:
            if len(reqs) == 1:
                req = reqs[0]
                req.finish(RequestOutcome.FAILED,
                           error=f"quarantined: {type(e).__name__}: {e}")
                self.metrics.failed += 1
                tr.instant("quarantine", cat="error", tid=TID_COMPLETE,
                           request_id=req.rid, error=repr(e))
                self._account(req)
                tr.end(span, error=repr(e), quarantined=req.rid)
                return
            mid = (len(reqs) + 1) // 2     # bisect: isolate the poison
            self._serve_degraded(reqs[:mid])
            self._serve_degraded(reqs[mid:])
            tr.end(span, error=repr(e), bisected=True)
            return
        t_done = time.monotonic()
        m = self.metrics
        off = 0
        for req in reqs:
            rows = logits[off:off + req.n]
            off += req.n
            if np.isfinite(rows).all():
                req.logits = rows
                req.served_by = "reference"
                req.finish(RequestOutcome.OK, t=t_done)
                m.images += req.n
                m.requests += 1
                m.latency_hist.record(req.latency_s)
            else:
                req.finish(RequestOutcome.FAILED, t=t_done,
                           error="quarantined: non-finite reference output")
                m.failed += 1
                tr.instant("quarantine", cat="error", tid=TID_COMPLETE,
                           request_id=req.rid,
                           error="non-finite reference output")
            self._account(req)
        tr.end(span, served_by="reference")

    def warmup(self) -> Sequence[int]:
        """Run every bucket width once on zeros, so serving latencies
        measure steady-state forwards (the kernel build, the captures and
        the fold counters' model rows are paid here).  Returns the widths warmed.  Chaos never
        wraps warmup: the injector's dispatch indices count served batches
        only."""
        widths = self.batcher.policy.widths
        for w in widths:
            net = self._net(w)
            self.folds.prepare(net.layer_schedules)
            zeros = np.zeros((w // self._data, self.batcher.chan,
                              self.batcher.img, self.batcher.img),
                             np.float32)
            with torch.inference_mode():
                self._forward(net, self._to_device(zeros)).cpu()
        return widths

    def step(self) -> int:
        """Serve one batch synchronously; returns #images served (0 when
        the queue is empty)."""
        t0 = time.monotonic()
        staged = self._stage()
        if staged is None:
            return 0
        self._complete(self._dispatch(staged))
        self.metrics.elapsed_s += time.monotonic() - t0
        return staged[0].n_images

    def run(self, max_batches: int = 1_000_000) -> ServingMetrics:
        """Drain the queue with the double-buffered feeder: batch k+1 is
        formed and staged while the device computes batch k, and the
        blocking readback of k happens only after k+1 is dispatched.
        Recovery (the degradation ladder) runs inside completion."""
        t0 = time.monotonic()
        inflight = None
        batches = 0
        # a batch is only formed (popping its requests) while the budget
        # allows dispatching it, so no request is ever staged and dropped
        staged = self._stage() if max_batches > 0 else None
        while staged is not None or inflight is not None:
            nxt = None
            if staged is not None:
                nxt = self._dispatch(staged)
                batches += 1
            staged = self._stage() if batches < max_batches else None
            if inflight is not None:
                self._complete(inflight)
            inflight = nxt
        self.metrics.elapsed_s += time.monotonic() - t0
        return self.metrics

    # -- reporting ---------------------------------------------------------
    def metrics_dict(self) -> dict:
        d = self.metrics.as_dict()
        d["compile"] = self.compiler.stats()
        d["buckets"] = list(self.batcher.policy.widths)
        d["mesh"] = dict(self.mesh.shape) if self.mesh is not None else None
        d["device"] = str(self.device)
        d["host_us_per_batch"] = round(
            1e6 * self.metrics.host_s / self.metrics.batches, 3) \
            if self.metrics.batches else 0.0
        # zero-loss invariant: submitted == terminal + still queued
        d["robustness"]["lost_requests"] = (
            self.metrics.submitted - sum(self.metrics.outcomes.values())
            - self.pending)
        if self.chaos is not None:
            d["robustness"]["chaos_injected"] = dict(self.chaos.injected)
        # the live per-ScheduleKey table (obs/folds.py): the MAVeC model's
        # eq-10 utilization and bytes joined with measured dispatch time
        d["observability"] = self.folds.as_dict()
        return d

    def snapshot_registry(self, registry: Optional[MetricsRegistry] = None,
                          labels: Optional[Dict[str, str]] = None
                          ) -> MetricsRegistry:
        """Sync every serving counter into a metrics registry
        (``obs/metrics.py``) — one snapshot carrying perf + robustness +
        fold-reuse + chaos health.  Sync happens here, at snapshot time,
        so the serving hot path never touches the registry.  ``labels``
        (e.g. ``{"worker": "w0"}``) is stamped onto every synced series."""
        reg = registry if registry is not None else \
            (self.registry or MetricsRegistry())
        lb = dict(labels or {})
        m = self.metrics

        def c(name: str, help_: str = "", **kw):
            return reg.counter(name, help_, **lb, **kw)

        def g(name: str, help_: str = "", **kw):
            return reg.gauge(name, help_, **lb, **kw)
        c("serve_requests_submitted_total",
          "Requests entering the engine (any fate)").set_total(m.submitted)
        for outcome, n in sorted(m.outcomes.items()):
            c("serve_requests_total", "Terminal requests by outcome",
              outcome=outcome).set_total(n)
        c("serve_images_total", "Images served OK").set_total(m.images)
        c("serve_batches_total", "Primary batches completed"
          ).set_total(m.batches)
        for name, help_ in (("shed", "Admission-rejected at submit"),
                            ("expired", "Deadline passed before forming"),
                            ("failed", "Quarantined requests"),
                            ("degraded_batches", "Primary -> reference"),
                            ("nonfinite_batches", "Non-finite primary out"),
                            ("hung_batches", "Dispatch over hang timeout"),
                            ("straggler_events", "Straggling bucket lanes"),
                            ("deadline_total", "Terminal with an SLO"),
                            ("deadline_hits", "SLO met")):
            c(f"serve_{name}_total", help_).set_total(getattr(m, name))
        g("serve_kips", "Measured kilo-images per second").set(m.kips)
        g("serve_deadline_hit_rate", "SLO hit fraction"
          ).set(m.deadline_hit_rate)
        g("serve_pending_requests", "Still queued").set(self.pending)
        cs = self.compiler.cache.stats
        c("schedule_cache_hits_total", "Fold-reuse hits").set_total(cs.hits)
        c("schedule_cache_misses_total", "Schedules planned"
          ).set_total(cs.misses)
        c("schedule_cache_replans_total", "Geometry replans"
          ).set_total(cs.replans)
        g("schedule_cache_hit_rate", "Fold-reuse rate").set(cs.hit_rate)
        reg.register_histogram("serve_latency_seconds", m.latency_hist,
                               "End-to-end request latency", **lb)
        reg.register_histogram("serve_slot_occupancy", m.occupancy_hist,
                               "Real rows / bucket width per batch", **lb)
        if self.chaos is not None:
            for kind, n in sorted(self.chaos.injected.items()):
                c("chaos_injected_total", "Faults fired by the injector",
                  kind=kind).set_total(n)
        for row in self.folds.rows():
            g("fold_util_model_pct", "eq-10 model PE utilization",
              schedule=row["key"]).set(row["util_model_pct"])
            g("fold_achieved_vs_model_pct",
              "Measured GFLOP/s over eq-12 model GFLOP/s",
              schedule=row["key"]).set(row["achieved_vs_model_pct"])
        c("admission_observations_total", "Batch service-time samples"
          ).set_total(self.admission.observations)
        return reg


def serving_summary(model: str, *, requests: int = 32, img: int = 32,
                    width_mult: float = 0.0625, classes: int = 10,
                    policy: str = "auto",
                    buckets: Sequence[int] = (1, 2, 4, 8), mesh=None,
                    seed: int = 0, autotune: bool = False,
                    tuning_path: Optional[str] = None,
                    deadline_s: Optional[float] = None,
                    deadline_every: int = 1, guard=None, tracer=None,
                    registry: Optional[MetricsRegistry] = None,
                    device: Any = "cuda", precision: str = "fp32",
                    jit: bool = True, verbose: bool = False) -> dict:
    """Serve a deterministic mixed-size random request stream through a
    registered model (``models/zoo.py``) with random weights made from
    ``seed``, and return ``metrics_dict()`` plus the ``workload`` block.

    Request sizes (1 .. the widest bucket) and images come from
    ``np.random.default_rng(seed)``, all made before the first submit (a
    request's latency holds none of that host work); ``deadline_s``
    attaches an SLO to every ``deadline_every``-th request.  ``guard`` is a
    ``ft/fault_tolerance.py:PreemptionGuard`` (or anything with a
    ``requested`` attribute): once it trips, admission stops — the rest of
    the stream is never submitted — while everything queued is flushed
    and the metrics still emit.  The queue drains through the bucket
    forwards (CUDA graphs unless ``jit=False``).  Then each request served
    OK is compared with a direct eager forward (``jit=False``) of its own
    images through the same schedule cache (and, for int8, the same
    ``QuantRecipe``), under the policy of the rung that served it: whether
    every one matched bitwise, the largest difference and the largest
    reference magnitude land under ``"verify"``.  With ``mesh`` (one call
    per rank) the engine serves on the mesh and each rank holds every
    served request against that mesh-less direct forward."""
    from repro_torch.models.zoo import compile_forward, get_conv_model
    spec = get_conv_model(model)
    _, dev = resolve_execution(policy, device)     # raises without a GPU
    gen = torch.Generator(device=dev if dev.type == "cuda" else "cpu")
    params = spec.init_params(gen.manual_seed(seed), width_mult=width_mult,
                              img=img, classes=classes, device=dev)
    engine = VisionEngine(params, spec.to_graph(), img=img, policy=policy,
                          buckets=buckets, jit=jit, autotune=autotune,
                          tuning_path=tuning_path, tracer=tracer,
                          registry=registry, device=dev,
                          precision=precision, mesh=mesh)
    engine.warmup()
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, engine.batcher.policy.max_width + 1, requests)
    imgs = [rng.standard_normal((int(n), 3, img, img)).astype(np.float32)
            for n in sizes]
    reqs = []
    preempted = 0
    for i, im in enumerate(imgs):
        if guard is not None and getattr(guard, "requested", False):
            preempted = len(sizes) - i      # stop admitting, keep draining
            break
        dl = (deadline_s if deadline_s is not None
              and (deadline_every <= 1 or i % deadline_every == 0) else None)
        reqs.append(engine.submit(im, deadline_s=dl))
    engine.run()                            # flush everything in flight
    if registry is not None:
        engine.snapshot_registry(registry)
    d = engine.metrics_dict()
    err = ref = 0.0
    bitwise = True
    served = [(r, im) for r, im in zip(reqs, imgs)
              if r.outcome is RequestOutcome.OK]
    for req, im in served:
        rung = policy if req.served_by == "primary" else "reference"
        direct = compile_forward(spec, params, img=img, batch=im.shape[0],
                                 policy=rung, cache=engine.compiler.cache,
                                 jit=False, device=dev, precision=precision,
                                 quant=engine.compiler.quant)
        with torch.inference_mode():
            want = direct(params, torch.from_numpy(im).to(dev))
        got = torch.from_numpy(req.logits).to(dev)
        bitwise = bitwise and torch.equal(got, want)
        err = max(err, float((got - want).abs().max()))
        ref = max(ref, float(want.abs().max()))
    d["verify"] = {"requests": len(served), "bitwise": bitwise,
                   "max_abs_err": err, "max_abs_ref": ref}
    d["served_by"] = {rung: sum(r.served_by == rung for r, _ in served)
                      for rung in ("primary", "reference")}
    d["workload"] = {"model": model, "width_mult": width_mult, "img": img,
                     "classes": classes, "requests": int(requests),
                     "policy": policy, "precision": precision,
                     "jit": jit, "seed": seed, "device": str(dev),
                     "autotune": autotune, "deadline_s": deadline_s,
                     "preempted": preempted}
    if verbose:
        lat, rb, c = d["latency"], d["robustness"], d["compile"]
        print(f"served {d['requests']} requests / {d['images']} images in "
              f"{d['elapsed_s']}s: {d['kips']} KIPS "
              f"({d['images_per_s']} img/s)")
        print(f"latency p50={lat['p50_s']}s p95={lat['p95_s']}s "
              f"p99={lat['p99_s']}s; slot occupancy "
              f"{d['slot_occupancy']}; batches/bucket "
              f"{d['per_bucket_batches']}")
        print(f"robustness: outcomes {rb['outcomes']}, "
              f"shed={rb['shed']} expired={rb['expired']} "
              f"failed={rb['failed']} degraded={rb['degraded_batches']} "
              f"deadline_hit_rate={rb['deadline_hit_rate']} "
              f"lost={rb['lost_requests']}")
        if preempted:
            print(f"preemption drain: {preempted} request(s) never "
                  "admitted; queue flushed cleanly")
        print(f"buckets compiled {c['buckets']}, "
              f"{c['distinct_schedules']} distinct schedules, "
              f"schedule-cache hit_rate={c['hit_rate']}")
        print(engine.folds.table())
    return d
