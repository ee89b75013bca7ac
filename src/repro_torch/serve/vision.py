"""Continuous-batching image-inference engine over the compiled
fold-schedule engine.

* batches form from a FIFO queue with **bucketed** widths
  (``serve/batcher.py``) — one compiled forward per bucket, all buckets
  sharing one ``ScheduleCache`` via ``BucketCompiler``, so fold planning
  is pay-once across buckets; on a CUDA device each bucket's forward is
  one CUDA graph (``BucketCompiler``'s default ``jit``), captured at
  ``warmup`` and replayed for every batch;
* host→device staging **overlaps compute** with a double-buffered
  feeder: while the device runs batch k, batch k+1 is formed, copied into
  pinned host memory and sent with a non-blocking copy; the blocking point
  is the readback of batch k's logits at completion;
* ``ServingMetrics``: images/s, p50/p95/p99 request latency, slot
  occupancy, and the schedule cache's fold-reuse counters.

``serving_summary`` serves a deterministic mixed-size request stream
through any registered conv model (``models/zoo.py``), in fp32 or int8,
and is what ``launch/serve.py --vision`` runs.  Of the degradation ladder
only its compile surface is here (``reference_compiler``, the reference
rung's compiled forwards); the ladder itself, admission control, chaos,
watchdog, tracing, autotuning and the mesh wait for a later slice
(ROADMAP queue A item 9).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.engine import (BucketCompiler, ScheduleCache,
                                     resolve_execution)
from repro_torch.obs.metrics import LogHistogram
from repro_torch.serve.batcher import (BucketPolicy, FormedBatch,
                                       ImageBatcher, ImageRequest)

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
    excluded).  Every submitted request ends in one of ``outcomes`` or is
    still queued."""
    images: int = 0
    requests: int = 0
    batches: int = 0
    elapsed_s: float = 0.0
    latency_hist: LogHistogram = dataclasses.field(
        default_factory=_latency_hist)
    occupancy_hist: LogHistogram = dataclasses.field(
        default_factory=_occupancy_hist)
    per_bucket: Dict[int, int] = dataclasses.field(default_factory=dict)
    submitted: int = 0
    expired: int = 0
    outcomes: Dict[str, int] = dataclasses.field(default_factory=dict)

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

    def latency_percentiles(self) -> Dict[str, float]:
        h = self.latency_hist
        if not h.count:
            return {"p50_s": 0.0, "p95_s": 0.0, "p99_s": 0.0, "mean_s": 0.0}
        return {"p50_s": round(h.percentile(50), 6),
                "p95_s": round(h.percentile(95), 6),
                "p99_s": round(h.percentile(99), 6),
                "mean_s": round(h.mean, 6)}

    def as_dict(self) -> dict:
        """The JAX package's keys, nesting and rounding.  Its robust-serving
        counters (shed, failed, degraded / non-finite / hung batches,
        straggler events, deadlines) come with the admission controller
        and the degradation ladder, which the port does not have yet."""
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
                "expired": self.expired,
                "outcomes": {k: self.outcomes[k]
                             for k in sorted(self.outcomes)},
            },
        }


class VisionEngine:
    """Serve a stream of image requests through bucketed compiled forwards.

    ``submit`` then ``run`` (or ``step`` one batch at a time).  Outputs land
    on each request's ``logits``, bitwise equal to a direct forward of the
    same images: neither the fold kernels nor the head kernel
    (``kernels/dense.py``) let a row's sum order depend on the batch, so
    the bucket a batch is padded to changes no bit.

    ``jit`` (default True) goes to the ``BucketCompiler``: on a CUDA device
    each bucket's forward is a CUDA graph, captured by ``warmup`` (or a
    bucket's first batch).  A staged batch is copied into the graph's
    static input on the current stream, after the previous replay, and
    each replay's logits come back as a tensor of their own, so batch k's
    logits survive the dispatch of k + 1.
    """

    def __init__(self, params: Dict[str, Any], graph, *,
                 img: int, chan: int = 3, policy: str = "auto",
                 buckets: Sequence[int] = (1, 2, 4, 8),
                 cache: Optional[ScheduleCache] = None,
                 head: Optional[Callable] = None, jit: bool = True,
                 fuse_epilogues: bool = True, device: Any = "cuda",
                 precision: str = "fp32"):
        self.params = params
        self.batcher = ImageBatcher(BucketPolicy(buckets), img, chan)
        self.compiler = BucketCompiler(
            params, graph, img, chan=chan, policy=policy, cache=cache,
            head=head, jit=jit, fuse_epilogues=fuse_epilogues,
            device=device, precision=precision)
        self._ref_compiler: Optional[BucketCompiler] = None
        # compile the first bucket now: it resolves the device (raising
        # when a requested GPU is absent) before any request is taken
        self.device = self.compiler.network_for(
            self.batcher.policy.widths[0]).device
        self.metrics = ServingMetrics()

    # -- request side ------------------------------------------------------
    def submit(self, images: np.ndarray,
               deadline_s: Optional[float] = None) -> ImageRequest:
        """Validate and enqueue one request.  Malformed payloads raise
        ``BadRequestError``; a request whose deadline passes before its
        batch forms ends ``expired``."""
        req = self.batcher.submit(images, deadline_s)
        self.metrics.submitted += 1
        return req

    @property
    def pending(self) -> int:
        return len(self.batcher)

    def _account(self, req: ImageRequest) -> None:
        key = req.outcome.value
        self.metrics.outcomes[key] = self.metrics.outcomes.get(key, 0) + 1

    def _drain_expired(self) -> None:
        for req in self.batcher.expired:
            self.metrics.expired += 1
            self._account(req)
        self.batcher.expired.clear()

    @property
    def reference_compiler(self) -> BucketCompiler:
        """The reference rung's compile surface: reference-policy compiled
        forwards per bucket, built on first use, sharing the primary
        compiler's ``ScheduleCache``.  It takes the same precision and the
        same ``QuantRecipe`` object, so a request run on the reference rung
        sees the same activation scales.  When the primary policy already
        is the reference, the primary compiler is returned."""
        c = self.compiler
        if c.policy == "reference":
            return c
        if self._ref_compiler is None:
            self._ref_compiler = BucketCompiler(
                self.params, c.graph, c.img, chan=c.chan,
                policy="reference", cache=c.cache, head=c.head, jit=c.jit,
                device=c.device, precision=c.precision, quant=c.quant)
        return self._ref_compiler

    # -- device side -------------------------------------------------------
    def _to_device(self, x: np.ndarray) -> torch.Tensor:
        """Stage a host batch: into pinned memory, then a non-blocking copy
        on the current stream (the caching host allocator keeps the pinned
        block alive until that copy has run)."""
        if self.device.type != "cuda":
            return torch.from_numpy(x)
        host = torch.empty(x.shape, dtype=torch.float32, pin_memory=True)
        host.numpy()[...] = x
        return host.to(self.device, non_blocking=True)

    def _stage(self) -> Optional[Tuple[FormedBatch, torch.Tensor]]:
        fb = self.batcher.form()
        self._drain_expired()
        if fb is None:
            return None
        return fb, self._to_device(fb.x)

    def _dispatch(self, staged: Tuple[FormedBatch, torch.Tensor]):
        """Enqueue the bucket's forward and return without waiting: the
        kernels run while the host forms and stages the next batch."""
        fb, x = staged
        net = self.compiler.network_for(fb.bucket)
        with torch.inference_mode():
            return fb, net(self.params, x)

    def _complete(self, inflight) -> None:
        fb, out = inflight
        logits = out.cpu().numpy()        # blocks until the device is done
        t_done = time.monotonic()
        m = self.metrics
        m.batches += 1
        m.occupancy_hist.record(fb.occupancy)
        m.per_bucket[fb.bucket] = m.per_bucket.get(fb.bucket, 0) + 1
        ImageBatcher.scatter(fb, logits, t_done)
        m.images += fb.n_images
        m.requests += len(fb.requests)
        for req in fb.requests:
            m.latency_hist.record(req.latency_s)
            self._account(req)

    def warmup(self) -> Sequence[int]:
        """Run every bucket width once on zeros, so serving latencies
        measure steady-state forwards (and the kernel build is paid
        here).  Returns the widths warmed."""
        widths = self.batcher.policy.widths
        for w in widths:
            net = self.compiler.network_for(w)
            zeros = np.zeros((w, self.batcher.chan, self.batcher.img,
                              self.batcher.img), np.float32)
            with torch.inference_mode():
                net(self.params, self._to_device(zeros)).cpu()
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
        blocking readback of k happens only after k+1 is dispatched."""
        t0 = time.monotonic()
        inflight = None
        batches = 0
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

    def metrics_dict(self) -> dict:
        d = self.metrics.as_dict()
        d["compile"] = self.compiler.stats()
        d["buckets"] = list(self.batcher.policy.widths)
        d["device"] = str(self.device)
        # zero-loss invariant: submitted == terminal + still queued
        d["robustness"]["lost_requests"] = (
            self.metrics.submitted - sum(self.metrics.outcomes.values())
            - self.pending)
        return d


def serving_summary(model: str, *, requests: int = 32, img: int = 32,
                    width_mult: float = 0.0625, classes: int = 10,
                    policy: str = "auto",
                    buckets: Sequence[int] = (1, 2, 4, 8), seed: int = 0,
                    device: Any = "cuda", precision: str = "fp32",
                    jit: bool = True) -> dict:
    """Serve a deterministic mixed-size random request stream through a
    registered model (``models/zoo.py``) with random weights made from
    ``seed``, and return ``metrics_dict()`` plus the ``workload`` block.

    Request sizes (1 .. the widest bucket) and images come from
    ``np.random.default_rng(seed)``; every request is submitted, then the
    queue is drained through the bucket forwards (CUDA graphs unless
    ``jit=False``).  Then each request's served logits are compared
    with a direct eager forward (``jit=False``) of its own images through
    the same schedule cache (and, for int8, the same ``QuantRecipe``):
    whether every request matched bitwise, the largest difference and the
    largest reference magnitude land under ``"verify"``."""
    from repro_torch.models.zoo import compile_forward, get_conv_model
    spec = get_conv_model(model)
    _, dev = resolve_execution(policy, device)     # raises without a GPU
    gen = torch.Generator(device=dev if dev.type == "cuda" else "cpu")
    params = spec.init_params(gen.manual_seed(seed), width_mult=width_mult,
                              img=img, classes=classes, device=dev)
    engine = VisionEngine(params, spec.to_graph(), img=img, policy=policy,
                          buckets=buckets, jit=jit, device=dev,
                          precision=precision)
    engine.warmup()
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, engine.batcher.policy.max_width + 1, requests)
    imgs = [rng.standard_normal((int(n), 3, img, img)).astype(np.float32)
            for n in sizes]
    reqs = [engine.submit(im) for im in imgs]
    engine.run()
    d = engine.metrics_dict()
    err = ref = 0.0
    bitwise = True
    for req, im in zip(reqs, imgs):
        direct = compile_forward(spec, params, img=img, batch=im.shape[0],
                                 policy=policy, cache=engine.compiler.cache,
                                 jit=False, device=dev, precision=precision,
                                 quant=engine.compiler.quant)
        with torch.inference_mode():
            want = direct(params, torch.from_numpy(im).to(dev))
        got = torch.from_numpy(req.logits).to(dev)
        bitwise = bitwise and torch.equal(got, want)
        err = max(err, float((got - want).abs().max()))
        ref = max(ref, float(want.abs().max()))
    d["verify"] = {"requests": len(reqs), "bitwise": bitwise,
                   "max_abs_err": err, "max_abs_ref": ref}
    d["workload"] = {"model": model, "width_mult": width_mult, "img": img,
                     "classes": classes, "requests": int(requests),
                     "policy": policy, "precision": precision,
                     "jit": jit, "seed": seed, "device": str(dev)}
    return d
