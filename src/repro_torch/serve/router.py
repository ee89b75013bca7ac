"""SLO-aware request routing across serving workers: the counterpart of
the JAX package's ``serve/router.py``.

One ``VisionEngine`` is one replica: a ``BucketCompiler`` with one
compiled forward per bucket width (one CUDA graph each on the card).
Scaling the serving tier means N such replicas — in-process worker
threads sharing one ``ScheduleCache`` (planning stays pay-once across
replicas, as it is across buckets), or subprocesses speaking the same
HTTP protocol the front-end serves (``spawn_worker``: each its own CUDA
context on the same card; a remote worker is a client of another
``TransportServer``).

Dispatch policy: pick the worker that minimizes the predicted wait for
this request's bucket,

    score(w) = ceil(inflight_w / widest) * ewma_w(widest)
               + ewma_w(bucket_for(n))

— the queued work ahead of us, in batches of the widest bucket, plus this
request's own service time.  The EWMAs are measured at the router (wall
time per dispatch, per worker x bucket), which works the same for local
and remote workers.  Ties break toward lower inflight, then round-robin.

Failover: only a transport failure (``WorkerUnavailable`` — the worker is
unreachable or its thread died) reroutes a request to the next-best
worker.  An engine-level ``failed`` outcome does not: the degradation
ladder already ran the request, so re-dispatching it would double-serve a
poison request.  ``quarantine_after`` consecutive transport failures
bench a worker until a ``probe()`` (healthz round trip) brings it back.
"""
from __future__ import annotations

import asyncio
import math
import os
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serve.batcher import BucketPolicy
from repro_torch.serve.transport import (EngineWorker, InferResult, http_json,
                                   encode_images_payload,
                                   result_from_request,
                                   result_from_response)

__all__ = ["Router", "LocalWorker", "RemoteWorker", "WorkerUnavailable",
           "NoWorkersAvailable", "spawn_worker"]


class WorkerUnavailable(Exception):
    """Transport-level failure: the worker cannot be reached (or its
    thread is dead).  The ONLY error that triggers failover."""


class NoWorkersAvailable(Exception):
    """Every worker is quarantined or unreachable — served as 503."""


class LocalWorker:
    """An in-process replica: an ``EngineWorker`` thread bridged to
    asyncio via ``asyncio.wrap_future``."""

    remote = False

    def __init__(self, name: str, worker: EngineWorker):
        self.name = name
        self.worker = worker

    @property
    def inflight(self) -> int:
        return self.worker.inflight

    async def infer(self, images: np.ndarray,
                    deadline_s: Optional[float]) -> InferResult:
        if not self.worker.alive:
            raise WorkerUnavailable(
                f"worker {self.name!r}: engine thread is dead")
        req = await asyncio.wrap_future(
            self.worker.submit(images, deadline_s))
        return result_from_request(req, worker=self.name)

    async def call(self, fn: Callable):
        return await asyncio.wrap_future(self.worker.call(fn))

    async def stats(self) -> dict:
        return await self.call(lambda e: e.metrics_dict())

    async def sync_registry(self, registry) -> None:
        await self.call(lambda e: e.snapshot_registry(
            registry, labels={"worker": self.name}))

    async def healthy(self) -> bool:
        return self.worker.alive


class RemoteWorker:
    """A subprocess (or genuinely remote) replica behind its own
    ``TransportServer``; every connection error maps to
    ``WorkerUnavailable`` so the router's failover sees one error
    vocabulary."""

    remote = True

    def __init__(self, name: str, host: str, port: int,
                 proc: Optional[subprocess.Popen] = None):
        self.name = name
        self.host = host
        self.port = int(port)
        self.proc = proc
        self._inflight = 0

    @property
    def inflight(self) -> int:
        return self._inflight

    async def infer(self, images: np.ndarray,
                    deadline_s: Optional[float]) -> InferResult:
        payload = encode_images_payload(images, deadline_s)
        self._inflight += 1
        try:
            status, obj = await http_json(
                self.host, self.port, "POST", "/v1/infer", payload)
        except (ConnectionError, OSError, asyncio.IncompleteReadError) as e:
            raise WorkerUnavailable(
                f"worker {self.name!r} at {self.host}:{self.port} "
                f"unreachable: {e}") from e
        finally:
            self._inflight -= 1
        return result_from_response(status, obj, worker=self.name)

    async def stats(self) -> dict:
        try:
            _, obj = await http_json(self.host, self.port, "GET", "/stats")
        except (ConnectionError, OSError, asyncio.IncompleteReadError) as e:
            raise WorkerUnavailable(str(e)) from e
        # a worker subprocess runs a 1-worker router: lift its totals
        return obj.get("totals", obj) if isinstance(obj, dict) else {}

    async def sync_registry(self, registry) -> None:
        # remote replicas expose their own /metrics; the front-end
        # exports only what it owns rather than re-labeling a scrape
        return None

    async def healthy(self) -> bool:
        try:
            status, _ = await http_json(self.host, self.port,
                                        "GET", "/healthz")
        except (ConnectionError, OSError, asyncio.IncompleteReadError):
            return False
        return status == 200

    def terminate(self, timeout: float = 20.0) -> None:
        """SIGTERM the subprocess (its ``PreemptionGuard`` drains) and
        wait; escalate to kill only if the drain hangs."""
        if self.proc is None:
            return
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(5.0)


class _Ewma:
    """Scalar EWMA with a sensible cold-start (first sample wins)."""

    def __init__(self, alpha: float = 0.25):
        self.alpha = float(alpha)
        self.value: Optional[float] = None

    def observe(self, x: float) -> None:
        self.value = (float(x) if self.value is None
                      else self.alpha * float(x)
                      + (1.0 - self.alpha) * self.value)

    def get(self, default: float = 0.0) -> float:
        return self.value if self.value is not None else default


class Router:
    """SLO-aware dispatch + failover over a fixed worker set."""

    def __init__(self, workers: Sequence, buckets: Sequence[int] = (1, 2, 4, 8),
                 *, quarantine_after: int = 3, ewma_alpha: float = 0.25,
                 clock: Callable[[], float] = time.monotonic):
        if not workers:
            raise ValueError("router needs at least one worker")
        self.workers: List = list(workers)
        self.policy = BucketPolicy(buckets)
        self.quarantine_after = int(quarantine_after)
        self.clock = clock
        self._ewma: Dict[Tuple[str, int], _Ewma] = {
            (w.name, b): _Ewma(ewma_alpha)
            for w in self.workers for b in self.policy.widths}
        self._failures: Dict[str, int] = {w.name: 0 for w in self.workers}
        self._quarantined: Dict[str, bool] = {w.name: False
                                              for w in self.workers}
        self._routed: Dict[str, int] = {w.name: 0 for w in self.workers}
        self._failovers = 0
        self._rr = 0

    # -- dispatch ----------------------------------------------------------
    def worker_names(self) -> List[str]:
        return [w.name for w in self.workers]

    def quarantined(self) -> List[str]:
        return [n for n, q in self._quarantined.items() if q]

    def _bucket(self, n: int) -> int:
        # an oversize request scores against the widest bucket; the
        # worker's own validation produces the authoritative 400
        try:
            return self.policy.bucket_for(max(1, n))
        except ValueError:
            return self.policy.max_width

    def _score(self, w, bucket: int) -> float:
        widest = self.policy.max_width
        queue_ahead = math.ceil(w.inflight / widest)
        return (queue_ahead * self._ewma[(w.name, widest)].get()
                + self._ewma[(w.name, bucket)].get())

    def _pick(self, n: int, exclude: frozenset):
        live = [w for w in self.workers
                if w.name not in exclude and not self._quarantined[w.name]]
        if not live:
            return None
        bucket = self._bucket(n)
        self._rr += 1
        return min(
            live,
            key=lambda w: (self._score(w, bucket), w.inflight,
                           (self.workers.index(w) + self._rr)
                           % len(self.workers)))

    async def infer(self, images: np.ndarray,
                    deadline_s: Optional[float] = None) -> InferResult:
        images = np.asarray(images, np.float32)
        n = int(images.shape[0]) if images.ndim else 1
        bucket = self._bucket(n)
        tried: set = set()
        while True:
            w = self._pick(n, frozenset(tried))
            if w is None:
                raise NoWorkersAvailable(
                    f"no live worker (tried {sorted(tried)}, "
                    f"quarantined {self.quarantined()})")
            tried.add(w.name)
            t0 = self.clock()
            try:
                res = await w.infer(images, deadline_s)
            except WorkerUnavailable:
                self._note_failure(w.name)
                self._failovers += 1
                continue
            self._note_success(w.name, bucket, self.clock() - t0)
            return res

    def _note_success(self, name: str, bucket: int, wall_s: float) -> None:
        self._failures[name] = 0
        self._routed[name] += 1
        self._ewma[(name, bucket)].observe(wall_s)

    def _note_failure(self, name: str) -> None:
        self._failures[name] += 1
        if self._failures[name] >= self.quarantine_after:
            self._quarantined[name] = True

    # -- health ------------------------------------------------------------
    async def probe(self) -> List[str]:
        """Healthz every quarantined worker; a passing probe un-benches
        it.  Returns the workers brought back."""
        revived: List[str] = []
        for w in self.workers:
            if self._quarantined[w.name] and await w.healthy():
                self._quarantined[w.name] = False
                self._failures[w.name] = 0
                revived.append(w.name)
        return revived

    # -- introspection -----------------------------------------------------
    async def sync_registry(self, registry) -> None:
        for w in self.workers:
            if not self._quarantined[w.name]:
                await w.sync_registry(registry)

    async def stats(self) -> dict:
        out: Dict[str, dict] = {}
        totals = {"submitted": 0, "requests": 0, "images": 0,
                  "shed": 0, "expired": 0, "failed": 0,
                  "lost_requests": 0}
        for w in self.workers:
            row: Dict[str, object] = {
                "remote": w.remote,
                "inflight": w.inflight,
                "routed": self._routed[w.name],
                "consecutive_failures": self._failures[w.name],
                "quarantined": self._quarantined[w.name],
                "ewma_s": {str(b): round(self._ewma[(w.name, b)].get(), 6)
                           for b in self.policy.widths
                           if self._ewma[(w.name, b)].value is not None},
            }
            if not self._quarantined[w.name]:
                try:
                    eng = await w.stats()
                except WorkerUnavailable as e:
                    eng = {"error": str(e)}
                row["engine"] = eng
                rb = eng.get("robustness", eng) if isinstance(eng, dict) \
                    else {}
                for k in ("submitted", "shed", "expired", "failed",
                          "lost_requests"):
                    if isinstance(rb.get(k), (int, float)):
                        totals[k] += rb[k]
                for k in ("requests", "images"):
                    if isinstance(eng, dict) and \
                            isinstance(eng.get(k), (int, float)):
                        totals[k] += eng[k]
            out[w.name] = row
        return {"workers": out, "totals": totals,
                "failovers": self._failovers,
                "buckets": list(self.policy.widths)}


def spawn_worker(name: str, argv_tail: Sequence[str], *,
                 timeout_s: float = 180.0) -> RemoteWorker:
    """Launch ``python -m repro_torch.launch.server --workers 1 --port 0
    <argv_tail>`` and wait for its ``LISTENING <port>`` line: one engine
    subprocess per worker (``argv_tail`` carries the caller's
    ``--device``).  A worker that exits, or prints no ``LISTENING`` within
    ``timeout_s`` (one that cannot get its device exits nonzero without
    it), raises ``WorkerUnavailable``.  The subprocess imports the same
    ``repro_torch`` as this process (its directory leads ``PYTHONPATH``)."""
    cmd = [sys.executable, "-m", "repro_torch.launch.server",
           "--workers", "1", "--port", "0", *argv_tail]
    env = dict(os.environ)
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (pkg_root, env.get("PYTHONPATH")) if p)
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True, env=env)
    deadline = time.monotonic() + timeout_s
    port = None
    assert proc.stdout is not None
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        if not line:
            break
        if line.startswith("LISTENING "):
            port = int(line.split()[1])
            break
    if port is None:
        proc.kill()
        proc.wait()
        raise WorkerUnavailable(
            f"worker subprocess {name!r} never printed LISTENING "
            f"(exit={proc.poll()})")
    return RemoteWorker(name, "127.0.0.1", port, proc=proc)
