"""Async HTTP request transport over the port's vision serving runtime:
the counterpart of the JAX package's ``serve/transport.py``, speaking the
same JSON protocol byte for byte, so a client of either package talks to
a server of the other.

A small asyncio HTTP/1.1 front-end (stdlib only) puts ``VisionEngine``
behind a wire, and the request-lifecycle outcomes become HTTP statuses:

    outcome   (serve/admission.py)        HTTP
    --------------------------------------------------------------
    BadRequestError at submit             400  (never reaches a batch)
    rejected  (admission shed)            429  + Retry-After from the
                                               predicted queue wait
    expired   (deadline passed queued)    504
    failed    (quarantined by the ladder) 500
    ok                                    200  + logits, served_by
    draining  (PreemptionGuard tripped)   503  (new work refused)
    body over the cap                     413  (before it is read)

Every submitted request reaches exactly one terminal outcome and every
wire request receives exactly one response carrying it.

Threading model: each ``VisionEngine`` is owned by one ``EngineWorker``
thread; the asyncio side enqueues ``(payload, Future)`` pairs and awaits
the future (``asyncio.wrap_future``).  The worker drains its inbox before
every step so concurrent wire requests pack into wide device batches.  On
a CUDA device the worker thread does all of its engine's device work on
that thread's current stream (PyTorch keeps one per thread: the
host-to-device copy, the copy into a captured forward's static input, the
graph replay and the readback), and it only replays: every bucket's CUDA
graph is captured by ``warmup`` on the thread that starts the worker,
before the worker serves (a capture while another thread launches on the
legacy default stream would be invalidated; ``core/engine.
CapturedForward`` refuses a capture from another thread).  In-process
workers share the card's default stream, so their batches do not overlap
on the device, and the interpreter lock serializes their host work.

Endpoints:

* ``POST /v1/infer``  — images (nested JSON lists, or base64 raw
  float32 via ``{"shape", "dtype", "data_b64"}``) + optional deadline
  (``X-Deadline-S`` header, or ``deadline_s`` in the body); images are
  ``(n, chan, img, img)``.
* ``GET /healthz``    — liveness; 503 once draining.
* ``GET /metrics``    — Prometheus text exposition of the shared
  ``MetricsRegistry`` (engines synced per scrape under a ``worker``
  label); ``GET /metrics.json`` is the JSON snapshot
  ``obs.report --validate-metrics`` checks.
* ``GET /stats``      — router dispatch state + per-worker engine
  metrics (``totals.lost_requests`` is the zero-loss ledger).

Observability: per-endpoint request counters
(``transport_requests_total{endpoint,status}``) and one transport span
per request on ``TID_TRANSPORT``.
"""
from __future__ import annotations

import asyncio
import base64
import dataclasses
import json
import math
import queue
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np

from repro_torch.obs.trace import NULL_TRACER, TID_TRANSPORT
from repro_torch.serve.admission import BadRequestError
from repro_torch.serve.batcher import ImageRequest

__all__ = ["EngineWorker", "InferResult", "TransportServer",
           "HttpClient", "http_json", "PayloadTooLarge",
           "encode_images_payload", "decode_infer_body",
           "result_from_request", "result_from_response",
           "OUTCOME_STATUS"]

# terminal RequestOutcome value -> HTTP status (the wire contract)
OUTCOME_STATUS = {"ok": 200, "rejected": 429, "expired": 504,
                  "failed": 500}
_REASONS = {200: "OK", 400: "Bad Request", 404: "Not Found",
            405: "Method Not Allowed", 413: "Payload Too Large",
            429: "Too Many Requests", 500: "Internal Server Error",
            503: "Service Unavailable", 504: "Gateway Timeout"}

MAX_BODY_BYTES = 8 << 20        # oversized payloads are capped, not read
MAX_HEADERS = 100


class PayloadTooLarge(Exception):
    """Declared Content-Length exceeds the body cap — answered 413
    before a single body byte is read."""


# ---------------------------------------------------------------------------
# wire payloads
# ---------------------------------------------------------------------------

def encode_images_payload(images: np.ndarray,
                          deadline_s: Optional[float] = None) -> dict:
    """The compact client-side body: base64 of the raw float32 buffer
    (~3x smaller than nested JSON lists and no float-repr cost)."""
    arr = np.ascontiguousarray(np.asarray(images, np.float32))
    payload: Dict[str, Any] = {
        "shape": list(arr.shape), "dtype": "float32",
        "data_b64": base64.b64encode(arr.tobytes()).decode("ascii")}
    if deadline_s is not None:
        payload["deadline_s"] = float(deadline_s)
    return payload


def decode_infer_body(body: bytes) -> Tuple[np.ndarray, Optional[float]]:
    """Parse a ``POST /v1/infer`` body into (images, deadline_s).

    Raises ``BadRequestError`` for malformed JSON or an undecodable
    payload — before anything touches an engine, so a garbage body can
    never show up in ``metrics.submitted``."""
    try:
        obj = json.loads(body.decode("utf-8"))
    except (UnicodeDecodeError, ValueError) as e:
        raise BadRequestError(f"request body is not valid JSON: {e}") from e
    if not isinstance(obj, dict):
        raise BadRequestError(
            f"request body must be a JSON object, got "
            f"{type(obj).__name__}")
    deadline = obj.get("deadline_s")
    if deadline is not None:
        try:
            deadline = float(deadline)
        except (TypeError, ValueError) as e:
            raise BadRequestError(
                f"deadline_s must be a number, got {deadline!r}") from e
    if "data_b64" in obj:
        try:
            raw = base64.b64decode(obj["data_b64"], validate=True)
            arr = np.frombuffer(raw, dtype=np.dtype(
                obj.get("dtype", "float32"))).reshape(obj["shape"])
        except (KeyError, TypeError, ValueError) as e:
            raise BadRequestError(
                f"undecodable b64 image payload: {e}") from e
        return np.asarray(arr, np.float32), deadline
    if "images" in obj:
        try:
            arr = np.asarray(obj["images"], np.float32)
        except (TypeError, ValueError) as e:
            raise BadRequestError(
                f"images field is not a numeric array: {e}") from e
        return arr, deadline
    raise BadRequestError(
        "request body needs an 'images' array or a "
        "'shape'/'dtype'/'data_b64' payload")


@dataclasses.dataclass
class InferResult:
    """One wire-level inference result — what the router returns and
    ``POST /v1/infer`` serializes, whichever worker produced it."""
    outcome: str
    status: int
    logits: Optional[np.ndarray] = None
    served_by: Optional[str] = None
    error: Optional[str] = None
    latency_s: Optional[float] = None
    predicted_wait_s: Optional[float] = None
    request_id: Optional[int] = None
    worker: Optional[str] = None

    def body(self) -> dict:
        d: Dict[str, Any] = {"outcome": self.outcome}
        for k in ("request_id", "worker", "served_by", "error"):
            v = getattr(self, k)
            if v is not None:
                d[k] = v
        if self.latency_s is not None:
            d["latency_s"] = round(self.latency_s, 6)
        if self.predicted_wait_s is not None:
            d["predicted_wait_s"] = round(self.predicted_wait_s, 6)
        if self.logits is not None:
            # float32 -> float64 -> repr round-trips bitwise, so served
            # logits survive the JSON hop exactly (tested)
            d["logits"] = np.asarray(self.logits, np.float64).tolist()
        return d

    def headers(self) -> Dict[str, str]:
        if self.status == 429:
            wait = max(self.predicted_wait_s or 0.0, 0.0)
            return {"Retry-After": str(max(1, math.ceil(wait)))}
        return {}


def result_from_request(req: ImageRequest,
                        worker: Optional[str] = None) -> InferResult:
    """Terminal ``ImageRequest`` -> wire result (the local-worker path)."""
    out = req.outcome.value
    return InferResult(
        outcome=out, status=OUTCOME_STATUS.get(out, 500),
        logits=req.logits if out == "ok" else None,
        served_by=req.served_by, error=req.error,
        latency_s=req.latency_s if req.done else None,
        predicted_wait_s=req.predicted_wait_s,
        request_id=req.rid, worker=worker)


def result_from_response(status: int, obj: dict,
                         worker: Optional[str] = None) -> InferResult:
    """HTTP response from a remote worker -> wire result (the
    subprocess-worker path)."""
    if not isinstance(obj, dict):
        obj = {"error": f"non-JSON worker response: {obj!r}"}
    logits = obj.get("logits")
    return InferResult(
        outcome=obj.get("outcome", "failed"), status=int(status),
        logits=(np.asarray(logits, np.float32)
                if logits is not None else None),
        served_by=obj.get("served_by"), error=obj.get("error"),
        latency_s=obj.get("latency_s"),
        predicted_wait_s=obj.get("predicted_wait_s"),
        request_id=obj.get("request_id"), worker=worker)


# ---------------------------------------------------------------------------
# the engine worker thread
# ---------------------------------------------------------------------------

class EngineWorker:
    """One serving worker: a dedicated thread owning a ``VisionEngine``.

    The transport enqueues ``(payload, Future)`` pairs; the thread
    drains its whole inbox before every ``step()`` so concurrent wire
    requests pack into the same device batch, then resolves each
    future the moment its request reaches a terminal outcome (including
    submit-time admission rejects and form-time expiries).  ``call``
    runs an arbitrary function against the engine *on the worker
    thread* — stats and metrics snapshots serialize with serving work
    instead of racing it.
    """

    def __init__(self, name: str, engine, *, poll_s: float = 0.002):
        self.name = name
        self.engine = engine
        self.poll_s = float(poll_s)
        self._inbox: "queue.Queue" = queue.Queue()
        self._waiting: Dict[int, Tuple[ImageRequest, Future]] = {}
        self._stop = threading.Event()
        self._drain = True
        self._thread = threading.Thread(
            target=self._loop, name=f"engine-worker-{name}", daemon=True)
        # test hook: when set to an (unset) Event the loop idles until
        # it is set — lets tests hold a request in flight deterministically
        self.gate: Optional[threading.Event] = None

    def start(self, warmup: bool = True) -> "EngineWorker":
        if warmup:
            self.engine.warmup()
        self._thread.start()
        return self

    @property
    def alive(self) -> bool:
        return self._thread.is_alive()

    @property
    def inflight(self) -> int:
        """Requests accepted but not yet terminal (inbox + queued)."""
        return self._inbox.qsize() + len(self._waiting)

    def submit(self, images: np.ndarray,
               deadline_s: Optional[float] = None) -> Future:
        """Thread-safe: resolves to the terminal ``ImageRequest`` (or
        raises ``BadRequestError`` for malformed payloads)."""
        fut: Future = Future()
        self._inbox.put(("infer", (images, deadline_s), fut))
        return fut

    def call(self, fn: Callable) -> Future:
        """Run ``fn(engine)`` on the worker thread; resolves to its
        return value."""
        fut: Future = Future()
        self._inbox.put(("call", fn, fut))
        return fut

    def stop(self, drain: bool = True, timeout: float = 60.0) -> None:
        """Stop the worker; with ``drain`` (the default) everything
        already accepted completes first — the SIGTERM discipline."""
        self._drain = drain
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout)

    # -- worker thread -----------------------------------------------------
    def _loop(self) -> None:
        while True:
            gate = self.gate
            if gate is not None and not gate.wait(timeout=0.01):
                if self._stop.is_set() and not self._drain:
                    break
                continue
            drained = 0
            while True:
                try:
                    item = self._inbox.get_nowait()
                except queue.Empty:
                    break
                self._handle(item)
                drained += 1
            if self.engine.pending:
                self.engine.step()
                self._resolve_terminal()
                continue
            self._resolve_terminal()
            if self._stop.is_set():
                if not self._drain:
                    self._fail_waiting("worker stopped without drain")
                    break
                if self._inbox.empty() and not self._waiting:
                    break
                continue
            if not drained:
                try:
                    item = self._inbox.get(timeout=self.poll_s)
                except queue.Empty:
                    continue
                self._handle(item)

    def _handle(self, item) -> None:
        kind, payload, fut = item
        if not fut.set_running_or_notify_cancel():
            return
        if kind == "call":
            try:
                fut.set_result(payload(self.engine))
            except Exception as e:
                fut.set_exception(e)
            return
        images, deadline_s = payload
        try:
            req = self.engine.submit(images, deadline_s=deadline_s)
        except Exception as e:
            fut.set_exception(e)
            return
        if req.outcome.terminal:
            fut.set_result(req)
        else:
            self._waiting[req.rid] = (req, fut)

    def _resolve_terminal(self) -> None:
        done = [rid for rid, (req, _) in self._waiting.items()
                if req.outcome.terminal]
        for rid in done:
            req, fut = self._waiting.pop(rid)
            fut.set_result(req)

    def _fail_waiting(self, why: str) -> None:
        for _, fut in self._waiting.values():
            if not fut.done():
                fut.set_exception(RuntimeError(why))
        self._waiting.clear()


# ---------------------------------------------------------------------------
# HTTP/1.1 framing (stdlib asyncio streams; no new deps)
# ---------------------------------------------------------------------------

async def _read_http_message(reader: asyncio.StreamReader,
                             max_body: int):
    """One request or response off the stream:
    ``(start_line_parts, headers, body)``; ``None`` on clean EOF.
    Raises ``PayloadTooLarge`` *before* reading an oversized body."""
    line = await reader.readline()
    if not line:
        return None
    parts = line.decode("latin-1").split()
    if len(parts) < 2:
        raise ValueError(f"malformed HTTP start line: {line!r}")
    headers: Dict[str, str] = {}
    while True:
        h = await reader.readline()
        if h in (b"\r\n", b"\n", b""):
            break
        k, _, v = h.decode("latin-1").partition(":")
        headers[k.strip().lower()] = v.strip()
        if len(headers) > MAX_HEADERS:
            raise ValueError("too many HTTP headers")
    length = int(headers.get("content-length", "0") or "0")
    if length > max_body:
        raise PayloadTooLarge(
            f"declared body of {length} bytes exceeds the "
            f"{max_body}-byte cap")
    body = await reader.readexactly(length) if length > 0 else b""
    return parts, headers, body


def _http_response(status: int, payload,
                   content_type: str = "application/json",
                   extra_headers: Optional[Dict[str, str]] = None,
                   close: bool = False) -> bytes:
    if isinstance(payload, (dict, list)):
        body = json.dumps(payload).encode("utf-8")
    elif isinstance(payload, str):
        body = payload.encode("utf-8")
    else:
        body = bytes(payload)
    lines = [f"HTTP/1.1 {status} {_REASONS.get(status, 'Unknown')}",
             f"Content-Type: {content_type}",
             f"Content-Length: {len(body)}",
             f"Connection: {'close' if close else 'keep-alive'}"]
    for k, v in (extra_headers or {}).items():
        lines.append(f"{k}: {v}")
    return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1") + body


class HttpClient:
    """A keep-alive JSON client on one asyncio connection — the load
    generator runs one per virtual user, the router one per call."""

    def __init__(self, host: str, port: int):
        self.host = host
        self.port = int(port)
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None

    async def _connect(self) -> None:
        self._reader, self._writer = await asyncio.open_connection(
            self.host, self.port)

    async def request(self, method: str, path: str, payload=None,
                      headers: Optional[Dict[str, str]] = None,
                      max_body: int = MAX_BODY_BYTES):
        """Returns ``(status, parsed_json_or_text)``; reconnects once on
        a dropped keep-alive connection."""
        body = (json.dumps(payload).encode("utf-8")
                if payload is not None else b"")
        head = [f"{method} {path} HTTP/1.1",
                f"Host: {self.host}:{self.port}",
                f"Content-Length: {len(body)}",
                "Content-Type: application/json"]
        for k, v in (headers or {}).items():
            head.append(f"{k}: {v}")
        raw = ("\r\n".join(head) + "\r\n\r\n").encode("latin-1") + body
        for attempt in (0, 1):
            if self._writer is None:
                await self._connect()
            try:
                assert self._writer is not None and self._reader is not None
                self._writer.write(raw)
                await self._writer.drain()
                msg = await _read_http_message(self._reader, max_body)
                if msg is None:
                    raise ConnectionError("server closed the connection")
                break
            except (ConnectionError, asyncio.IncompleteReadError, OSError):
                await self.close()
                if attempt:
                    raise
        parts, resp_headers, resp_body = msg
        status = int(parts[1])
        if resp_headers.get("connection", "").lower() == "close":
            await self.close()
        ctype = resp_headers.get("content-type", "")
        if ctype.startswith("application/json"):
            return status, json.loads(resp_body.decode("utf-8"))
        return status, resp_body.decode("utf-8", "replace")

    async def close(self) -> None:
        if self._writer is not None:
            try:
                self._writer.close()
                await self._writer.wait_closed()
            except (ConnectionError, OSError):
                pass
        self._reader = self._writer = None


async def http_json(host: str, port: int, method: str, path: str,
                    payload=None, headers: Optional[Dict[str, str]] = None):
    """One-shot request on a fresh connection (the router's remote-worker
    calls and the launcher's probes)."""
    client = HttpClient(host, port)
    try:
        return await client.request(method, path, payload, headers)
    finally:
        await client.close()


# ---------------------------------------------------------------------------
# the server
# ---------------------------------------------------------------------------

class TransportServer:
    """The asyncio HTTP front-end over a ``serve/router.py:Router``.

    One connection-handler coroutine per client with keep-alive, a
    body-size cap answered 413 before the body is read, per-endpoint
    request counters in ``registry``, one transport span per request in
    ``tracer``, and an optional append-only access log.  ``guard`` is a
    ``PreemptionGuard`` (anything with ``.requested``): once it trips,
    new ``/v1/infer`` requests are refused 503 and ``/healthz`` reports
    draining, while responses already in flight complete — the graceful
    SIGTERM drain, visible from the wire.
    """

    def __init__(self, router, *, host: str = "127.0.0.1", port: int = 0,
                 registry=None, tracer=None, guard=None,
                 max_body: int = MAX_BODY_BYTES,
                 access_log: Optional[str] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.router = router
        self.host = host
        self.port = int(port)          # rebound to the OS pick on start
        self.registry = registry
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.guard = guard
        self.max_body = int(max_body)
        self.clock = clock
        self._access_path = access_log
        self._access_fh = None
        self._server: Optional[asyncio.base_events.Server] = None
        self._probe_task: Optional[asyncio.Task] = None

    # -- lifecycle ---------------------------------------------------------
    @property
    def draining(self) -> bool:
        return bool(self.guard is not None
                    and getattr(self.guard, "requested", False))

    async def start(self, probe_interval_s: float = 0.0) -> int:
        if self._access_path:
            self._access_fh = open(self._access_path, "a", buffering=1)
        self._server = await asyncio.start_server(
            self._handle_conn, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        if probe_interval_s > 0:
            self._probe_task = asyncio.ensure_future(
                self._probe_loop(probe_interval_s))
        return self.port

    async def shutdown(self) -> None:
        """Stop accepting; in-flight handler coroutines finish on their
        own (worker drain is the caller's job — ``launch/server.py``)."""
        if self._probe_task is not None:
            self._probe_task.cancel()
            self._probe_task = None
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None
        if self._access_fh is not None:
            self._access_fh.close()
            self._access_fh = None

    async def _probe_loop(self, interval_s: float) -> None:
        while True:
            await asyncio.sleep(interval_s)
            try:
                await self.router.probe()
            except Exception:       # a failed probe must not kill serving
                pass

    # -- observability -----------------------------------------------------
    def _observe(self, endpoint: str, status: int, t0: float,
                 **span_args) -> None:
        dur = self.clock() - t0
        if self.registry is not None:
            self.registry.counter(
                "transport_requests_total",
                "Wire requests by endpoint and status",
                endpoint=endpoint, status=str(status)).inc()
            self.registry.histogram(
                "transport_request_seconds",
                "Wire request handling time",
                endpoint=endpoint).record(dur)
        if self.tracer.enabled:
            self.tracer.add_span(endpoint, "transport", TID_TRANSPORT,
                                 t0, dur, status=status, **span_args)
        if self._access_fh is not None:
            self._access_fh.write(
                f"{time.time():.3f} {endpoint} {status} "
                f"{dur * 1e3:.2f}ms\n")

    # -- connection handling -----------------------------------------------
    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        try:
            while True:
                t0 = self.clock()
                try:
                    msg = await _read_http_message(reader, self.max_body)
                except PayloadTooLarge as e:
                    # the body was never read: answer and drop the
                    # connection rather than resynchronize mid-stream
                    writer.write(_http_response(
                        413, {"outcome": "bad_request", "error": str(e)},
                        close=True))
                    await writer.drain()
                    self._observe("payload-too-large", 413, t0)
                    break
                except (ValueError, asyncio.IncompleteReadError):
                    break            # malformed framing: drop quietly
                if msg is None:
                    break            # client closed between requests
                parts, headers, body = msg
                method, target = parts[0], parts[1]
                path = target.split("?", 1)[0]
                endpoint = f"{method} {path}"
                status, payload, extra, ctype = await self._route(
                    method, path, headers, body)
                close = (headers.get("connection", "").lower() == "close"
                         or status in (413, 503))
                writer.write(_http_response(
                    status, payload, content_type=ctype,
                    extra_headers=extra, close=close))
                await writer.drain()
                self._observe(endpoint, status, t0)
                if close:
                    break
        except (ConnectionError, OSError):
            pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    # -- routing -----------------------------------------------------------
    async def _route(self, method: str, path: str,
                     headers: Dict[str, str], body: bytes):
        """(status, payload, extra_headers, content_type) per endpoint."""
        json_t = "application/json"
        if path == "/healthz":
            if self.draining:
                return 503, {"status": "draining"}, None, json_t
            return 200, {"status": "ok",
                         "workers": self.router.worker_names(),
                         "quarantined": self.router.quarantined()}, \
                None, json_t
        if path == "/metrics":
            text = await self._metrics_text()
            return 200, text, None, "text/plain; version=0.0.4"
        if path == "/metrics.json":
            return 200, await self._metrics_snapshot(), None, json_t
        if path == "/stats":
            return 200, await self.router.stats(), None, json_t
        if path == "/v1/infer":
            if method != "POST":
                return 405, {"error": f"{method} not allowed; POST"}, \
                    None, json_t
            return await self._infer(headers, body) + (json_t,)
        return 404, {"error": f"no such endpoint {path!r}"}, None, json_t

    async def _infer(self, headers: Dict[str, str], body: bytes):
        from repro_torch.serve.router import NoWorkersAvailable
        if self.draining:
            return 503, {"outcome": "draining",
                         "error": "server is draining (preemption "
                                  "requested); refusing new requests"}, \
                None
        try:
            images, deadline_s = decode_infer_body(body)
            hdr = headers.get("x-deadline-s")
            if hdr is not None:        # the header wins over the body
                try:
                    deadline_s = float(hdr)
                except ValueError as e:
                    raise BadRequestError(
                        f"X-Deadline-S header {hdr!r} is not a "
                        "number") from e
            res = await self.router.infer(images, deadline_s)
        except BadRequestError as e:
            return 400, {"outcome": "bad_request", "error": str(e)}, None
        except NoWorkersAvailable as e:
            return 503, {"outcome": "unavailable", "error": str(e)}, None
        return res.status, res.body(), res.headers()

    # -- metrics endpoints -------------------------------------------------
    async def _sync_engines(self):
        from repro_torch.obs.metrics import MetricsRegistry
        reg = self.registry if self.registry is not None else \
            MetricsRegistry(max_series=2048)
        await self.router.sync_registry(reg)
        return reg

    async def _metrics_text(self) -> str:
        reg = await self._sync_engines()
        return reg.to_prometheus()

    async def _metrics_snapshot(self) -> dict:
        reg = await self._sync_engines()
        return reg.snapshot()
