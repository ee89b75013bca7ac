"""The port's HTTP serving front-end (``serve/transport.py``,
``serve/router.py``, ``launch/server.py``) against the JAX package's:
the counterpart of every test of ``tests/test_transport.py`` but the
three that drive ``benchmarks/`` (the load generator and the ``check_bench``
scopes, which wait for their port), on ``device="cpu"``,
``policy="reference"``, at reduced width.  Added: the wire format is the
JAX package's byte for byte (payload codec, outcome -> status map and body
keys, a JAX-package client against a port server), a ``spawn_worker``
subprocess that serves and drains on SIGTERM with exit 0, and the launcher
refusing to start on ``--device cuda`` without a GPU."""
import asyncio
import base64
import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.serve import transport as j_transport  # noqa: E402
from repro.serve.batcher import ImageRequest as JImageRequest  # noqa: E402
from repro.serve.batcher import RequestOutcome as JOutcome  # noqa: E402
from repro_torch.launch.server import start_server  # noqa: E402
from repro_torch.serve import transport as t_transport  # noqa: E402
from repro_torch.serve.admission import BadRequestError  # noqa: E402
from repro_torch.serve.batcher import ImageRequest as TImageRequest  # noqa: E402,E501
from repro_torch.serve.batcher import RequestOutcome as TOutcome  # noqa: E402
from repro_torch.serve.router import (NoWorkersAvailable, Router,  # noqa: E402
                                      WorkerUnavailable, spawn_worker)
from repro_torch.serve.transport import (InferResult,  # noqa: E402
                                         decode_infer_body,
                                         encode_images_payload, http_json)

IMG = 32
BUCKETS = (1, 2, 4)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class FakeGuard:
    requested = False


@pytest.fixture(scope="module")
def served():
    guard = FakeGuard()
    handle = start_server("vgg16", n_workers=2, policy="reference",
                          img=IMG, width_mult=0.0625, buckets=BUCKETS,
                          guard=guard, device="cpu")
    handle.test_guard = guard
    yield handle
    handle.stop()


def http(handle, method, path, payload=None, headers=None):
    return asyncio.run(http_json(handle.host, handle.port, method, path,
                                 payload, headers))


def images(n, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (n, 3, IMG, IMG)).astype(np.float32)


def engines(handle):
    return [w.worker.engine for w in handle.workers]


def submitted_total(handle):
    return sum(e.metrics.submitted for e in engines(handle))


# ---------------------------------------------------------------------------
# payload codec
# ---------------------------------------------------------------------------

def test_b64_payload_roundtrips_bitwise():
    x = images(3, seed=7)
    arr, deadline = decode_infer_body(
        json.dumps(encode_images_payload(x, 2.5)).encode())
    assert deadline == 2.5
    assert arr.dtype == np.float32
    np.testing.assert_array_equal(arr, x)


@pytest.mark.parametrize("body", [
    b"{not json",                                   # malformed JSON
    b"[1, 2, 3]",                                   # not an object
    b'{"deadline_s": "soon", "images": [1]}',       # non-numeric deadline
    b'{"shape": [1], "data_b64": "!!!"}',           # undecodable base64
    b'{"images": [["a"]]}',                         # non-numeric images
    b'{"nothing": 1}',                              # no payload at all
])
def test_decode_rejects_malformed_bodies(body):
    with pytest.raises(BadRequestError):
        decode_infer_body(body)


# ---------------------------------------------------------------------------
# the wire format is the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("deadline", [None, 2.5])
def test_wire_codec_matches_reference_package(deadline):
    """The same images encode to the same JSON bytes in both packages, and
    the same bodies (b64 and nested lists) decode to the same arrays."""
    x = images(2, seed=11)
    got = json.dumps(encode_images_payload(x, deadline)).encode()
    want = json.dumps(j_transport.encode_images_payload(x, deadline)).encode()
    assert got == want
    for body in (got, json.dumps({"images": x.tolist(),
                                  "deadline_s": deadline}).encode()):
        arr, dl = decode_infer_body(body)
        jarr, jdl = j_transport.decode_infer_body(body)
        assert dl == jdl and arr.dtype == jarr.dtype
        np.testing.assert_array_equal(arr, jarr)
    assert t_transport.OUTCOME_STATUS == j_transport.OUTCOME_STATUS
    assert t_transport._REASONS == j_transport._REASONS
    assert t_transport.MAX_BODY_BYTES == j_transport.MAX_BODY_BYTES


@pytest.mark.parametrize("outcome", [o.value for o in TOutcome
                                     if o.terminal])
def test_outcome_maps_to_reference_status_and_body(outcome):
    """Each terminal ``RequestOutcome`` gives the same status, headers and
    response body (keys and values) in both packages."""
    def finished(cls, outcome_cls):
        req = cls(rid=5, images=images(1, seed=2), t_submit=1.0)
        req.predicted_wait_s = 1.25
        logits = np.arange(10, dtype=np.float32)[None] / 7
        if outcome == "ok":
            req.logits = logits
            req.served_by = "primary"
        req.finish(outcome_cls(outcome), t=1.5,
                   error=None if outcome == "ok" else "why")
        return req

    got = t_transport.result_from_request(
        finished(TImageRequest, TOutcome), worker="w0")
    want = j_transport.result_from_request(
        finished(JImageRequest, JOutcome), worker="w0")
    assert got.status == want.status
    assert got.headers() == want.headers()
    assert json.dumps(got.body(), sort_keys=True) == \
        json.dumps(want.body(), sort_keys=True)
    back = t_transport.result_from_response(want.status, want.body(), "w1")
    jback = j_transport.result_from_response(want.status, want.body(), "w1")
    assert back.body() == jback.body() and back.status == jback.status


def test_reference_client_talks_to_port_server(served):
    """A client of the JAX package (its ``http_json`` and payload codec)
    gets from the port's server what the port's own client gets."""
    x = images(2, seed=12)
    status, obj = asyncio.run(j_transport.http_json(
        served.host, served.port, "POST", "/v1/infer",
        j_transport.encode_images_payload(x)))
    assert status == 200 and obj["outcome"] == "ok"
    worker = {w.name: w for w in served.workers}[obj["worker"]].worker
    direct = worker.submit(x).result(60.0)
    np.testing.assert_array_equal(np.asarray(obj["logits"], np.float32),
                                  direct.logits)
    status, obj = asyncio.run(j_transport.http_json(
        served.host, served.port, "GET", "/healthz"))
    assert status == 200 and obj["status"] == "ok"


# ---------------------------------------------------------------------------
# the wire contract
# ---------------------------------------------------------------------------

def test_served_logits_bitwise_equal_direct_engine(served):
    """HTTP serving is the engine, observed through a lossless wire:
    logits match a direct ``VisionEngine`` submission bit for bit."""
    x = images(2, seed=3)
    status, obj = http(served, "POST", "/v1/infer",
                       encode_images_payload(x))
    assert status == 200 and obj["outcome"] == "ok"
    assert obj["served_by"] == "primary"
    wire = np.asarray(obj["logits"], np.float32)
    worker = {w.name: w for w in served.workers}[obj["worker"]].worker
    direct = worker.submit(x).result(60.0)
    assert direct.outcome.value == "ok"
    np.testing.assert_array_equal(wire, direct.logits)


def test_nested_list_images_accepted(served):
    x = images(1, seed=4)
    status, obj = http(served, "POST", "/v1/infer",
                       {"images": x.tolist()})
    assert status == 200 and obj["outcome"] == "ok"
    assert np.asarray(obj["logits"], np.float32).shape == (1, 10)


def test_malformed_body_400_without_engine_submit(served):
    before = submitted_total(served)
    status, obj = http(served, "POST", "/v1/infer", None)  # empty body
    assert status == 400 and obj["outcome"] == "bad_request"

    async def raw_garbage():
        reader, writer = await asyncio.open_connection(served.host,
                                                       served.port)
        body = b"{definitely not json"
        writer.write(b"POST /v1/infer HTTP/1.1\r\n"
                     b"Content-Length: %d\r\n\r\n%s" % (len(body), body))
        await writer.drain()
        line = await reader.readline()
        writer.close()
        return int(line.split()[1])

    assert asyncio.run(raw_garbage()) == 400
    # a garbage body never became a request: no engine saw a submit
    assert submitted_total(served) == before
    # an image of the wrong layout (NHWC) is refused by validation
    status, obj = http(served, "POST", "/v1/infer",
                       encode_images_payload(np.zeros((1, IMG, IMG, 3),
                                                      np.float32)))
    assert status == 400 and obj["outcome"] == "bad_request"


def test_oversized_payload_413_before_body_read(served):
    """A huge declared Content-Length is answered from the headers
    alone — the server never reads (or allocates for) the body."""

    async def oversized():
        reader, writer = await asyncio.open_connection(served.host,
                                                       served.port)
        writer.write(b"POST /v1/infer HTTP/1.1\r\n"
                     b"Content-Length: 999999999\r\n\r\n")
        await writer.drain()
        line = await reader.readline()
        writer.close()
        return int(line.split()[1])

    before = submitted_total(served)
    assert asyncio.run(oversized()) == 413
    assert submitted_total(served) == before


def test_deadline_header_propagates_to_engine_submit(served):
    """``X-Deadline-S`` reaches ``engine.submit(deadline_s=...)`` and
    wins over the body's ``deadline_s``."""
    seen = []
    originals = [(e, e.submit) for e in engines(served)]
    for eng, orig in originals:
        def recorder(images, deadline_s=None, _orig=orig):
            seen.append(deadline_s)
            return _orig(images, deadline_s=deadline_s)
        eng.submit = recorder
    try:
        payload = encode_images_payload(images(1, seed=5), deadline_s=1.0)
        status, obj = http(served, "POST", "/v1/infer", payload,
                           headers={"X-Deadline-S": "30.0"})
    finally:
        for eng, orig in originals:
            eng.submit = orig
    assert status == 200 and obj["outcome"] == "ok"
    assert seen == [30.0]

    status, obj = http(served, "POST", "/v1/infer",
                       encode_images_payload(images(1, seed=5)),
                       headers={"X-Deadline-S": "not-a-number"})
    assert status == 400 and obj["outcome"] == "bad_request"


def test_sigterm_drain_completes_inflight_refuses_new(served):
    """The preemption discipline over the wire: once the guard trips,
    new requests get 503 and healthz reports draining, while a request
    accepted before the trip still completes 200."""
    gates = []
    for w in served.workers:
        gate = threading.Event()        # unset: the worker loop idles
        w.worker.gate = gate
        gates.append(gate)
    results = []
    t = threading.Thread(target=lambda: results.append(
        http(served, "POST", "/v1/infer",
             encode_images_payload(images(1, seed=6)))))
    try:
        t.start()
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline and \
                sum(w.worker.inflight for w in served.workers) == 0:
            time.sleep(0.005)
        assert sum(w.worker.inflight for w in served.workers) == 1
        served.test_guard.requested = True
        status, obj = http(served, "POST", "/v1/infer",
                           encode_images_payload(images(1, seed=6)))
        assert status == 503 and obj["outcome"] == "draining"
        status, obj = http(served, "GET", "/healthz")
        assert status == 503 and obj["status"] == "draining"
    finally:
        for gate in gates:
            gate.set()                  # release the drain
        t.join(60.0)
        served.test_guard.requested = False
        for w in served.workers:
            w.worker.gate = None
    assert not t.is_alive()
    status, obj = results[0]
    assert status == 200 and obj["outcome"] == "ok"


def test_metrics_and_stats_endpoints(served):
    status, text = http(served, "GET", "/metrics")
    assert status == 200
    assert "transport_requests_total" in text
    assert 'worker="w0"' in text        # per-worker engine series

    from repro_torch.obs.metrics import validate_metrics_snapshot
    status, snap = http(served, "GET", "/metrics.json")
    assert status == 200 and validate_metrics_snapshot(snap) == []

    status, stats = http(served, "GET", "/stats")
    assert status == 200
    assert stats["totals"]["lost_requests"] == 0
    assert set(stats["workers"]) == {"w0", "w1"}


def test_unknown_route_404_and_method_405(served):
    assert http(served, "GET", "/nope")[0] == 404
    assert http(served, "GET", "/v1/infer")[0] == 405


# ---------------------------------------------------------------------------
# router: dispatch, failover, quarantine
# ---------------------------------------------------------------------------

class FakeWorker:
    remote = False

    def __init__(self, name, fail=False, healthy_after=False,
                 service_s=0.0):
        self.name = name
        self.fail = fail
        self.healthy_after = healthy_after
        self.service_s = service_s
        self.inflight = 0
        self.served = 0

    async def infer(self, images, deadline_s):
        if self.fail:
            raise WorkerUnavailable(f"{self.name} is down")
        self.served += 1
        return InferResult(outcome="ok", status=200,
                           logits=np.zeros((1, 10), np.float32),
                           worker=self.name)

    async def stats(self):
        return {"robustness": {"lost_requests": 0}}

    async def sync_registry(self, registry):
        pass

    async def healthy(self):
        return self.healthy_after


def test_router_failover_on_transport_error_only():
    bad = FakeWorker("bad", fail=True)
    good = FakeWorker("good")
    router = Router([bad, good], BUCKETS, quarantine_after=2)
    for b in BUCKETS:                   # make the dead worker the pick
        router._note_success("good", b, 1.0)
    res = asyncio.run(router.infer(np.zeros((1, 3, IMG, IMG),
                                            np.float32)))
    assert res.worker == "good" and res.status == 200
    assert router._failures["bad"] == 1 and not router.quarantined()
    assert router._failovers == 1


def test_router_quarantine_and_probe_revival():
    bad = FakeWorker("bad", fail=True, healthy_after=True)
    good = FakeWorker("good")
    router = Router([bad, good], BUCKETS, quarantine_after=2)
    x = np.zeros((1, 3, IMG, IMG), np.float32)
    for _ in range(4):
        assert asyncio.run(router.infer(x)).worker == "good"
    # two consecutive transport failures benched the bad worker: it no
    # longer even gets picked (failures stop accumulating)
    assert router.quarantined() == ["bad"]
    fails_frozen = router._failures["bad"]
    asyncio.run(router.infer(x))
    assert router._failures["bad"] == fails_frozen
    # a passing healthz probe un-benches it
    bad.fail = False
    assert asyncio.run(router.probe()) == ["bad"]
    assert router.quarantined() == []


def test_router_all_down_raises_no_workers():
    bad = FakeWorker("bad", fail=True)
    router = Router([bad], BUCKETS, quarantine_after=1)
    x = np.zeros((1, 3, IMG, IMG), np.float32)
    with pytest.raises(NoWorkersAvailable):
        asyncio.run(router.infer(x))
    with pytest.raises(NoWorkersAvailable):
        asyncio.run(router.infer(x))    # quarantined: refused immediately


def test_router_pick_prefers_fast_idle_worker():
    slow = FakeWorker("slow")
    fast = FakeWorker("fast")
    router = Router([slow, fast], BUCKETS)
    for bucket in BUCKETS:
        router._note_success("slow", bucket, 0.1)
        router._note_success("fast", bucket, 0.01)
    assert router._pick(1, frozenset()).name == "fast"
    # queue depth overrides raw speed once the fast worker backs up:
    # 64 queued images = 16 widest-bucket batches ahead of us, so the
    # predicted wait (16 * 0.01 + 0.01) now exceeds slow's idle 0.1
    fast.inflight = 64
    assert router._pick(1, frozenset()).name == "slow"


def test_router_failed_outcome_does_not_failover():
    """An engine-level ``failed`` outcome is terminal — rerouting it
    would double-serve a poison request through another replica."""

    class FailedOutcomeWorker(FakeWorker):
        async def infer(self, images, deadline_s):
            self.served += 1
            return InferResult(outcome="failed", status=500,
                               error="quarantined by the ladder",
                               worker=self.name)

    poison = FailedOutcomeWorker("poison")
    spare = FakeWorker("spare")
    router = Router([poison, spare], BUCKETS)
    for b in BUCKETS:                   # make poison the pick
        router._note_success("spare", b, 1.0)
    res = asyncio.run(router.infer(np.zeros((1, 3, IMG, IMG),
                                            np.float32)))
    assert res.status == 500 and res.worker == "poison"
    assert spare.served == 0 and router._failovers == 0


# ---------------------------------------------------------------------------
# subprocess workers and the launcher
# ---------------------------------------------------------------------------

async def _drain_probe(host, port):
    """Two keep-alive connections opened before the worker's SIGTERM: poll
    /healthz on one until it reports draining, then POST on the other.
    The server finishes its shutdown only when its connections close, so
    both are answered."""
    health = t_transport.HttpClient(host, port)
    infer = t_transport.HttpClient(host, port)
    try:
        assert (await health.request("GET", "/healthz"))[0] == 200
        assert (await infer.request("GET", "/healthz"))[0] == 200
        yield
        deadline = time.monotonic() + 30.0
        while True:
            status, obj = await health.request("GET", "/healthz")
            if status == 503 or time.monotonic() > deadline:
                break
            await asyncio.sleep(0.01)
        yield status, obj
        yield await infer.request(
            "POST", "/v1/infer", encode_images_payload(images(1, seed=9)))
    finally:
        await health.close()
        await infer.close()


def sigterm_drain(proc, host, port):
    """SIGTERM ``proc`` with two connections open; returns the /healthz
    and /v1/infer answers during its drain."""
    async def run():
        probe = _drain_probe(host, port)
        await probe.__anext__()
        proc.send_signal(signal.SIGTERM)
        health = await probe.__anext__()
        infer = await probe.__anext__()
        await probe.aclose()
        return health, infer
    return asyncio.run(run())


def test_spawn_worker_serves_and_drains_on_sigterm():
    """``spawn_worker`` boots ``python -m repro_torch.launch.server`` on
    the CPU, serves a request through the router (bitwise the logits of
    an in-process engine on the same seed), and on SIGTERM refuses new
    work with 503 while draining, then exits 0."""
    tail = ["--model", "vgg16", "--device", "cpu", "--policy", "reference",
            "--img", str(IMG), "--buckets", "1,2"]
    worker = spawn_worker("w0", tail, timeout_s=120.0)
    try:
        router = Router([worker], (1, 2))
        x = images(2, seed=8)
        res = asyncio.run(router.infer(x))
        assert res.status == 200 and res.outcome == "ok"
        guard = FakeGuard()
        local = start_server("vgg16", n_workers=1, policy="reference",
                             img=IMG, buckets=(1, 2), guard=guard,
                             device="cpu")
        try:
            want = local.workers[0].worker.submit(x).result(60.0).logits
        finally:
            local.stop()
        np.testing.assert_array_equal(res.logits, want)
        (h_status, h_obj), (i_status, i_obj) = sigterm_drain(
            worker.proc, worker.host, worker.port)
        assert h_status == 503 and h_obj["status"] == "draining"
        assert i_status == 503 and i_obj["outcome"] == "draining"
        out, _ = worker.proc.communicate(timeout=60)
        assert worker.proc.returncode == 0
        assert "# drained cleanly" in out
    finally:
        if worker.proc.poll() is None:
            worker.proc.kill()
            worker.proc.wait()


def test_launcher_without_a_gpu_exits_nonzero_before_listening():
    """``--device cuda`` (the default) with no GPU raises before the
    socket opens: a nonzero exit and no ``LISTENING`` line, which is what
    makes ``spawn_worker`` raise ``WorkerUnavailable``."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the launcher would serve")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.server", "--port", "0",
         "--buckets", "1"], capture_output=True, text=True, timeout=120,
        cwd=ROOT)
    assert proc.returncode != 0
    assert "LISTENING" not in proc.stdout
    assert "no CUDA device" in proc.stderr
    with pytest.raises(WorkerUnavailable):
        spawn_worker("w0", ["--buckets", "1"], timeout_s=120.0)
