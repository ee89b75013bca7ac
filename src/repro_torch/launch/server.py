"""HTTP serving launcher: N ``VisionEngine`` replicas behind the asyncio
front-end (``serve/transport.py``) and the SLO-aware router
(``serve/router.py``); the counterpart of the JAX package's
``launch/server.py``.

    # a CPU check: 2 in-process replicas of the reduced-width vgg16
    python -m repro_torch.launch.server --workers 2 --device cpu

    # on the card, full width, one subprocess per worker
    python -m repro_torch.launch.server --model mobilenetv2 --width 1.0 \\
        --workers 2 --spawn

    curl -s localhost:8080/healthz
    curl -s -XPOST localhost:8080/v1/infer -d '{"images": [[[[...]]]]}'

Images are ``(n, 3, img, img)``.  On boot the launcher prints ``LISTENING
<port>`` on stdout (the readiness line ``spawn_worker`` waits for).
In-process workers share one ``ScheduleCache`` and are warmed up one
after another on the calling thread (every bucket's CUDA graph captured)
before any worker thread starts and before the socket opens, so no
capture ever runs beside another thread's launches and the first wire
request hits steady-state forwards.  Without a GPU, ``--device cuda``
(the default) raises before ``LISTENING``: the process exits nonzero.

``--policy`` is the port's execution policy (``auto`` / ``kernel``: the
fold kernels; ``reference``: the plain-torch direct conv), ``--device``
where the engines run, ``--dtype`` the parameters' type (``bf16`` serves
a bf16 network: images are rounded to bf16 on the device, logits come
back widened to fp32), and ``--seed`` seeds the ``torch.Generator`` of
the random weights.

Shutdown is the preemption drain: SIGTERM/SIGINT trips a
``PreemptionGuard``, new ``/v1/infer`` requests are refused 503 while
everything in flight completes, worker threads drain, spawned workers get
SIGTERM in turn, the obs artifacts (``--trace`` / ``--metrics-json``)
still emit, and the process exits 0.
"""
from __future__ import annotations

import argparse
import asyncio
import dataclasses
import json
import threading
import time
from typing import List, Optional, Sequence

from repro_torch.core.engine import POLICIES

__all__ = ["ServerHandle", "start_server", "build_workers", "main",
           "DTYPES"]

DTYPES = ("fp32", "bf16")


def build_workers(model: str, n: int, *, img: int = 32,
                  width_mult: float = 0.0625, classes: int = 10,
                  policy: str = "auto",
                  buckets: Sequence[int] = (1, 2, 4, 8),
                  precision: str = "fp32", seed: int = 0,
                  tracer=None, warmup: bool = True, device="cuda",
                  dtype: str = "fp32"):
    """N in-process replicas: one ``VisionEngine`` + ``EngineWorker``
    thread each, all compiling over ONE shared ``ScheduleCache`` (the
    second replica's planning is pure cache hits), on the same random
    weights (a ``torch.Generator`` seeded with ``seed``).  Every engine is
    warmed up on the calling thread before any worker thread starts."""
    import torch

    from repro_torch.core.engine import ScheduleCache, resolve_execution
    from repro_torch.models.zoo import get_conv_model
    from repro_torch.serve.router import LocalWorker
    from repro_torch.serve.transport import EngineWorker
    from repro_torch.serve.vision import VisionEngine

    if dtype not in DTYPES:
        raise ValueError(f"dtype must be one of {DTYPES}, got {dtype!r}")
    if dtype != "fp32" and precision != "fp32":
        raise ValueError(f"precision={precision!r} quantizes fp32 "
                         f"parameters; dtype={dtype!r} is not servable so")
    _, dev = resolve_execution(policy, device)     # raises without a GPU
    spec = get_conv_model(model)
    gen = torch.Generator(device=dev if dev.type == "cuda" else "cpu")
    params = spec.init_params(
        gen.manual_seed(seed), width_mult=width_mult, img=img,
        classes=classes, device=dev,
        dtype=torch.bfloat16 if dtype == "bf16" else torch.float32)
    graph = spec.to_graph()
    cache = ScheduleCache()
    workers = []
    for i in range(n):
        engine = VisionEngine(params, graph, img=img, policy=policy,
                              buckets=tuple(buckets), cache=cache,
                              tracer=tracer if i == 0 else None,
                              precision=precision, device=dev)
        if warmup:
            engine.warmup()
        workers.append(EngineWorker(f"w{i}", engine))
    return [LocalWorker(w.name, w.start(warmup=False)) for w in workers]


@dataclasses.dataclass
class ServerHandle:
    """A running server: the asyncio loop lives on a daemon thread, so
    tests and scripts drive it from plain sync code."""
    host: str
    port: int
    server: object            # serve/transport.py:TransportServer
    router: object            # serve/router.py:Router
    workers: list             # LocalWorker / RemoteWorker
    loop: asyncio.AbstractEventLoop
    thread: threading.Thread
    guard: object = None
    tracer: object = None

    def run(self, coro, timeout: float = 120.0):
        """Run a coroutine on the server loop from sync code."""
        return asyncio.run_coroutine_threadsafe(
            coro, self.loop).result(timeout)

    def stop(self, drain: bool = True) -> None:
        """Stop accepting, drain every worker, tear the loop down."""
        self.run(self.server.shutdown())
        for w in self.workers:
            if hasattr(w, "worker"):            # local: drain the thread
                w.worker.stop(drain=drain)
            elif hasattr(w, "terminate"):       # remote: SIGTERM drain
                w.terminate()
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(30.0)


def start_server(model: str = "vgg16", *, host: str = "127.0.0.1",
                 port: int = 0, n_workers: int = 1, spawn: bool = False,
                 img: int = 32, width_mult: float = 0.0625,
                 classes: int = 10, policy: str = "auto",
                 buckets: Sequence[int] = (1, 2, 4, 8),
                 precision: str = "fp32", seed: int = 0,
                 guard=None, tracer=None, registry=None,
                 access_log: Optional[str] = None,
                 probe_interval_s: float = 0.0,
                 workers=None, device="cuda",
                 dtype: str = "fp32") -> ServerHandle:
    """Boot the serving tier and return a live ``ServerHandle``.

    ``workers`` overrides construction entirely (tests inject fakes);
    ``spawn`` builds subprocess replicas via ``spawn_worker`` (each given
    this call's ``device`` and ``dtype``) instead of in-process engine
    threads."""
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.serve.router import Router, spawn_worker
    from repro_torch.serve.transport import TransportServer

    if workers is None:
        if spawn:
            tail = ["--model", model, "--policy", policy,
                    "--img", str(img), "--width", str(width_mult),
                    "--classes", str(classes), "--precision", precision,
                    "--seed", str(seed), "--device", str(device),
                    "--dtype", dtype,
                    "--buckets", ",".join(str(b) for b in buckets)]
            workers = [spawn_worker(f"w{i}", tail)
                       for i in range(n_workers)]
        else:
            workers = build_workers(
                model, n_workers, img=img, width_mult=width_mult,
                classes=classes, policy=policy, buckets=buckets,
                precision=precision, seed=seed, tracer=tracer,
                device=device, dtype=dtype)
    router = Router(workers, buckets)
    if registry is None:
        registry = MetricsRegistry(max_series=2048)
    server = TransportServer(router, host=host, port=port,
                             registry=registry, tracer=tracer,
                             guard=guard, access_log=access_log)
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever,
                              name="transport-loop", daemon=True)
    thread.start()
    bound = asyncio.run_coroutine_threadsafe(
        server.start(probe_interval_s), loop).result(60.0)
    return ServerHandle(host=host, port=bound, server=server,
                        router=router, workers=workers, loop=loop,
                        thread=thread, guard=guard, tracer=tracer)


def _drain_and_exit(handle: ServerHandle, args) -> None:
    """The SIGTERM discipline: stop admitting (the guard already flips
    ``/v1/infer`` to 503), let in-flight work finish, then tear down."""
    deadline = time.monotonic() + args.drain_timeout_s
    while time.monotonic() < deadline:
        if all(w.inflight == 0 for w in handle.workers):
            break
        time.sleep(0.05)
    handle.stop(drain=True)
    if args.trace and handle.tracer is not None:
        handle.tracer.save(args.trace)
        print(f"# wrote Chrome trace ({len(handle.tracer.events)} "
              f"events) to {args.trace}")
    if args.metrics_json:
        snap = handle.server.registry.snapshot()
        with open(args.metrics_json, "w") as f:
            json.dump(snap, f, indent=1, sort_keys=True)
            f.write("\n")
        print(f"# wrote metrics snapshot to {args.metrics_json}")


def main(argv: Optional[Sequence[str]] = None) -> None:
    from repro_torch.models.zoo import conv_model_names
    ap = argparse.ArgumentParser(
        description="HTTP serving front-end over VisionEngine workers")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080,
                    help="0 = let the OS pick (printed as LISTENING)")
    ap.add_argument("--workers", type=int, default=1,
                    help="number of VisionEngine replicas")
    ap.add_argument("--spawn", action="store_true",
                    help="one subprocess per worker instead of in-process "
                         "engine threads")
    ap.add_argument("--model", default="vgg16",
                    choices=conv_model_names())
    ap.add_argument("--policy", choices=POLICIES, default="auto",
                    help="auto/kernel: the fold kernels; reference: the "
                         "plain-torch direct conv")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain-torch "
                         "versions)")
    ap.add_argument("--dtype", choices=DTYPES, default="fp32",
                    help="the parameters' type")
    ap.add_argument("--img", type=int, default=32)
    ap.add_argument("--width", type=float, default=0.0625)
    ap.add_argument("--classes", type=int, default=10)
    ap.add_argument("--buckets", default="1,2,4,8")
    ap.add_argument("--precision", default="fp32",
                    choices=["fp32", "int8"])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights")
    ap.add_argument("--probe-interval-s", type=float, default=2.0,
                    help="healthz-probe cadence for quarantined workers")
    ap.add_argument("--drain-timeout-s", type=float, default=60.0)
    ap.add_argument("--access-log", default="",
                    help="append one line per wire request here "
                         "(e.g. server_access.log)")
    ap.add_argument("--trace", default="", metavar="PATH",
                    help="write a Chrome trace with the transport track")
    ap.add_argument("--metrics-json", default="", metavar="PATH",
                    help="write the registry snapshot at shutdown")
    args = ap.parse_args(argv)

    from repro_torch.ft.fault_tolerance import PreemptionGuard

    buckets = tuple(int(b) for b in args.buckets.split(","))
    tracer = None
    if args.trace:
        from repro_torch.obs.trace import Tracer
        tracer = Tracer(time.monotonic)
    with PreemptionGuard() as guard:
        handle = start_server(
            args.model, host=args.host, port=args.port,
            n_workers=args.workers, spawn=args.spawn, img=args.img,
            width_mult=args.width, classes=args.classes, policy=args.policy,
            buckets=buckets, precision=args.precision, seed=args.seed,
            guard=guard, tracer=tracer,
            access_log=args.access_log or None,
            probe_interval_s=args.probe_interval_s, device=args.device,
            dtype=args.dtype)
        # the machine-readable readiness line (spawn_worker waits for it)
        print(f"LISTENING {handle.port}", flush=True)
        mode = "spawned subprocesses" if args.spawn else "in-process"
        print(f"# serving {args.model} on {args.host}:{handle.port} "
              f"with {args.workers} {mode} worker(s), policy={args.policy}, "
              f"device={args.device}, dtype={args.dtype}, "
              f"buckets={list(buckets)}", flush=True)
        while not guard.requested:
            time.sleep(0.1)
        print("# preemption requested: draining", flush=True)
        _drain_and_exit(handle, args)
    print("# drained cleanly", flush=True)


if __name__ == "__main__":
    main()
