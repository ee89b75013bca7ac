"""An open loop into an ``EngineWorker`` (``serve/transport.py``): a
generator thread submits each request due inside the window at its due
time, whatever the system does; those requests are waited for after the
close, a minute at most."""
import concurrent.futures
import threading
import time

import numpy as np

from portbench.lib.drive import DRAIN_S, FormHook, Served, Window, take


def drive(system, stream, pool, seconds, p, profiler=None):
    worker = system.worker()
    worker.start(warmup=False)
    count = int(np.searchsorted(stream.due_s, seconds))  # due ascending
    due_s = stream.due_s[:count]
    served, futures = [], []
    submitted = np.zeros(count)
    t0 = time.monotonic()
    t_end = t0 + seconds
    if profiler is not None:
        profiler.anchor(t0)

    def generate():
        for k in range(count):
            due = t0 + float(due_s[k])
            wait = due - time.monotonic()
            if wait > 0:
                time.sleep(wait)
            idx = stream.request(k)
            submitted[k] = time.monotonic()
            served.append(Served(idx=idx, due=due))
            futures.append(worker.submit(take(pool, idx)))

    try:
        with FormHook(system, t_end, None, profiler) as hook:
            gen = threading.Thread(target=generate, name="portbench-gen")
            gen.start()
            gen.join()
            concurrent.futures.wait(
                futures, timeout=max(0.0, t_end + DRAIN_S - time.monotonic()))
            drained_at = time.monotonic()
            # the profiler is stopped on the worker's thread, between
            # batches, or, where the window ended first, here
            worker.call(lambda _: hook.profiler and hook.profiler.stop()
                        ).result(timeout=DRAIN_S)
    finally:
        worker.stop(drain=False, timeout=DRAIN_S)
    for s, fut in zip(served, futures):
        if not fut.done():
            s.error = "no answer a minute after the window closed"
        elif fut.exception() is not None:
            s.error = repr(fut.exception())
        else:
            s.req = fut.result()
    return Window(t0=t0, t_end=t_end, served=served,
                  counters=hook.at_close or system.counters(),
                  profiled=hook.profiled, drained_at=drained_at,
                  lateness_s=submitted - (t0 + due_s))
