"""A closed backlog into ``VisionEngine.submit`` + ``VisionEngine.run``
(the double-buffered feeder): before each batch is formed the backlog is
topped up to ``backlog_batches`` widest batches of images, until the
window closes; then the queue drains."""
import time

from portbench.lib.drive import FormHook, Served, Window, take


def drive(system, stream, pool, seconds, p, profiler=None):
    eng = system.engine
    served = []
    target = int(p["backlog_batches"]) * eng.batcher.policy.max_width
    k = 0

    def topup():
        nonlocal k
        while eng.batcher.pending_images < target:
            idx = stream.request(k)
            k += 1
            s = Served(idx=idx, due=time.monotonic())
            s.req = eng.submit(take(pool, idx))
            served.append(s)

    t0 = time.monotonic()
    t_end = t0 + seconds
    if profiler is not None:
        profiler.anchor(t0)
    with FormHook(system, t_end, topup, profiler) as hook:
        eng.run()
    return Window(t0=t0, t_end=t_end, served=served,
                  counters=hook.at_close or system.counters(),
                  profiled=hook.profiled, drained_at=time.monotonic())
