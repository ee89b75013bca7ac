"""Run one cell of ``BENCHMARK.json`` once and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout.  Set-up makes the weights and the image pool
on the card from the seed, builds the engine and warms up the
configuration's buckets; the window then runs the cell's traffic for
``--seconds``; after it the port's state is freed and every served
request is compared with the plain reference.  Earlier lines (standard
error) say what the run did; the last lines of standard error are the
numbers compared, each beside its limit; the last line of standard output
is the result, in JSON.  With ``--trace 1`` the metrics are the cell's
per-layer ones: the window runs untraced as in any run, then the profiler
starts and a short segment of the same traffic is traced; its requests are
checked too.  Exit codes: 0 with a result (whether or not it is correct);
3 without a card, or with fewer than the cell asks for; 4 where JAX or
the JAX package was loaded; any other error raises.
"""
import time

T_IMPORT = time.monotonic()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.lib.bench import Bench  # noqa: E402
from portbench.lib.guard import forbidden_modules  # noqa: E402

# the traced segment after the window: the profiler runs from TRACE_LEAD
# to TRACE_LEAD + TRACE_SECONDS of a segment TRACE_SEGMENT seconds long,
# or over TRACE_BATCHES batches where those come first
TRACE_LEAD, TRACE_SECONDS, TRACE_SEGMENT = 1.0, 2.0, 3.5
TRACE_BATCHES = 200


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def process_start() -> float:
    """When this process started, on ``time.monotonic``'s clock (from
    ``/proc``; this module's import where that cannot be read)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        age = time.clock_gettime(time.CLOCK_BOOTTIME) - \
            int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return time.monotonic() - age
    except (OSError, ValueError, IndexError):
        return T_IMPORT


def cell_traffic(bench: Bench, cell) -> dict:
    """The cell's traffic parameters: its mix with its own over them."""
    from portbench.lib import traffic
    return traffic.params(bench.mix(cell.traffic), cell.params)


def prepare(bench: Bench, cell, seed: int, seconds: float,
            device) -> types.SimpleNamespace:
    """Set-up: weights and images from the seed, the engine warmed up on
    the configuration's buckets, the request stream."""
    from portbench.lib import traffic, weights
    from portbench.lib.system import System
    cfg = bench.config(cell.config)
    ref = bench.reference(cfg["family"])
    p = cell_traffic(bench, cell)
    w_seed, img_seed, t_seed = weights.sub_seeds(seed, 3)
    marks = [("imports", time.monotonic())]
    params = weights.make_params(ref.param_specs(cfg), w_seed, device)
    marks.append(("weights", time.monotonic()))
    system = System(cfg, params, device)
    marks.append(("engine", time.monotonic()))
    system.warmup()
    marks.append(("warmup", time.monotonic()))
    if device.type == "cuda":
        log(f"[build] kernel library built in this run: "
            f"{System.build_seconds()} s")
    pool = weights.make_images(int(p["pool_images"]), cfg["img"], img_seed,
                               device)
    stream = traffic.make(bench.arrivals(p["arrivals"]), p, t_seed,
                          widest=max(cfg["buckets"]), seconds=seconds)
    marks.append(("inputs", time.monotonic()))
    log("[setup] s at the end of each step: " + ", ".join(
        f"{name} {t - T_IMPORT:.3f}" for name, t in marks)
        + " (from this module's import)")
    return types.SimpleNamespace(bench=bench, cfg=cfg, ref=ref, p=p,
                                 w_seed=w_seed, t_seed=t_seed, system=system,
                                 pool=pool, stream=stream)


def drive_window(prep, seconds: float, profiler=None):
    """The mix's loop (``loops/<loop>.py``) over the prepared stream."""
    return prep.bench.loop(prep.p["loop"]).drive(
        prep.system, prep.stream, prep.pool, seconds, prep.p, profiler)


def run_cell(bench: Bench, cell, seed: int, seconds: float, trace: bool,
             device, *, t_start: float = None) -> dict:
    """One run of ``cell``; returns the result (``checks`` last)."""
    import numpy as np
    import torch
    from portbench.lib import check, cost
    from portbench.lib.profile import Profiler, reduce
    from portbench.lib.system import System
    cuda = device.type == "cuda"
    prep = prepare(bench, cell, seed, seconds, device)
    cfg, ref, system = prep.cfg, prep.ref, prep.system

    win = drive_window(prep, seconds)
    setup_s = win.t0 - (t_start if t_start is not None else T_IMPORT)
    served, profiler, profiled = list(win.served), None, []
    if trace:
        # CUPTI, once started, stays attached while CUDA graphs live, so
        # the trace comes after the window, in a segment of its own
        if cuda:
            Profiler.warm(device)
            profiler = Profiler(TRACE_LEAD, TRACE_LEAD + TRACE_SECONDS,
                                TRACE_BATCHES)
        seg = drive_window(prep, TRACE_SEGMENT, profiler)
        served += seg.served
        profiled = seg.profiled
    kind = torch.cuda.get_device_name(device) if cuda else "cpu"
    mem = 0
    if cuda:
        torch.cuda.synchronize(device)
        mem = torch.cuda.max_memory_allocated(device)
    dataflows = {b: system.dataflows(b) for b, _ in profiled}
    build_s = System.build_seconds() if cuda else 0.0
    del system, prep.system
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    table = check.reference_table(ref, cfg, prep.pool, prep.w_seed,
                                  device)
    values = check.compare(served, table)
    correct, checks = check.verdict(values, cell.params["limits"])

    tr = None
    t_trace = time.monotonic()
    path = profiler.export() if profiler is not None else None
    if path is not None:
        tr = reduce(path)
        os.unlink(path)
    t_trace = time.monotonic() - t_trace
    lat_ms = np.array([
        1e3 * ((s.req.t_done if s.ok else win.drained_at) - s.due)
        for s in win.served if s.due < win.t_end])
    done = sum(s.n for s in win.served if s.ok and s.req.t_done <= win.t_end)
    art = types.SimpleNamespace(
        seconds=win.seconds, setup_s=setup_s, images_in_window=done,
        latencies_ms=lat_ms, counters=win.counters,
        flops_per_image=cost.flops_per_image(ref.layers(cfg, 1)),
        peak_flops=cost.peak(kind, cfg["precision"]),
        precision=cfg["precision"], device_kind=kind, trace=tr,
        profiled=profiled, dataflows=dataflows,
        layers=lambda b: {g["name"]: g for g in ref.layers(cfg, b)})
    metrics = {}
    for m in bench.metrics(cell, end_to_end=not trace):
        value = bench.reader(m.name).read(art)
        if value is not None:
            metrics[m.name] = {"value": float(value), "unit": m.unit}

    c = win.counters
    log(f"[window] {win.seconds:.3f} s, {len(win.served)} requests, "
        f"{done} images answered inside it; engine batches {c['batches']}, "
        f"images {c['images']}, host_s {c['host_s']:.6f}, degraded "
        f"batches {c['degraded_batches']}; setup_s {setup_s:.3f} "
        f"(build {build_s:.3f})")
    if win.lateness_s is not None:
        late = 1e3 * win.lateness_s
        log(f"[generator] lateness ms: p50 {np.percentile(late, 50):.4f}, "
            f"p99 {np.percentile(late, 99):.4f}, max {late.max():.4f}")
        log("[latency] ms: " + ", ".join(
            f"p{q} {np.percentile(lat_ms, q):.4f}" for q in (50, 90, 95, 99))
            + f", mean {lat_ms.mean():.4f}")
    if tr is not None:
        log(f"[trace] {len(profiled)} batches, "
            f"{sum(n for _, n in profiled)} images, busy "
            f"{tr.busy_s:.6f} s of {tr.span_s:.6f} s; exported and read "
            f"in {t_trace:.3f} s")
    result = {
        "correct": correct, "attempted": len(served),
        "failed": int(values["requests_not_served"]), "metrics": metrics,
        "device": {"platform": "gpu" if cuda else device.type,
                   "kind": kind, "count": cell.chips,
                   "memory_peak_bytes": int(mem)}}
    if trace and tr is not None:
        result["device"].update(busy_s=tr.busy_s, window_s=tr.span_s)
        result["breakdown"] = {
            "device_ops": [[n[:160], s] for n, s in tr.device_ops],
            "idle_gaps": [[n[:160], s] for n, s in tr.idle_gaps]}
    result["checks"] = checks
    return result


def main(argv=None, *, root: pathlib.Path = ROOT, device=None) -> int:
    """``device`` set (tests) skips the look for a card."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    t_start = process_start() if device is None else None
    bench = Bench(root)
    cell = bench.cell(args.workload)
    import torch
    if device is None:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell.chips:
            found = torch.cuda.device_count() \
                if torch.cuda.is_available() else 0
            log(f"{cell.name} needs {cell.chips} CUDA device(s); found "
                f"{found}")
            return 3
        device = torch.device("cuda", 0)
    result = run_cell(bench, cell, args.seed, args.seconds,
                      bool(args.trace), torch.device(device),
                      t_start=t_start)
    bad = forbidden_modules()
    if bad:
        log(f"loaded JAX or the JAX package: {', '.join(bad)}")
        return 4
    for name, c in result["checks"].items():
        log(f"[check] {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
