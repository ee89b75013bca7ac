"""The knee of an open-loop cell, found once, by a sweep on the chip:

    python3 portbench/sweep.py --workload vgg16-224.poisson \
        --seeds 7,8 --seconds 15 --rates 40,50,60

One set-up (weights and images from the first seed), then one window for
each rate (requests a second) and seed (the traffic's), the cell's mix
otherwise.  A line for each: images offered and answered a second, the
latency percentiles from the due times, and the requests still open at the
close.  The knee is the highest rate that every seed sustains, as do all
lower rates swept: the images answered inside the window are at least 0.99
of those offered (a queue that does not keep up falls behind by more).
Not a rule on the latency of parts of the window: at these rates a
fifth's median, and more so its 95th percentile, moves by a quarter with
the seed's order of arrivals alone.  The last line is the knee.  Not part
of a benchmark run.
"""
import argparse
import json
import sys

import numpy as np

import run  # portbench/run.py: puts the checkout on sys.path

KEPT_UP = 0.99      # answered / offered images


def reading(win) -> dict:
    lat = np.array([1e3 * ((s.req.t_done if s.ok else win.drained_at)
                           - s.due) for s in win.served])
    offered = sum(s.n for s in win.served)
    done = sum(s.n for s in win.served if s.ok and s.req.t_done <= win.t_end)
    return {
        "offered_images_per_s": offered / win.seconds,
        "answered_images_per_s": done / win.seconds,
        "p50_ms": float(np.percentile(lat, 50)),
        "p95_ms": float(np.percentile(lat, 95)),
        "p99_ms": float(np.percentile(lat, 99)),
        "open_at_close": sum(not (s.ok and s.req.t_done <= win.t_end)
                             for s in win.served),
        "late_p99_ms": float(np.percentile(1e3 * win.lateness_s, 99)),
        "sustained": bool(done >= KEPT_UP * offered),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args(argv)
    import torch
    from portbench.lib import traffic, weights
    if not torch.cuda.is_available():
        print("sweep.py needs a CUDA device", file=sys.stderr)
        return 3
    bench = run.Bench(run.ROOT)
    cell = bench.cell(args.workload)
    base = run.cell_traffic(bench, cell)
    seeds = [int(s) for s in args.seeds.split(",")]
    rates = [float(r) for r in args.rates.split(",")]
    prep = run.prepare(bench, cell, seeds[0], args.seconds,
                       torch.device("cuda", 0))
    sustained = {}
    for rate in rates:
        for seed in seeds:
            prep.p = {**base, "rate_rps": rate}
            prep.stream = traffic.make(
                bench.arrivals(prep.p["arrivals"]), prep.p,
                weights.sub_seeds(seed, 3)[2],
                widest=max(prep.cfg["buckets"]), seconds=args.seconds)
            row = {"rate_rps": rate, "seed": seed,
                   **reading(run.drive_window(prep, args.seconds))}
            sustained[rate] = sustained.get(rate, True) and row["sustained"]
            print(json.dumps(row), flush=True)
    knee = None
    for rate in sorted(rates):
        if not sustained[rate]:
            break
        knee = rate
    print(json.dumps({"knee_rps": knee, "sustained": sustained}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
