"""Readings that a cell's correctness limits are set from, in one process:

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        --seconds 5 [--control]

For each seed, one run of the cell as ``run.py`` makes it (its
``logit_rel_gap``: the port's reading), and, with ``--control``, the
control: the plain reference computed in TF32, the nearest precision
below the configuration's fp32, put in the port's place over the same
images (``logit_rel_gap`` of its logits against the fp32 reference's),
once with every operand rounded to TF32 here and once on cuDNN's and
cuBLAS's own TF32 paths.  One JSON line a seed, then the largest port
reading and the smallest control reading.  Needs a card, as a run does.
Not part of a benchmark run.
"""
import argparse
import gc
import json
import sys

import run  # portbench/run.py: puts the checkout on sys.path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    import torch
    from portbench.lib import check, weights
    if not torch.cuda.is_available():
        print("calibrate.py needs a CUDA device", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    bench = run.Bench(run.ROOT)
    cell = bench.cell(args.workload)
    cfg = bench.config(cell.config)
    ref = bench.reference(cfg["family"])
    p = run.cell_traffic(bench, cell)
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        res = run.run_cell(bench, cell, seed, args.seconds, False, device)
        row = {"seed": seed, "correct": res["correct"],
               "port": res["checks"]["logit_rel_gap"]["value"],
               "metrics": {k: v["value"] for k, v in res["metrics"].items()}}
        if args.control:
            w_seed, img_seed, _ = weights.sub_seeds(seed, 3)
            pool = weights.make_images(int(p["pool_images"]), cfg["img"],
                                       img_seed, device)
            want = check.reference_table(ref, cfg, pool, w_seed, device)
            for name, rounded in (("control_rounded", True),
                                  ("control_tf32", False)):
                got = check.reference_table(ref, cfg, pool, w_seed, device,
                                            round_tf32=rounded,
                                            tf32_paths=not rounded)
                row[name] = check.rel_gap(got, want)
            del want, got
        rows.append(row)
        print(json.dumps(row), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    summary = {"workload": cell.name, "seeds": len(rows),
               "port_max": max(r["port"] for r in rows)}
    if args.control:
        summary["control_min"] = min(min(r["control_rounded"],
                                         r["control_tf32"]) for r in rows)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
