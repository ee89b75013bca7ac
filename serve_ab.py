#!/usr/bin/env python3
"""Served images/s of one checkout of the port, for a same-card A/B.

    python3 serve_ab.py ROOT LABEL [--runs 6]

Imports the port from ``ROOT/src`` (so the parent commit, unpacked with
``git archive`` into a git-ignored directory, and the change are timed
by the same script), then serves ``chip_smoke.py`` phase 8's stream
through that file's own ``serve_phase8`` (jitted) ``--runs`` times in one
process, and prints ``P8 LABEL images/s p50_s`` for every run but the
first (which warms the host's allocators).  Run the two checkouts in
turns (parent, change, change, parent, ...) in one call on one card; each
process needs the card.
"""
from __future__ import annotations

import argparse
import pathlib
import sys

import chip_smoke


def main() -> int:
    ap = argparse.ArgumentParser(prog="serve_ab.py")
    ap.add_argument("root", help="checkout whose src/ holds the port")
    ap.add_argument("label", help="name printed on each line")
    ap.add_argument("--runs", type=int, default=6)
    args = ap.parse_args()
    sys.path.insert(0, str(pathlib.Path(args.root).resolve() / "src"))
    import torch
    if not torch.cuda.is_available():
        print("serve_ab: no CUDA device available", file=sys.stderr)
        return 2
    chip_smoke.set_numerics(torch)
    dev = torch.device("cuda", 0)
    for i in range(args.runs):
        d = chip_smoke.serve_phase8(dev)
        if i:
            print("P8", args.label, d["images_per_s"], d["latency"]["p50_s"],
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
