"""Serving launcher, vision path: an image request stream through the
continuous-batching vision engine (``serve/vision.py``).

    python -m repro_torch.launch.serve --vision --model mobilenetv2
    python -m repro_torch.launch.serve --vision --model resnet18 --width 1.0
    python -m repro_torch.launch.serve --vision --model vgg16 --device cpu
    python -m repro_torch.launch.serve --vision --precision int8 \
        --device cpu --width 0.0625

It serves a deterministic mixed-size request stream through the bucketed
compiled forwards of any registered conv model (``models/zoo.py``,
``--model``) and prints the summary (images/s, latency percentiles, slot
occupancy, fold reuse, served-vs-direct check) as one JSON object; with
``--precision int8`` that object sits under the key ``serving_int8`` (the
JAX launcher's section name).  It writes no file.  Token serving and
``--chaos`` wait for their slices (ROADMAP queue A item 9).
"""
from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

from repro_torch.core.engine import POLICIES


def main(argv: Optional[Sequence[str]] = None) -> dict:
    from repro_torch.models.zoo import conv_model_names
    from repro_torch.serve.vision import serving_summary
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--vision", action="store_true",
                    help="serve an image stream through the compiled "
                         "fold-schedule engine (the only path ported)")
    ap.add_argument("--model", default="vgg16", choices=conv_model_names(),
                    help="registered conv model to serve (models/zoo.py)")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--width", type=float, default=0.0625,
                    help="model width multiplier (1.0 is full width)")
    ap.add_argument("--img", type=int, default=32)
    ap.add_argument("--buckets", default="1,2,4,8",
                    help="comma-separated batch bucket widths")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and the request stream")
    ap.add_argument("--policy", choices=POLICIES, default="auto",
                    help="auto/kernel: the fold kernels; reference: the "
                         "plain-torch direct conv")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain-torch "
                         "versions)")
    ap.add_argument("--precision", choices=("fp32", "int8"), default="fp32",
                    help="streamed conv precision of the compiled forwards")
    args = ap.parse_args(argv)
    if not args.vision:
        ap.error("token serving is not ported yet (ROADMAP queue A item "
                 "9); pass --vision")
    summary = serving_summary(
        args.model, requests=args.requests, img=args.img,
        width_mult=args.width, policy=args.policy,
        buckets=tuple(int(b) for b in args.buckets.split(",")),
        seed=args.seed, device=args.device, precision=args.precision)
    # an int8 summary prints under its own key, as the JAX launcher files
    # it under its own section beside the fp32 one
    out = summary if args.precision == "fp32" else \
        {f"serving_{args.precision}": summary}
    print(json.dumps(out, indent=1, sort_keys=True))
    return summary


if __name__ == "__main__":
    main()
