"""Serving launcher: token requests through the continuous-batching
``BatchEngine`` (``serve/engine.py``), or — with ``--vision`` — an image
request stream through the vision engine (``serve/vision.py``).

    python -m repro_torch.launch.serve --device cpu
    python -m repro_torch.launch.serve --arch zamba2-1.2b --full
    python -m repro_torch.launch.serve --vision --model mobilenetv2
    python -m repro_torch.launch.serve --vision --model resnet18 --width 1.0
    python -m repro_torch.launch.serve --vision --model vgg16 --device cpu
    python -m repro_torch.launch.serve --vision --precision int8 \
        --device cpu --width 0.0625

The token path serves ``--requests`` random prompts of ``--prompt-len``
tokens, ``--new-tokens`` each, at batch width ``--batch``, over random
weights from ``--seed`` (the bf16 policy; ``--full`` for the published
widths, else the reduced config), and prints requests done/lost, tokens,
tokens/s and the prefill/decode times as one JSON object.  zamba2-1.2b is
the only LM ported; another ``--arch`` is refused, naming its ROADMAP
item.

The vision path serves a deterministic mixed-size request stream through
the bucketed compiled forwards of any registered conv model
(``models/zoo.py``, ``--model``) and prints the summary (images/s, latency
percentiles, slot occupancy, fold reuse, served-vs-direct check) as one
JSON object; with ``--precision int8`` that object sits under the key
``serving_int8`` (the JAX launcher's section name).

It writes no file.  ``--chaos`` waits for its slice (ROADMAP queue A
item 9).
"""
from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

from repro_torch.core.engine import POLICIES


def main(argv: Optional[Sequence[str]] = None) -> dict:
    from repro_torch.configs.registry import arch_names
    from repro_torch.models.zoo import conv_model_names
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--requests", type=int, default=None,
                    help="requests to serve (tokens: 8, vision: 32)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and the requests")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain-torch "
                         "versions)")
    # token serving
    ap.add_argument("--arch", default="zamba2-1.2b", choices=arch_names(),
                    help="LM architecture (configs/registry.py)")
    ap.add_argument("--full", action="store_true",
                    help="the published widths (else the reduced config)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=12)
    # vision serving
    ap.add_argument("--vision", action="store_true",
                    help="serve an image stream through the compiled "
                         "fold-schedule engine instead of token decode")
    ap.add_argument("--model", default="vgg16", choices=conv_model_names(),
                    help="registered conv model to serve (models/zoo.py)")
    ap.add_argument("--width", type=float, default=0.0625,
                    help="model width multiplier (1.0 is full width)")
    ap.add_argument("--img", type=int, default=32)
    ap.add_argument("--buckets", default="1,2,4,8",
                    help="comma-separated batch bucket widths")
    ap.add_argument("--policy", choices=POLICIES, default="auto",
                    help="auto/kernel: the fold kernels; reference: the "
                         "plain-torch direct conv")
    ap.add_argument("--precision", choices=("fp32", "int8"), default="fp32",
                    help="streamed conv precision of the compiled forwards")
    args = ap.parse_args(argv)
    if not args.vision:
        return token_main(args)
    from repro_torch.serve.vision import serving_summary
    summary = serving_summary(
        args.model, requests=args.requests or 32, img=args.img,
        width_mult=args.width, policy=args.policy,
        buckets=tuple(int(b) for b in args.buckets.split(",")),
        seed=args.seed, device=args.device, precision=args.precision)
    # an int8 summary prints under its own key, as the JAX launcher files
    # it under its own section beside the fp32 one
    out = summary if args.precision == "fp32" else \
        {f"serving_{args.precision}": summary}
    print(json.dumps(out, indent=1, sort_keys=True))
    return summary


def token_main(args) -> dict:
    from repro_torch.serve.engine import token_serving_summary
    summary = token_serving_summary(
        args.arch, full=args.full, batch=args.batch, max_len=args.max_len,
        prompt_len=args.prompt_len, new_tokens=args.new_tokens,
        requests=args.requests or 8, seed=args.seed, device=args.device)
    print(json.dumps(summary, indent=1, sort_keys=True))
    return summary


if __name__ == "__main__":
    main()
