"""End-to-end token serving on the port: batched requests through the
continuous-batching engine (the dense attention family and zamba2), its
decode step one CUDA graph on the card.

    PYTHONPATH=src python examples/torch_serve_lm.py --arch qwen3-4b \
        --requests 6 [--device cpu] [--window-cache] [--full]
"""
import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs.registry import get_config
from repro_torch.device import resolve_device
from repro_torch.models import api
from repro_torch.serve.engine import BatchEngine, Request

ARCHS = ("llama3-8b", "qwen3-4b", "qwen2.5-14b", "gemma3-12b",
         "zamba2-1.2b")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b", choices=ARCHS)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card) or cpu")
    ap.add_argument("--full", action="store_true",
                    help="the published widths (else the reduced config)")
    ap.add_argument("--window-cache", action="store_true",
                    help="ring-buffer caches for gemma3's local layers")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--batch", type=int, default=3)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=10)
    args = ap.parse_args()
    dev = resolve_device(args.device)

    cfg = get_config(args.arch, reduced=not args.full)
    if args.window_cache:
        cfg = dataclasses.replace(cfg, window_cache=True)
    params = api.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             device=dev)
    engine = BatchEngine(cfg, params, batch=args.batch, max_len=64,
                         device=dev)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab, args.prompt_len,
                                        dtype=np.int32),
                    max_new_tokens=args.new_tokens)
            for i in range(args.requests)]
    t0 = time.monotonic()
    for r in reqs:
        engine.submit(r)
    engine.run()
    dt = time.monotonic() - t0
    toks = sum(len(r.output) for r in reqs)
    assert all(r.done for r in reqs)
    step_ms = 1e3 * engine.decode_s / max(engine.decode_steps, 1)
    print(f"{cfg.name} on {dev}: served {len(reqs)} requests / {toks} "
          f"tokens in {dt:.2f}s ({toks / dt:.1f} tok/s, continuous batching "
          f"width {args.batch}, decode step {step_ms:.3f} ms)")
    print("sample:", reqs[0].output)


if __name__ == "__main__":
    main()
