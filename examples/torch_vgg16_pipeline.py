"""End-to-end VGG-16 inference through the port's fold framework — the
paper's own evaluation model (Table 2B).

Two execution paths:
  * the per-layer ``vgg.forward`` with an explicit impl (the validation
    path: one kernel launch per conv on the fold impls);
  * the cached fold-schedule engine (``vgg.compile_forward``): one static
    whole-network schedule, dataflows picked by the cost model.

    PYTHONPATH=src python examples/torch_vgg16_pipeline.py \
        [--device cpu] [--width 0.125] [--impl fold_auto]
"""
import argparse
import time

import torch

from repro_torch.core import PEArray, kips, vgg16_conv_layers
from repro_torch.device import resolve_device
from repro_torch.models import vgg


def _timed(dev, fn):
    """fn() and its seconds on the host clock, the device synchronised."""
    t0 = time.perf_counter()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return out, time.perf_counter() - t0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    ap.add_argument("--width", type=float, default=0.125)
    ap.add_argument("--img", type=int, default=64)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--impl", default="fold_auto",
                    choices=["direct", "im2col", "fold_ws", "fold_os",
                             "fold_auto", "torch"])
    ap.add_argument("--policy", default="kernel",
                    choices=["kernel", "reference"],
                    help="engine execution policy for the compiled path")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    params = vgg.init_params(torch.Generator(device=dev).manual_seed(0),
                             width_mult=args.width, img=args.img,
                             classes=100, device=dev)
    x = torch.randn(args.batch, 3, args.img, args.img, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(1))
    with torch.inference_mode():
        logits, first_t = _timed(
            dev, lambda: vgg.forward(params, x, impl=args.impl))
        logits, step_t = _timed(
            dev, lambda: vgg.forward(params, x, impl=args.impl))
    print(f"VGG-16(w={args.width}) impl={args.impl} on {dev}: logits "
          f"{tuple(logits.shape)}, first call {first_t:.3f}s, step "
          f"{step_t:.3f}s")
    assert bool(torch.isfinite(logits).all())

    # the cached fold-schedule engine: whole-network static schedule
    with torch.inference_mode():
        net, compile_t = _timed(dev, lambda: vgg.compile_forward(
            params, img=args.img, batch=args.batch, policy=args.policy,
            device=dev))
        logits2, _ = _timed(dev, lambda: net(params, x))
        logits2, step_t = _timed(dev, lambda: net(params, x))
    reuse = net.fold_reuse()
    print(f"engine(policy={args.policy}, mode={net.mode}): "
          f"compile {compile_t:.1f}s, step {step_t:.3f}s, "
          f"{reuse['distinct_schedules']} schedules for "
          f"{reuse['conv_layers']} conv layers "
          f"({reuse['hits']} fold-reuse hits)")
    print(f"max |engine - per-layer| = "
          f"{(logits2 - logits).abs().max().item():.2e}")
    print(net.describe())

    # full-size analytical projection on the paper's 64x64 MAVeC array
    layers = [cv for _, cv in vgg16_conv_layers()]
    r = kips(layers, PEArray(64, 64))
    print(f"analytical full-size VGG-16 on MAVeC 64x64: "
          f"{r['kips']:.1f} KIPS at util {r['util_avg_pct']:.1f}% "
          f"(paper quotes 12.7 KIPS at its own component cycles)")


if __name__ == "__main__":
    main()
