#!/usr/bin/env python3
"""Device times of the depthwise fold kernel (fp32, int8, bf16), the bf16
output-stationary fold kernel and the bf16 head of one checkout of the
port, and of the bf16 forwards that run them, for a same-card A/B.

    python3 kernel_ab.py ROOT LABEL [--runs 2]

Imports the port from ``ROOT/src`` (so the parent commit, unpacked with
``git archive`` into a git-ignored directory, and the change are timed
by the same script, which builds each checkout's kernels on first use),
then ``--runs`` times in one process prints, with ``chip_smoke.py``'s own
timers and shapes:

    KAB LABEL os_<model> MS          the bf16 OS layers of VGG-16, ResNet-18
                                     and MobileNetV2 at 32, batch 4, summed
                                     (device time of the bare launches)
    KAB LABEL ws_vgg16_224 MS        the bf16 WS kernel on VGG-16's 13
                                     layers at 224, batch 1, summed (the
                                     partner that shares OS's walk)
    KAB LABEL dense_bf16_b<B> MS     VGG-16's head at 224 (fc1-fc3), bf16,
                                     batch 1 and 4, summed
    KAB LABEL fwd_<model>_b4 MS      the bf16 forward at 32, batch 4,
                                     jitted (one CUDA-graph replay)
    KAB LABEL dw_<fp32|int8|bf16>_mobilenetv2 MS
                                     MobileNetV2's 17 depthwise layers at
                                     32, batch 4, summed (device time of
                                     the bare launches, the geometry the
                                     checkout picks)

Run the two checkouts in turns (parent, change, change, parent) in one
call on one card; each process needs the card.
"""
from __future__ import annotations

import argparse
import pathlib
import sys

import chip_smoke as cs


def dw_ms(torch, dev, cw, layers, dtype, reps=10):
    """The depthwise launches of ``layers`` in ``dtype`` on prepared
    operands, device ms summed; only the wrapper's API that every checkout
    has (``prepare``, the dataflow's launcher)."""
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 60)
    total = 0.0
    for _, sched, cv, epi in layers:
        x, w, kw = cs.dw_operands(torch, gen, dev, dtype, cv.n, cv.c, cv.x,
                                  cv.y, cv.stride, epi, sched.plan)
        spec, *ops = cw.prepare(x, w, cv.stride, sched.plan, "depthwise",
                                kw.get("bias"), kw["epilogue"], cv.groups,
                                kw.get("residual"), kw.get("scale"),
                                kw.get("shift"))
        launch = cw.LAUNCHERS["depthwise"]
        total += cs.time_graph_ms(torch, lambda: launch(spec, *ops), reps)
    return total


def main() -> int:
    ap = argparse.ArgumentParser(prog="kernel_ab.py")
    ap.add_argument("root", help="checkout whose src/ holds the port")
    ap.add_argument("label", help="name printed on each line")
    ap.add_argument("--runs", type=int, default=2)
    args = ap.parse_args()
    sys.path.insert(0, str(pathlib.Path(args.root).resolve() / "src"))
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch.models import mobilenet, resnet, vgg
    cs.set_numerics(torch)
    dev = torch.device("cuda", 0)
    bf = torch.bfloat16
    print(f"KAB {args.label} card {cs.smi_line()}", flush=True)
    layers = {m: [r for r in cs.model_layers(m, 32, 4)
                  if r[1].dataflow == "output_stationary"]
              for m in ("vgg16", "resnet18", "mobilenetv2")}
    ws_layers = cs.vgg_layer_specs(224, 1)
    nets = {}
    for m, module in (("mobilenetv2", mobilenet), ("resnet18", resnet)):
        gen = torch.Generator(device=dev).manual_seed(cs.SEED + 50)
        params = module.init_params(gen, img=32, device=dev, dtype=bf)
        x = torch.randn(4, 3, 32, 32, device=dev, generator=gen).to(bf)
        nets[m] = (module.compile_forward(params, img=32, batch=4,
                                          device=dev), params, x)
    from repro_torch.kernels import conv2d_ws as cw
    dw_layers = [r for r in cs.model_layers("mobilenetv2", 32, 4)
                 if r[1].dataflow == "depthwise"]
    for _ in range(args.runs):
        for tag, dt in (("fp32", torch.float32), ("int8", torch.int8),
                        ("bf16", bf)):
            ms = dw_ms(torch, dev, cw, dw_layers, dt)
            print(f"KAB {args.label} dw_{tag}_mobilenetv2 {ms:.4f}",
                  flush=True)
        for m, rows in layers.items():
            ms = sum(r["ms"] for r in cs.time_model_layers(
                torch, dev, rows, 10, dtype=bf))
            print(f"KAB {args.label} os_{m} {ms:.4f}", flush=True)
        ms = sum(r["weight_stationary_ms"] for r in cs.time_layers(
            torch, dev, ws_layers, ("weight_stationary",), 5, dtype=bf))
        print(f"KAB {args.label} ws_vgg16_224 {ms:.4f}", flush=True)
        for b in (1, 4):
            ms = sum(r["ms"] for r in cs.time_dense(torch, dev, b, 10, bf))
            print(f"KAB {args.label} dense_bf16_b{b} {ms:.4f}", flush=True)
        for m, (net, params, x) in nets.items():
            with torch.inference_mode():
                ms = cs.time_ms(torch, lambda: net(params, x), 20)
            print(f"KAB {args.label} fwd_{m}_b4 {ms:.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
