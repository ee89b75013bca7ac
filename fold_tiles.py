#!/usr/bin/env python3
"""Time every CTA tile of the port's WS / OS fold-conv kernel, per layer,
on one NVIDIA GPU: the data ``conv2d_ws.tile_cycles`` is fitted to.

    python3 fold_tiles.py [--int8] [--out FILE]

For every WS / OS conv of VGG-16 (224x224, batch 1; 32x32, batch 4),
ResNet-18 and MobileNetV2 (32x32, batch 4), all at full width, and of
ResNeXt-50 32x4d's grouped 3x3 (``chip_smoke.resnext_layer``), the bare
launch is timed with every tile it can run (``conv2d_ws.tile_candidates``,
forced through the launcher's ``tile`` argument) as device time (CUDA-graph
replay on prepared operands), and each tile's output is checked against
the plain walk (fp32 within 1e-4·max(1, max|plain|); ``--int8``, the int8
kernels on quantized operands, bitwise).  Prints one line per layer (the
tile ``fold_tile`` picks, each tile's ms) and, as the last line, a JSON
summary: per model and dataflow the sum of the picked tiles against the
sum of the fastest, and per tile how often it is picked or fastest.
``--out`` writes the per-layer rows.  Exits non-zero without a GPU or
where a tile disagrees with the plain walk.  The per-layer rows of
``chip_smoke.py`` (``build/chip_smoke.json``) are what a same-card
comparison of two commits reads.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

import chip_smoke as cs

TOL = 1e-4


def conv_sets():
    """(set name, [(layer, schedule, loop nest, epilogue)]) of the WS / OS
    convs swept."""
    sets = {"vgg16_224_b1": cs.model_layers("vgg16", 224, 1),
            "vgg16_32_b4": cs.model_layers("vgg16", 32, 4),
            "resnet18_32_b4": cs.model_layers("resnet18", 32, 4),
            "mobilenetv2_32_b4": cs.model_layers("mobilenetv2", 32, 4),
            "resnext50_56_b1": [cs.resnext_layer()]}
    return {k: [c for c in v if c[1].dataflow != "depthwise"]
            for k, v in sets.items()}


def operands(torch, gen, dev, cv, epi, int8: bool):
    """Random operands of one layer as ``conv2d_folded`` takes them; int8
    ones quantized to [-127, 127]."""
    x = torch.randn(cv.n, cv.c, cv.x + 2 * cv.pad, cv.y + 2 * cv.pad,
                    device=dev, generator=gen)
    w = torch.randn(cv.nf, cv.c // cv.groups, cv.r, cv.s, device=dev,
                    generator=gen)
    if int8:
        x, w = ((a * 40).round().clamp(-127, 127).to(torch.int8)
                for a in (x, w))
    return x, w, cs.epi_operands(torch, gen, dev, epi, cv.n, cv.nf, cv.p,
                                 cv.q)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--int8", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("fold_tiles: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(cs.SRC))
    from repro_torch.kernels import conv2d_ws as cw
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = cs.smi_line()
    print(f"[fold_tiles] {smi}; int8={args.int8}")
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    sets = conv_sets()
    rows, bad = [], 0
    for setname, convs in sets.items():
        for name, sched, cv, epi in convs:
            x, w, ops = operands(torch, gen, dev, cv, epi, args.int8)
            spec, *prep = cw.prepare(
                x, w, cv.stride, sched.plan, sched.dataflow,
                ops.get("bias"), epi, cv.groups, ops.get("residual"),
                ops.get("scale"), ops.get("shift"))
            launch = cw.LAUNCHERS[spec.dataflow]
            want = cw._finish(spec, cw._PLAIN_WALKS[spec.dataflow](
                spec, *prep))
            tol = 0.0 if args.int8 else \
                TOL * max(1.0, want.abs().max().item())
            picked = cw.fold_tile(spec, cv.n, sm_count).index
            row = {"set": setname, "layer": name,
                   "dataflow": spec.dataflow, "tile": picked, "tiles": {}}
            for t in cw.tile_candidates(spec, cv.n, sm_count):
                got = cw._finish(spec, launch(spec, *prep, tile=t.index))
                bad += (got - want).abs().max().item() > tol
                row["tiles"][t.index] = cs.time_graph_ms(
                    torch, lambda: launch(spec, *prep, tile=t.index), 10)
            row["ms"] = row["tiles"][picked]
            row["best"] = min(row["tiles"], key=row["tiles"].get)
            rows.append(row)
            print(f"[fold_tiles] {setname:17} {name:10} "
                  f"{spec.dataflow[:2]} tile={picked} ms={row['ms']:.4f} "
                  f"best={row['best']} "
                  + " ".join(f"{i}:{ms:.4f}" for i, ms in
                             sorted(row["tiles"].items())), flush=True)
    summary = {"card": smi, "int8": args.int8, "bad_tiles": bad,
               "picked": {}, "fastest": {}}
    for row in rows:
        for key in ("picked", "fastest"):
            i = str(row["tile" if key == "picked" else "best"])
            summary[key][i] = summary[key].get(i, 0) + 1
    for setname in sets:
        for df in ("weight_stationary", "output_stationary"):
            sel = [r for r in rows if r["set"] == setname
                   and r["dataflow"] == df]
            if sel:
                summary[f"{setname}/{df}"] = {
                    "layers": len(sel), "ms": sum(r["ms"] for r in sel),
                    "best_tiles_ms": sum(min(r["tiles"].values())
                                         for r in sel)}
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(rows, indent=1))
    print(json.dumps(summary))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
