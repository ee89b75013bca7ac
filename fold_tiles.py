#!/usr/bin/env python3
"""Time every CTA tile of the port's WS / OS fold-conv kernel, per layer,
on one NVIDIA GPU: the data ``conv2d_ws.tile_cycles`` is fitted to.

    python3 fold_tiles.py [--int8 | --bf16] [--out FILE]

For every WS / OS conv of VGG-16 (224x224, batch 1; 32x32, batch 4),
ResNet-18 and MobileNetV2 (32x32, batch 4), all at full width, and of
ResNeXt-50 32x4d's grouped 3x3 (``chip_smoke.resnext_layer``), the bare
launch is timed with every tile it can run (``conv2d_ws.tile_candidates``,
forced through the launcher's ``tile`` argument) as device time (CUDA-graph
replay on prepared operands), and each tile's output is checked against
the plain walk (fp32 within 1e-4·max(1, max|plain|); ``--int8``, the int8
kernels on quantized operands, bitwise; ``--bf16``, the bf16 instances on
bf16 operands within one bf16 step of each element plus
1e-4·max(1, max|plain|), ``chip_smoke.bf16_err``: every tile of
``TC_TILES`` on the OS layers, its first ``TC_WS_TILES`` on the WS ones,
and every tensor-core tile of the psum staging on VGG-16's 13 layers at
224, batch 1, its step widened by the depth folds' magnitudes).  Prints one line per
layer (the
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
TAG = {"weight_stationary": "ws", "output_stationary": "os",
       "weight_stationary_psum": "ps"}


def conv_sets(bf16: bool = False):
    """(set name, [(layer, schedule, loop nest, epilogue, dataflow)]) of
    the WS / OS convs swept; with ``bf16`` also VGG-16's 13 layers at 224,
    batch 1, as psum staging launches."""
    from repro_torch.core.epilogue import Epilogue
    sets = {"vgg16_224_b1": cs.model_layers("vgg16", 224, 1),
            "vgg16_32_b4": cs.model_layers("vgg16", 32, 4),
            "resnet18_32_b4": cs.model_layers("resnet18", 32, 4),
            "mobilenetv2_32_b4": cs.model_layers("mobilenetv2", 32, 4),
            "resnext50_56_b1": [cs.resnext_layer()]}
    out = {k: [c + (c[1].dataflow,) for c in v
               if c[1].dataflow != "depthwise"]
           for k, v in sets.items()}
    if bf16:
        out["vgg16_224_b1_psum"] = [
            (name, sched, cv, Epilogue(), "weight_stationary_psum")
            for name, sched, cv, _ in sets["vgg16_224_b1"]]
    return out


def operands(torch, gen, dev, cv, epi, int8: bool, bf16: bool):
    """Random operands of one layer as ``conv2d_folded`` takes them; int8
    ones quantized to [-127, 127]; bf16 ones with the weights scaled by
    1/sqrt(fan-in), as ``chip_smoke.time_model_layers`` makes them."""
    x = torch.randn(cv.n, cv.c, cv.x + 2 * cv.pad, cv.y + 2 * cv.pad,
                    device=dev, generator=gen)
    w = torch.randn(cv.nf, cv.c // cv.groups, cv.r, cv.s, device=dev,
                    generator=gen)
    ops = cs.epi_operands(torch, gen, dev, epi, cv.n, cv.nf, cv.p, cv.q)
    if int8:
        x, w = ((a * 40).round().clamp(-127, 127).to(torch.int8)
                for a in (x, w))
    if bf16:
        w = w / (cv.c // cv.groups * cv.r * cv.s) ** 0.5
        x, w = x.to(torch.bfloat16), w.to(torch.bfloat16)
        ops = {k: v.to(torch.bfloat16) for k, v in ops.items()}
    return x, w, ops


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--int8", action="store_true")
    mode.add_argument("--bf16", action="store_true")
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
    print(f"[fold_tiles] {smi}; int8={args.int8} bf16={args.bf16}")
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    sets = conv_sets(args.bf16)
    rows, bad = [], 0
    for setname, convs in sets.items():
        for name, sched, cv, epi, df in convs:
            x, w, ops = operands(torch, gen, dev, cv, epi, args.int8,
                                 args.bf16)
            spec, *prep = cw.prepare(
                x, w, cv.stride, sched.plan, df,
                ops.get("bias"), epi, cv.groups, ops.get("residual"),
                ops.get("scale"), ops.get("shift"))
            launch = cw.LAUNCHERS[spec.dataflow]
            odt = torch.bfloat16 if args.bf16 else None
            want = cw._finish(spec, cw._PLAIN_WALKS[spec.dataflow](
                spec, *prep), odt)
            extra = None
            if spec.dataflow == "weight_stationary_psum":
                extra = cs.psum_extra(torch, x, w, cv.stride)
            tol = 0.0 if args.int8 else \
                TOL * max(1.0, want.abs().max().item())
            dtype = prep[0].dtype
            picked = cw.fold_tile(spec, cv.n, sm_count, dtype=dtype).index
            row = {"set": setname, "layer": name,
                   "dataflow": spec.dataflow, "tile": picked, "tiles": {},
                   "core": cw.tile_core(spec.dataflow, dtype)}
            for t in cw.tile_candidates(spec, cv.n, sm_count, dtype):
                got = cw._finish(spec, launch(spec, *prep, tile=t.index),
                                 odt)
                if args.bf16:
                    try:
                        cs.bf16_err(torch, got, want,
                                    f"{setname} {name} tile {t.index}",
                                    extra)
                    except RuntimeError as e:
                        print(f"[fold_tiles] {e}")
                        bad += 1
                else:
                    bad += (got - want).abs().max().item() > tol
                row["tiles"][t.index] = cs.time_graph_ms(
                    torch, lambda: launch(spec, *prep, tile=t.index), 10)
            row["ms"] = row["tiles"][picked]
            row["best"] = min(row["tiles"], key=row["tiles"].get)
            rows.append(row)
            print(f"[fold_tiles] {setname:17} {name:10} "
                  f"{TAG[spec.dataflow]} tile={picked} ms={row['ms']:.4f} "
                  f"best={row['best']} "
                  + " ".join(f"{i}:{ms:.4f}" for i, ms in
                             sorted(row["tiles"].items())), flush=True)
    summary = {"card": smi, "int8": args.int8, "bf16": args.bf16,
               "bad_tiles": bad, "picked": {}, "fastest": {}}
    for row in rows:
        for key in ("picked", "fastest"):
            i = f"{row['core']}{row['tile' if key == 'picked' else 'best']}"
            summary[key][i] = summary[key].get(i, 0) + 1
    for setname in sets:
        for df in ("weight_stationary", "output_stationary",
                   "weight_stationary_psum"):
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
