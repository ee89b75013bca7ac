#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU, end to end.

    python3 chip_smoke.py

Phases (any failed check raises, and the script exits non-zero):

1. Environment: the card's name and power limit, the CUDA version, whether
   ``triton`` imports, ``nvcc``, and the build of the fold kernels from
   ``src/repro_torch/kernels/csrc/`` into ``build/``.
2. Kernels: each CUDA kernel against its plain-torch version on the card
   over random shapes, then the kernel, its plain version and
   ``torch.nn.functional.conv2d`` timed at the 13 VGG-16 layer shapes.
3. Full-width VGG-16 at 224x224, batch 1 and 4: fold reuse, one WS launch
   per conv, logits against the reference policy, and the conv trunk
   bitwise-identical across batch widths.
4. Full-width VGG-16 at 32x32, batch 4: 2 WS + 11 OS launches per forward.
5. Serving: ``VisionEngine`` at 224 over buckets (1, 2, 4).

The kernel launch counts are set to 0 just before phase 3 and read just
after phase 5: that run is the main path.  The second-to-last line is a
JSON object with one entry per kernel; the last line is
``{"ok": true, "device": {...}}``.  Details (per-layer times, serving
metrics, the compiler's resource report) go to ``build/chip_smoke.json``.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

# NVIDIA H100 SXM data sheet: fp32 outside the tensor cores, HBM3 rate
FP32_PEAK = 67e12
HBM_BYTES_PER_S = 3.35e12
SEED = 0
TOL_KERNEL = 1e-4      # kernel vs plain: two fp32 sums in different orders
TOL_MODEL = 1e-4       # kernel path vs reference policy, over the network
TOL_SERVE = 1e-5       # served vs direct: the same kernels, cuBLAS head


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps: int) -> float:
    """Mean ms per call over ``reps`` calls between two CUDA events, after
    one warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def bound(n, c, xp, yp, nf, r, s, p, q, out_numel):
    """(bound ms, op ms, byte ms) of one fold conv: each operand read once,
    the output written once, fp32."""
    op_s = 2.0 * n * nf * c * r * s * p * q / FP32_PEAK
    byte_s = 4.0 * (n * c * xp * yp + nf * c * r * s + nf + out_numel) \
        / HBM_BYTES_PER_S
    return 1e3 * max(op_s, byte_s), 1e3 * op_s, 1e3 * byte_s


def phase_environment(torch):
    from repro_torch.kernels import build
    print(f"[env] nvidia-smi: {smi_line()}")
    print(f"[env] torch {torch.__version__}, torch.version.cuda "
          f"{torch.version.cuda}, device {torch.cuda.get_device_name(0)}, "
          f"count {torch.cuda.device_count()}")
    try:
        import triton
        print(f"[env] triton {triton.__version__} imports")
    except ImportError as e:
        print(f"[env] triton does not import: {e}")
    print(f"[env] nvcc: {build.nvcc_path()}")
    t0 = time.perf_counter()
    build.library()
    info = build.build_info()
    print(f"[env] kernel library {info['path']} built in "
          f"{info['seconds']:.2f} s ({time.perf_counter() - t0:.2f} s "
          "with loading)")
    for line in info["ptxas"].splitlines():
        if "registers" in line or "Compiling entry" in line \
                or "spill" in line:
            print(f"[env] ptxas: {line.strip()}")
    return {"build_s": info["seconds"], "ptxas": info["ptxas"]}


def phase_kernels(torch, dev):
    from repro_torch.core.epilogue import Epilogue
    from repro_torch.core.mapping import ConvBlockPlan
    from repro_torch.kernels import conv2d_ws as cw

    id_, br, brp = (Epilogue(), Epilogue(bias=True, relu=True),
                    Epilogue(bias=True, relu=True, pool="max2"))
    # (n, c, h, w, nf, r, s, stride, pad, epilogue, forced plan or None)
    cases = [
        (1, 3, 32, 32, 64, 3, 3, 1, 1, br, None),           # C = 3
        (3, 16, 13, 10, 20, 3, 3, 1, 1, brp, None),         # odd P, pool
        (1, 24, 12, 21, 12, 3, 3, 1, 1, id_, None),         # ragged Q
        (3, 40, 18, 18, 30, 3, 3, 1, 1, brp,                # g_c = 3
         ConvBlockPlan(nf_block=24, c_block=16, p_block=5, grid=(2, 3, 4),
                       vmem_bytes=0)),
        (3, 8, 17, 15, 9, 5, 5, 2, 2, id_, None),           # stride 2, 5x5
        (1, 256, 28, 28, 256, 3, 3, 1, 1, brp, None),       # VGG conv4-ish
        (3, 33, 9, 7, 13, 3, 3, 1, 1, br,                   # g_c = 2, ragged
         ConvBlockPlan(nf_block=8, c_block=17, p_block=3, grid=(2, 2, 3),
                       vmem_bytes=0)),
    ]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    errs = {"fold_conv_ws": 0.0, "fold_conv_os": 0.0}
    for (n, c, h, w_, nf, r, s, st, pad, epi, plan) in cases:
        x = torch.randn(n, c, h + 2 * pad, w_ + 2 * pad, device=dev,
                        generator=gen)
        w = torch.randn(nf, c, r, s, device=dev, generator=gen)
        b = torch.randn(nf, device=dev, generator=gen)
        for name, df in (("fold_conv_ws", "weight_stationary"),
                         ("fold_conv_os", "output_stationary")):
            kw = dict(stride=st, plan=plan, dataflow=df, epilogue=epi,
                      bias=b if epi.bias else None)
            before = cw.launch_counts()[name]
            got = cw.conv2d_folded(x, w, **kw)
            torch.cuda.synchronize()
            check(cw.launch_counts()[name] == before + 1,
                  f"{name} did not launch")
            want = cw.conv2d_folded_plain(x, w, **kw)
            err = (got - want).abs().max().item()
            tol = TOL_KERNEL * max(1.0, want.abs().max().item())
            print(f"[kernels] {name} n={n} c={c} {h}x{w_} nf={nf} "
                  f"{r}x{s}/s{st} epi={epi} max_abs_err={err:.3e} "
                  f"(tol {tol:.3e})")
            check(got.shape == want.shape and err <= tol,
                  f"{name} disagrees with its plain version")
            errs[name] = max(errs[name], err)
    return errs


def vgg_layer_specs(img: int, batch: int):
    """(name, schedule, fused epilogue, batch, input height) of VGG-16's 13
    convs as the engine compiles them at full width."""
    import torch
    from repro_torch.core.engine import compile_network
    from repro_torch.models import vgg
    params = vgg.init_params(torch.Generator().manual_seed(SEED),
                             img=img, device="meta")
    net = compile_network(params, vgg.to_graph(), (batch, 3, img, img),
                          device="meta")
    epis = {nd.name: nd.epilogue for nd in net.graph.nodes
            if nd.op == "conv"}
    out, h = [], img
    for name, sched in net.layer_schedules:
        out.append((name, sched, epis[name], batch, h))
        if epis[name].pool:
            h //= 2
    return out


def time_layers(torch, dev, layers, dataflows, reps):
    """Time the kernel(s), the plain version and F.conv2d at each layer's
    main-path shape.  Returns per-layer rows."""
    import torch.nn.functional as F
    from repro_torch.kernels import conv2d_ws as cw
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows = []
    for name, sched, epi, batch, h in layers:
        cv = sched.nest          # its channels; the extent is the layer's own
        x = torch.randn(batch, cv.c, h + 2, h + 2, device=dev, generator=gen)
        w = torch.randn(cv.nf, cv.c, 3, 3, device=dev, generator=gen)
        b = torch.randn(cv.nf, device=dev, generator=gen)
        row = {"layer": name, "batch": batch, "h": h,
               "c": cv.c, "nf": cv.nf, "epilogue": str(epi)}
        for df in dataflows:
            kw = dict(plan=sched.plan, dataflow=df, epilogue=epi, bias=b)
            row[f"{df}_ms"] = time_ms(
                torch, lambda: cw.conv2d_folded(x, w, **kw), reps)
        kw = dict(plan=sched.plan, dataflow=dataflows[0], epilogue=epi,
                  bias=b)
        row["plain_ms"] = time_ms(
            torch, lambda: cw.conv2d_folded_plain(x, w, **kw), 2)
        xin = x[:, :, 1:-1, 1:-1].contiguous()
        row["library_ms"] = time_ms(
            torch, lambda: F.conv2d(xin, w, b, padding=1), max(reps, 10))
        out = cw.conv2d_folded(x, w, **kw)
        row["bound_ms"], row["op_ms"], row["byte_ms"] = bound(
            batch, cv.c, h + 2, h + 2, cv.nf, 3, 3, h, h, out.numel())
        rows.append(row)
    return rows


def summarize(rows, df):
    keys = (f"{df}_ms", "plain_ms", "library_ms", "bound_ms", "op_ms",
            "byte_ms")
    tot = {k: sum(r[k] for r in rows) for k in keys}
    return {"ms": tot[f"{df}_ms"], "plain_ms": tot["plain_ms"],
            "library_ms": tot["library_ms"], "bound_ms": tot["bound_ms"],
            "bound_by": ("operations" if tot["op_ms"] >= tot["byte_ms"]
                         else "bytes")}


def forward_counts(torch, net, params, x):
    from repro_torch.kernels import conv2d_ws as cw
    before = cw.launch_counts()
    with torch.inference_mode():
        y = net(params, x)
    torch.cuda.synchronize()
    after = cw.launch_counts()
    return y, {k: after[k] - before[k] for k in after}


def close(torch, got, want, tol_rel, what):
    err = (got - want).abs().max().item()
    tol = tol_rel * want.abs().max().item()
    print(f"[{what}] max_abs_err={err:.3e} (tol {tol:.3e})")
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
    check(err <= tol, f"{what}: outside tolerance")


def phase_model_224(torch, dev, params):
    from repro_torch.core.engine import compile_network
    from repro_torch.models import vgg
    out = {}
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    x4 = torch.randn(4, 3, 224, 224, device=dev, generator=gen)
    nets = {b: vgg.compile_forward(params, img=224, batch=b, device=dev)
            for b in (1, 4)}
    fr = nets[1].fold_reuse()
    print(f"[model224] fold_reuse {fr}")
    check((fr["conv_layers"], fr["distinct_schedules"], fr["hits"],
           fr["misses"]) == (13, 8, 5, 8), "fold reuse is not 13/8/5/8")
    desc = nets[1].describe()
    print(desc)
    check(sum(" weight_stationary " in ln for ln in desc.splitlines()) == 13,
          "describe() does not list WS for all 13 layers")
    for b, net in nets.items():
        x = x4[:b]
        y, counts = forward_counts(torch, net, params, x)
        print(f"[model224] batch {b}: launches {counts}")
        check(counts == {"fold_conv_ws": 13, "fold_conv_os": 0},
              f"batch {b}: expected 13 WS launches per forward")
        ref = vgg.compile_forward(params, img=224, batch=b,
                                  policy="reference", device=dev)
        with torch.inference_mode():
            want = ref(params, x)
        check(y.shape == (b, 1000), f"logits shape {tuple(y.shape)}")
        close(torch, y, want, TOL_MODEL, f"model224 b{b} vs reference")
        with torch.inference_mode():
            out[f"forward_b{b}_ms"] = time_ms(
                torch, lambda: net(params, x), 5)
            out[f"reference_b{b}_ms"] = time_ms(
                torch, lambda: ref(params, x), 3)
        print(f"[model224] batch {b}: forward {out[f'forward_b{b}_ms']:.3f}"
              f" ms, reference policy {out[f'reference_b{b}_ms']:.3f} ms")
    trunks = {b: compile_network(params, vgg.to_graph(include_head=False),
                                 (b, 3, 224, 224), device=dev)
              for b in (1, 4)}
    with torch.inference_mode():
        t4 = trunks[4](params, x4)
        for i in range(4):
            t1 = trunks[1](params, x4[i:i + 1])
            check(torch.equal(t1[0], t4[i]),
                  f"trunk row {i} differs between batch 1 and batch 4")
    print("[model224] trunk rows bitwise-equal at batch 1 and batch 4")
    return out


def phase_model_32(torch, dev):
    from repro_torch.models import vgg
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    params = vgg.init_params(gen, img=32, device=dev)
    x = torch.randn(4, 3, 32, 32, device=dev, generator=gen)
    net = vgg.compile_forward(params, img=32, batch=4, device=dev)
    print(net.describe())
    y, counts = forward_counts(torch, net, params, x)
    print(f"[model32] batch 4: launches {counts}")
    check(counts == {"fold_conv_ws": 2, "fold_conv_os": 11},
          "expected 2 WS + 11 OS launches per forward at 32x32")
    ref = vgg.compile_forward(params, img=32, batch=4, policy="reference",
                              device=dev)
    with torch.inference_mode():
        want = ref(params, x)
    close(torch, y, want, TOL_MODEL, "model32 b4 vs reference")
    return net


def phase_serving(torch, dev, params):
    import numpy as np
    from repro_torch.models import vgg
    from repro_torch.serve.vision import VisionEngine
    eng = VisionEngine(params, vgg.to_graph(), img=224, buckets=(1, 2, 4),
                       device=dev)
    eng.warmup()
    rng = np.random.default_rng(SEED)
    imgs = [rng.standard_normal((int(k), 3, 224, 224)).astype(np.float32)
            for k in rng.integers(1, 4, 8)]
    reqs = [eng.submit(im) for im in imgs]
    m = eng.run()
    for req, im in zip(reqs, imgs):
        check(req.outcome.value == "ok", f"request {req.rid} ended "
              f"{req.outcome.value}")
        direct = vgg.compile_forward(params, img=224, batch=im.shape[0],
                                     cache=eng.compiler.cache, device=dev)
        with torch.inference_mode():
            want = direct(params, torch.from_numpy(im).to(dev))
        close(torch, torch.from_numpy(req.logits).to(dev), want, TOL_SERVE,
              f"serve request {req.rid} ({im.shape[0]} images)")
    d = eng.metrics_dict()
    lat = d["latency"]
    print(f"[serve] {d['requests']} requests / {d['images']} images in "
          f"{d['elapsed_s']:.4f} s: {d['images_per_s']:.3f} images/s, "
          f"p50 {lat['p50_s'] * 1e3:.3f} ms, p99 {lat['p99_s'] * 1e3:.3f} ms,"
          f" batches per bucket {d['per_bucket_batches']}")
    check(d["lost_requests"] == 0, "requests lost")
    return d


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are not under {SRC}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    report = {"nvidia_smi": smi_line()}

    report["env"] = phase_environment(torch)
    errs = phase_kernels(torch, dev)

    from repro_torch.kernels import conv2d_ws as cw
    from repro_torch.models import vgg
    ws_layers = vgg_layer_specs(224, 1)
    os_layers = [row for row in vgg_layer_specs(32, 4)
                 if row[1].dataflow == "output_stationary"]
    check(len(os_layers) == 11, "expected 11 OS layers at 32x32")
    rows224 = time_layers(torch, dev, ws_layers,
                          ("weight_stationary", "output_stationary"), 5)
    rows32 = time_layers(torch, dev, vgg_layer_specs(32, 4),
                         ("output_stationary",), 10)
    rows32_os = [r for r in rows32
                 if r["layer"] in {row[0] for row in os_layers}]
    print("[kernels] VGG-16 layers at 224, batch 1 (ms):")
    for r in rows224:
        print(f"  {r['layer']:<8} c={r['c']:<4} nf={r['nf']:<4} h={r['h']:<4}"
              f" ws={r['weight_stationary_ms']:.4f} "
              f"os={r['output_stationary_ms']:.4f} "
              f"plain={r['plain_ms']:.4f} F.conv2d={r['library_ms']:.4f} "
              f"bound={r['bound_ms']:.4f}")
    report["layers_224_b1"] = rows224
    report["layers_32_b4"] = rows32

    # -- the main path: counts from 0 just before, read just after --------
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = vgg.init_params(gen, img=224, device=dev)
    cw.reset_launch_counts()
    report["model224"] = phase_model_224(torch, dev, params)
    phase_model_32(torch, dev)
    report["serving"] = phase_serving(torch, dev, params)
    launches = cw.launch_counts()
    print(f"[main path] launches {launches}")
    for name, n in launches.items():
        check(n > 0, f"{name} never launched on the main path")

    kernels = []
    for name, df, rows, line in (
            ("fold_conv_ws", "weight_stationary", rows224, 131),
            ("fold_conv_os", "output_stationary", rows32_os, 176)):
        entry = {"name": name, "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/fold_conv.cu",
                 "replaces": f"src/repro/kernels/conv2d_ws.py:{line}",
                 "launches": launches[name], "max_abs_err": errs[name]}
        entry.update(summarize(rows, df))
        kernels.append(entry)
    report["kernels"] = kernels
    report["seconds"] = time.perf_counter() - t_start
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1,
                                                        default=str))
    print(f"[done] {report['seconds']:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(report["nvidia_smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
