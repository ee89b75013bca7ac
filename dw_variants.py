#!/usr/bin/env python3
"""Variants of the depthwise fold kernel beside the tree's own, on one card.

    python3 dw_variants.py [--runs 3]

Builds, from this checkout's ``csrc/fold_conv.cuh``, a library holding only
the three ``fold_conv_dw*`` entries for each variant:

    tree          the kernel as it is
    fence_sc      a CTA fence (``__threadfence_block``) after every load
    fence_acqrel  ``fence.acq_rel.cta`` there instead
    syncwarp      ``__syncwarp`` there instead
    pdl           programmatic dependent launch: ``cudaLaunchKernelEx``
                  with programmatic stream serialization, the weights and
                  the channel's vector read before ``griddepcontrol.wait``

(the fences: to force every load of a thread before its first FFMA in the
SASS), and the port's full library for every other kernel.  Prints, per
variant, how many of its 24 fixed-tap fp32 / bf16 instances issue every
``LDG`` before their first ``FFMA`` (``cuobjdump -sass``), whether its
depthwise launches are bitwise the tree's on phase 2's geometries and
MobileNetV2's layers at every strip (``chip_smoke.phase_dw_strips``), and
whether a bf16 MobileNetV2 forward at 32, batch 4 captured with it is
bitwise its eager forward; then ``--runs`` rounds, the variants in turn, of

    DWV rI VARIANT dw_fp32 MS dw_int8 MS dw_bf16 MS fwd_bf16_b4 MS

(MobileNetV2's 17 depthwise layers at 32, batch 4, summed device time, and
the jitted bf16 forward), the programmatic edge of a captured pair of
``pdl`` launches, and the tree's per-strip times of the 17 layers at batch
1, 4 and 8 (``DWV strips bN``).  Needs the card; JAX is not imported.
"""
from __future__ import annotations

import argparse
import ctypes
import pathlib
import re
import shutil
import subprocess
import sys
import tempfile

import chip_smoke as cs
import kernel_ab

ROOT = pathlib.Path(__file__).resolve().parent
HEADER = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "fold_conv.cuh"
ENTRIES = ("fold_conv_dw", "fold_conv_dw_i8", "fold_conv_dw_bf16")
ENTRY_SRC = """#include "fold_conv.cuh"
extern "C" {
#define DW(name, T, A)                                                     \\
  int name(const void* x, const void* w, const void* vec, const void* res, \\
           void* out, int n, int c, int c_pad, int x_rows, int yp, int r,   \\
           int s, int stride, int q, int p_pad, int epi, int tq, int rows,  \\
           int chans, int pairs, void* stream) {                           \\
    return launch_dw<T, A>(x, w, vec, res, out, n, c, c_pad, x_rows, yp, r, \\
                           s, stride, q, p_pad, epi, tq, rows, chans, pairs,\\
                           stream);                                        \\
  }
DW(fold_conv_dw, float, float)
DW(fold_conv_dw_i8, int8_t, int)
DW(fold_conv_dw_bf16, __nv_bfloat16, float)
}
"""
# after the last window row's loads of the fixed-tap path
AFTER_LOADS = """        for (int k = 0; k < WIN; ++k) pin(win[i][k]);
      }
    }
"""
REPIN = """    pin(bias);
    pin(scale);
    pin(shift);
#pragma unroll
    for (int dp = 0; dp < 2; ++dp) {
#pragma unroll
      for (int j = 0; j < TQ; ++j) pin(rv[dp][j]);
    }
#pragma unroll
    for (int k = 0; k < KR * KS; ++k) pin(wr[k]);
#pragma unroll
    for (int i = 0; i < NR; ++i) {
#pragma unroll
      for (int k = 0; k < WIN; ++k) pin(win[i][k]);
    }
"""
LAUNCH = """  using O = typename OutOf<T>::type;
  if constexpr (KR > 0) {
    if (pairs) {
      dw_kernel<T, A, O, KR, KS, ST, TQ, true><<<grid, threads, 0, st>>>(
          x, w, vec, res, out, g);
      return;
    }
  }
  dw_kernel<T, A, O, KR, KS, ST, TQ, false><<<grid, threads, 0, st>>>(
      x, w, vec, res, out, g);"""
PDL_LAUNCH = """  using O = typename OutOf<T>::type;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = threads;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if constexpr (KR > 0) {
    if (pairs) {
      cudaLaunchKernelEx(&cfg, dw_kernel<T, A, O, KR, KS, ST, TQ, true>, x,
                         w, vec, res, out, g);
      return;
    }
  }
  cudaLaunchKernelEx(&cfg, dw_kernel<T, A, O, KR, KS, ST, TQ, false>, x, w,
                     vec, res, out, g);"""


def patched(src: str, old: str, new: str) -> str:
    if old not in src:
        raise SystemExit(f"dw_variants: fold_conv.cuh no longer holds "
                         f"{old.splitlines()[0].strip()!r}")
    return src.replace(old, new)


def variants(src: str) -> dict:
    def fence(stmt):
        return patched(src, AFTER_LOADS, AFTER_LOADS + stmt + REPIN)
    pdl = patched(src, "  if (op >= po || c >= g.c) return;\n",
                  '  asm volatile("griddepcontrol.launch_dependents;" ::: '
                  '"memory");\n  if (op >= po || c >= g.c) return;\n')
    pdl = patched(pdl, "  pin(shift);\n  const bool residual",
                  '  pin(shift);\n  asm volatile("griddepcontrol.wait;" ::: '
                  '"memory");\n  const bool residual')
    return {"tree": src,
            "fence_sc": fence("    __threadfence_block();\n"),
            "fence_acqrel": fence('    asm volatile("fence.acq_rel.cta;" '
                                  '::: "memory");\n'),
            "syncwarp": fence("    __syncwarp(__activemask());\n"),
            "pdl": patched(pdl, LAUNCH, PDL_LAUNCH)}


def sass_in_order(cuobjdump: str, lib: pathlib.Path) -> tuple:
    """(fixed-tap fp32 / bf16 instances, those with every LDG before their
    first FFMA)."""
    out = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                         text=True, check=True).stdout
    funcs = re.split(r"\n\s*Function : ", out)[1:]
    names = cs.demangle([f.split("\n", 1)[0].strip() for f in funcs])
    total = ordered = 0
    for body, name in zip(funcs, names):
        if not re.search(r"dw_kernel<(float|__nv_bfloat16)[^>]*, 3, 3, ",
                         name):
            continue
        ins = [ln for ln in body.split("\n")
               if re.search(r"/\*[0-9a-f]{4,}\*/", ln)]
        ldg = [i for i, ln in enumerate(ins) if re.search(r"\bLDG\b", ln)]
        ffma = [i for i, ln in enumerate(ins) if re.search(r"\bFFMA\b", ln)]
        total += 1
        ordered += bool(ffma) and max(ldg) < ffma[0]
    return total, ordered


def main() -> int:
    ap = argparse.ArgumentParser(prog="dw_variants.py")
    ap.add_argument("--runs", type=int, default=3)
    args = ap.parse_args()
    sys.path.insert(0, str(cs.SRC))
    import torch
    if not torch.cuda.is_available():
        print("dw_variants: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch.core.epilogue import Epilogue
    from repro_torch.kernels import build
    from repro_torch.kernels import conv2d_ws as cw
    from repro_torch.models import mobilenet
    cs.set_numerics(torch)
    dev, bf = torch.device("cuda", 0), torch.bfloat16
    print(f"DWV card {cs.smi_line()}", flush=True)
    nvcc = build.nvcc_path()
    cuobjdump = str(pathlib.Path(nvcc).parent / "cuobjdump")
    (ROOT / "build").mkdir(exist_ok=True)
    work = pathlib.Path(tempfile.mkdtemp(dir=ROOT / "build"))
    procs = {}
    for name, src in variants(HEADER.read_text()).items():
        d = work / name
        d.mkdir()
        (d / "fold_conv.cuh").write_text(src)
        (d / "dw_only.cu").write_text(ENTRY_SRC)
        procs[name] = subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"),
             str(d / "dw_only.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
    full = build.library()
    libs = {}
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{err[-2000:]}")
        lib = ctypes.CDLL(str(work / name / "lib.so"))
        for entry in ENTRIES:
            fn = getattr(lib, entry)
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 15 + [
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
        libs[name] = lib
        total, ordered = sass_in_order(cuobjdump, work / name / "lib.so")
        print(f"DWV {name} sass: {ordered} of {total} fixed-tap fp32 / bf16 "
              f"instances with every LDG before the first FFMA", flush=True)

    class Library:
        """The port's library with this variant's depthwise entries."""
        def __init__(self, dw):
            self.dw = dw

        def __getattr__(self, k):
            return getattr(self.dw if k in ENTRIES else full, k)

    def use(name):
        build.library = (lambda lib: (lambda: lib))(Library(libs[name]))

    sc6 = Epilogue(scale=True, relu6=True)
    dw_cases = [(4, 96, 32, 32, 1, sc6, None), (4, 144, 32, 32, 2, sc6, None),
                (2, 24, 15, 15, 2, sc6, None),
                (3, 40, 9, 11, 1, Epilogue(scale=True, residual=True), None),
                (4, 960, 4, 4, 1, sc6, None),
                (2, 5, 9, 11, 1, Epilogue(scale=True, relu6=True,
                                          pool="max2"), None)]
    layers = [r for r in cs.model_layers("mobilenetv2", 32, 4)
              if r[1].dataflow == "depthwise"]
    nets, ref = {}, None
    for name in libs:
        use(name)
        for dt in (torch.float32, torch.int8, bf):
            cs.phase_dw_strips(torch, dev, dw_cases, dt)
        gen = torch.Generator(device=dev).manual_seed(cs.SEED + 50)
        params = mobilenet.init_params(gen, img=32, device=dev, dtype=bf)
        x = torch.randn(4, 3, 32, 32, device=dev, generator=gen).to(bf)
        net = mobilenet.compile_forward(params, img=32, batch=4, device=dev)
        with torch.inference_mode():
            jit, eager = net(params, x), net.eager(params, x)
        ref = jit if ref is None else ref
        print(f"DWV {name}: strips bitwise and within the plain version's "
              f"rule; forward jitted bitwise eager {torch.equal(jit, eager)},"
              f" bitwise the tree's {torch.equal(jit, ref)}", flush=True)
        nets[name] = (net, params, x)
    for rnd in range(args.runs):
        for name in libs:
            use(name)
            row = [f"dw_{tag} "
                   f"{kernel_ab.dw_ms(torch, dev, cw, layers, dt):.5f}"
                   for tag, dt in (("fp32", torch.float32),
                                   ("int8", torch.int8), ("bf16", bf))]
            net, params, x = nets[name]
            with torch.inference_mode():
                ms = cs.time_ms(torch, lambda: net(params, x), 50)
            row.append(f"fwd_bf16_b4 {ms:.5f}")
            print(f"DWV r{rnd} {name} " + " ".join(row), flush=True)
    use("pdl")
    gen = torch.Generator(device=dev).manual_seed(1)
    x, w, kw = cs.dw_operands(torch, gen, dev, bf, 4, 96, 32, 32, 1, sc6,
                              None)
    spec, *ops = cw.prepare(x, w, 1, None, "depthwise", None, sc6, 96, None,
                            kw["scale"], kw["shift"])
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        cw.launch_dw(spec, *ops)
        cw.launch_dw(spec, *ops)
    edges = ctypes.CDLL("libcuda.so.1").cuGraphGetEdges_v2
    count = ctypes.c_size_t(0)
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    edges(handle, None, None, None, ctypes.byref(count))
    frm = (ctypes.c_void_p * count.value)()
    to = (ctypes.c_void_p * count.value)()
    data = (ctypes.c_ubyte * (8 * count.value))()
    edges(handle, frm, to, data, ctypes.byref(count))
    print(f"DWV pdl: a captured pair of launches has edge types "
          f"{[data[8 * i + 2] for i in range(count.value)]} (1: "
          f"programmatic)", flush=True)
    use("tree")
    sms = cw._sm_count(dev)
    for batch in (1, 4, 8):
        rows = []
        for name, sched, cv, epi in cs.model_layers("mobilenetv2", 32, batch):
            if sched.dataflow != "depthwise":
                continue
            x, w, kw = cs.dw_operands(
                torch, torch.Generator(device=dev).manual_seed(3), dev, bf,
                cv.n, cv.c, cv.x, cv.y, cv.stride, epi, sched.plan)
            spec, *ops = cw.prepare(x, w, cv.stride, sched.plan, "depthwise",
                                    None, epi, cv.groups, None, kw["scale"],
                                    kw["shift"])
            ms = {tq: cs.time_graph_ms(
                torch, lambda: cw.launch_dw(spec, *ops, tq=tq), 50)
                for tq in cw.dw_tq_choices(spec)}
            rows.append(f"{name} " + "/".join(f"{t}:{v:.4f}"
                                              for t, v in ms.items())
                        + f" (picked {cw.dw_geometry(spec, batch, sms).tq})")
        print(f"DWV strips b{batch} bf16: " + ", ".join(rows), flush=True)
    shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
