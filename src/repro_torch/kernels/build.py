"""Build and load the port's CUDA kernels.

``library()`` compiles each ``csrc/*.cu`` with its own ``nvcc`` process,
all started together, and links the objects into one shared library with
a plain C interface, at first use, into
``build/repro_torch_kernels/<hash of the sources>/`` at the repository root,
and loads it with ``ctypes``.  A source change gets a new directory, so a
stale build is never loaded.  A missing ``nvcc`` or a failed build raises.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time

__all__ = ["library", "build_info", "nvcc_path", "raise_on_error",
           "refuse_grad", "CSRC", "BUILD_ROOT"]

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = (pathlib.Path(__file__).resolve().parents[3] / "build"
              / "repro_torch_kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
_LIB_NAME = "libfoldconv.so"


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME "
                       f"({home}); the port's kernels cannot be built")


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    geom = [i32] * 13               # n .. epi, see csrc/fold_conv.cuh
    for suffix in ("", "_i8", "_bf16"):    # fp32, int8, bf16 instances
        ws, os_, dw = (getattr(lib, f"fold_conv_{k}{suffix}")
                       for k in ("ws", "os", "dw"))
        ws.argtypes = [ptr] * 6 + geom + [i32, i32, ptr]   # tile, m_per_cta
        os_.argtypes = [ptr] * 5 + geom + [i32, ptr]       # tile
        # n .. epi, then tq, rows, chans, pairs (dw_geometry)
        dw.argtypes = [ptr] * 5 + [i32] * 15 + [ptr]
        ws.restype = os_.restype = dw.restype = i32
    # n .. p_pad, then c_block, the tile, the M tiles one CTA walks
    for psum in (lib.fold_conv_psum, lib.fold_conv_psum_bf16):
        psum.argtypes = [ptr] * 3 + [i32] * 13 + [ptr]
        psum.restype = i32
    # x, w, b, part, out, counters, then rows, k, n, the K chunk
    # (csrc/dense.cu)
    for dense in (lib.dense_f32, lib.dense_bf16):
        dense.argtypes = [ptr] * 6 + [i32] * 4 + [ptr]
        dense.restype = i32
    lib.conv1d_causal_vector_path.argtypes = [ptr] * 3 + [i32] * 2
    lib.conv1d_causal_vector_path.restype = i32
    lib.fold_conv_error_string.argtypes = [i32]
    lib.fold_conv_error_string.restype = ctypes.c_char_p
    for dt in ("f32", "bf16", "bf16_wbf16"):
        conv1d = getattr(lib, f"conv1d_causal_{dt}")   # x, w, out, b .. k
        conv1d.argtypes = [ptr] * 3 + [i32] * 4 + [ptr]
        conv1d.restype = i32
    for dt in ("f32", "bf16"):
        attn = getattr(lib, f"attention_fold_{dt}")   # q, k, v, out, b .. scale
        attn.argtypes = [ptr] * 4 + [i32] * 8 + [ctypes.c_float, ptr]
        attn.restype = i32
    return lib


def raise_on_error(lib: ctypes.CDLL, err: int, name: str) -> None:
    """Raise if a kernel entry point returned a CUDA error code."""
    if err != 0:
        msg = lib.fold_conv_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {err} ({msg})")


def refuse_grad(name: str, *tensors, hint: str = "") -> None:
    """Raise when grad mode is on and one of ``tensors`` requires grad:
    ``name`` writes its output through raw pointers and has no backward,
    so its result would be silently cut off from autograd.  ``None``
    entries are skipped; ``hint`` names the differentiable way, where
    there is one."""
    import torch
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} has no backward: its output would be detached from "
            f"autograd (call it under torch.no_grad(){hint})")


def _compile_all(lib_path: pathlib.Path) -> str:
    """Compile every source to an object, one ``nvcc`` each, all at once,
    link them into the library at ``lib_path``, and return the compilers'
    resource reports.  Everything is built in a private directory and the
    library renamed into place: a reader never sees half a library, and
    two processes building at once never share a file."""
    nvcc = nvcc_path()
    work = pathlib.Path(tempfile.mkdtemp(dir=lib_path.parent))
    try:
        procs = []
        for src in (p for p in _sources() if p.suffix == ".cu"):
            obj = work / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            procs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        logs, failed = [], []
        for cmd, _, proc in procs:
            _, err = proc.communicate()
            logs.append(err)
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}):\n"
                              f"{' '.join(cmd)}\n{err}")
        if failed:
            raise RuntimeError("\n".join(failed))
        cmd = [nvcc, "-shared", "-o", str(work / _LIB_NAME),
               *[str(obj) for _, obj, _ in procs]]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stderr}")
        os.replace(work / _LIB_NAME, lib_path)
        return "".join(logs)
    finally:
        shutil.rmtree(work, ignore_errors=True)


@functools.lru_cache(maxsize=None)
def _build() -> tuple:
    out_dir = BUILD_ROOT / _digest()
    lib_path = out_dir / _LIB_NAME
    log_path = out_dir / "ptxas.log"
    seconds = 0.0
    if not lib_path.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        log_path.write_text(_compile_all(lib_path))
        seconds = time.perf_counter() - t0
    log = log_path.read_text() if log_path.exists() else ""
    return _declare(ctypes.CDLL(str(lib_path))), str(lib_path), log, seconds


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    return _build()[0]


def build_info() -> dict:
    """Where the library is, the compiler's resource report, and how long
    the build took in this process (0.0 when an earlier run built it)."""
    _, path, log, seconds = _build()
    return {"path": path, "ptxas": log, "seconds": seconds}
