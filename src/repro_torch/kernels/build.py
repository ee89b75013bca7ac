"""Build and load the port's CUDA kernels.

``library()`` compiles ``csrc/*.cu`` with ``nvcc`` into a shared library
with a plain C interface, at first use, into
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

__all__ = ["library", "build_info", "nvcc_path", "CSRC", "BUILD_ROOT"]

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = (pathlib.Path(__file__).resolve().parents[3] / "build"
              / "repro_torch_kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
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
                       f"({home}); the fold kernels cannot be built")


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
    common = [i32] * 15                # n .. mq, see csrc/fold_conv.cu
    for suffix in ("", "_i8"):             # the fp32 and int8 instances
        ws, os_, dw = (getattr(lib, f"fold_conv_{k}{suffix}")
                       for k in ("ws", "os", "dw"))
        ws.argtypes = [ptr] * 6 + common + [i32, i32, ptr]
        os_.argtypes = [ptr] * 5 + common + [i32, ptr]
        dw.argtypes = [ptr] * 5 + [i32] * 11 + [ptr]
        ws.restype = os_.restype = dw.restype = i32
    # n .. p_block, then mq and threads
    lib.fold_conv_psum.argtypes = [ptr] * 3 + [i32] * 15 + [ptr]
    lib.fold_conv_psum.restype = i32
    lib.fold_conv_error_string.argtypes = [i32]
    lib.fold_conv_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _build() -> tuple:
    out_dir = BUILD_ROOT / _digest()
    lib_path = out_dir / _LIB_NAME
    log_path = out_dir / "ptxas.log"
    seconds = 0.0
    if not lib_path.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        # build to a private name, then rename: a reader never sees half
        # a library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
               *[str(p) for p in _sources() if p.suffix == ".cu"]]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stderr}")
        log_path.write_text(proc.stderr)
        os.replace(tmp, lib_path)
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
