"""The dense head ``y = x @ w + b`` with one order of sum per output,
whatever the number of rows.

``dense`` launches the hand-written CUDA kernel (``csrc/dense.cu``) on CUDA
tensors and runs its plain version on CPU tensors.  Both give row ``i``
the same bits at every batch width, so served logits equal a direct
forward of the same images bitwise, as they do in the JAX package (where
the head runs inside one compiled program).  A library matrix product
does not promise that: its algorithm may change with the row count.

The kernel splits K into chunks of ``k_chunk(K, N)`` taps, a function of
(K, N) alone: each chunk's sum runs k ascending from 0 in one thread, the
chunk sums are added in ascending order, then the bias.  It reads ``w``
once per call for up to 8 rows and keeps their sums in registers; more
rows are tiled.  The plain version computes row by row
(``x[i:i+1] @ w + b``), which is batch-invariant on the CPU too.

No TPU kernel stands behind this one.  Forward only, fp32.
"""
from __future__ import annotations

from typing import Dict

import torch

__all__ = ["dense", "dense_plain", "launch", "k_chunk", "launch_counts",
           "reset_launch_counts", "KERNEL"]

KERNEL = "dense"
_COLS_PER_CTA = 512       # 128 threads x 4 columns (csrc/dense.cu)
# CTAs per row tile the K split aims at: the fastest of 256 to 2048 on
# VGG-16's fc layers at 224 (an H100 sweep)
_TARGET_CTAS = 512
_KC_MIN, _KC_MAX = 32, 1024
_LAUNCHES: Dict[str, int] = {KERNEL: 0}


def k_chunk(k: int, n: int) -> int:
    """Taps per K chunk of the kernel: a function of (K, N) alone, so the
    order of every output's sum is fixed by the layer's shape.  Enough
    chunks that about ``_TARGET_CTAS`` CTAs share the weights' read, each
    chunk a multiple of 8 taps between ``_KC_MIN`` and ``_KC_MAX``."""
    col_tiles = -(-n // _COLS_PER_CTA)
    splits = max(1, _TARGET_CTAS // col_tiles)
    kc = -(-k // splits)
    return min(_KC_MAX, max(_KC_MIN, -(-kc // 8) * 8))


def _check(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> None:
    if x.dim() != 2 or w.dim() != 2 or b.dim() != 1 \
            or x.shape[1] != w.shape[0] or b.shape[0] != w.shape[1]:
        raise ValueError(f"dense takes x (B, K), w (K, N) and b (N), got "
                         f"{tuple(x.shape)}, {tuple(w.shape)} and "
                         f"{tuple(b.shape)}")


def dense_plain(x: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """The plain version, row by row: each row runs the same (1, K) @
    (K, N) product whatever B is."""
    _check(x, w, b)
    return torch.cat([x[i:i + 1] @ w + b for i in range(x.shape[0])])


def launch(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on fp32 CUDA operands on one device; returns the
    (B, N) output."""
    from repro_torch.kernels import build
    _check(x, w, b)
    for t in (x, w, b):
        if t.dtype != torch.float32 or t.device != x.device:
            raise ValueError(f"the dense kernel takes fp32 operands on "
                             f"{x.device}, got {t.dtype} on {t.device}")
    rows, k = x.shape
    n = w.shape[1]
    if max(rows, k) * n >= 2 ** 31 or rows * k >= 2 ** 31:
        raise ValueError(f"the dense kernel indexes rows with 32-bit "
                         f"offsets: x {tuple(x.shape)}, w {tuple(w.shape)}")
    x, w, b = x.contiguous(), w.contiguous(), b.contiguous()
    kc = k_chunk(k, n)
    out = torch.empty((rows, n), device=x.device, dtype=torch.float32)
    part = torch.empty((-(-k // kc), rows, n), device=x.device,
                       dtype=torch.float32)
    lib = build.library()
    err = lib.dense_f32(x.data_ptr(), w.data_ptr(), b.data_ptr(),
                        part.data_ptr(), out.data_ptr(), rows, k, n, kc,
                        torch.cuda.current_stream(x.device).cuda_stream)
    build.raise_on_error(lib, err, KERNEL)
    _LAUNCHES[KERNEL] += 1
    return out


def dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x (B, K) @ w (K, N) + b (N) -> (B, N).  On CUDA tensors this launches
    the kernel (or raises); on CPU tensors it runs the plain version."""
    if x.device.type == "cuda":
        return launch(x, w, b)
    if x.device.type == "cpu":
        return dense_plain(x, w, b)
    raise ValueError(f"dense runs on cuda or cpu tensors, got {x.device}")


def launch_counts() -> Dict[str, int]:
    """Kernel launches so far, by kernel name."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    _LAUNCHES[KERNEL] = 0
