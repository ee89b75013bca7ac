"""The dense head ``y = x @ w + b`` with one order of sum per output,
whatever the number of rows.

``dense`` launches the hand-written CUDA kernel (``csrc/dense.cu``) on CUDA
tensors and runs its plain version on CPU tensors.  Both give row ``i``
the same bits at every batch width, so served logits equal a direct
forward of the same images bitwise, as they do in the JAX package (where
the head runs inside one compiled program).  A library matrix product
does not promise that: its algorithm may change with the row count.

The kernel splits K into chunks of ``k_chunk(K, N)`` taps, a function of
(K, N) alone: each chunk's sum runs k ascending from 0 in one thread; the chunk sums are added in a fixed
two-level tree, each group of 8 chunks in ascending order, then the group
sums in ascending order, then the bias.  It reads ``w`` once per call for
up to 8 rows and keeps their sums in registers; more rows are tiled.  It is one launch: a CTA's 8
warps sum the 8 chunks of one group and add them in shared memory, and
the last CTA of a column tile adds the group sums, found through
per-device arrival counters that the wrapper zeroes once and every
launch leaves at zero (so a CUDA graph replays it with no reset).  The
plain version computes row by row (``x[i:i+1] @ w + b``), which is
batch-invariant on the CPU too.

bf16 ``x``, ``w`` and ``b`` (all three) run the kernel's bf16 instance:
the operands are widened to fp32 as they load and summed in the same
order, and the result is rounded as the JAX package's bf16 ``x @ w + b``
rounds it: the product to bf16, then the sum with the bias to bf16.  It
reads ``w`` by 16-byte loads, 8 columns a lane and 256 a CTA, and keeps
the sums of 1, 2, 4 or 8 rows a CTA, the fewest that hold the call's rows
(``rows_per_cta``): which instance runs changes no sum's order.  A
mix of fp32 and bf16 is widened to fp32 (exact), as jnp promotes it, and
gives fp32.

No TPU kernel stands behind this one.  ``dense`` is differentiable: its
backward is plain torch with fp32 sums (``x^T g``, ``g w^T`` and the
column sums of ``g``, TF32 off), what the JAX package's ``x @ w + b``
differentiates to; a bare ``launch`` has none and raises under grad.
"""
from __future__ import annotations

from typing import Dict, List

import torch

__all__ = ["dense", "dense_plain", "launch", "k_chunk", "launch_grid",
           "rows_per_cta", "launch_counts", "reset_launch_counts", "KERNEL",
           "KERNEL_BF16"]

KERNEL = "dense"
KERNEL_BF16 = "dense_bf16"
# columns a CTA: 32 lanes x 16 bytes of w (4 fp32 or 8 bf16 columns; the
# wide instances of csrc/dense.cu), or 32 x 1 column where N is not a
# multiple of a lane's columns.  The K split counts the fp32 instance's
# 128 columns a CTA for both types: one chunking of (K, N) whatever the
# type (a 256-column split for bf16 ran no faster on VGG-16's head at
# batch 1 and 4, PERF.md), so bf16 kept its sum order when its lanes
# widened to 16 bytes.
_COLS_WIDE = {torch.float32: 128, torch.bfloat16: 256}
_COLS_PER_CTA = 128
_COLS_NARROW = 32
_ROWS_PER_CTA = 8         # at most
_GROUP = 8                # chunks per group (a CTA's warps), the first level
# warps (chunk x column tile) per row tile the K split aims at: 2048 was
# the fastest of 1024 to 8192 on VGG-16's fc layers at 224 (H100 sweeps,
# at 4 warps a CTA)
_TARGET_WARPS = 2048
# at most this many chunks (16 groups) where the chunk size allows: the
# last CTA of a tile adds one group sum per group (128 rather than 64:
# faster on VGG-16's fc3 and ResNet-18's head, level on the rest; an H100
# sweep)
_MAX_SPLITS = 128
_KC_MIN, _KC_MAX = 32, 448
_LAUNCHES: Dict[str, int] = {KERNEL: 0, KERNEL_BF16: 0}
_ENTRY = {torch.float32: ("dense_f32", KERNEL),
          torch.bfloat16: ("dense_bf16", KERNEL_BF16)}
# the arrival counters of each device, zeroed once (csrc/dense.cu)
_COUNTERS: Dict[torch.device, torch.Tensor] = {}
# every counter buffer a larger one replaced: a CUDA graph captured with
# it still points at it, so none is ever freed (each stays at zero)
_REPLACED: List[torch.Tensor] = []


def k_chunk(k: int, n: int) -> int:
    """Taps per K chunk of the kernel: a function of (K, N) alone, so the
    order of every output's sum is fixed by the layer's shape, never by
    the rows or the instance.  Enough chunks that about ``_TARGET_WARPS``
    warps share the weights' read, but no more than ``_MAX_SPLITS`` chunks
    unless K needs more, each a multiple of 8 taps between ``_KC_MIN`` and
    ``_KC_MAX``."""
    col_tiles = -(-n // _COLS_PER_CTA)
    splits = max(1, min(_MAX_SPLITS, _TARGET_WARPS // col_tiles))
    kc = -(-k // splits)
    return min(_KC_MAX, max(_KC_MIN, -(-kc // 8) * 8))


def _check(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> None:
    if x.dim() != 2 or w.dim() != 2 or b.dim() != 1 \
            or x.shape[1] != w.shape[0] or b.shape[0] != w.shape[1]:
        raise ValueError(f"dense takes x (B, K), w (K, N) and b (N), got "
                         f"{tuple(x.shape)}, {tuple(w.shape)} and "
                         f"{tuple(b.shape)}")


def _operands(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """All bf16 as they are; any other mix of fp32 and bf16 widened to
    fp32 (exact); anything else refused."""
    types = {x.dtype, w.dtype, b.dtype}
    if not types <= {torch.float32, torch.bfloat16}:
        raise ValueError(f"dense takes fp32 or bf16 operands, got "
                         f"{x.dtype}, {w.dtype} and {b.dtype}")
    if types == {torch.bfloat16}:
        return x, w, b
    return x.float(), w.float(), b.float()


def dense_plain(x: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """The plain version, row by row: each row runs the same (1, K) @
    (K, N) product whatever B is.  bf16 sums in fp32, rounds the product
    to bf16 and rounds again after the bias."""
    _check(x, w, b)
    x, w, b = _operands(x, w, b)
    if x.dtype == torch.bfloat16:
        xf, wf, bf = x.float(), w.float(), b.float()
        return torch.cat([((xf[i:i + 1] @ wf).to(torch.bfloat16).float()
                           + bf).to(torch.bfloat16)
                          for i in range(x.shape[0])])
    return torch.cat([x[i:i + 1] @ w + b for i in range(x.shape[0])])


def rows_per_cta(rows: int, dtype: torch.dtype = torch.float32) -> int:
    """Rows of x a CTA keeps sums for: 8 for fp32; for bf16 the fewest of
    1, 2, 4 and 8 that hold ``rows`` (up to 8: more are tiled by 8)."""
    if dtype != torch.bfloat16:
        return _ROWS_PER_CTA
    return next(r for r in (1, 2, 4, _ROWS_PER_CTA)
                if r >= min(rows, _ROWS_PER_CTA))


def launch_grid(rows: int, k: int, n: int,
                dtype: torch.dtype = torch.float32) -> tuple:
    """The kernel's grid for x (rows, k) @ w (k, n) of ``dtype``: (column
    tiles, groups of chunks, row tiles), with 16-byte aligned w (as torch
    allocates it)."""
    wide = _COLS_WIDE[dtype]
    cols = wide if n % (wide // 32) == 0 else _COLS_NARROW
    chunks = -(-k // k_chunk(k, n))
    return (-(-n // cols), -(-chunks // _GROUP),
            -(-rows // rows_per_cta(rows, dtype)))


def _counters(device: torch.device, tiles: int) -> torch.Tensor:
    """The device's arrival counters, at least ``tiles`` of them: zeroed
    when first made (or grown), never per call; each launch leaves them at
    zero, so a captured launch replays with no reset.  They are made
    outside any CUDA-graph capture (a capture would put them in its
    graph's memory pool), and a buffer that a larger one replaces is kept:
    a graph captured with it still reads it."""
    buf = _COUNTERS.get(device)
    if buf is None or buf.numel() < tiles:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"the head kernel needs {tiles} arrival counters on "
                f"{device}, more than it has, during a CUDA-graph capture: "
                "run the forward once outside the capture first")
        if buf is not None:
            _REPLACED.append(buf)
        buf = torch.zeros(max(tiles, 4096), device=device, dtype=torch.int32)
        _COUNTERS[device] = buf
    return buf


def launch(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on CUDA operands of one type (fp32, or bf16 for
    the bf16 instance) on one device; returns the (B, N) output in that
    type."""
    from repro_torch.kernels import build
    _check(x, w, b)
    build.refuse_grad("the dense kernel launch", x, w, b,
                      hint=", or train through dense(), which has one")
    for t in (x, w, b):
        if t.dtype not in _ENTRY or t.dtype != x.dtype \
                or t.device != x.device:
            raise ValueError(f"the dense kernel takes fp32 or bf16 operands "
                             f"of one type on {x.device}, got {t.dtype} on "
                             f"{t.device}")
    rows, k = x.shape
    n = w.shape[1]
    if max(rows, k) * n >= 2 ** 31 or rows * k >= 2 ** 31:
        raise ValueError(f"the dense kernel indexes rows with 32-bit "
                         f"offsets: x {tuple(x.shape)}, w {tuple(w.shape)}")
    x, w, b = x.contiguous(), w.contiguous(), b.contiguous()
    kc = k_chunk(k, n)
    _, groups, row_tiles = launch_grid(rows, k, n, x.dtype)
    out = torch.empty((rows, n), device=x.device, dtype=x.dtype)
    part = torch.empty((groups, rows, n), device=x.device,
                       dtype=torch.float32)
    # one counter per (row tile, column tile of the narrowest kind)
    counters = _counters(x.device, row_tiles * -(-n // _COLS_NARROW))
    entry, name = _ENTRY[x.dtype]
    lib = build.library()
    err = getattr(lib, entry)(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), part.data_ptr(),
        out.data_ptr(), counters.data_ptr(), rows, k, n, kc,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.raise_on_error(lib, err, name)
    _LAUNCHES[name] += 1
    return out


def _dense_forward(x: torch.Tensor, w: torch.Tensor,
                   b: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cuda":
        return launch(*_operands(x, w, b))
    if x.device.type == "cpu":
        return dense_plain(x, w, b)
    raise ValueError(f"dense runs on cuda or cpu tensors, got {x.device}")


class _Dense(torch.autograd.Function):
    """``dense`` under autograd: the forward as ``dense`` runs it, the
    backward in plain torch with fp32 sums, each gradient rounded once to
    its operand's type."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        ctx.b_dtype = b.dtype
        return _dense_forward(x, w, b)

    @staticmethod
    def backward(ctx, g):
        from repro_torch.kernels.ref import full_fp32
        x, w = ctx.saved_tensors
        g32 = g.float()
        with full_fp32():
            dx = (g32 @ w.float().T).to(x.dtype)
            dw = (x.float().T @ g32).to(w.dtype)
        return dx, dw, g32.sum(dim=0).to(ctx.b_dtype)


def dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x (B, K) @ w (K, N) + b (N) -> (B, N).  On CUDA tensors this launches
    the kernel (or raises); on CPU tensors it runs the plain version.
    fp32 and bf16 may mix (``_operands``).  Under grad mode with an operand
    that requires grad it records the plain backward (``_Dense``)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, w, b)):
        return _Dense.apply(x, w, b)
    return _dense_forward(x, w, b)


def launch_counts() -> Dict[str, int]:
    """Kernel launches so far, by kernel name."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0
