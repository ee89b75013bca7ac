"""Fold-streamed convolution: the paper's two dataflows and the depthwise
fold as hand-written CUDA kernels for Hopper, with their plain-torch fold
loops beside them.

The dense kernels compute, for one conv layer on the pre-padded input
``x (N, C, Xp, Yp)`` and ``w (NF, C, R, S)``::

    out = epilogue(sum_{c,r,s} w[f,c,r,s] * x[n, c, p*stride+r, q*stride+s])

with the epilogue bias -> BN scale/shift -> residual add -> ReLU or ReLU6
-> optional 2x2/2 max-pool, the sum taken in true fp32 (FFMA on the CUDA
cores: ``wgmma`` takes no fp32 operands and TF32 is not fp32; bf16
operands' products, exact in fp32, are summed in fp32 on the tensor cores
by the bf16 WS, OS and psum kernels), and the output written to device
memory once — the pre-activation never reaches it.  Bias, scale and shift ride
in one ``(NF_pad, 3)`` vector block (``_vector_block``); the residual is
an ``(N, NF, P, Q)`` shortcut.  The dense kernels differ in loop order,
as the paper's dataflows do:

* ``weight_stationary`` (replaces ``repro/kernels/conv2d_ws.py:_ws_kernel``):
  per depth fold a CTA keeps its filter tile resident in shared memory
  and walks its share of the image's pixel tiles past it.  With more
  than one depth fold the partial sums live in an fp32 (int32) slab that
  only that CTA reads and writes, in a fixed order.
* ``output_stationary`` (replaces ``_os_kernel``): a CTA owns an output
  tile held in registers across the whole depth and streams the weights
  and the input through shared memory.

Both run one tile core, an implicit GEMM over (pixels, one group's
filters, the group's taps) with a register tile per thread (in bf16, the
same GEMM on the tensor cores, ``csrc/fold_conv_tc.cuh``); the CTA tile
of each launch comes from ``fold_tile``, a pure function of the launch
spec, the operand type and the SM count.  Grouped layers
(1 < G < C) run on both: a filter tile never straddles a group and reads
its own group's channels.

The third, ``depthwise`` (replaces ``_dw_kernel``), is the groups == C ==
NF fold: ``w (C, 1, R, S)``, one filter per channel, no depth reduction,
the R*S taps multiplied elementwise and the epilogue flushed for every
output at once.

The fourth, ``weight_stationary_psum`` (replaces ``_ws_psum_kernel``), is
the paper's Fig. 5 formulation and the WS accumulator's spill for an
identity epilogue: every depth fold writes its fp32 partial sums to a
``(g_c, N, NF_pad, P_pad, Q)`` staging buffer in device memory, and
``conv2d_folded`` sums the folds afterwards with ``torch.sum``.  It runs
on the WS / OS tile core (bf16: the tensor-core one), its depth folds
side by side on the grid.

**Int8** ``x`` and ``w`` select the quantized stream of the WS, OS and
depthwise kernels: each operand widens to int32 before the multiply, the
depth folds accumulate in int32 (exact in any order), and the flush
converts to fp32 and applies the requant affine the caller put in the
scale/shift slot (``core/quant.py:requant_affine``;
``kernels/ops.py:conv2d_int8`` is the packaged entry point).  The output
is fp32.  The psum staging has no flush to dequantize at and refuses
int8, as the JAX package does.

**bf16** operands (``*_bf16`` instances of all four kernels) give fp32
sums of exact bf16 products, an fp32 WS slab and an fp32 epilogue, and
each output is rounded once to bf16 at the store (the psum staging rounds
each depth fold's partial sums, as the JAX package stores them in the
output type): the JAX package's arithmetic (``_fold_partial`` widens both
operands).  The WS, OS and psum instances run ``mma.sync`` m16n8k16 on
the tensor cores with bf16 operands in shared memory (``TC_TILES``); the
depthwise instance widens each bf16 value to fp32 as it loads and runs
FFMA.  fp32 and bf16 may mix: the wrapper widens the bf16 operand (exact)
and runs the fp32 instance, then rounds to ``out_dtype``.

The kernels are in ``csrc/fold_conv.cuh`` and ``csrc/fold_conv_tc.cuh``
(entry points: ``fold_conv.cu``, ``fold_conv_bf16.cu``); ``build.py``
compiles them at first use.  On a CPU tensor ``conv2d_folded`` runs the
plain-torch version of the same fold loop (``conv2d_folded_plain``:
``_fold_partial`` + ``_flush_value`` + the WS/OS grid walk, or the
depthwise walk); on a CUDA tensor it launches the kernel or raises.

The order of the sum for one output element is channel-ascending, then
R, then S, from 0, in the dense kernels, and R then S in the depthwise
one: one fused multiply-add a tap on the FFMA core, one ``mma.sync`` a
16-tap step on the tensor cores (bf16 WS, OS and psum; the steps start
at each depth fold's first tap, as ``csrc/fold_conv_tc.cuh`` states).  It
depends only on (C/G, R, S, c_block) — never on N, the grid, the CTA tile
or the dataflow — so a layer gives bitwise-identical rows at every batch
width (int8 sums are exact, so their order does not matter at all), and
the two dataflows give the same bits in fp32, int8 and bf16.  The
epilogue rounds each step on its own (no fused multiply-add), so a fused
layer gives the bits of the same steps run as separate torch ops.

Inputs are NCHW, weights OIHW.  The caller pre-pads spatially
(``ops.py``).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.epilogue import Epilogue, epilogue_out_hw, maxpool2x2
from repro_torch.core.loopnest import ConvLoopNest
from repro_torch.core.mapping import (WS_ACC_BYTES_LIMIT, ConvBlockPlan,
                                      plan_conv_blocks)

__all__ = ["conv2d_folded", "conv2d_folded_plain", "DATAFLOWS",
           "default_plan",
           "OperandSpec", "FoldKernelSpec", "fold_kernel_spec", "launch_ws",
           "launch_os", "launch_dw", "launch_psum", "LAUNCHERS", "KERNELS",
           "launch_counts", "reset_launch_counts", "prepare", "FoldTile",
           "fold_tile", "tile_candidates", "tile_cycles", "TILES",
           "TC_TILES", "tile_core", "tile_count", "tile_shape",
           "tile_chunk", "tile_smem", "DwGeometry", "dw_geometry",
           "dw_tq_choices", "DW_THREADS", "DW_MAX_CHANS", "DW_TQS",
           "DW_POOL_TQS", "DW_WARPS_PER_SM"]

DATAFLOWS = ("weight_stationary", "output_stationary", "depthwise")


def default_plan(conv: ConvLoopNest, **kw) -> ConvBlockPlan:
    """The block plan ``conv2d_folded`` solves when it is given none
    (``plan_conv_blocks``)."""
    return plan_conv_blocks(conv, **kw)


# --------------------------------------------------------------------------
# Index maps as inspectable data
# --------------------------------------------------------------------------
# Every index map below is a *named module-level function* (bound with
# ``functools.partial`` where group geometry applies): the launch geometry
# of a fold schedule as data, in the JAX package's own terms, so the two
# packages' specs compare field by field.  Grid argument orders:
#   weight_stationary / psum : (b, f, cc, pp)   -- grid (N, nf, c, p)
#   output_stationary        : (b, f, pp, cc)   -- grid (N, nf, p, c)
#   depthwise                : (b, cc, pp)      -- grid (N, c, p)

def _ix_ws_x(b, f, cc, pp, *, nfg_folds: int, cg_folds: int):
    """Streamed input block: channel fold ``cc`` within the group the
    current filter fold ``f`` belongs to.  Dense layers are the G=1 case
    (``nfg_folds`` = all nf folds, so the group index is always 0)."""
    return (b, (f // nfg_folds) * cg_folds + cc, 0, 0)


def _ix_ws_w(b, f, cc, pp):
    """Weight fold: globally filter-indexed, per-group channel-indexed."""
    return (f, cc, 0, 0)


def _ix_ws_vec(b, f, cc, pp):
    return (f, 0)


def _ix_ws_res(b, f, cc, pp):
    """Residual rides full-height, resident like the WS accumulator."""
    return (b, f, 0, 0)


def _ix_ws_out(b, f, cc, pp):
    """Constant along (c, p): the finished output is written to device
    memory exactly once per (N, NF-fold).  P-fold revisits write
    disjoint in-block row slices (``inner_sliced_axes``)."""
    return (b, f, 0, 0)


def _ix_os_x(b, f, pp, cc, *, nfg_folds: int, cg_folds: int):
    return (b, (f // nfg_folds) * cg_folds + cc, 0, 0)


def _ix_os_w(b, f, pp, cc):
    return (f, cc, 0, 0)


def _ix_os_vec(b, f, pp, cc):
    return (f, 0)


def _ix_os_res(b, f, pp, cc):
    return (b, f, pp, 0)


def _ix_os_out(b, f, pp, cc):
    """Constant along c only: the depth sweep accumulates into the
    block-sized scratch and writes the block once."""
    return (b, f, pp, 0)


def _ix_dw_x(b, cc, pp):
    return (b, cc, 0, 0)


def _ix_dw_w(b, cc, pp):
    return (cc, 0, 0, 0)


def _ix_dw_vec(b, cc, pp):
    return (cc, 0)


def _ix_dw_res(b, cc, pp):
    return (b, cc, pp, 0)


def _ix_dw_out(b, cc, pp):
    return (b, cc, pp, 0)


def _ix_psum_out(b, f, cc, pp):
    """One partial-sum fold per depth fold: cc addresses a leading psum
    axis, so every grid point owns a distinct output block (no revisits)."""
    return (cc, b, f, pp, 0)


@dataclasses.dataclass(frozen=True)
class OperandSpec:
    """One kernel operand: its block shape, the (padded) array shape the
    kernel binds, and the fold index map as an inspectable callable.
    ``role`` is one of x | w | vec | residual | out."""
    role: str
    block: Tuple[int, ...]
    array_shape: Tuple[int, ...]
    index_map: Callable[..., Tuple[int, ...]]


@dataclasses.dataclass(frozen=True)
class FoldKernelSpec:
    """The complete static description of one fold-streamed conv kernel
    launch: resolved dataflow, grid, and every operand's block geometry
    as data.  ``conv2d_folded`` pads its operands to the spec's array
    shapes and sizes its CUDA launch from the spec's plan.

    ``reduction_axis`` is the depth-fold grid axis (the only axis allowed
    to revisit the accumulator/output block); ``inner_sliced_axes`` are
    grid axes whose output revisits are *disjoint in-block sub-slices*
    (the WS kernel's per-P-fold rows), not races.
    """
    dataflow: str                       # resolved (post-fallback)
    requested: str                      # dataflow as requested by caller
    grid: Tuple[int, ...]
    grid_axes: Tuple[str, ...]          # loop-nest name per grid axis
    reduction_axis: Optional[int]
    inner_sliced_axes: Tuple[int, ...]
    inputs: Tuple[OperandSpec, ...]
    output: OperandSpec
    epilogue: Epilogue
    plan: ConvBlockPlan                 # clamped to this layer's dims
    groups: int
    nfg_folds: int                      # nf folds per group (g_nf / G)
    cg_folds: int                       # c folds per group (= depth folds)
    nf: int
    c: int
    p: int
    q: int
    r: int
    s: int
    stride: int
    nf_pad: int
    c_pad: int
    p_pad: int
    x_rows: int                         # padded input rows the kernel sees
    p_block: int                        # post pool-even bump
    p_valid: int
    q_valid: int


def fold_kernel_spec(x_shape: Tuple[int, int, int, int],
                     w_shape: Tuple[int, int, int, int], *,
                     stride: int = 1,
                     plan: Optional[ConvBlockPlan] = None,
                     dataflow: str = "weight_stationary",
                     epilogue: Optional[Epilogue] = None,
                     groups: int = 1) -> FoldKernelSpec:
    """Solve the complete launch geometry for a fold-streamed conv — block
    clamping, the pool-even P bump, padding, and the WS->psum/OS
    accumulator fallback — and return it as inspectable data.  Pure shape
    arithmetic: no tensors are touched, so it applies to any layer."""
    n, c, xp_, yp_ = x_shape
    nf, cw, r, s = w_shape
    assert c == cw * groups, (c, cw, groups)
    assert nf % groups == 0, (nf, groups)
    p = (xp_ - r) // stride + 1
    q = (yp_ - s) // stride + 1
    epi = epilogue or Epilogue()
    if epi.pool == "max2" and (p < 2 or q < 2):
        raise ValueError(f"cannot fuse 2x2 pool into a {p}x{q} output")
    requested = dataflow
    if dataflow == "depthwise" and not (groups > 1 and groups == c == nf):
        raise ValueError("dataflow='depthwise' needs groups == C == N_F, "
                         f"got groups={groups}, C={c}, N_F={nf}")
    if dataflow not in DATAFLOWS + ("weight_stationary_psum",):
        raise ValueError(f"unknown dataflow {dataflow!r}")
    if dataflow == "weight_stationary_psum":
        if not epi.identity:
            raise ValueError("the legacy psum dataflow has no fused epilogue")
        if groups > 1:
            raise ValueError("the legacy psum dataflow predates grouped "
                             "convolution")
    if plan is None or plan.groups != groups:
        # a plan solved for a different group structure cannot tile this
        # layer (divisibility invariants differ) — re-solve
        cv = ConvLoopNest(n=n, nf=nf, c=c, r=r, s=s,
                          x=xp_, y=yp_, stride=stride, pad=0, groups=groups)
        plan = plan_conv_blocks(cv)
    plan = plan.clamped(nf, c, p)
    nf_b, c_b, p_b = plan.nf_block, plan.c_block, plan.p_block
    g_nf, g_c, g_p = plan.grid
    pooled = epi.pool == "max2"
    if pooled and p_b % 2:
        # pool windows must not straddle P-fold boundaries
        p_b += 1
        g_p = -(-p // p_b)
    p_valid, q_valid = epilogue_out_hw(epi, p, q)
    q_o = q // 2 if pooled else q

    if dataflow == "depthwise":
        c_pad, p_pad = g_c * c_b, g_p * p_b
        rows_needed = (p_pad - 1) * stride + r
        x_rows = max(xp_, rows_needed)
        p_b_o = p_b // 2 if pooled else p_b
        p_o_pad = p_pad // 2 if pooled else p_pad
        inputs = [
            OperandSpec("x", (1, c_b, x_rows, yp_),
                        (n, c_pad, x_rows, yp_), _ix_dw_x),
            OperandSpec("w", (c_b, 1, r, s), (c_pad, 1, r, s), _ix_dw_w),
            OperandSpec("vec", (c_b, 3), (c_pad, 3), _ix_dw_vec),
        ]
        if epi.residual:
            inputs.append(OperandSpec("residual", (1, c_b, p_b, q),
                                      (n, c_pad, p_pad, q), _ix_dw_res))
        out = OperandSpec("out", (1, c_b, p_b_o, q_o),
                          (n, c_pad, p_o_pad, q_o), _ix_dw_out)
        return FoldKernelSpec(
            dataflow="depthwise", requested=requested,
            grid=(n, g_c, g_p), grid_axes=("n", "c", "p"),
            reduction_axis=None, inner_sliced_axes=(),
            inputs=tuple(inputs), output=out, epilogue=epi, plan=plan,
            groups=groups, nfg_folds=1, cg_folds=g_c,
            nf=nf, c=c, p=p, q=q, r=r, s=s, stride=stride,
            nf_pad=c_pad, c_pad=c_pad, p_pad=p_pad, x_rows=x_rows,
            p_block=p_b, p_valid=p_valid, q_valid=q_valid)

    # Pad every tiled dim to an exact block multiple: zero channels/filters
    # contribute nothing to the accumulation, and extra bottom rows only
    # produce out-of-range outputs that are sliced away.  This keeps the
    # in-kernel dynamic_slice un-clamped (fold geometry stays exact).
    # Aligned layers skip the pads entirely (no copy).  Grouped layers are
    # exactly tiled by construction (blocks divide the per-group extents),
    # so only the bottom-row pad can apply.
    if groups > 1:
        nf_pad, c_pad = nf, c
        g_nfg = g_nf // groups            # nf folds per group
    else:
        nf_pad, c_pad = g_nf * nf_b, g_c * c_b
        g_nfg = g_nf
    p_pad = g_p * p_b
    rows_needed = (p_pad - 1) * stride + r
    x_rows = max(xp_, rows_needed)

    # a fused residual rides along full-height, resident like the
    # accumulator — it doubles the WS footprint the spill check must price
    ws_resident = nf_b * p_pad * q * 4 * (2 if epi.residual else 1)
    if (dataflow == "weight_stationary"
            and ws_resident > WS_ACC_BYTES_LIMIT):
        # the full-height fp32 accumulator (+ resident residual) would not
        # fit WS_ACC_BYTES_LIMIT: fall back to psum staging (or to the
        # block-accumulator OS kernel when an epilogue must flush
        # in-kernel, and always for grouped layers — the psum formulation
        # predates groups) — mirrored by the spill price in
        # ``core/engine.py:dataflow_traffic_bytes``
        dataflow = ("weight_stationary_psum"
                    if epi.identity and groups == 1
                    else "output_stationary")

    if dataflow == "weight_stationary_psum":
        inputs = [
            OperandSpec("x", (1, c_b, x_rows, yp_), (n, c_pad, x_rows, yp_),
                        functools.partial(_ix_ws_x, nfg_folds=g_nfg,
                                          cg_folds=g_c)),
            OperandSpec("w", (nf_b, c_b, r, s),
                        (nf_pad, c_pad // groups, r, s), _ix_ws_w),
        ]
        # out: one partial-sum fold per depth fold (paper Fig 5, staged in
        # device memory — the formulation the in-kernel reduction replaces)
        out = OperandSpec("out", (1, 1, nf_b, p_b, q),
                          (g_c, n, nf_pad, p_pad, q), _ix_psum_out)
        return FoldKernelSpec(
            dataflow="weight_stationary_psum", requested=requested,
            grid=(n, g_nf, g_c, g_p), grid_axes=("n", "nf", "c", "p"),
            reduction_axis=None, inner_sliced_axes=(),
            inputs=tuple(inputs), output=out, epilogue=epi, plan=plan,
            groups=groups, nfg_folds=g_nfg, cg_folds=g_c,
            nf=nf, c=c, p=p, q=q, r=r, s=s, stride=stride,
            nf_pad=nf_pad, c_pad=c_pad, p_pad=p_pad, x_rows=x_rows,
            p_block=p_b, p_valid=p_valid, q_valid=q_valid)

    if dataflow == "weight_stationary":
        p_o_pad = p_pad // 2 if pooled else p_pad
        inputs = [
            OperandSpec("x", (1, c_b, x_rows, yp_), (n, c_pad, x_rows, yp_),
                        functools.partial(_ix_ws_x, nfg_folds=g_nfg,
                                          cg_folds=g_c)),
            OperandSpec("w", (nf_b, c_b, r, s),
                        (nf_pad, c_pad // groups, r, s), _ix_ws_w),
            OperandSpec("vec", (nf_b, 3), (nf_pad, 3), _ix_ws_vec),
        ]
        if epi.residual:
            # resident like the output: constant along (c, p)
            inputs.append(OperandSpec("residual", (1, nf_b, p_pad, q),
                                      (n, nf_pad, p_pad, q), _ix_ws_res))
        out = OperandSpec("out", (1, nf_b, p_o_pad, q_o),
                          (n, nf_pad, p_o_pad, q_o), _ix_ws_out)
        return FoldKernelSpec(
            dataflow="weight_stationary", requested=requested,
            grid=(n, g_nf, g_c, g_p), grid_axes=("n", "nf", "c", "p"),
            reduction_axis=2, inner_sliced_axes=(3,),
            inputs=tuple(inputs), output=out, epilogue=epi, plan=plan,
            groups=groups, nfg_folds=g_nfg, cg_folds=g_c,
            nf=nf, c=c, p=p, q=q, r=r, s=s, stride=stride,
            nf_pad=nf_pad, c_pad=c_pad, p_pad=p_pad, x_rows=x_rows,
            p_block=p_b, p_valid=p_valid, q_valid=q_valid)

    # output_stationary
    p_b_o = p_b // 2 if pooled else p_b
    p_o_pad = p_pad // 2 if pooled else p_pad
    inputs = [
        OperandSpec("x", (1, c_b, x_rows, yp_), (n, c_pad, x_rows, yp_),
                    functools.partial(_ix_os_x, nfg_folds=g_nfg,
                                      cg_folds=g_c)),
        OperandSpec("w", (nf_b, c_b, r, s),
                    (nf_pad, c_pad // groups, r, s), _ix_os_w),
        OperandSpec("vec", (nf_b, 3), (nf_pad, 3), _ix_os_vec),
    ]
    if epi.residual:
        inputs.append(OperandSpec("residual", (1, nf_b, p_b, q),
                                  (n, nf_pad, p_pad, q), _ix_os_res))
    out = OperandSpec("out", (1, nf_b, p_b_o, q_o),
                      (n, nf_pad, p_o_pad, q_o), _ix_os_out)
    return FoldKernelSpec(
        dataflow="output_stationary", requested=requested,
        grid=(n, g_nf, g_p, g_c), grid_axes=("n", "nf", "p", "c"),
        reduction_axis=3, inner_sliced_axes=(),
        inputs=tuple(inputs), output=out, epilogue=epi, plan=plan,
        groups=groups, nfg_folds=g_nfg, cg_folds=g_c,
        nf=nf, c=c, p=p, q=q, r=r, s=s, stride=stride,
        nf_pad=nf_pad, c_pad=c_pad, p_pad=p_pad, x_rows=x_rows,
        p_block=p_b, p_valid=p_valid, q_valid=q_valid)



def _pad_to(arr: torch.Tensor, shape: Tuple[int, ...]) -> torch.Tensor:
    """Zero-pad ``arr`` up to ``shape`` (a contiguous no-copy when already
    aligned)."""
    pads = [t - d for d, t in zip(arr.shape, shape)]
    if not any(pads):
        return arr.contiguous()
    flat = []
    for hi in reversed(pads):            # F.pad wants last dim first
        flat += [0, hi]
    return F.pad(arr, flat)


# --------------------------------------------------------------------------
# What the kernels take
# --------------------------------------------------------------------------

_FLOATS = (torch.float32, torch.bfloat16)


def _check_operands(x_padded: torch.Tensor, w: torch.Tensor,
                    dataflow: str) -> None:
    """Take what the JAX package takes: fp32 and bf16 operands in any mix,
    or int8 with int8; refuse anything else (``ValueError``)."""
    if x_padded.dtype == torch.int8:
        if w.dtype != torch.int8:
            raise ValueError(f"int8 activations need int8 weights, got "
                             f"w dtype {w.dtype}")
        if dataflow == "weight_stationary_psum":
            raise ValueError("the legacy psum dataflow cannot stream int8 "
                             "(its HBM-staged partial sums have no flush "
                             "hook to apply the dequant scale at)")
    elif x_padded.dtype not in _FLOATS or w.dtype not in _FLOATS:
        raise ValueError(f"the fold kernels take fp32 / bf16 or int8 "
                         f"operands, got x {x_padded.dtype} and w {w.dtype}")


def _resolve_out_dtype(x_padded: torch.Tensor,
                       out_dtype: Optional[torch.dtype]) -> torch.dtype:
    """x's type for a float stream and fp32 for int8, unless the caller
    names one (``repro/kernels/conv2d_ws.py:conv2d_folded``)."""
    if out_dtype is not None:
        return out_dtype
    return torch.float32 if x_padded.dtype == torch.int8 else x_padded.dtype


def _stream_dtype(x_padded: torch.Tensor, w: torch.Tensor,
                  residual: Optional[torch.Tensor],
                  out_dtype: torch.dtype) -> torch.dtype:
    """The operand type the kernels stream: int8 for int8, bf16 where x, w
    and the residual are bf16 and so is the output, else fp32.  A mixed
    call widens its bf16 operands to fp32, which is exact, so it does the
    JAX package's arithmetic (each operand widened, fp32 sums)."""
    if x_padded.dtype == torch.int8:
        return torch.int8
    if (x_padded.dtype == w.dtype == out_dtype == torch.bfloat16
            and (residual is None or residual.dtype == torch.bfloat16)):
        return torch.bfloat16
    return torch.float32


def _vector_block(nf: int, nf_pad: int, epi: Epilogue,
                  bias: Optional[torch.Tensor],
                  scale: Optional[torch.Tensor],
                  shift: Optional[torch.Tensor],
                  device: torch.device) -> torch.Tensor:
    """The (nf_pad, 3) per-filter vector block every fold kernel carries:
    column 0 the bias, columns 1-2 the folded-BN scale/shift.  Columns the
    epilogue does not enable are zeros and never read."""
    vec = torch.zeros((nf_pad, 3), dtype=torch.float32, device=device)
    if epi.bias:
        vec[:nf, 0] = bias
    if epi.scale:
        vec[:nf, 1] = scale
        vec[:nf, 2] = shift
    return vec


# --------------------------------------------------------------------------
# The plain-torch fold loop (the CPU path and the kernels' oracle)
# --------------------------------------------------------------------------

def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    """The accumulator type of a stream: int32 for int8, else fp32."""
    return torch.int32 if x.dtype == torch.int8 else torch.float32


def _fold_partial(xv: torch.Tensor, w: torch.Tensor, i_p: int, *, r: int,
                  s: int, stride: int, p_block: int, q: int) -> torch.Tensor:
    """One fold interaction (Fig 4): R*S stationary taps against a strided
    window of the image rows.  xv (N, c_b, rows, Y), w (nf_b, c_b, R, S)
    -> (N, nf_b, p_block, q) in fp32, or in int32 for int8 operands: each
    tap's contraction then runs in float64 (exact for int8 products at any
    depth a layer has; PyTorch has no integer matmul on CUDA) and adds
    into the int32 sum."""
    row0 = i_p * p_block * stride
    rows = (p_block - 1) * stride + r
    xwin = xv[:, :, row0:row0 + rows]
    acc_dtype = _acc_dtype(xv)
    tap_dtype = torch.float64 if acc_dtype == torch.int32 else torch.float32
    acc = xv.new_zeros((xv.shape[0], w.shape[0], p_block, q),
                       dtype=acc_dtype)
    for ri in range(r):
        for si in range(s):
            win = xwin[:, :, ri:ri + p_block * stride:stride,
                       si:si + q * stride:stride]        # (N, c_b, p_b, q)
            acc += torch.einsum("fc,ncpq->nfpq", w[:, :, ri, si].to(tap_dtype),
                                win.to(tap_dtype)).to(acc_dtype)
    return acc


def _flush_value(v: torch.Tensor, vec: torch.Tensor, epi: Epilogue,
                 res: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Apply the fused epilogue to a finished fold (N, nf_b, p_b, q), fp32
    or the int32 sums of an int8 stream (converted to fp32 first), in the
    JAX order: bias -> scale/shift -> residual -> ReLU or ReLU6 -> 2x2
    pool.  ``vec`` is the fold's (nf_b, 3) slice of the vector block,
    ``res`` the fold's slice of the shortcut."""
    v = v.float()
    if epi.bias:
        v = v + vec[:, 0][None, :, None, None]
    if epi.scale:                            # inference BN: y*scale + shift
        v = (v * vec[:, 1][None, :, None, None]
             + vec[:, 2][None, :, None, None])
    if epi.residual:
        v = v + res                          # ResNet shortcut, pre-ReLU
    if epi.relu:
        v = torch.relu(v)
    if epi.relu6:
        v = torch.clamp(v, 0.0, 6.0)         # MobileNet activation
    if epi.pool == "max2":
        v = maxpool2x2(v)        # p_b forced even: windows stay in-fold
    return v


def _plain_walk(spec: "FoldKernelSpec", xp: torch.Tensor, wp: torch.Tensor,
                vec: torch.Tensor, res: Optional[torch.Tensor]
                ) -> torch.Tensor:
    """The WS / OS grid walk of the TPU kernels, fold by fold, in torch;
    grouped layers read each filter fold's own group of input channels."""
    epi = spec.epilogue
    nf_b, c_b = spec.plan.nf_block, spec.plan.c_block
    p_b, q, g_c = spec.p_block, spec.q, spec.cg_folds
    g_nf, g_p = spec.nf_pad // nf_b, spec.p_pad // p_b
    p_bo = p_b // 2 if epi.pool == "max2" else p_b
    kw = dict(r=spec.r, s=spec.s, stride=spec.stride, p_block=p_b, q=q)
    out = xp.new_empty(spec.output.array_shape, dtype=torch.float32)
    for f in range(g_nf):
        fs = slice(f * nf_b, (f + 1) * nf_b)
        # the input channels of depth fold c of this filter fold's group
        # (``_ix_ws_x``); the weights are channel-indexed within the group
        grp = f // spec.nfg_folds
        xs = [slice((grp * g_c + c) * c_b, (grp * g_c + c + 1) * c_b)
              for c in range(g_c)]
        if spec.dataflow == "weight_stationary":
            # grid (N, nf, c, p), p fastest: the full-height accumulator
            acc = xp.new_empty((xp.shape[0], nf_b, spec.p_pad, q),
                               dtype=_acc_dtype(xp))
            for c in range(g_c):
                cs = slice(c * c_b, (c + 1) * c_b)
                for i_p in range(g_p):
                    rows = slice(i_p * p_b, (i_p + 1) * p_b)
                    part = _fold_partial(xp[:, xs[c]], wp[fs, cs], i_p, **kw)
                    acc[:, :, rows] = part if c == 0 else acc[:, :, rows] + part
                    if c == g_c - 1:
                        r_ = res[:, fs, rows] if epi.residual else None
                        out[:, fs, i_p * p_bo:(i_p + 1) * p_bo] = \
                            _flush_value(acc[:, :, rows], vec[fs], epi, r_)
        else:
            # grid (N, nf, p, c), c fastest: a block-sized accumulator
            for i_p in range(g_p):
                acc = None
                for c in range(g_c):
                    cs = slice(c * c_b, (c + 1) * c_b)
                    part = _fold_partial(xp[:, xs[c]], wp[fs, cs], i_p, **kw)
                    acc = part if acc is None else acc + part
                rows = slice(i_p * p_b, (i_p + 1) * p_b)
                r_ = res[:, fs, rows] if epi.residual else None
                out[:, fs, i_p * p_bo:(i_p + 1) * p_bo] = \
                    _flush_value(acc, vec[fs], epi, r_)
    return out


def _plain_psum_walk(spec: "FoldKernelSpec", xp: torch.Tensor,
                     wp: torch.Tensor, vec: Optional[torch.Tensor] = None,
                     res: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The grid walk (N, nf, c, p) of ``_ws_psum_kernel``: each depth fold's
    fp32 partial sums land in their own slice of the (g_c, N, NF_pad,
    P_pad, Q) staging buffer, unsummed."""
    nf_b, c_b = spec.plan.nf_block, spec.plan.c_block
    p_b, g_c = spec.p_block, spec.cg_folds
    kw = dict(r=spec.r, s=spec.s, stride=spec.stride, p_block=p_b, q=spec.q)
    out = xp.new_empty(spec.output.array_shape, dtype=torch.float32)
    for f in range(spec.nf_pad // nf_b):
        fs = slice(f * nf_b, (f + 1) * nf_b)
        for c in range(g_c):
            cs = slice(c * c_b, (c + 1) * c_b)
            for i_p in range(spec.p_pad // p_b):
                out[c, :, fs, i_p * p_b:(i_p + 1) * p_b] = _fold_partial(
                    xp[:, cs], wp[fs, cs], i_p, **kw)
    return out


def _plain_dw_walk(spec: "FoldKernelSpec", xp: torch.Tensor,
                   wp: torch.Tensor, vec: torch.Tensor,
                   res: Optional[torch.Tensor]) -> torch.Tensor:
    """The depthwise grid walk (N, c folds, p folds) of ``_dw_kernel``: no
    depth reduction, R*S elementwise taps per channel, R then S, and the
    epilogue flushed at every step.  Int8 operands widen to int32 before
    the product."""
    epi = spec.epilogue
    c_b, p_b, q, st = spec.plan.c_block, spec.p_block, spec.q, spec.stride
    p_bo = p_b // 2 if epi.pool == "max2" else p_b
    rows = (p_b - 1) * st + spec.r
    acc_dtype = _acc_dtype(xp)
    out = xp.new_empty(spec.output.array_shape, dtype=torch.float32)
    for cc in range(spec.c_pad // c_b):
        cs = slice(cc * c_b, (cc + 1) * c_b)
        for i_p in range(spec.p_pad // p_b):
            row0 = i_p * p_b * st
            xwin = xp[:, cs, row0:row0 + rows].to(acc_dtype)
            acc = xp.new_zeros((xp.shape[0], c_b, p_b, q), dtype=acc_dtype)
            for ri in range(spec.r):
                for si in range(spec.s):
                    win = xwin[:, :, ri:ri + p_b * st:st,
                               si:si + q * st:st]          # (N, c_b, p_b, q)
                    acc += win * wp[cs, 0, ri, si].to(acc_dtype)[
                        None, :, None, None]
            p_rows = slice(i_p * p_b, (i_p + 1) * p_b)
            r_ = res[:, cs, p_rows] if epi.residual else None
            out[:, cs, i_p * p_bo:(i_p + 1) * p_bo] = \
                _flush_value(acc, vec[cs], epi, r_)
    return out


# --------------------------------------------------------------------------
# The CUDA launches
# --------------------------------------------------------------------------
#
# Bound on the H100: the FFMA rate for fp32.  A 3x3 VGG layer does 2*C*9
# flops per output element for 4 bytes written, far above the card's ~20
# flop/byte fp32 ridge, so the fp32 dense kernels are compute-bound by the
# 67 TFLOP/s fp32 CUDA-core peak (``wgmma`` takes no fp32 operands, and
# TF32 is not fp32).  What the design does about it (the note at the head
# of ``csrc/fold_conv.cuh``): the WS and OS kernels share one tile core, an
# implicit GEMM of M = output pixels (n, p, q) by N = one group's filters
# over K = the group's (c, r, s) taps, with a TM x TN register tile per
# thread fed by 16-byte shared-memory reads, the input gathered a chunk
# ahead and the OS weights streamed PB chunks ahead.  ``fold_tile`` picks
# the CTA tile of each launch from ``TILES`` by ``tile_cycles``, a model
# of issue slots, latency and rounds fitted to the card, so a 4x4 layer at
# batch 4 gets small tiles and a 224x224 one large tiles.  The sum of each
# output runs c, r, s from 0 in one thread whatever the tile, so the tile
# changes no bit.  What binds the kernels short of the FFMA rate is the
# gather (one 4-byte load per tap and pixel) and, on the smallest layers,
# too few outputs to fill the card: nothing splits K (PERF.md).
#
# The depthwise kernel's bound is bytes instead: 2*R*S flops per output
# element (18 at 3x3) against the bytes it writes and about as many it
# reads, far below the ridge.  But the zoo's depthwise layers move 0.1-2 MB
# each, a fraction of a microsecond at the card's rate, so what binds them
# is the launch and the memory round trips a thread waits on, and on the
# small planes (8x8, 4x4) too few threads to fill the card.  So a CTA owns
# (image, channels, rows), a thread TQ consecutive outputs along Q with
# TQ picked per launch (``dw_geometry``: narrow strips where the plane is
# small, so every SM has warps; wide ones where it is large, so fewer
# loads and instructions an output), and each thread's source issues every
# load it needs (weights, its channel's vector, residual, the window of
# each input row its outputs share) before its first multiply-add, the
# window two elements a load and its outputs stored as one word where
# aligned.  Its channel, row and strip are its thread index's three axes
# (no division), its offsets 32-bit.
#
# The int8 instances (``*_i8``) run the same tile core on int32 IMAD: the
# operands are widened to int32 as they are staged, so their sums are
# exact.  Their bound is the card's int8 tensor-core rate (1979 TOP/s),
# which IMAD on the CUDA cores does not reach (``mma.sync`` s8 is the
# redesign).
#
# The bf16 WS, OS and psum kernels (``fold_conv_ws_bf16``,
# ``fold_conv_os_bf16``, ``fold_conv_psum_bf16``; they replace
# ``_ws_kernel``, ``_os_kernel`` and ``_ws_psum_kernel`` on bf16 operands)
# run on the tensor cores (``csrc/fold_conv_tc.cuh``): the same implicit
# GEMM with the operands kept bf16 in shared memory, ``mma.sync`` m16n8k16
# with fp32 sums, a warp a block of m16n8 accumulators (``TC_TILES``).
# Their bound is the bf16 tensor-core rate (989 TFLOP/s); what binds them
# is the gather, one 2-byte load a tap and pixel for BN multiply-adds, and
# on the deepest layers (Kf 4608, BN 16, one CTA an SM) its latency, which
# two chunks of loads in flight only partly hide (PERF.md); so WS's tile
# set reaches for a wide filter tile where the resident weights fit
# (``tile_smem``), OS streams its filter tile through a ring of
# ``TC_STAGES`` chunks of ``TC_OS_BK`` taps (52 KB at BN 64 whatever the
# depth; its 16- to 64-pixel layers run one CTA of 4 warps an SM or fewer,
# where a chunk's fixed costs bind, so its chunks are twice WS's) and adds
# the small-M tiles those layers need, and the finished
# tile flushes through shared memory with the FFMA core's epilogue.  Each
# output's sum is a chain of 16-tap MMA steps from its depth fold's first
# tap, in k order, one walk (``tc_run``) for all three (stated in
# ``csrc/fold_conv_tc.cuh``): neither the tile nor the dataflow changes a
# bit there either.
#
# The psum kernel is the WS fold sum without the in-kernel reduction: each
# depth fold writes a partial-sum tensor, so the bytes grow by 2*g_c+1
# output-sized transfers (with the ``torch.sum``) — the cost the paper's
# reserved-column reduction removes.  It is a third instance of the WS
# tile core (of the tensor-core core in bf16): its grid gains the depth
# folds as a third axis, a CTA keeps one fold's filter tile resident and
# stores its tiles' raw sums to that fold's slice, so the folds run in
# parallel and the comparison with WS measures the two reductions, not two
# cores.

SMEM_LIMIT = 232_448    # dynamic shared memory one CTA may use on sm_90
# The depthwise launch (``csrc/fold_conv.cuh``: dw_kernel): threads a CTA
# at most, the outputs along Q a thread may own (the kernel's TQ
# instances; the fused pool takes 2 or 4, so each 2x2 window stays in one
# thread), and the warps an SM a strip must leave the launch for
# ``dw_geometry`` to pick it (PERF.md: on the zoo's 17 layers at batch 1, 4
# and 8, wider strips with fewer warps ran slower; a strip of 1 was no
# faster than one of 2 beyond the timings' spread, so the kernel has none)
DW_THREADS = 128
DW_MAX_CHANS = 64       # a CTA's channels are its z axis: the card's limit
DW_TQS = (2, 4, 8)
DW_POOL_TQS = (2, 4)
DW_WARPS_PER_SM = 12
SMEM_PER_SM = 233_472   # shared memory of one SM that CTAs may take
# taps per K chunk, chunks of the OS weights copied ahead (BK, PB in
# csrc/fold_conv.cuh); the input's ring has two stages
BK, PB = 32, 8
# The CTA tiles of the FFMA tile core (fp32 and int8 WS / OS, fp32 psum),
# (TM, TN, MG, NG): MG x NG threads, each with TM pixels x TN filters
# (Tile0..Tile6 in csrc/fold_conv.cuh): the tiles some conv of the zoo runs
# fastest with (fold_tiles.py, PERF.md)
TILES = ((2, 4, 32, 4), (1, 4, 64, 2), (4, 2, 32, 4), (4, 2, 64, 4),
         (4, 4, 32, 4), (4, 4, 64, 4), (4, 1, 16, 8))
# The CTA tiles of the tensor-core core (bf16 WS, OS and psum), (WTM, WTN,
# WM, WN): WM x WN warps, each with WTM pixels x WTN filters of m16n8
# accumulators (TcTile0..TcTile7 in csrc/fold_conv_tc.cuh): 64 or 128
# pixels by 16, 32 or 64 filters, then OS's 16 and 32 pixels by 64 filters
# for its small-M layers.  WS and psum run the first TC_WS_TILES.
TC_TILES = ((16, 16, 4, 1), (16, 16, 8, 1), (16, 32, 4, 1), (32, 16, 4, 2),
            (32, 32, 2, 2), (32, 32, 4, 2), (16, 16, 1, 4), (16, 32, 2, 2))
TC_WS_TILES = 6
MMA_K = 16              # taps of one mma.sync m16n8k16 step
# taps a chunk of the tensor-core walk (WS, psum; OS at most, where a
# thread's gather stays at 16 taps: ``tile_chunk``), and the chunks of the
# OS weight ring (csrc/fold_conv_tc.cuh)
TC_BK, TC_OS_BK, TC_STAGES = 64, 128, 3
# Epilogue flags, one bit per step (EPI_* in csrc/fold_conv.cuh)
EPI_BIAS, EPI_SCALE, EPI_RESIDUAL, EPI_RELU, EPI_RELU6, EPI_POOL = \
    1, 2, 4, 8, 16, 32


def _epi_flags(epi: Epilogue) -> int:
    return (EPI_BIAS * epi.bias | EPI_SCALE * epi.scale
            | EPI_RESIDUAL * epi.residual | EPI_RELU * epi.relu
            | EPI_RELU6 * epi.relu6 | EPI_POOL * (epi.pool == "max2"))


@dataclasses.dataclass(frozen=True)
class FoldTile:
    """The CTA tile of one WS / OS / psum launch, as the kernel will run it.

    ``core`` is ``"ffma"`` (the tile core of ``csrc/fold_conv.cuh``: a tile
    of ``TILES``, ``tm`` x ``tn`` accumulators a thread) or ``"tc"`` (the
    tensor-core core of ``csrc/fold_conv_tc.cuh``, bf16 WS, OS and psum: a
    tile of ``TC_TILES``, ``tm`` x ``tn`` m16n8 accumulators a warp).  ``m``
    output pixels (four per pooled output where the pool is fused) are cut
    into ``m_tiles`` tiles of ``bm``; each group's ``nfg`` filters into
    tiles of ``bn``, so ``n_tiles`` = groups x ceil(nfg / bn) and no filter
    tile straddles a group.  An OS CTA owns one (M tile, filter tile); a WS
    CTA walks ``m_per_cta`` consecutive M tiles past its resident filter
    tile, a psum CTA the same for one of ``folds`` depth folds (the grid's
    third axis; 1 for WS and OS).  ``resident`` CTAs of ``smem`` bytes fit
    one SM (WS and psum hold a depth fold of the filter tile, OS a ring of
    its chunks: ``dataflow`` says which).  Each sum a CTA finishes is
    ``k_len`` taps long, c then r then s (the whole depth for WS and OS,
    one depth fold for psum), in depth folds of ``kf`` taps: one tap at a
    time on the FFMA core, 16-tap MMA steps from each fold's first tap on
    the tensor cores (the order ``csrc/fold_conv_tc.cuh`` states)."""
    index: int                 # into TILES ("ffma") or TC_TILES ("tc")
    tm: int
    tn: int
    bm: int
    bn: int
    threads: int
    m: int
    m_tiles: int
    groups: int
    nfg: int
    n_tiles: int
    m_per_cta: int
    grid: Tuple[int, int]
    folds: int
    smem: int
    resident: int
    k_len: int
    core: str
    kf: int
    dataflow: str


def tile_core(dataflow: str, dtype: torch.dtype) -> str:
    """The tile core a WS / OS / psum launch runs on: ``"tc"`` (tensor
    cores) for bf16, ``"ffma"`` otherwise."""
    return "tc" if dtype == torch.bfloat16 else "ffma"


def tile_count(core: str, dataflow: str) -> int:
    """How many tiles of its core's set a launch may run: every tile of
    ``TILES``; of ``TC_TILES`` every one for OS, the first ``TC_WS_TILES``
    for WS and psum (the kernels have no WS or psum instance of OS's
    small-M tiles)."""
    if core != "tc":
        return len(TILES)
    return len(TC_TILES) if dataflow == "output_stationary" else TC_WS_TILES


def tile_shape(core: str, index: int) -> Tuple[int, int, int, int, int]:
    """(tm, tn, bm, bn, threads) of tile ``index`` of a core's tile set:
    ``TILES`` (a thread's tm x tn) or ``TC_TILES`` (a warp's)."""
    if core == "tc":
        wtm, wtn, wm, wn = TC_TILES[index]
        return wtm, wtn, wtm * wm, wtn * wn, 32 * wm * wn
    tm, tn, mg, ng = TILES[index]
    return tm, tn, tm * mg, tn * ng, mg * ng


def tile_chunk(ws: bool, bm: int, threads: int) -> int:
    """Taps a chunk of a tensor-core walk (``TcTile::BK``): ``TC_BK`` for
    WS and psum; for OS (``TcOs``) ``TC_OS_BK`` where a thread then
    gathers at most 16 taps of its two pixels, else ``TC_BK``."""
    return TC_BK if ws else min(TC_OS_BK, 16 * threads // (bm // 2))


def tile_smem(core: str, ws: bool, bm: int, bn: int, kf: int,
              k_total: int, threads: int) -> int:
    """Shared memory bytes of one CTA (``launch_tile`` / ``tc_smem`` in the
    sources): the resident filter tile of a depth fold of ``kf`` taps (WS,
    psum; OS: the weight ring), the input ring and the k offset table of
    the group's ``k_total`` taps.  The tensor-core tile keeps bf16 rows of
    16-tap steps plus 8 (OS: ``TC_STAGES`` chunks plus 8), gathers the
    input a chunk at a time (``tile_chunk``, of the tile's ``threads``)
    and stages its finished fp32 tile in the input ring."""
    if core == "tc":
        kpad = -(-kf // MMA_K) * MMA_K
        bk = tile_chunk(ws, bm, threads)
        weights = bn * (kpad + 8) if ws else TC_STAGES * bn * (bk + 8)
        return (2 * weights + max(2 * 2 * bk * (bm + 8), 4 * bn * (bm + 4))
                + 4 * k_total)
    bnp = bn + 4 if bn >= 32 else bn
    return 4 * (((kf * bnp) if ws else (PB + 1) * BK * bnp)
                + 2 * BK * bm + k_total)


def tile_candidates(spec: "FoldKernelSpec", n: int, sm_count: int,
                    dtype: torch.dtype = torch.float32) -> list:
    """Every tile the WS / OS / psum kernel can run this launch with on
    ``dtype`` operands (its core's tile set, ``tile_core``; its shared
    memory fits one CTA; whole 2x2 quads per thread where the pool is
    fused), as ``FoldTile``s: the mirror of ``launch_tile`` in
    ``csrc/fold_conv.cuh`` and ``launch_tc_tile`` in
    ``csrc/fold_conv_tc.cuh``.  A pure function of the launch spec, the
    operand type, the batch and the card's SM count."""
    return list(_candidates(*_launch_key(spec, n, sm_count, dtype)))


def _launch_key(spec: "FoldKernelSpec", n: int, sm_count: int,
                dtype: torch.dtype = torch.float32) -> tuple:
    """What of a launch the tile depends on."""
    return (spec.dataflow, tile_core(spec.dataflow, dtype),
            spec.epilogue.pool == "max2", spec.groups, spec.c_pad, spec.r,
            spec.s, spec.plan.c_block, spec.nf_pad, spec.p_pad, spec.q, n,
            sm_count)


@functools.lru_cache(maxsize=None)
def _candidates(dataflow: str, core: str, pool: bool, g: int, c_pad: int,
                r: int, s: int, c_block: int, nf_pad: int, p_pad: int,
                q: int, n: int, sm_count: int) -> Tuple[FoldTile, ...]:
    # WS and psum keep a depth fold's filter tile resident; psum runs its
    # depth folds side by side, each CTA summing one fold
    ws = dataflow != "output_stationary"
    k_len, kf = c_pad // g * r * s, c_block * r * s
    folds = c_pad // g // c_block if dataflow == "weight_stationary_psum" \
        else 1
    nfg = nf_pad // g
    po, qo = (p_pad // 2, q // 2) if pool else (p_pad, q)
    m = (4 if pool else 1) * n * po * qo
    out = []
    for idx in range(tile_count(core, dataflow)):
        tm, tn, bm, bn, threads = tile_shape(core, idx)
        smem = tile_smem(core, ws, bm, bn, kf, k_len, threads)
        if (core == "ffma" and pool and tm % 4) or smem > SMEM_LIMIT:
            continue
        m_tiles, n_tiles = -(-m // bm), g * -(-nfg // bn)
        resident = max(1, min(SMEM_PER_SM // (smem + 1024),
                              2048 // threads, 32))
        m_per_cta = 1
        if ws:
            # one wave of CTAs, each walking its share of the M tiles past
            # its resident filter tile
            chunks = max(1, min(m_tiles, -(-sm_count * resident
                                           // (n_tiles * folds))))
            m_per_cta = -(-m_tiles // chunks)
        out.append(FoldTile(
            index=idx, tm=tm, tn=tn, bm=bm, bn=bn, threads=threads, m=m,
            m_tiles=m_tiles, groups=g, nfg=nfg, n_tiles=n_tiles,
            m_per_cta=m_per_cta, grid=(-(-m_tiles // m_per_cta), n_tiles),
            folds=folds, smem=smem, resident=resident,
            k_len=kf if folds > 1 else k_len, core=core, kf=kf,
            dataflow=dataflow))
    return tuple(out)


def tile_cycles(tile: FoldTile, sm_count: int) -> float:
    """The tile model: estimated cycles of one launch with ``tile``.

    FFMA core: a thread issues about TM*TN + 8 instructions per tap (its
    FFMAs, the shared reads and its share of the gather); the warps on one
    SM scheduler issue one instruction a cycle between them, and a warp
    alone needs about 2*TM*TN cycles a tap.  Each tile's flush costs
    about 300 cycles per accumulator.  A launch takes as many rounds of
    resident CTAs as its grid needs (a psum grid has a third axis, its
    depth folds), each CTA walking its M tiles' K taps in series.  Fitted
    to the card's per-layer times of every WS / OS tile over the zoo's
    convs (``fold_tiles.py``, PERF.md).  The tensor-core core:
    ``_tc_cycles``."""
    if tile.core == "tc":
        return _tc_cycles(tile, sm_count)
    per_sm = -(-tile.grid[0] * tile.grid[1] * tile.folds // sm_count)
    rounds = -(-per_sm // tile.resident)
    warps = min(per_sm, tile.resident) * tile.threads / 32 / 4
    acc = tile.tm * tile.tn
    per_tap = max(warps * (acc + 8), 2 * acc)
    return rounds * tile.m_per_cta * (tile.k_len * per_tap + 300 * acc)


# The tensor-core tile model's constants (``_tc_cycles``): warp
# instructions of the gather per pixel and 16-tap step, SM cycles per
# m16n8k16 MMA, warps an SM needs to hide the gather's latency, cycles of
# the flush per output; fitted to ``fold_tiles.py --bf16`` on the card
# (the picks' sum within 0.5% of the fastest tiles', PERF.md).  OS's
# streamed weights: warp instructions per 16 filters of a step (the
# 16-byte copies, their addresses and the wait), and the bytes an SM
# reads from L2 a cycle; fitted to the OS layers of the same sweep (the
# picks' sum within 0.3% of the fastest tiles', PERF.md).
TC_GATHER, TC_MMA_CYCLES, TC_WARPS_HIDE, TC_FLUSH = 7 / 4, 1.0, 8, 0.5
TC_STREAM, TC_L2_BYTES = 1.0, 128.0


def _tc_cycles(tile: FoldTile, sm_count: int) -> float:
    """The tensor-core tile model: per 16-tap step, the CTAs resident on
    one SM issue the gather's instructions (``TC_GATHER`` a pixel), their
    ldmatrix and MMA instructions (OS: and ``TC_STREAM`` per 16 filters
    for the weights it streams), four a cycle when ``TC_WARPS_HIDE`` warps
    hide the gather's latency (fewer issue proportionally slower), the
    tensor cores take ``TC_MMA_CYCLES`` an MMA, and (OS) the SM reads the
    step's BN x 16 weights, 2 bytes each, at ``TC_L2_BYTES`` a cycle; the
    longest sets the step.  A launch takes as many rounds of resident CTAs
    as its grid needs, each CTA walking its M tiles' steps in series, plus
    the flush of each tile."""
    per_sm = -(-tile.grid[0] * tile.grid[1] * tile.folds // sm_count)
    rounds = -(-per_sm // tile.resident)
    ctas = min(per_sm, tile.resident)
    warps = ctas * tile.threads / 32
    wm, wn = tile.bm // tile.tm, tile.bn // tile.tn
    mmas = (tile.bm // 16) * (tile.bn // 8)
    instr = TC_GATHER * tile.bm + mmas + (tile.bm // 16) * wn \
        + wm * (tile.bn // 16)
    stream = 0.0
    if tile.dataflow == "output_stationary":
        instr += TC_STREAM * tile.bn / 16
        stream = ctas * tile.bn * MMA_K * 2 / TC_L2_BYTES
    issue = ctas * instr / 4 / min(1.0, warps / TC_WARPS_HIDE)
    step = max(issue, ctas * mmas * TC_MMA_CYCLES, stream)
    steps = tile.k_len // tile.kf * -(-tile.kf // MMA_K)
    flush = ctas * TC_FLUSH * tile.bm * tile.bn
    return rounds * tile.m_per_cta * (steps * step + flush)


def fold_tile(spec: "FoldKernelSpec", n: int, sm_count: int,
              index: Optional[int] = None,
              dtype: torch.dtype = torch.float32) -> FoldTile:
    """Pick the CTA tile of a WS / OS / psum launch on ``dtype`` operands:
    the candidate with the least ``tile_cycles``, among those whose filter
    tile is no wider than a group (where any is); or, with ``index``, that
    tile of the core's tile set (``TILES``, or ``TC_TILES`` for bf16,
    ``tile_count``).  Raises where no tile (or not that one) fits the
    launch: a bf16 launch no tensor-core tile fits has no other kernel."""
    key = _launch_key(spec, n, sm_count, dtype)
    if index is None:
        tile = _pick(*key)
    else:
        tile = next((t for t in _candidates(*key) if t.index == index),
                    None)
    if tile is None:
        raise ValueError(
            f"no {key[1]} CTA tile{'' if index is None else f' {index}'} "
            f"of the {spec.dataflow} kernel fits this launch in "
            f"{SMEM_LIMIT} bytes of shared memory (c_block="
            f"{spec.plan.c_block}, {spec.r}x{spec.s}, C/G="
            f"{spec.c_pad // spec.groups})")
    return tile


@functools.lru_cache(maxsize=None)
def _pick(*key) -> Optional[FoldTile]:
    cands = _candidates(*key)
    # OS's small-M tensor-core tiles are 64 filters wide and the fastest
    # on the zoo's 32-filter OS layers all the same (fold_tiles.py --bf16,
    # PERF.md): the model prices their masked filters, no rule drops them
    fit = [t for t in cands if t.bn <= max(t.nfg, 4)
           or (t.core, t.dataflow) == ("tc", "output_stationary")] or cands
    return min(fit, key=lambda t: tile_cycles(t, key[-1]), default=None)



@dataclasses.dataclass(frozen=True)
class DwGeometry:
    """The thread and CTA geometry of one depthwise launch, as the kernel
    runs it (``launch_dw`` in ``csrc/fold_conv.cuh``).

    A thread owns ``tq`` consecutive outputs along Q of one output row (of
    one pooled row, both pre-pool rows, where the pool is fused): each
    row's ``qlim`` pre-pool columns are ``strips`` threads.  A CTA of
    (``strips``, ``rows``, ``chans``) threads, ``threads`` in all, owns
    ``rows`` output rows of ``chans`` channels of one image; the grid is
    (row blocks, channel blocks, images).  ``pairs``: the input rows start
    on a two-element boundary (``yp`` even), so the window loads two
    elements at a time.  ``warps_per_sm``: the launch's threads in warps
    over the card's SMs."""
    tq: int
    strips: int
    rows: int
    chans: int
    threads: int
    grid: Tuple[int, int, int]
    pairs: bool
    warps_per_sm: float


def dw_tq_choices(spec: "FoldKernelSpec") -> Tuple[int, ...]:
    """The outputs along Q a depthwise thread may own at this launch: the
    kernel's ``DW_TQS`` (``DW_POOL_TQS`` where the pool is fused) whose
    strips of a row fit one CTA."""
    pool = spec.epilogue.pool == "max2"
    qlim = spec.q // 2 * 2 if pool else spec.q
    return tuple(t for t in (DW_POOL_TQS if pool else DW_TQS)
                 if -(-qlim // t) <= DW_THREADS)


def dw_geometry(spec: "FoldKernelSpec", n: int, sm_count: int,
                dtype: torch.dtype = torch.float32,
                tq: Optional[int] = None) -> DwGeometry:
    """Pick the geometry of a depthwise launch on ``dtype`` operands at
    batch ``n`` on ``sm_count`` SMs: the widest strip (``tq``) that still
    puts ``DW_WARPS_PER_SM`` warps on every SM (TQ 4 on MobileNetV2's
    32x32 layer of 96 channels at batch 4), else the narrowest (the small
    planes); whole rows of strips in one CTA of up to ``DW_THREADS``
    threads, a few channels' planes where a plane has fewer.  With
    ``tq``, that strip.  Raises where no strip (or not that one) fits: a
    row wider than ``DW_THREADS`` threads of the widest.  A pure function
    of the launch spec, the batch and the SM count: the pick is the same
    for every operand type (``dtype`` is the launch's, as ``fold_tile``
    takes it)."""
    del dtype
    pool = spec.epilogue.pool == "max2"
    span = 2 if pool else 1
    po, qlim = spec.p_pad // span, spec.q // span * span
    choices = dw_tq_choices(spec)

    def warps(t: int) -> float:
        return n * spec.c * po * -(-qlim // t) / 32 / sm_count

    if tq is None:
        tq = next((t for t in sorted(choices, reverse=True)
                   if warps(t) >= DW_WARPS_PER_SM), min(choices, default=0))
    if tq not in choices:
        raise ValueError(
            f"no depthwise strip of {tq or 'any'} outputs fits this launch: "
            f"{qlim} columns a row, {DW_THREADS} threads a CTA, strips of "
            f"{choices or DW_TQS}")
    strips = -(-qlim // tq)
    per_chan = po * strips
    if per_chan >= DW_THREADS:
        chans, rows = 1, DW_THREADS // strips
    else:
        rows = po
        chans = max(1, min(spec.c, DW_THREADS // per_chan, DW_MAX_CHANS))
    return DwGeometry(tq=tq, strips=strips, rows=rows, chans=chans,
                      threads=chans * rows * strips,
                      grid=(-(-po // rows), -(-spec.c // chans), n),
                      pairs=spec.inputs[0].array_shape[3] % 2 == 0,
                      warps_per_sm=warps(tq))


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _out_type(xp: torch.Tensor) -> torch.dtype:
    """What a kernel instance stores (and reads the residual in): bf16 for
    the bf16 stream, else fp32."""
    return torch.bfloat16 if xp.dtype == torch.bfloat16 else torch.float32


def _check_cuda_operands(xp: torch.Tensor, wp: torch.Tensor,
                         vec: Optional[torch.Tensor] = None,
                         res: Optional[torch.Tensor] = None) -> None:
    """x and w of one type (fp32, bf16 or int8), the vector block fp32, the
    residual of the instance's output type, all contiguous on one device,
    every offset within 32 bits, and none of them requiring grad under
    grad mode (the launch has no backward)."""
    from repro_torch.kernels import build
    build.refuse_grad("a fold kernel launch", xp, wp, vec, res,
                      hint=_GRAD_HINT)
    dev = xp.device
    for t, want in ((xp, xp.dtype), (wp, xp.dtype), (vec, torch.float32),
                    (res, _out_type(xp))):
        if t is None:
            continue
        if t.device != dev or t.dtype != want or not t.is_contiguous():
            raise ValueError(f"fold kernel operands must be contiguous on "
                             f"{dev}: {want} expected, got {t.dtype} on "
                             f"{t.device}")
    if xp.numel() >= 2 ** 31:
        raise ValueError(f"the fold kernels index x with 32-bit offsets: "
                         f"{xp.numel()} elements")


_GRAD_HINT = (", or train through kernels/ops.py's conv2d / conv2d_fused, "
              "whose backward recomputes through the reference")

# Launches so far, by the name of the kernel's C entry point
KERNELS = ("fold_conv_ws", "fold_conv_os", "fold_conv_dw", "fold_conv_ws_i8",
           "fold_conv_os_i8", "fold_conv_dw_i8", "fold_conv_psum",
           "fold_conv_ws_bf16", "fold_conv_os_bf16", "fold_conv_dw_bf16",
           "fold_conv_psum_bf16")
_LAUNCHES: Dict[str, int] = dict.fromkeys(KERNELS, 0)
_SUFFIX = {torch.float32: "", torch.int8: "_i8", torch.bfloat16: "_bf16"}


def _entry(base: str, xp: torch.Tensor) -> str:
    """The C entry point of a kernel for x's type."""
    return base + _SUFFIX[xp.dtype]


def _geom_args(spec: "FoldKernelSpec", n: int) -> list:
    return [n, spec.c_pad, spec.x_rows, spec.inputs[0].array_shape[3],
            spec.nf_pad, spec.r, spec.s, spec.stride, spec.q, spec.p_pad]


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def launch_ws(spec: "FoldKernelSpec", xp: torch.Tensor, wp: torch.Tensor,
              vec: torch.Tensor, res: Optional[torch.Tensor],
              tile: Optional[int] = None) -> torch.Tensor:
    """Launch the weight-stationary kernel on padded CUDA operands, with
    the CTA tile ``fold_tile`` picks (or tile ``tile`` of the core's tile
    set: ``TC_TILES`` for bf16, ``TILES`` otherwise)."""
    from repro_torch.kernels import build
    _check_cuda_operands(xp, wp, vec, res)
    n, name = xp.shape[0], _entry("fold_conv_ws", xp)
    tile = fold_tile(spec, n, _sm_count(xp.device), tile, xp.dtype)
    out = torch.empty(spec.output.array_shape, device=xp.device,
                      dtype=_out_type(xp))
    slab = None
    if spec.cg_folds > 1:
        slab = torch.empty((n, spec.nf_pad, spec.p_pad, spec.q),
                           device=xp.device, dtype=_acc_dtype(xp))
    lib = build.library()
    err = getattr(lib, name)(
        _ptr(xp), _ptr(wp), _ptr(vec), _ptr(res), _ptr(out), _ptr(slab),
        *_geom_args(spec, n), spec.groups, spec.plan.c_block,
        _epi_flags(spec.epilogue), tile.index, tile.m_per_cta,
        torch.cuda.current_stream(xp.device).cuda_stream)
    build.raise_on_error(lib, err, name)
    _LAUNCHES[name] += 1
    return out


def launch_os(spec: "FoldKernelSpec", xp: torch.Tensor, wp: torch.Tensor,
              vec: torch.Tensor, res: Optional[torch.Tensor],
              tile: Optional[int] = None) -> torch.Tensor:
    """Launch the output-stationary kernel on padded CUDA operands, with
    the CTA tile ``fold_tile`` picks (or tile ``tile`` of the core's tile
    set: ``TC_TILES`` for bf16, ``TILES`` otherwise)."""
    from repro_torch.kernels import build
    _check_cuda_operands(xp, wp, vec, res)
    n, name = xp.shape[0], _entry("fold_conv_os", xp)
    tile = fold_tile(spec, n, _sm_count(xp.device), tile, xp.dtype)
    out = torch.empty(spec.output.array_shape, device=xp.device,
                      dtype=_out_type(xp))
    lib = build.library()
    err = getattr(lib, name)(
        _ptr(xp), _ptr(wp), _ptr(vec), _ptr(res), _ptr(out),
        *_geom_args(spec, n), spec.groups, spec.plan.c_block,
        _epi_flags(spec.epilogue), tile.index,
        torch.cuda.current_stream(xp.device).cuda_stream)
    build.raise_on_error(lib, err, name)
    _LAUNCHES[name] += 1
    return out


def launch_dw(spec: "FoldKernelSpec", xp: torch.Tensor, wp: torch.Tensor,
              vec: torch.Tensor, res: Optional[torch.Tensor],
              tq: Optional[int] = None) -> torch.Tensor:
    """Launch the depthwise kernel on padded CUDA operands, with the
    geometry ``dw_geometry`` picks (or its strip of ``tq`` outputs a
    thread).  Only the layer's own C channels are computed: the output's
    channels past C (``c_pad``) are left unwritten and sliced away by the
    caller.  Raises (``ValueError``) where no strip fits: an output row
    wider than ``DW_THREADS`` threads of the widest strip."""
    from repro_torch.kernels import build
    _check_cuda_operands(xp, wp, vec, res)
    n, name = xp.shape[0], _entry("fold_conv_dw", xp)
    geom = dw_geometry(spec, n, _sm_count(xp.device), xp.dtype, tq)
    out = torch.empty(spec.output.array_shape, device=xp.device,
                      dtype=_out_type(xp))
    # two-element loads need the rows on that boundary and x aligned to it
    pairs = geom.pairs and xp.data_ptr() % (2 * xp.element_size()) == 0
    lib = build.library()
    err = getattr(lib, name)(
        _ptr(xp), _ptr(wp), _ptr(vec), _ptr(res), _ptr(out), n, spec.c,
        spec.c_pad, spec.x_rows, spec.inputs[0].array_shape[3], spec.r,
        spec.s, spec.stride, spec.q, spec.p_pad, _epi_flags(spec.epilogue),
        geom.tq, geom.rows, geom.chans, int(pairs),
        torch.cuda.current_stream(xp.device).cuda_stream)
    build.raise_on_error(lib, err, name)
    _LAUNCHES[name] += 1
    return out


def launch_psum(spec: "FoldKernelSpec", xp: torch.Tensor, wp: torch.Tensor,
                vec: Optional[torch.Tensor] = None,
                res: Optional[torch.Tensor] = None,
                tile: Optional[int] = None) -> torch.Tensor:
    """Launch the psum-staging kernel on padded fp32 or bf16 CUDA
    operands, with the CTA tile ``fold_tile`` picks (or tile ``tile`` of
    the core's tile set: ``TC_TILES`` for bf16, ``TILES`` for fp32);
    returns the (g_c, N, NF_pad, P_pad, Q) staging buffer,
    unsummed, in the instance's output type (each fold's sums rounded to
    bf16 by the bf16 instance, as the JAX package stores them)."""
    from repro_torch.kernels import build
    _check_cuda_operands(xp, wp)
    if xp.dtype == torch.int8:
        raise ValueError("the psum staging kernel takes fp32 or bf16 "
                         "operands")
    n, name = xp.shape[0], _entry("fold_conv_psum", xp)
    tile = fold_tile(spec, n, _sm_count(xp.device), tile, xp.dtype)
    out = torch.empty(spec.output.array_shape, device=xp.device,
                      dtype=_out_type(xp))
    lib = build.library()
    err = getattr(lib, name)(
        _ptr(xp), _ptr(wp), _ptr(out), *_geom_args(spec, n),
        spec.plan.c_block, tile.index, tile.m_per_cta,
        torch.cuda.current_stream(xp.device).cuda_stream)
    build.raise_on_error(lib, err, name)
    _LAUNCHES[name] += 1
    return out


# The launcher of each resolved dataflow's kernel; each picks its C entry
# point by the operands' type and counts its launches under that name
LAUNCHERS: Dict[str, Callable] = {"weight_stationary": launch_ws,
                                  "output_stationary": launch_os,
                                  "depthwise": launch_dw,
                                  "weight_stationary_psum": launch_psum}


def launch_counts() -> Dict[str, int]:
    """Kernel launches so far, by kernel name."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


# --------------------------------------------------------------------------
# The public entry
# --------------------------------------------------------------------------

def prepare(x_padded, w, stride, plan, dataflow, bias, epilogue, groups,
            residual, scale, shift, out_dtype=None):
    """Check a call, solve its spec, and pad its operands in the stream's
    type (``_stream_dtype``): returns ``(spec, x, w, vec, residual or
    None)``, what a launcher takes."""
    n, c, xp_, yp_ = x_padded.shape
    nf, cw, r, s = w.shape
    epi = epilogue or Epilogue()
    _check_operands(x_padded, w, dataflow)
    if c != cw * groups or nf % groups:
        raise ValueError(f"input has {c} channels, weights expect "
                         f"{cw}x{groups} (and groups={groups} must divide "
                         f"NF={nf})")
    if epi.bias and bias is None:
        raise ValueError("epilogue.bias=True needs a bias vector")
    if epi.scale and (scale is None or shift is None):
        raise ValueError("epilogue.scale=True needs scale and shift "
                         "vectors")
    spec = fold_kernel_spec(tuple(x_padded.shape), tuple(w.shape),
                            stride=stride, plan=plan, dataflow=dataflow,
                            epilogue=epi, groups=groups)
    if epi.residual:
        if residual is None:
            raise ValueError("epilogue.residual=True needs a residual "
                             "tensor")
        if tuple(residual.shape) != (n, nf, spec.p, spec.q):
            raise ValueError(f"residual shape {tuple(residual.shape)} != "
                             f"conv output {(n, nf, spec.p, spec.q)}")
    if x_padded.dtype == torch.int8 and \
            spec.dataflow == "weight_stationary_psum":
        # the WS accumulator spill lands on psum staging only for an
        # identity epilogue, which an int8 stream never has (its requant
        # affine is a scale)
        raise ValueError("int8 weight_stationary spilled to psum staging, "
                         "which cannot dequantize; use output_stationary")
    # the operands in the spec's order: x, w[, vec][, residual]; int8 x
    # and w pad in int8, bf16 in bf16, before the kernel
    stream = _stream_dtype(x_padded, w, residual,
                           _resolve_out_dtype(x_padded, out_dtype))
    if stream != torch.int8:
        x_padded, w = x_padded.to(stream), w.to(stream)
        if residual is not None:
            residual = residual.to(stream)
    arrays = {"x": x_padded, "w": w, "residual": residual}
    ops = []
    for op in spec.inputs:
        if op.role == "vec":
            ops.append(_vector_block(nf, op.array_shape[0], epi, bias,
                                     scale, shift, x_padded.device))
        else:
            ops.append(_pad_to(arrays[op.role], op.array_shape))
    if spec.dataflow == "weight_stationary_psum":
        ops.append(None)                  # no vector block: nothing flushes
    if not epi.residual:
        ops.append(None)
    return (spec, *ops)


_PLAIN_WALKS = {"weight_stationary": _plain_walk,
                "output_stationary": _plain_walk,
                "depthwise": _plain_dw_walk,
                "weight_stationary_psum": _plain_psum_walk}


def _finish(spec: "FoldKernelSpec", out: torch.Tensor,
            out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Slice the padded output to the layer's own extent, in ``out_dtype``
    (one rounding, where the stream's output type differs; by default the
    type the kernel or the plain walk wrote).  psum staging
    first sums its depth folds through device memory, as the JAX package
    does outside its kernel: each fold's partial sums stored in
    ``out_dtype``, then added in fp32 and rounded once (jnp's sum widens
    bf16)."""
    out_dtype = out_dtype or out.dtype
    if spec.dataflow == "weight_stationary_psum":
        folds = out.to(out_dtype).float()
        return folds.sum(dim=0)[:, :spec.nf, :spec.p].to(out_dtype)
    return out[:, :spec.nf, :spec.p_valid, :spec.q_valid].to(out_dtype)


def conv2d_folded_plain(x_padded: torch.Tensor, w: torch.Tensor, *,
                        stride: int = 1,
                        plan: Optional[ConvBlockPlan] = None,
                        dataflow: str = "weight_stationary",
                        bias: Optional[torch.Tensor] = None,
                        epilogue: Optional[Epilogue] = None,
                        residual: Optional[torch.Tensor] = None,
                        scale: Optional[torch.Tensor] = None,
                        shift: Optional[torch.Tensor] = None,
                        groups: int = 1,
                        out_dtype: Optional[torch.dtype] = None
                        ) -> torch.Tensor:
    """The plain-torch version of ``conv2d_folded`` on any device: the same
    spec, the same padding, the fold loop in torch ops (fp32 sums and
    epilogue, one rounding to ``out_dtype``)."""
    spec, *ops = prepare(x_padded, w, stride, plan, dataflow, bias,
                          epilogue, groups, residual, scale, shift,
                          out_dtype)
    return _finish(spec, _PLAIN_WALKS[spec.dataflow](spec, *ops),
                   _resolve_out_dtype(x_padded, out_dtype))


def conv2d_folded(x_padded: torch.Tensor, w: torch.Tensor, *,
                  stride: int = 1,
                  plan: Optional[ConvBlockPlan] = None,
                  dataflow: str = "weight_stationary",
                  bias: Optional[torch.Tensor] = None,
                  epilogue: Optional[Epilogue] = None,
                  residual: Optional[torch.Tensor] = None,
                  scale: Optional[torch.Tensor] = None,
                  shift: Optional[torch.Tensor] = None,
                  groups: int = 1,
                  out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Run the fold-streamed conv on a PRE-PADDED input.

    x_padded: (N, C, Xp, Yp)   w: (NF, C/groups, R, S)   -> (N, NF, P', Q')
    where (P', Q') = (P, Q) or (P//2, Q//2) when ``epilogue.pool`` fuses
    the 2x2/2 max-pool.

    ``plan`` may come from the engine's schedule cache and describe a
    larger geometry sharing this layer's filter-fold key; it is clamped to
    the actual dims here, which is what makes schedule reuse exact.
    ``epilogue`` is flushed in-kernel, with ``bias`` when
    ``epilogue.bias``, ``scale``/``shift`` (the folded batch-norm vectors)
    when ``epilogue.scale`` and ``residual`` (an (N, NF, P, Q) shortcut)
    when ``epilogue.residual``.  ``dataflow="depthwise"`` (groups == C ==
    NF) selects the no-reduction kernel, ``"weight_stationary_psum"`` the
    partial-sum staging (identity epilogue, fp32 only).  Int8 ``x`` and
    ``w`` stream through the int8 kernels and give fp32 (the caller puts
    the requant affine in ``scale``/``shift``).  fp32 and bf16 operands
    may mix: each is widened to fp32, the sums and the epilogue run in
    fp32, and the output is rounded once, at the store, to ``out_dtype``
    (x's type by default, fp32 for int8).  An all-bf16 call runs the bf16
    instances of the kernels (``_stream_dtype``).  On a CUDA tensor this
    launches the kernel; on a CPU tensor it runs the plain-torch fold loop.
    Grouped layers (1 < G < C) run on the WS and OS kernels like dense
    ones, each filter fold on its own group's channels.

    It has no backward, as the JAX function (a Pallas call) has none: under
    grad mode an operand that requires grad raises, on either device.
    ``kernels/ops.py``'s ``conv2d`` / ``conv2d_fused`` are the trainable
    ops over it.
    """
    from repro_torch.kernels import build
    build.refuse_grad("conv2d_folded", x_padded, w, bias, residual, scale,
                      shift, hint=_GRAD_HINT)
    spec, *ops = prepare(x_padded, w, stride, plan, dataflow, bias,
                          epilogue, groups, residual, scale, shift,
                          out_dtype)
    if ops[0].device.type == "cuda":
        out = LAUNCHERS[spec.dataflow](spec, *ops)
    elif ops[0].device.type == "cpu":
        out = _PLAIN_WALKS[spec.dataflow](spec, *ops)
    else:
        raise ValueError(f"conv2d_folded runs on cuda or cpu tensors, got "
                         f"{ops[0].device}")
    return _finish(spec, out, _resolve_out_dtype(x_padded, out_dtype))
