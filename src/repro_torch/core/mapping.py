"""The Spatial-Map / Temporal-Map directive algebra (paper Fig 6b) and the
fold block-plan solver: the paper's fold-geometry equations (1)-(2) solved
once per layer into a ``ConvBlockPlan``.

The paper expresses its dataflow with two data-centric directives:

  Spatial Map (tile, tile) dim   -- distribute a loop dim across hardware
  Temporal Map (1, 1) dim        -- serialize a loop dim in time

``MappingPlan`` carries a set of directives for a named loop nest, checks
them and gives the extents of its temporal (streamed) dims.  The canonical
plans below are pure directive sets: the weight-stationary conv of Fig 6,
batched conv serving and LM training.  ``partition_spec`` binds a plan's
spatial dims to mesh axes: a ``PartitionSpec`` per tensor, which
``distributed/sharding.py`` turns into each rank's slice.

The block plan is the *logical* schedule.  It fixes the filter fold
(``nf_block`` filters), the depth fold (``c_block`` channels) and the image
fold (``p_block`` output rows), and with them the schedule table, the fold
reuse across layers and the WS/OS choice (``core/engine.py``).  It carries
the same numbers as the JAX package's solver so the two packages build
identical schedule tables.

The Hopper limits — 227 KB of shared memory per CTA and the register file —
belong to the CUDA launch, not to this plan: each kernel wrapper derives its
CTA tile *inside* one fold of the plan (``kernels/conv2d_ws.py``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.core.loopnest import ConvLoopNest

__all__ = [
    "SpatialMap",
    "TemporalMap",
    "Directive",
    "MappingPlan",
    "ConvBlockPlan",
    "PartitionSpec",
    "conv_working_set",
    "largest_divisor_le",
    "plan_conv_blocks",
    "weight_stationary_conv_plan",
    "serving_conv_plan",
    "lm_train_plan",
    "WS_ACC_BYTES_LIMIT",
]

# Ceiling for the weight-stationary dataflow's full-height fp32
# accumulator (nf_block x P x Q).  Beyond it ``fold_kernel_spec`` falls back
# to output-stationary (or to psum staging for an identity epilogue) and
# ``engine.dataflow_traffic_bytes`` prices the same fallback.  On the card
# the WS kernel keeps that accumulator in registers while g_c == 1 and in a
# device-memory slab that only its CTA touches while g_c > 1, so nothing on
# the H100 enforces 16 MiB; the constant stays because it decides the
# dataflow, and the dataflow must match the JAX package's.
WS_ACC_BYTES_LIMIT = 16 * 1024 * 1024


@dataclasses.dataclass(frozen=True)
class SpatialMap:
    """Distribute ``dim`` across the hardware axis ``axis``."""
    dim: str
    axis: str            # mesh axis name ("data", "model", "pod") or "mxu"

    def __str__(self) -> str:
        return f"SpatialMap({self.dim} -> {self.axis})"


@dataclasses.dataclass(frozen=True)
class TemporalMap:
    """Serialize ``dim`` in time (streaming order = declaration order)."""
    dim: str
    tile: int = 1        # streaming tile size along the dim

    def __str__(self) -> str:
        return f"TemporalMap({self.dim}, tile={self.tile})"


Directive = Union[SpatialMap, TemporalMap]


class PartitionSpec(tuple):
    """Per tensor dim, the mesh axis it is split over, a tuple of axes
    (split over their product, the first the major), or None
    (replicated): ``jax.sharding.PartitionSpec``'s tuple, with its
    normalization (a one-axis tuple is the axis, an empty one None), its
    equality (a tuple's: ``P("data") != P("data", None)``) and its
    printing."""

    def __new__(cls, *parts):
        def norm(p):
            if isinstance(p, (tuple, list)):
                p = tuple(p)
                return None if not p else (p[0] if len(p) == 1 else p)
            return p
        return super().__new__(cls, tuple(norm(p) for p in parts))

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return "PartitionSpec" + tuple.__repr__(self)

    __str__ = __repr__


@dataclasses.dataclass(frozen=True)
class MappingPlan:
    """A complete binding of a loop nest's dims to space and time."""
    name: str
    dims: Dict[str, int]                      # loop extents
    directives: Tuple[Directive, ...]         # Spatial/Temporal maps, ordered

    def spatial(self) -> List[SpatialMap]:
        return [d for d in self.directives if isinstance(d, SpatialMap)]

    def temporal(self) -> List[TemporalMap]:
        return [d for d in self.directives if isinstance(d, TemporalMap)]

    def validate(self) -> None:
        seen = set()
        for d in self.directives:
            if d.dim not in self.dims:
                raise ValueError(f"{d}: unknown dim (have {list(self.dims)})")
            if d.dim in seen:
                raise ValueError(f"{d}: dim bound twice")
            seen.add(d.dim)

    def partition_spec(self, tensor_dims: Sequence[Optional[str]]
                       ) -> PartitionSpec:
        """The ``PartitionSpec`` of a tensor whose axes are named by loop
        dims (None: not a loop dim, replicated); a dim spatially mapped to
        ``mxu`` (within a chip) is not a mesh axis."""
        by_dim = {d.dim: d.axis for d in self.spatial() if d.axis != "mxu"}
        return PartitionSpec(*[by_dim.get(d) if d else None
                               for d in tensor_dims])

    def grid(self) -> Tuple[int, ...]:
        """Extents of the temporal dims in tiles, in streaming order (the
        launch grid of a kernel that streams them)."""
        return tuple(math.ceil(self.dims[t.dim] / t.tile)
                     for t in self.temporal())

    def __str__(self) -> str:
        body = "; ".join(str(d) for d in self.directives)
        return f"MappingPlan[{self.name}]({body})"


@dataclasses.dataclass(frozen=True)
class ConvBlockPlan:
    """Block shapes of one fold schedule.

    The weight block (nf_b, c_b*r*s) is the Filter Fold that stays resident
    while image folds (c_b, rows, y) stream past; partial sums accumulate
    across the depth folds.
    """
    nf_block: int        # filters per fold
    c_block: int         # channels per fold (per group when groups > 1)
    p_block: int         # output rows per image fold
    grid: Tuple[int, int, int]           # (nf folds, c folds, p folds)
    vmem_bytes: int      # estimated working set of one fold step
    groups: int = 1      # channel groups G the blocks were solved within

    @property
    def total_folds(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]

    def clamped(self, nf: int, c: int, p: int) -> "ConvBlockPlan":
        """Clamp block shapes to a layer's actual dims and re-derive the
        grid.  This is what makes a cached schedule reusable across layers
        that share filter-fold geometry but differ spatially."""
        dw = self.groups > 1 and self.groups == c == nf   # depthwise
        c_span = c if dw else c // self.groups
        nf_b = max(1, min(self.nf_block, nf))
        c_b = max(1, min(self.c_block, c_span))
        p_b = max(1, min(self.p_block, p))
        if dw:
            nf_b = c_b
            grid = (1, math.ceil(c / c_b), math.ceil(p / p_b))
        else:
            grid = (math.ceil(nf / nf_b), math.ceil(c_span / c_b),
                    math.ceil(p / p_b))
        if (nf_b, c_b, p_b, grid) == (self.nf_block, self.c_block,
                                      self.p_block, self.grid):
            return self
        return dataclasses.replace(self, nf_block=nf_b, c_block=c_b,
                                   p_block=p_b, grid=grid)


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def conv_working_set(conv: ConvLoopNest, nf_block: int, c_block: int,
                     p_block: int, bytes_per_elem: int = 4) -> int:
    """Bytes of one fold step's working set: weight fold + streamed image
    rows + block accumulator."""
    if conv.depthwise:
        w = c_block * conv.r * conv.s
        acc = c_block * p_block * conv.q
    else:
        w = nf_block * c_block * conv.r * conv.s
        acc = nf_block * p_block * conv.q
    img = c_block * (p_block * conv.stride + conv.r) * conv.padded_y
    return (w + img + acc) * bytes_per_elem


def largest_divisor_le(n: int, cap: int) -> int:
    """Largest divisor of ``n`` that is <= ``cap`` (>= 1)."""
    cap = max(1, min(cap, n))
    for d in range(cap, 0, -1):
        if n % d == 0:
            return d
    return 1


def plan_conv_blocks(conv: ConvLoopNest,
                     vmem_limit: int = 64 * 1024 * 1024,
                     mxu: int = 128,
                     bytes_per_elem: int = 4) -> ConvBlockPlan:
    """Solve eqs (1)-(2) for one layer, with the same numbers as the JAX
    package: ``nf_block`` = min(N_F rounded to 8, 2*mxu), ``c_block`` the
    largest channel count whose working set fits half of ``vmem_limit``,
    ``p_block`` ~512 output positions per image fold."""
    p_block = min(conv.p, max(1, 512 // max(conv.q, 1)))

    def working_set(nf_b: int, c_b: int) -> int:
        return conv_working_set(conv, nf_b, c_b, p_block, bytes_per_elem)

    if conv.depthwise:
        c_block = min(_round_up(conv.c, 8), 512)
        while c_block > 1 and working_set(c_block, c_block) > vmem_limit // 2:
            c_block //= 2
        grid = (1, math.ceil(conv.c / c_block), math.ceil(conv.p / p_block))
        return ConvBlockPlan(nf_block=c_block, c_block=c_block,
                             p_block=p_block, grid=grid,
                             vmem_bytes=working_set(c_block, c_block),
                             groups=conv.groups)

    if conv.groups > 1:
        nfg, cg = conv.nfg, conv.cg
        want_nf = min(_round_up(nfg, 8), 2 * mxu)
        nf_block = largest_divisor_le(nfg, want_nf)
        c_block = largest_divisor_le(cg, 512)
        while (c_block > 1
               and working_set(nf_block, c_block) > vmem_limit // 2):
            c_block = largest_divisor_le(cg, c_block - 1)
        grid = (conv.groups * (nfg // nf_block), cg // c_block,
                math.ceil(conv.p / p_block))
        return ConvBlockPlan(nf_block=nf_block, c_block=c_block,
                             p_block=p_block, grid=grid,
                             vmem_bytes=working_set(nf_block, c_block),
                             groups=conv.groups)

    nf_block = min(_round_up(conv.nf, 8), 2 * mxu)
    c_block = min(conv.c, 512)
    while c_block > 1 and working_set(nf_block, c_block) > vmem_limit // 2:
        c_block //= 2
    grid = (math.ceil(conv.nf / nf_block),
            math.ceil(conv.c / c_block),
            math.ceil(conv.p / p_block))
    return ConvBlockPlan(nf_block=nf_block, c_block=c_block, p_block=p_block,
                         grid=grid, vmem_bytes=working_set(nf_block, c_block))


# --------------------------------------------------------------------------
# Canonical plans (Fig 6)
# --------------------------------------------------------------------------

def weight_stationary_conv_plan(conv: ConvLoopNest) -> MappingPlan:
    """Fig 6(b): FF spatial, IF/IB temporal, PS reduced."""
    plan = MappingPlan(
        name=f"ws-conv[{conv}]",
        dims=conv.dims(),
        directives=(
            SpatialMap("N_F", "mxu"),       # filters across PE rows
            SpatialMap("R", "mxu"),         # flattened filter cols
            SpatialMap("S", "mxu"),
            TemporalMap("C", 1),            # image blocks (depth)
            TemporalMap("N", 1),            # image folds
            TemporalMap("P", 1),
            TemporalMap("Q", 1),            # shift cycles
        ),
    )
    plan.validate()
    return plan


def serving_conv_plan(batch: int, nf: int, *, data_axis: str = "data",
                      model_axis: str = "model") -> MappingPlan:
    """The Spatial-Map directive set for batched conv serving: the batch
    (image-fold streaming) axis distributes across the ``data`` mesh axis
    and the N_F (filter-fold stationary) axis across ``model`` — the same
    two bindings Fig 6 assigns on-fabric, lifted one level to the mesh."""
    plan = MappingPlan(
        name=f"serve-conv[n={batch},nf={nf}]",
        dims={"N": batch, "N_F": nf},
        directives=(
            SpatialMap("N", data_axis),      # image folds -> DP
            SpatialMap("N_F", model_axis),   # filter folds -> TP
        ),
    )
    plan.validate()
    return plan


def lm_train_plan(batch: int, seq: int, d_model: int) -> MappingPlan:
    """The directive set behind the LM sharding rules: batch spatial on
    data (and pod), model dims spatial on model, sequence temporal."""
    plan = MappingPlan(
        name="lm-train",
        dims={"B": batch, "T": seq, "D": d_model},
        directives=(
            SpatialMap("B", "data"),
            SpatialMap("D", "model"),
            TemporalMap("T", seq),
        ),
    )
    plan.validate()
    return plan
