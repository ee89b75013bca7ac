"""Analytical performance model (paper §V.B, equations 6-15).

Reproduces, from fold geometry alone:
  * reuse / parallelism metrics        eqs (6)-(9)
  * average PE utilization             eq (10)
  * total execution cycles  T_Ops      eq (11)
  * compute throughput (GFLOP/s)       eq (12)
  * system throughput (KIPS)           eqs (13)-(15)

Validated against the paper's own numbers in ``tests/test_perfmodel.py`` and
``benchmarks/``: Table 3 fold counts, the 75% -> >92% utilization step, the
~78 GFLOP/s (16x16) -> ~1.56 TFLOP/s (64x64) throughput span and the
12.7 KIPS VGG-16 system figure.

Note on eq (11): the paper's routing term ``K = log_(I+1)(C_P) + 1`` is
typeset ambiguously; we use the reduction-tree depth through the reserved
columns, ``K = ceil(log_{S+1}(C_P)) + 1`` (branching factor S+1).  K is
O(log C_P) and numerically negligible against the shift term either way.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence

from repro_torch.core.folds import FoldingPlan, PEArray, decompose
from repro_torch.core.loopnest import ConvLoopNest

__all__ = [
    "MavecConfig",
    "ReuseMetrics",
    "LayerPerf",
    "reuse_metrics",
    "layer_perf",
    "t_ops_cycles",
    "kips",
]


@dataclasses.dataclass(frozen=True)
class MavecConfig:
    """System constants of the evaluated MAVeC SoC (paper §V.A)."""
    freq_ghz: float = 1.0           # PE clock
    pcie_gbps: float = 126.0        # PCIe Gen6 x16 (GB/s)
    offchip_gbps: float = 4.5       # GDDR7 as quoted in §V.C (GB/s)
    bytes_per_elem: int = 4         # FP32
    tile_pes: int = 256             # PEs per tile (16 SiteMs x 4x4 SiteOs)
    # message-injection calibration: input elements moved per cycle into the
    # fabric per active tile (see simulator.py for the counted version)
    msgs_per_cycle_per_tile: float = 1.0

    def tiles(self, pe: PEArray) -> int:
        return max(pe.size // self.tile_pes, 1)


# --------------------------------------------------------------------------
# eqs (6)-(9): reuse & parallelism metrics
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ReuseMetrics:
    temporal_weight_reuse: int    # eq (6)
    spatial_input_reuse: int      # eq (7)
    spatial_parallelism: int      # eq (8)
    spatial_reduction: int        # eq (9)


def reuse_metrics(plan: FoldingPlan) -> ReuseMetrics:
    cv, pe = plan.conv, plan.pe
    cpf = plan.channels_per_fold if plan.channels_per_fold >= 1 else 1
    base = cpf * cv.r * cv.s                   # active (multiplying) columns
    return ReuseMetrics(
        temporal_weight_reuse=cv.p * cv.q * pe.rp * base,          # eq (6)
        spatial_input_reuse=cv.q * pe.rp * base,                   # eq (7)
        spatial_parallelism=pe.rp * cpf * cv.r * (cv.s + 1),       # eq (8)
        spatial_reduction=cv.p * cv.q * pe.rp * cpf * cv.s,        # eq (9)
    )


# --------------------------------------------------------------------------
# eq (11): total execution cycles
# --------------------------------------------------------------------------

def _routing_k(plan: FoldingPlan) -> int:
    """K = ceil(log_{S+1}(C_P)) + 1 (see module docstring)."""
    base = plan.conv.s + 1
    return math.ceil(math.log(max(plan.pe.cp, base), base)) + 1


def _accum_cycles(plan: FoldingPlan) -> int:
    """(T_AddOps * T_AddCCs): merging the N_FT(C) partial-sum folds.

    Each of the (N_FT(C)-1) merges adds a (P x Q) partial-sum fold,
    pipelined across the C_P adder lanes.
    """
    merges = plan.n_col_splits - 1
    per_merge = math.ceil(plan.conv.p * plan.conv.q / plan.pe.cp)
    return merges * per_merge


def t_ops_cycles(plan: FoldingPlan) -> int:
    """eq (11):

    T_Ops = [ N_FT(C) + 4 * Shifts * N_DT * N_FT(C) + K
              + T_AddOps*T_AddCCs ] * N_FT(R)

    with Shifts = Q (shift cycles per fold) and N_DT = P*N (image folds per
    block).  The leading N_FT(C) term is the per-fold weight-programming
    cost; the factor 4 is the paper's per-shift pipeline depth (multicast,
    multiply, reduce, shift).
    """
    nft_c = plan.n_col_splits
    nft_r = plan.n_row_splits
    shifts = plan.shifts_per_fold
    n_dt = plan.image_folds_per_block
    inner = (nft_c
             + 4 * shifts * n_dt * nft_c
             + _routing_k(plan)
             + _accum_cycles(plan))
    return inner * nft_r


# --------------------------------------------------------------------------
# eq (12): compute throughput
# --------------------------------------------------------------------------

def gflops_per_sec(plan: FoldingPlan, cfg: MavecConfig) -> float:
    """eq (12): 2*(I + 2P/S)^2 * (N_F * D * F^2) / T_Ops * f.

    (I + 2*pad/stride)^2 is the paper's output-activation estimate; D = input
    channels, F = filter spatial size.
    """
    cv = plan.conv
    out_positions = (cv.x + 2 * cv.pad / cv.stride) ** 2
    ops = 2.0 * out_positions * (cv.nf * cv.c * cv.r * cv.s)
    return ops / t_ops_cycles(plan) * cfg.freq_ghz  # cycles@GHz -> GFLOP/s


# --------------------------------------------------------------------------
# eq (10) + packaging
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LayerPerf:
    plan: FoldingPlan
    util_avg_pct: float
    t_ops: int
    gflops: float
    reuse: ReuseMetrics

    def as_dict(self) -> dict:
        d = self.plan.summary()
        d.update(util_avg_pct=round(self.util_avg_pct, 2),
                 t_ops_cycles=self.t_ops,
                 gflops_per_sec=round(self.gflops, 2),
                 temporal_weight_reuse=self.reuse.temporal_weight_reuse,
                 spatial_input_reuse=self.reuse.spatial_input_reuse,
                 spatial_parallelism=self.reuse.spatial_parallelism,
                 spatial_reduction=self.reuse.spatial_reduction)
        return d


def layer_perf(conv: ConvLoopNest, pe: PEArray,
               cfg: Optional[MavecConfig] = None) -> LayerPerf:
    cfg = cfg or MavecConfig()
    plan = decompose(conv, pe)
    return LayerPerf(
        plan=plan,
        util_avg_pct=plan.avg_utilization(),
        t_ops=t_ops_cycles(plan),
        gflops=gflops_per_sec(plan, cfg),
        reuse=reuse_metrics(plan),
    )


# --------------------------------------------------------------------------
# eqs (13)-(15): end-to-end system throughput (KIPS)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SystemCycles:
    """T_Total components (paper §V.C), in cycles."""
    t_pcie: float
    t_wl: float      # weight loading
    t_mt: float      # message transfer
    t_op: float      # execution

    @property
    def total(self) -> float:
        return self.t_pcie + self.t_wl + self.t_mt + self.t_op


def system_cycles(layers: Sequence[ConvLoopNest], pe: PEArray,
                  cfg: MavecConfig, multicast_hops: bool = True
                  ) -> SystemCycles:
    """First-principles estimate of the four T_Total components.

    * T_PCIe: all weights + the network input over PCIe.
    * T_WL: weight elements injected at one element/cycle/tile.
    * T_MT: input-activation messages.  Every image fold is re-multicast for
      each of its filter folds' row splits; the dedup rule means only new
      columns stream after the first fold of a block.  With
      ``multicast_hops`` the vertical multicast is store-and-forward across
      the R_P rows (the MAVeC spatial-bus behaviour) — this is what makes
      message transfer dominate the paper's VGG-16 breakdown (260.7M of
      290M cycles); our estimate lands within ~2x of that quoted figure.
    * T_OP: sum of eq (11) over layers.
    """
    bytes_total = 0
    wl_elems = 0
    mt_msgs = 0
    t_op = 0
    tiles = cfg.tiles(pe)
    for cv in layers:
        plan = decompose(cv, pe)
        sizes = cv.tensor_sizes()
        bytes_total += sizes["filter"] * cfg.bytes_per_elem
        wl_elems += sizes["filter"]
        # messages: per distinct block, the streamed unique columns (full
        # height x channels in the block), re-sent for every row split.
        per_block_cols = plan.streamed_cols_per_block()
        cpf = max(plan.channels_per_fold, 1)
        elems_per_block = per_block_cols * cv.padded_x * cpf * cv.n
        hop = pe.rp if multicast_hops else 1   # store-and-forward rows
        mt_msgs += elems_per_block * plan.distinct_image_blocks \
            * plan.n_row_splits * hop
        t_op += t_ops_cycles(plan)
    if layers:
        first = layers[0]
        bytes_total += first.tensor_sizes()["input"] * cfg.bytes_per_elem
    t_pcie = bytes_total / (cfg.pcie_gbps * 1e9) * cfg.freq_ghz * 1e9
    t_wl = wl_elems / tiles
    t_mt = mt_msgs / (cfg.msgs_per_cycle_per_tile * tiles)
    return SystemCycles(t_pcie=t_pcie, t_wl=t_wl, t_mt=t_mt, t_op=t_op)


def kips(layers: Sequence[ConvLoopNest], pe: PEArray,
         cfg: Optional[MavecConfig] = None,
         cycles: Optional[SystemCycles] = None,
         batch: int = 1) -> Dict[str, float]:
    """eqs (13)-(15) exactly as written.

    Ops/Inf   = Total Operations / (B * N)                       eq (14)
    Ops/Sec   = (Ops_Total / T_Total) * (Tiles*256) * Util * f   eq (15)
    KIPS      = Ops/Sec / (Ops/Inf * 1e3)                        eq (13)

    ``cycles`` may be supplied to evaluate the model at externally-quoted
    component values (e.g. the paper's own §V.C numbers).
    """
    cfg = cfg or MavecConfig()
    cycles = cycles or system_cycles(layers, pe, cfg)
    total_ops = float(sum(cv.flops for cv in layers))
    util = sum(decompose(cv, pe).avg_utilization() for cv in layers) \
        / max(len(layers), 1)
    ops_per_inf = total_ops / batch                                 # eq (14)
    ops_per_sec = ((total_ops / cycles.total)
                   * (cfg.tiles(pe) * cfg.tile_pes)
                   * (util / 100.0)
                   * cfg.freq_ghz * 1e9)                            # eq (15)
    return {
        "kips": ops_per_sec / (ops_per_inf * 1e3),                  # eq (13)
        "ops_per_sec": ops_per_sec,
        "ops_per_inf": ops_per_inf,
        "util_avg_pct": util,
        "t_pcie": cycles.t_pcie,
        "t_wl": cycles.t_wl,
        "t_mt": cycles.t_mt,
        "t_op": cycles.t_op,
        "t_total": cycles.total,
    }
