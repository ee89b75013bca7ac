"""Fold-execution simulator (the paper's "custom simulator", §V.A), the
JAX package's ``core/simulator.py`` on torch tensors.

Two parts:

1. ``execute_conv_by_folds`` — a *functional* executor that computes a real
   convolution by walking the exact fold schedule (filter fold -> image fold
   -> shift -> 3-stage reduction -> partial-sum accumulation across image
   blocks) on the tensors' own device.  Its output is compared against the
   conv oracles in tests: this proves the decomposition computes the right
   thing, not just that the geometry counts match Table 3.

2. ``simulate_cycles`` — a cycle-accounting model that walks the same
   schedule and charges cycles per stage (weight programming, multicast
   store-and-forward hops, MAC, reduction-tree depth, shift, lateral
   forwarding, writeback).  It produces the T_WL / T_MT / T_OP components
   used by the KIPS model alongside the closed-form eq (11).  Integer
   accounting: equal to the JAX package's on every layer.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.core.folds import PEArray, decompose
from repro_torch.core.loopnest import ConvLoopNest

__all__ = ["execute_conv_by_folds", "simulate_cycles", "CycleReport"]

# elements of one (N, F, c, R, S, positions) product block: the image-fold
# positions are walked in chunks that keep it near 256 MiB of fp32
_PRODUCT_ELEMS = 1 << 26


def execute_conv_by_folds(x: torch.Tensor, w: torch.Tensor,
                          conv: ConvLoopNest, pe: PEArray) -> torch.Tensor:
    """Compute conv(x, w) via the paper's fold schedule.

    x: (N, C, X, Y) input;  w: (N_F, C, R, S) filters, on one device.
    Returns (N, N_F, P, Q) in the operands' promoted type.

    Schedule (paper Fig 4/5):
      for each filter fold (row split over N_F, col split over depth):
        program stationary weights                       [weight-stationary]
        for each image fold p (P*N folds per block):
          multicast fold columns across PE rows          [spatial reuse]
          for each shift q (Q shifts, stride steps):
            MAC; reduce over S; reduce over depth-in-fold [in-fabric reduce]
        -> partial-sum fold for this block's depth range
      accumulate partial-sum folds across blocks          [multi-depth reduce]

    The (image fold, shift) pairs of one fold pair are independent, so they
    run together (``unfold`` gathers every window); the fold pairs, and
    with them the order of the depth accumulation, are walked as the
    JAX package walks them.  As there, the products and the S, R and
    in-fold depth sums are in the operands' type and the partial-sum folds
    accumulate in float64.
    """
    plan = decompose(conv, pe)
    n, c = conv.n, conv.c
    r, s, p, q = conv.r, conv.s, conv.p, conv.q
    dtype = torch.promote_types(x.dtype, w.dtype)
    xp = F.pad(x.to(dtype), (conv.pad,) * 4) if conv.pad else x.to(dtype)
    w = w.to(dtype)
    out = torch.zeros((n, conv.nf, p * q), dtype=torch.float64,
                      device=x.device)
    cpf = max(plan.channels_per_fold, 1)

    for i in range(plan.n_row_splits):                  # vertical fold splits
        f_lo = i * plan.fold_rows
        f_hi = min(f_lo + plan.fold_rows, conv.nf)
        for j in range(plan.n_col_splits):              # depth fold splits
            c_lo = j * cpf
            c_hi = min(c_lo + cpf, c)
            if c_lo >= c:
                break
            nfold, cfold = f_hi - f_lo, c_hi - c_lo
            w_fold = w[f_lo:f_hi, c_lo:c_hi]            # stationary weights
            # every (image fold, shift) window: (N, c*R*S, P*Q), channel-major
            windows = F.unfold(xp[:, c_lo:c_hi], (r, s), stride=conv.stride)
            windows = windows.reshape(n, 1, cfold, r, s, p * q)
            wf = w_fold.reshape(1, nfold, cfold, r, s, 1)
            step = max(1, _PRODUCT_ELEMS // (n * nfold * cfold * r * s))
            # partial-sum fold for this (filters, depth-range) pair
            ps = torch.empty((n, nfold, p * q), dtype=torch.float64,
                             device=x.device)
            for lo in range(0, p * q, step):
                prod = wf * windows[..., lo:lo + step]   # (N, F, c, R, S, L)
                red_s = prod.sum(dim=4)                  # filter-width reduce
                red_r = red_s.sum(dim=3)                 # across PE groups (R)
                red_d = red_r.sum(dim=2)                 # single-depth reduce
                ps[..., lo:lo + step] = red_d
            out[:, f_lo:f_hi] += ps                  # multi-depth accumulate
    return out.reshape(n, conv.nf, p, q).to(dtype)


# --------------------------------------------------------------------------
# Cycle accounting
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CycleReport:
    t_wl: int           # weight programming cycles
    t_mt: int           # message-transfer cycles (multicast + forwarding)
    t_op: int           # compute + reduce + shift cycles
    t_wb: int           # writeback cycles
    msgs: int           # total messages injected

    @property
    def total(self) -> int:
        return self.t_wl + self.t_mt + self.t_op + self.t_wb

    def as_dict(self) -> Dict[str, int]:
        return {"t_wl": self.t_wl, "t_mt": self.t_mt, "t_op": self.t_op,
                "t_wb": self.t_wb, "total": self.total, "msgs": self.msgs}


def simulate_cycles(conv: ConvLoopNest, pe: PEArray,
                    multicast_hops: bool = True,
                    inject_lanes: Optional[int] = None) -> CycleReport:
    """Charge cycles along the fold schedule.

    multicast_hops: model vertical multicast as store-and-forward across the
    R_P rows (1 hop/cycle/row, the MAVeC spatial-bus behaviour) rather than a
    single-cycle broadcast.  This is what makes message transfer dominate the
    paper's VGG-16 breakdown (260.7M of 290M cycles).
    inject_lanes: parallel injection ports (default: one per PE column).
    """
    plan = decompose(conv, pe)
    cv = conv
    lanes = inject_lanes or pe.cp
    s1 = cv.s + 1
    t_wl = t_mt = t_op = t_wb = msgs = 0
    for fold in plan.filter_folds():
        n_groups = fold.cols_used // s1
        n_weights = fold.rows_used * (fold.cols_used - n_groups)
        t_wl += math.ceil(n_weights / lanes)
        msgs += n_weights
        folds_in_block = plan.image_folds_per_block
        # multicast: per image fold, each group gets a column of S elements,
        # forwarded down rows_used rows if store-and-forward
        col_cost = cv.s * (fold.rows_used if multicast_hops else 1)
        inj = math.ceil(n_groups * col_cost / lanes)
        t_mt += folds_in_block * inj
        msgs += folds_in_block * n_groups * cv.s
        shifts = plan.shifts_per_fold
        # per shift: MAC(1) + reduce over S (log tree) + depth reduce
        reduce_depth = math.ceil(math.log2(max(cv.s, 2))) \
            + math.ceil(math.log2(max(n_groups, 2)))
        t_op += folds_in_block * shifts * (1 + reduce_depth + 1)   # +shift
        # lateral forwarding of reused columns each shift
        fwd = max(cv.s - cv.stride, 0)
        t_mt += folds_in_block * shifts * (fwd * (fold.rows_used
                                                  if multicast_hops else 1)
                                           ) // max(lanes, 1)
        msgs += folds_in_block * shifts * fwd
        t_wb += folds_in_block * math.ceil(fold.rows_used * shifts / lanes)
        msgs += folds_in_block * fold.rows_used
    return CycleReport(t_wl=t_wl, t_mt=t_mt, t_op=t_op, t_wb=t_wb, msgs=msgs)
