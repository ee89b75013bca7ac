"""Filter-Fold / Image-Block / Image-Fold decomposition (paper §IV.B).

Implements equations (1)-(5) and the fold enumeration exactly as the paper
describes them:

* the 4-D filter tensor is flattened depth-major, each channel's (R x S) grid
  unrolled column-by-column in REVERSE order, with one reserved reduction
  column appended after each spatial row -> effective width S+1;
* the flattened (N_F x C*R*(S+1)) matrix is sliced into Filter Folds sized by
  the PE-array geometry (R_P x C_P);
* the input tensor is depth-sliced into Image Blocks matching filter folds
  and width-sliced into Image Folds (P*N per block), with previously-used
  columns deduplicated so that only new columns are streamed.

These are *geometry* computations: they do not touch arrays and are shared by
the analytical performance model, the cycle simulator, and the Pallas kernel
block-shape solver.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterator, List, Tuple

from repro_torch.core.loopnest import ConvLoopNest

__all__ = [
    "PEArray",
    "FilterFold",
    "ImageFold",
    "FoldingPlan",
    "decompose",
]


@dataclasses.dataclass(frozen=True)
class PEArray:
    """A 2-D array of processing elements (paper: SiteOs in a MAVeC quad)."""
    rp: int  # rows  R_P
    cp: int  # cols  C_P

    @property
    def size(self) -> int:
        return self.rp * self.cp

    def __str__(self) -> str:
        return f"{self.rp}x{self.cp}"


@dataclasses.dataclass(frozen=True)
class FilterFold:
    """One slice of the flattened filter matrix mapped onto the PE array."""
    row_split: int        # vertical split index (over N_F)
    col_split: int        # horizontal split index (over C_transformed)
    rows_used: int        # filters resident in this fold (<= R_P)
    cols_used: int        # flattened columns occupied (<= fold_cols)
    chan_lo: int          # first input channel covered (inclusive)
    chan_hi: int          # last input channel covered (exclusive)

    def active_pes(self) -> int:
        """PEs occupied by this fold (reserved reduction columns count as
        active -- they perform the in-network reduction, paper Fig 4)."""
        return self.rows_used * self.cols_used

    def idle_pes(self, pe: PEArray) -> int:
        """Idle_i of eq (10)."""
        return pe.size - self.active_pes()


@dataclasses.dataclass(frozen=True)
class ImageFold:
    """One width-slice of an image block (paper Fig 3b)."""
    index: int                    # i in {0..P-1}
    candidate_cols: Tuple[int, ...]  # {C_i .. C_i+S-1}, reversed
    new_cols: Tuple[int, ...]        # after dedup vs previous folds

    @property
    def streamed_cols(self) -> int:
        return len(self.new_cols)


@dataclasses.dataclass(frozen=True)
class FoldingPlan:
    """Full decomposition of one conv layer onto one PE array."""
    conv: ConvLoopNest
    pe: PEArray

    # ---- eq (1)-(3): filter folds ------------------------------------------
    @property
    def slice_width(self) -> int:
        """Columns of one depth slice after reserved-column insertion:
        R * (S+1)."""
        return self.conv.r * (self.conv.s + 1)

    @property
    def c_transformed(self) -> int:
        """Width of the flattened filter matrix: C * R * (S+1)."""
        return self.conv.c * self.slice_width

    @property
    def fold_rows(self) -> int:
        """eq (1): fold height = R_P."""
        return self.pe.rp

    @property
    def channels_per_fold(self) -> int:
        """How many full depth slices fit side-by-side in C_P."""
        return self.pe.cp // self.slice_width

    @property
    def fold_cols(self) -> int:
        """eq (2): floor(C_P / (R*(S+1))) * R*(S+1).

        Degenerate case (slice wider than the array, e.g. 7x7 filters on a
        16-wide array): fall back to sub-slice folds aligned to whole
        (S+1)-column PE groups so the reduction tree stays intact.
        """
        if self.channels_per_fold >= 1:
            return self.channels_per_fold * self.slice_width
        groups = self.pe.cp // (self.conv.s + 1)
        if groups < 1:
            raise ValueError(
                f"PE array {self.pe} too narrow for filter width S={self.conv.s}")
        return groups * (self.conv.s + 1)

    @property
    def n_row_splits(self) -> int:
        """Vertical splits over N_F."""
        return math.ceil(self.conv.nf / self.fold_rows)

    @property
    def n_col_splits(self) -> int:
        """Horizontal splits over C_transformed (the paper's N_FT(C))."""
        return math.ceil(self.c_transformed / self.fold_cols)

    @property
    def total_filter_folds(self) -> int:
        """eq (3)."""
        return self.n_row_splits * self.n_col_splits

    # ---- eq (4)-(5): image blocks & folds -----------------------------------
    @property
    def total_image_blocks(self) -> int:
        """eq (4): one block per filter fold."""
        return self.total_filter_folds

    @property
    def distinct_image_blocks(self) -> int:
        """Distinct depth ranges (blocks repeat across N_F row splits)."""
        return self.n_col_splits

    @property
    def image_folds_per_block(self) -> int:
        """eq (5): P * N."""
        return self.conv.p * self.conv.n

    @property
    def shifts_per_fold(self) -> int:
        """Each fold is right-shifted by the stride Q times (paper Fig 4)."""
        return self.conv.q

    # ---- enumeration ---------------------------------------------------------
    def filter_folds(self) -> Iterator[FilterFold]:
        cpf = max(self.channels_per_fold, 1)
        for i in range(self.n_row_splits):
            rows_used = min(self.fold_rows, self.conv.nf - i * self.fold_rows)
            for j in range(self.n_col_splits):
                cols_used = min(self.fold_cols,
                                self.c_transformed - j * self.fold_cols)
                chan_lo = min((j * self.fold_cols) // self.slice_width,
                              self.conv.c - 1)
                chan_hi = min(chan_lo + cpf, self.conv.c)
                yield FilterFold(row_split=i, col_split=j,
                                 rows_used=rows_used, cols_used=cols_used,
                                 chan_lo=chan_lo, chan_hi=chan_hi)

    def image_folds(self) -> List[ImageFold]:
        """Width-slices of one image block, with cross-fold column dedup
        (paper Fig 3b: Fold #1 takes S columns, later folds only the new
        `stride` columns)."""
        used: set = set()
        folds = []
        for i in range(self.conv.p):
            start = i * self.conv.stride
            cand = tuple(reversed(range(start, start + self.conv.s)))
            new = tuple(c for c in cand if c not in used)
            used.update(new)
            folds.append(ImageFold(index=i, candidate_cols=cand, new_cols=new))
        return folds

    def streamed_cols_per_block(self) -> int:
        """Unique input columns actually injected per block (data-movement
        win of the dedup rule)."""
        return sum(f.streamed_cols for f in self.image_folds())

    # ---- eq (10): utilization -------------------------------------------------
    def avg_utilization(self) -> float:
        """Util_avg(%) -- average active-PE fraction across all folds."""
        total = 0.0
        n = 0
        for fold in self.filter_folds():
            total += (self.pe.size - fold.idle_pes(self.pe)) / self.pe.size
            n += 1
        return 100.0 * total / max(n, 1)

    # ---- summary (Table 3) ------------------------------------------------------
    def summary(self) -> dict:
        full = self.fold_rows * self.fold_cols == self.pe.size
        return {
            "workload": str(self.conv),
            "pe_array": str(self.pe),
            "filter_folds": self.total_filter_folds,
            "fold_type": "Full" if full else "Partial",
            "block_length": self.image_folds_per_block,
            "shifts": self.shifts_per_fold,
            "channels_per_fold": self.channels_per_fold,
            "fold_cols": self.fold_cols,
            "util_avg_pct": round(self.avg_utilization(), 2),
        }


def decompose(conv: ConvLoopNest, pe: PEArray) -> FoldingPlan:
    """Decompose a conv loop nest onto a PE array (the paper's §IV.B)."""
    return FoldingPlan(conv=conv, pe=pe)
