"""64-bit message encoding and instruction-stream generation (paper §IV.A),
a copy of the JAX package's ``core/streaming.py`` (pure Python over the
port's ``core/folds.FoldingPlan``; the words are bit-identical to its).

MAVeC executes convolution as a stream of 64-bit messages that carry both
data and opcodes ("message-driven execution").  This module keeps that
artifact faithful: a packed message word

    [63:56] opcode     [55:48] dest row    [47:40] dest col
    [39:32] flags      [31:0]  payload (fp32 bits or immediate)

and a generator that emits the exact instruction stream for one
filter-fold x image-block interaction (program -> multicast -> mac ->
reduce -> shift -> writeback, paper Fig 4).

A GPU has no decentralized opcode routing either: this layer exists for
fidelity, for the cycle simulator (``core/simulator.py``), and for tests
that check the stream's structure (message counts drive the T_MT term of
the KIPS model).
"""
from __future__ import annotations

import dataclasses
import enum
import struct
from typing import Iterator, List

from repro_torch.core.folds import FilterFold, FoldingPlan

__all__ = ["Opcode", "Message", "encode", "decode", "fold_stream",
           "stream_counts"]


class Opcode(enum.IntEnum):
    NOP = 0x00
    PROG_WEIGHT = 0x01     # program a stationary weight into a PE
    MCAST_COL = 0x02       # multicast an image column down a PE group
    MAC = 0x03             # elementwise multiply-accumulate
    REDUCE_S = 0x04        # column-wise reduction across filter width S
    REDUCE_DEPTH = 0x05    # single-depth reduction across column groups
    REDUCE_MULTI = 0x06    # multi-depth reduction
    SHIFT = 0x07           # right-shift image fold by stride
    FWD_LATERAL = 0x08     # forward reused column to next PE group
    WRITEBACK = 0x09       # partial-sum fold -> L1
    BARRIER = 0x0A


@dataclasses.dataclass(frozen=True)
class Message:
    opcode: Opcode
    row: int = 0
    col: int = 0
    flags: int = 0
    payload: int = 0       # raw 32-bit payload

    def pack(self) -> int:
        if not (0 <= self.row < 256 and 0 <= self.col < 256):
            raise ValueError("row/col exceed 8-bit routing field")
        return ((int(self.opcode) & 0xFF) << 56 | (self.row & 0xFF) << 48
                | (self.col & 0xFF) << 40 | (self.flags & 0xFF) << 32
                | (self.payload & 0xFFFFFFFF))


def encode(msg: Message) -> int:
    return msg.pack()


def decode(word: int) -> Message:
    return Message(
        opcode=Opcode((word >> 56) & 0xFF),
        row=(word >> 48) & 0xFF,
        col=(word >> 40) & 0xFF,
        flags=(word >> 32) & 0xFF,
        payload=word & 0xFFFFFFFF,
    )


def f32_payload(x: float) -> int:
    return struct.unpack("<I", struct.pack("<f", x))[0]


# --------------------------------------------------------------------------
# Instruction-stream generation for one fold interaction (paper Fig 4)
# --------------------------------------------------------------------------

def fold_stream(plan: FoldingPlan, fold: FilterFold) -> Iterator[Message]:
    """Emit the message stream for one filter fold interacting with its
    image block.  Payloads are elided (zero) -- the *structure* (opcodes,
    routing, counts) is what the simulator and tests consume.
    """
    cv = plan.conv
    s1 = cv.s + 1
    # (1) program the stationary filter fold
    for r in range(fold.rows_used):
        for c in range(fold.cols_used):
            if (c % s1) != cv.s:                       # skip reserved columns
                yield Message(Opcode.PROG_WEIGHT, row=r, col=c)
    yield Message(Opcode.BARRIER)
    n_groups = fold.cols_used // s1
    for _fold_i in range(plan.image_folds_per_block):
        # (2) spatial multicast: one column per PE group, S elements each
        for g in range(n_groups):
            yield Message(Opcode.MCAST_COL, row=0, col=g * s1,
                          flags=cv.s)                  # flags = burst length
        for _shift in range(plan.shifts_per_fold):
            # (3) elementwise multiply
            yield Message(Opcode.MAC, flags=1)
            # (4) three-stage hierarchical reduction
            yield Message(Opcode.REDUCE_S)
            yield Message(Opcode.REDUCE_DEPTH)
            yield Message(Opcode.REDUCE_MULTI)
            # (5) right-shift by stride; reused columns forward laterally
            yield Message(Opcode.SHIFT, flags=cv.stride)
            yield Message(Opcode.FWD_LATERAL, flags=min(cv.s - cv.stride,
                                                        cv.s) if cv.s > cv.stride else 0)
        yield Message(Opcode.WRITEBACK, flags=fold.rows_used)


def stream_counts(plan: FoldingPlan) -> dict:
    """Aggregate message counts per opcode for the whole layer, computed
    in closed form (enumerating 16k folds x 56x56 interactions message by
    message would be wasteful)."""
    cv = plan.conv
    s1 = cv.s + 1
    counts = {op.name: 0 for op in Opcode}
    folds_r, folds_c = plan.n_row_splits, plan.n_col_splits
    per_fold_weights = 0
    for fold in plan.filter_folds():
        n_groups = fold.cols_used // s1
        per_fold_weights += fold.rows_used * (fold.cols_used - n_groups)
        if_per_block = plan.image_folds_per_block
        counts["MCAST_COL"] += if_per_block * n_groups
        counts["WRITEBACK"] += if_per_block
    shifts = plan.shifts_per_fold
    interactions = plan.total_filter_folds * plan.image_folds_per_block
    counts["PROG_WEIGHT"] = per_fold_weights
    counts["BARRIER"] = plan.total_filter_folds
    counts["MAC"] = interactions * shifts
    counts["REDUCE_S"] = interactions * shifts
    counts["REDUCE_DEPTH"] = interactions * shifts
    counts["REDUCE_MULTI"] = interactions * shifts
    counts["SHIFT"] = interactions * shifts
    counts["FWD_LATERAL"] = interactions * shifts
    counts["total"] = sum(v for k, v in counts.items() if k != "total")
    del counts["NOP"]
    return counts
