"""Three-term roofline of a traced step on the H100 (the JAX package's
``roofline.py``, over the port's own counts: ``op_cost.OpCost``).

    compute term    = flops_per_device / peak_flops_per_chip
    memory term     = bytes_per_device / hbm_bw_per_chip
    collective term = effective collective bytes per device / link bw

``op_cost.analyze_step`` counts one rank's local ops, so all three terms
use per-GPU hardware constants directly.  Collective bytes are result
bytes scaled by the ring-cost factor of the op and its group size g
(``op_cost.RING_FACTOR``):

    all-reduce      2*(g-1)/g      (reduce-scatter + all-gather)
    all-gather      (g-1)/g        (the result already holds the g x
                                    growth, so wire bytes ~= result*(g-1)/g)
    reduce-scatter  (g-1)          (operand bytes ~= result*g)
    all-to-all      (g-1)/g
    collective-permute  1

What the single link term leaves out: an H100 node holds 8 GPUs joined
all to all by NVLink, so a mesh axis of 16 (the production ``model``
axis) spans two nodes and part of its traffic crosses the slower
inter-node network; the term prices every byte at NVLink's rate, as the
JAX package's single ``ici_bw`` prices DCN traffic at ICI's.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional

from repro_torch.op_cost import RING_FACTOR, CollectiveRecord, OpCost

__all__ = ["HW", "H100_SXM", "CollectiveStats", "collective_stats",
           "roofline_terms", "RooflineReport"]


@dataclasses.dataclass(frozen=True)
class HW:
    name: str
    peak_flops: float          # per chip, bf16
    hbm_bw: float              # B/s per chip
    ici_bw: float              # B/s per link


# NVIDIA H100 Tensor Core GPU datasheet, SXM5 column: 989 TFLOP/s dense
# BF16 on the tensor cores (1,979 with sparsity), 3.35 TB/s of HBM3, and
# NVLink 4 at 900 GB/s a GPU both directions together (450 GB/s each way)
H100_SXM = HW(name="h100-sxm-80gb", peak_flops=989e12, hbm_bw=3.35e12,
              ici_bw=450e9)


@dataclasses.dataclass
class CollectiveStats:
    count: Dict[str, float]
    result_bytes: Dict[str, float]      # raw result-shape bytes per device
    wire_bytes: Dict[str, float]        # ring-factor scaled

    @property
    def total_wire_bytes(self) -> float:
        return sum(self.wire_bytes.values())

    def as_dict(self) -> dict:
        return {"count": self.count, "result_bytes": self.result_bytes,
                "wire_bytes": self.wire_bytes,
                "total_wire_bytes": self.total_wire_bytes}


def collective_stats(records: Iterable[CollectiveRecord]
                     ) -> CollectiveStats:
    """Per HLO collective op: how many, their result bytes and their wire
    bytes (``RING_FACTOR`` of each one's group size)."""
    count: Dict[str, float] = {}
    rbytes: Dict[str, float] = {}
    wbytes: Dict[str, float] = {}
    for r in records:
        count[r.op] = count.get(r.op, 0) + r.count
        rbytes[r.op] = rbytes.get(r.op, 0.0) + r.count * r.result_bytes
        wbytes[r.op] = wbytes.get(r.op, 0.0) + (
            r.count * r.result_bytes
            * RING_FACTOR[r.op](max(r.group_size, 2)))
    return CollectiveStats(count=count, result_bytes=rbytes,
                           wire_bytes=wbytes)


@dataclasses.dataclass
class RooflineReport:
    flops_per_dev: float
    bytes_per_dev: float
    coll_wire_bytes: float
    collectives: CollectiveStats
    hw: HW
    model_flops: float = 0.0          # 6*N*D (global, analytic)
    chips: int = 1
    # the walker's cross-check figures (unfused bytes, op count), under
    # the JAX report's key for its XLA ``cost_analysis()``
    xla_cost_analysis: Optional[dict] = None

    @property
    def t_compute(self) -> float:
        return self.flops_per_dev / self.hw.peak_flops

    @property
    def t_memory(self) -> float:
        return self.bytes_per_dev / self.hw.hbm_bw

    @property
    def t_collective(self) -> float:
        return self.coll_wire_bytes / self.hw.ici_bw

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def bound_time(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / (chips * per-dev counted flops): remat and
        redundancy."""
        total = self.flops_per_dev * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Useful-compute fraction of the bound: how close the dominant-term
        time is to the time the model FLOPs alone would need at peak."""
        ideal = self.model_flops / (self.chips * self.hw.peak_flops)
        return ideal / self.bound_time if self.bound_time else 0.0

    def as_dict(self) -> dict:
        return {
            "flops_per_dev": self.flops_per_dev,
            "bytes_per_dev": self.bytes_per_dev,
            "coll_wire_bytes_per_dev": self.coll_wire_bytes,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "dominant": self.dominant,
            "model_flops": self.model_flops,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "collectives": self.collectives.as_dict(),
            "chips": self.chips,
            "hw": self.hw.name,
            "xla_cost_analysis": self.xla_cost_analysis,
        }


def roofline_terms(cost: OpCost, *, chips: int, model_flops: float = 0.0,
                   hw: HW = H100_SXM) -> RooflineReport:
    """The report of an ``op_cost.OpCost``: its flops, its HBM bytes (the
    elementwise ops fused) and its collectives' wire bytes."""
    colls = collective_stats(cost.records or ())
    return RooflineReport(
        flops_per_dev=cost.flops, bytes_per_dev=cost.bytes_hbm,
        coll_wire_bytes=colls.total_wire_bytes, collectives=colls, hw=hw,
        model_flops=model_flops, chips=chips,
        xla_cost_analysis={"flops": cost.flops,
                           "bytes_accessed": cost.bytes_all,
                           "bytes_all_upper_bound": cost.bytes_all,
                           "ops": cost.n_ops})
