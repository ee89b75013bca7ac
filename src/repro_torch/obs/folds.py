"""Per-schedule streaming counters: the paper's Fig 9 layer-wise
utilization profile and Table 3 fold-reuse numbers as *running* counters
over live traffic.

For every distinct ``ScheduleKey`` a served network executes, we join

* the **analytical model side** — ``perfmodel.layer_perf`` on the
  schedule's planned nest (eq 10 average PE utilization, eq 11 T_Ops,
  eq 12 GFLOP/s) and ``engine.dataflow_traffic_bytes`` for the selected
  dataflow (modeled off-chip bytes), normalized per inference.  These are
  the MAVeC accelerator's numbers (``MavecConfig``: its PE array, clock
  and bandwidth), not the H100's roofline; with

* the **measured side** — the host-clock interval from a batch's dispatch
  to the end of its readback, apportioned across the network's layers by
  each layer's share of the modeled T_Ops.  A jitted forward is one CUDA
  graph replay, so no per-layer time is measured; the apportionment is
  the model's own prediction of where the time goes and is tagged
  ``apportioned`` wherever it is surfaced.

The quotient — achieved GFLOP/s over the model's eq-12 GFLOP/s — is the
live achieved-vs-model column.

The model side is a pure function of a schedule (memoized: a full-width
layer's fold walk takes tens of ms on the host), and the T_Ops shares are
static per compiled network: ``prepare`` computes them once per
``layer_schedules`` tuple (one per bucket; ``VisionEngine.warmup`` calls
it), and every batch reuses them.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.engine import ConvSchedule, dataflow_traffic_bytes
from repro_torch.core.folds import PEArray
from repro_torch.core.perfmodel import MavecConfig, layer_perf

__all__ = ["model_layer_stats", "FoldStreamCounters"]


def model_layer_stats(sched: ConvSchedule, pe: PEArray,
                      cfg: Optional[MavecConfig] = None) -> dict:
    """The analytical-model row for one compiled schedule, normalized per
    inference (the planned nest's batch divided out)."""
    return dict(_model_row(sched.nest, sched.plan, sched.dataflow,
                           sched.key, pe, cfg or MavecConfig()))


@functools.lru_cache(maxsize=None)
def _model_row(nest, plan, dataflow: str, key, pe: PEArray,
               cfg: MavecConfig) -> dict:
    lp = layer_perf(nest, pe, cfg)
    # bytes are modeled at the *streamed* dtype: int8 schedules move
    # 1-byte weight/activation folds (psum staging stays 4-byte int32)
    traffic = dataflow_traffic_bytes(nest, plan, cfg.bytes_per_elem,
                                     precision=key.precision)
    bytes_batch = traffic.get(dataflow,
                              traffic.get("weight_stationary", 0.0))
    n = max(nest.n, 1)
    return {
        "key": str(key),
        "dataflow": dataflow,
        "precision": key.precision,
        "util_model_pct": round(lp.util_avg_pct, 2),
        "t_ops_cycles": lp.t_ops,
        "gflops_model": round(lp.gflops, 2),
        "flops_per_inf": nest.flops / n,
        "bytes_per_inf": bytes_batch / n,
    }


class _SchedCounters:
    """Running totals for one ScheduleKey."""

    __slots__ = ("model", "layers", "dispatches", "items", "time_s")

    def __init__(self, model: dict) -> None:
        self.model = model
        self.layers: List[str] = []
        self.dispatches = 0
        self.items = 0
        self.time_s = 0.0

    def row(self) -> dict:
        m = self.model
        flops = m["flops_per_inf"] * self.items * len(self.layers or [1])
        achieved = (flops / self.time_s / 1e9) if self.time_s > 0 else 0.0
        vs_model = (achieved / m["gflops_model"] * 100.0
                    if m["gflops_model"] else 0.0)
        return {
            "key": m["key"],
            "dataflow": m["dataflow"],
            "precision": m["precision"],
            "layers": list(self.layers),
            "util_model_pct": m["util_model_pct"],
            "t_ops_cycles": m["t_ops_cycles"],
            "gflops_model": m["gflops_model"],
            "dispatches": self.dispatches,
            "items": self.items,
            "measured_s": round(self.time_s, 6),
            "bytes_moved_model": m["bytes_per_inf"] * self.items
            * len(self.layers or [1]),
            "achieved_gflops": round(achieved, 4),
            "achieved_vs_model_pct": round(vs_model, 4),
        }


class FoldStreamCounters:
    """Live per-ScheduleKey utilization / bytes-moved / achieved-vs-model
    table.

    ``observe_compile`` registers a compiled network's layer → schedule
    mapping (idempotent per layer name); ``record`` folds one measured
    interval into the per-schedule totals, ``apportion`` splits it across
    the layers (for trace spans), and ``observe_dispatch`` does both.
    """

    def __init__(self, pe: Optional[PEArray] = None,
                 cfg: Optional[MavecConfig] = None) -> None:
        self.pe = pe or PEArray(16, 16)
        self.cfg = cfg or MavecConfig()
        self._by_key: Dict[str, _SchedCounters] = {}
        self._layer_key: Dict[str, str] = {}    # layer name -> key str
        self._layer_tops: Dict[str, int] = {}   # layer name -> model t_ops
        # id(layer_schedules) -> (the tuple, its ``prepare`` result)
        self._shares: Dict[int, Tuple[Sequence, Tuple[list, list]]] = {}

    # -- registration ------------------------------------------------------
    def observe_compile(
            self, layer_schedules: Sequence[Tuple[str, ConvSchedule]]
    ) -> None:
        for name, sched in layer_schedules:
            k = str(sched.key)
            sc = self._by_key.get(k)
            if sc is None:
                sc = _SchedCounters(model_layer_stats(sched, self.pe,
                                                      self.cfg))
                self._by_key[k] = sc
            if name not in self._layer_key:
                sc.layers.append(name)
            self._layer_key[name] = k
            self._layer_tops[name] = sc.model["t_ops_cycles"]

    def prepare(self, layer_schedules) -> Tuple[list, list]:
        """Computed on the first sight of a ``layer_schedules`` tuple and
        kept for it: each layer's (name, key, T_Ops share), and each
        distinct key's counters with its layers' summed share."""
        hit = self._shares.get(id(layer_schedules))
        if hit is not None and hit[0] is layer_schedules:
            return hit[1]
        self.observe_compile(layer_schedules)
        names = [name for name, _ in layer_schedules]
        total = float(sum(self._layer_tops[n] for n in names)) or 1.0
        layers = [(n, self._layer_key[n], self._layer_tops[n] / total)
                  for n in names]
        by_key: Dict[str, float] = {}
        for _, k, share in layers:
            by_key[k] = by_key.get(k, 0.0) + share
        keys = [(self._by_key[k], share) for k, share in by_key.items()]
        shares = (layers, keys)
        self._shares[id(layer_schedules)] = (layer_schedules, shares)
        return shares

    # -- measurement -------------------------------------------------------
    def apportion(
            self, layer_schedules: Sequence[Tuple[str, ConvSchedule]],
            kernel_time_s: float
    ) -> List[Tuple[str, str, float]]:
        """Split one measured interval across layers by modeled T_Ops
        share: ``[(layer, key_str, dur_s), ...]`` in layer order."""
        return [(n, k, kernel_time_s * share)
                for n, k, share in self.prepare(layer_schedules)[0]]

    def record(self, layer_schedules: Sequence[Tuple[str, ConvSchedule]],
               items: int, kernel_time_s: float) -> None:
        """Fold one dispatched batch (``items`` inferences, one measured
        interval) into the running totals: one update per distinct key,
        nothing allocated per layer (the serving hot path)."""
        for sc, share in self.prepare(layer_schedules)[1]:
            sc.time_s += kernel_time_s * share
            sc.dispatches += 1
            sc.items += items

    def observe_dispatch(
            self, layer_schedules: Sequence[Tuple[str, ConvSchedule]],
            items: int, kernel_time_s: float
    ) -> List[Tuple[str, str, float]]:
        """``record`` one batch and return its per-layer apportionment
        (same contract as ``apportion``)."""
        self.record(layer_schedules, items, kernel_time_s)
        return self.apportion(layer_schedules, kernel_time_s)

    # -- export ------------------------------------------------------------
    def rows(self) -> List[dict]:
        return [self._by_key[k].row() for k in sorted(self._by_key)]

    @property
    def util_model_pct(self) -> float:
        """Mean eq-10 utilization across distinct schedules — the headline
        the paper quotes (>90% for VGG-16 on 64x64)."""
        rows = self.rows()
        if not rows:
            return 0.0
        return sum(r["util_model_pct"] for r in rows) / len(rows)

    def as_dict(self) -> dict:
        return {
            "pe_array": f"{self.pe.rp}x{self.pe.cp}",
            "distinct_schedules": len(self._by_key),
            "conv_layers": len(self._layer_key),
            "util_model_pct": round(self.util_model_pct, 2),
            "schedules": {r["key"]: r for r in self.rows()},
        }

    def table(self) -> str:
        """Human-readable per-schedule table (the report CLI output)."""
        hdr = (f"{'schedule':<24} {'dataflow':<18} {'lyr':>3} "
               f"{'util%':>6} {'GF/s(mdl)':>10} {'disp':>5} {'items':>6} "
               f"{'meas(s)':>8} {'MB(mdl)':>9} {'GF/s':>8} {'vs-mdl%':>8}")
        lines = [hdr, "-" * len(hdr)]
        for r in self.rows():
            lines.append(
                f"{r['key']:<24} {r['dataflow']:<18} "
                f"{len(r['layers']):>3} {r['util_model_pct']:>6.2f} "
                f"{r['gflops_model']:>10.2f} {r['dispatches']:>5} "
                f"{r['items']:>6} {r['measured_s']:>8.3f} "
                f"{r['bytes_moved_model'] / 1e6:>9.2f} "
                f"{r['achieved_gflops']:>8.3f} "
                f"{r['achieved_vs_model_pct']:>8.3f}")
        lines.append(f"mean model utilization: "
                     f"{self.util_model_pct:.2f}% over "
                     f"{len(self._by_key)} schedules / "
                     f"{len(self._layer_key)} conv layers "
                     f"[PE {self.pe.rp}x{self.pe.cp}]")
        return "\n".join(lines)
