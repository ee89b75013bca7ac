"""Cached fold-schedule execution engine.

The paper compiles the 7-D loop nest into a *static* fold schedule once and
then streams data through it; a network's conv layers collapse to a
handful of distinct loop-nest geometries whose schedules are reused ("fold
reuse").  This module is that compile-once discipline, model-agnostic:
models describe themselves as streaming graphs (``core/graph.py``).

* ``ScheduleKey`` canonicalizes a ``ConvLoopNest`` to its filter-fold
  geometry ``(N_F, C, R, S, stride, dilation, groups)`` — spatial extents
  and the batch are excluded, so a deep trunk collapses to a few keys.
* ``ConvSchedule`` is one cached schedule: the ``ConvBlockPlan`` solved
  once per key plus the dataflow picked by ``dataflow_costs``.
* ``ScheduleCache`` is the registry; its hit/miss counters are the paper's
  fold-reuse metric.  ``autotune_for`` replaces the analytical ranking with
  measured timings (``autotune_schedule`` races ``tuning_candidates`` on
  the device, each candidate proven before it is launched), pay-once per
  key and persisted as JSON (``save_tuning`` / ``load_tuning``).
* ``compile_network`` lowers a ``StreamGraph`` through one shared cache
  and returns a forward with the schedules baked in, in fp32 or, with
  ``precision="int8"``, through the quantized fold stream
  (``core/quant.py``); with ``jit`` (the default, as in the JAX package)
  that forward is captured as one CUDA graph on its first call
  (``CapturedForward``).

The cost model prices traffic with the paper's accelerator constants
(``MavecConfig``), exactly as the JAX package does, so the two packages
pick the same dataflow for every layer.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import math
import os
import threading
import time
import warnings
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.core.epilogue import Epilogue, epilogue_out_hw, maxpool2x2
from repro_torch.core.graph import (DEPTHWISE, GraphError, StreamGraph,
                                    as_graph, bn_scale_shift, fuse_graph)
from repro_torch.core.loopnest import ConvLoopNest
from repro_torch.core.mapping import (WS_ACC_BYTES_LIMIT, ConvBlockPlan,
                                      conv_working_set, largest_divisor_le,
                                      plan_conv_blocks)
from repro_torch.core.perfmodel import MavecConfig
from repro_torch.device import resolve_device

__all__ = [
    "ScheduleKey",
    "ConvSchedule",
    "CacheStats",
    "ScheduleCache",
    "stream_bytes_per_elem",
    "traffic_components",
    "dataflow_costs",
    "dataflow_traffic_bytes",
    "select_dataflow",
    "plan_and_dataflow",
    "tuning_candidates",
    "measure_schedule_ms",
    "autotune_schedule",
    "backend_tag",
    "resolve_execution",
    "CompiledNetwork",
    "CapturedForward",
    "kernel_launch_counts",
    "compile_network",
    "BucketCompiler",
    "POLICIES",
]

POLICIES = ("auto", "kernel", "reference")


# --------------------------------------------------------------------------
# Canonical schedule keys
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ScheduleKey:
    """Filter-fold geometry of a conv loop nest — the schedule identity."""
    nf: int
    c: int
    r: int
    s: int
    stride: int
    dilation: int = 1
    groups: int = 1
    precision: str = "fp32"   # streamed dtype: an int8 filter fold is a
    #                           different resident tensor (1 byte/elem,
    #                           int32 sums), so a different schedule

    @classmethod
    def from_loopnest(cls, cv: ConvLoopNest,
                      precision: str = "fp32") -> "ScheduleKey":
        return cls(nf=cv.nf, c=cv.c, r=cv.r, s=cv.s, stride=cv.stride,
                   dilation=cv.dilation, groups=cv.groups,
                   precision=precision)

    def __str__(self) -> str:
        g = f"/g{self.groups}" if self.groups > 1 else ""
        pr = f"/{self.precision}" if self.precision != "fp32" else ""
        return f"{self.r}x{self.s}x{self.c}->{self.nf}/s{self.stride}{g}{pr}"


# the ``kernels.ops.conv2d`` impl that runs each dataflow
_IMPL_OF_DATAFLOW = {"weight_stationary": "fold_ws",
                     "output_stationary": "fold_os",
                     "weight_stationary_psum": "fold_ws_psum",
                     "depthwise": "fold_dw"}


@dataclasses.dataclass(frozen=True)
class ConvSchedule:
    """One compiled fold schedule: block plan + selected dataflow.  ``nest``
    is the loop nest the plan was solved against; ``costs`` are the
    estimated cycles per dataflow that drove the selection.  A measured
    schedule (``source`` "measured", or "loaded" from a tuning file) keeps
    the winner's median ms and every raced candidate's, fastest first;
    ``failed`` names the candidates that failed their proof or their
    measurement (not persisted)."""
    key: ScheduleKey
    nest: ConvLoopNest
    plan: ConvBlockPlan
    dataflow: str
    costs: Tuple[Tuple[str, float], ...]
    source: str = "model"                      # model | measured | loaded
    measured_ms: Optional[float] = None        # winner's median, if measured
    timings: Tuple[Tuple[str, float], ...] = ()  # (candidate, median ms)
    failed: Tuple[Tuple[str, str], ...] = ()   # (candidate, error)

    @property
    def cost_dict(self) -> Dict[str, float]:
        return dict(self.costs)

    @property
    def tuned(self) -> bool:
        return self.source in ("measured", "loaded")

    def impl(self) -> str:
        """The ``kernels.ops.conv2d`` impl string for this dataflow."""
        return _IMPL_OF_DATAFLOW[self.dataflow]


# --------------------------------------------------------------------------
# Dataflow selection from the traffic model
# --------------------------------------------------------------------------

def stream_bytes_per_elem(precision: str, bytes_per_elem: int = 4) -> int:
    """Bytes per streamed weight/activation element at a precision.  The
    outputs (and the accumulator) stay at ``bytes_per_elem``: the int8
    path dequantizes at the flush and writes fp32."""
    if precision == "int8":
        return 1
    if precision == "fp32":
        return bytes_per_elem
    raise ValueError(f"unknown precision {precision!r} (want fp32|int8)")


def traffic_components(cv: ConvLoopNest, plan: ConvBlockPlan, dataflow: str,
                       bytes_per_elem: int = 4,
                       precision: str = "fp32") -> Dict[str, float]:
    """Per-tensor-class off-chip byte split for one dataflow: weights and
    input at the streamed dtype, output and staged partial sums at the
    accumulator / write width."""
    bpe = bytes_per_elem
    sbpe = stream_bytes_per_elem(precision, bytes_per_elem)
    sizes = cv.tensor_sizes()
    w_bytes = sizes["filter"] * sbpe
    in_bytes = cv.n * cv.c * cv.padded_x * cv.padded_y * sbpe
    out_bytes = sizes["output"] * bpe
    clamped = plan.clamped(cv.nf, cv.c, cv.p)
    g_nf, g_c, g_p = clamped.grid
    if cv.depthwise:
        if dataflow != "depthwise":
            raise ValueError(f"depthwise nest has no {dataflow!r} "
                             "formulation")
        return {"weights": w_bytes, "input": in_bytes, "output": out_bytes}
    g_nfg = max(g_nf // cv.groups, 1)       # nf folds per group
    # psum staging writes and reads back every depth fold's partial sums,
    # then writes the output: (2*g_c + 1) output-sized transfers
    psum = (2 * g_c + 1) * out_bytes
    acc_bytes = clamped.nf_block * g_p * clamped.p_block * cv.q * bpe
    ws_out = out_bytes if acc_bytes <= WS_ACC_BYTES_LIMIT else psum
    if dataflow == "weight_stationary":
        return {"weights": w_bytes, "input": g_nfg * in_bytes,
                "output": ws_out}
    if dataflow == "weight_stationary_psum":
        return {"weights": w_bytes, "input": g_nfg * in_bytes,
                "output": psum}
    if dataflow == "output_stationary":
        return {"weights": g_p * w_bytes, "input": g_nfg * in_bytes,
                "output": out_bytes}
    raise ValueError(f"unknown dataflow {dataflow!r}")


def dataflow_traffic_bytes(cv: ConvLoopNest, plan: ConvBlockPlan,
                           bytes_per_elem: int = 4,
                           precision: str = "fp32") -> Dict[str, float]:
    """Modeled off-chip bytes per dataflow formulation (``precision=
    "int8"`` prices the weight and input streams at one byte)."""
    dws = (("depthwise",) if cv.depthwise else
           ("weight_stationary", "weight_stationary_psum",
            "output_stationary"))
    return {df: sum(traffic_components(cv, plan, df, bytes_per_elem,
                                       precision).values())
            for df in dws}


def dataflow_costs(cv: ConvLoopNest, plan: ConvBlockPlan,
                   cfg: Optional[MavecConfig] = None,
                   precision: str = "fp32") -> Dict[str, float]:
    """Estimated cycles of each dataflow for this layer: the shared compute
    term (MACs over the tile's PEs) plus the modeled traffic over the
    ``MavecConfig`` off-chip bandwidth.  Weight-stationary fetches weights
    once and re-streams the input per NF fold; output-stationary re-fetches
    the weight block for every P fold."""
    cfg = cfg or MavecConfig()
    traffic = dataflow_traffic_bytes(cv, plan, cfg.bytes_per_elem, precision)

    def cycles(traffic_bytes: float) -> float:
        return traffic_bytes / (cfg.offchip_gbps * 1e9) * (cfg.freq_ghz * 1e9)

    compute = cv.macs / cfg.tile_pes
    if cv.depthwise:
        return {"depthwise": compute + cycles(traffic["depthwise"])}
    return {
        "weight_stationary": compute + cycles(traffic["weight_stationary"]),
        "output_stationary": compute + cycles(traffic["output_stationary"]),
    }


def select_dataflow(cv: ConvLoopNest, plan: ConvBlockPlan,
                    cfg: Optional[MavecConfig] = None,
                    costs: Optional[Dict[str, float]] = None,
                    precision: str = "fp32") -> str:
    """Pick the cheaper dataflow; ties go to ``output_stationary``."""
    if cv.depthwise:
        return "depthwise"
    costs = (costs if costs is not None
             else dataflow_costs(cv, plan, cfg, precision))
    if costs["output_stationary"] <= costs["weight_stationary"]:
        return "output_stationary"
    return "weight_stationary"


def plan_and_dataflow(cv: ConvLoopNest,
                      cfg: Optional[MavecConfig] = None,
                      precision: str = "fp32"
                      ) -> Tuple[ConvBlockPlan, str]:
    """Uncached one-shot planning (the ``impl="fold_auto"`` path)."""
    plan = plan_conv_blocks(cv)
    return plan, select_dataflow(cv, plan, cfg, precision=precision)


# --------------------------------------------------------------------------
# Measured autotuning (the analytical ranking above is the no-tuning default)
# --------------------------------------------------------------------------

def tuning_candidates(cv: ConvLoopNest,
                      base_plan: Optional[ConvBlockPlan] = None,
                      vmem_limit: int = 64 * 1024 * 1024
                      ) -> List[Tuple[str, ConvBlockPlan, str]]:
    """The candidate set ``autotune_schedule`` races: the analytical plan
    plus nearby block-shape variants of every blocked axis (P, C, NF),
    crossed with both dataflows — the JAX package's set, labels and
    dedup, so the two packages race the same plans.

    Grouped geometries snap the varied blocks back to divisors of the
    per-group extents (``mapping.largest_divisor_le``), so no fold
    straddles a group; depthwise geometries vary the channel and P blocks
    only and race the single ``"depthwise"`` dataflow.  On the card a
    candidate's feasibility (a CTA tile that fits shared memory) is proven
    by ``autotune_schedule`` before it is launched, not here.
    """
    base = (base_plan or plan_conv_blocks(cv, vmem_limit=vmem_limit)
            ).clamped(cv.nf, cv.c, cv.p)

    if cv.depthwise:
        def with_dw(c_b: int, p_b: int) -> ConvBlockPlan:
            c_b = max(1, min(c_b, -(-cv.c // 8) * 8 if cv.c >= 8 else cv.c))
            p_b = max(1, min(p_b, cv.p))
            grid = (1, math.ceil(cv.c / c_b), math.ceil(cv.p / p_b))
            return dataclasses.replace(
                base, nf_block=c_b, c_block=c_b, p_block=p_b, grid=grid,
                vmem_bytes=conv_working_set(cv, c_b, c_b, p_b))

        c_b, p_b = base.c_block, base.p_block
        plans: Dict[Tuple[int, int, int], Tuple[str, ConvBlockPlan]] = {}
        for label, plan in (
                ("base", base),
                ("p_half", with_dw(c_b, p_b // 2)),
                ("p_double", with_dw(c_b, p_b * 2)),
                ("c_half", with_dw(c_b // 2, p_b)),
                ("c_double", with_dw(c_b * 2, p_b)),
        ):
            plans.setdefault((plan.nf_block, plan.c_block, plan.p_block),
                             (label, plan))
        return [(label, plan, "depthwise") for label, plan in plans.values()]

    def with_blocks(nf_b: int, c_b: int, p_b: int) -> ConvBlockPlan:
        if cv.groups > 1:
            nf_b = largest_divisor_le(cv.nfg, max(nf_b, 1))
            c_b = largest_divisor_le(cv.cg, max(c_b, 1))
            grid = (cv.groups * (cv.nfg // nf_b), cv.cg // c_b,
                    math.ceil(cv.p / max(1, min(p_b, cv.p))))
        else:
            if cv.nf >= 8:                  # the JAX package's lane rounding
                nf_b = -(-nf_b // 8) * 8
            nf_b = max(1, min(nf_b,
                              -(-cv.nf // 8) * 8 if cv.nf >= 8 else cv.nf))
            c_b = max(1, min(c_b, cv.c))
            grid = (math.ceil(cv.nf / nf_b), math.ceil(cv.c / c_b),
                    math.ceil(cv.p / max(1, min(p_b, cv.p))))
        p_b = max(1, min(p_b, cv.p))
        return dataclasses.replace(
            base, nf_block=nf_b, c_block=c_b, p_block=p_b, grid=grid,
            vmem_bytes=conv_working_set(cv, nf_b, c_b, p_b))

    nf_b, c_b, p_b = base.nf_block, base.c_block, base.p_block
    plans = {}
    for label, plan in (
            ("base", base),
            ("p_half", with_blocks(nf_b, c_b, p_b // 2)),
            ("p_double", with_blocks(nf_b, c_b, p_b * 2)),
            ("c_half", with_blocks(nf_b, c_b // 2, p_b)),
            ("nf_half", with_blocks(nf_b // 2, c_b, p_b)),
            ("nf_double", with_blocks(nf_b * 2, c_b, p_b)),
    ):
        plans.setdefault((plan.nf_block, plan.c_block, plan.p_block),
                         (label, plan))
    return [(label, plan, df) for label, plan in plans.values()
            for df in ("weight_stationary", "output_stationary")]


def _schedule_operands(cv: ConvLoopNest, epilogue: Optional[Epilogue],
                       precision: str, dev: torch.device) -> dict:
    """Random operands of one layer for ``conv2d_folded``, made from a
    seeded ``torch.Generator`` on ``dev``: x (padded), w, and the vectors
    and shortcut the epilogue reads.  With ``precision="int8"`` x and w
    are quantized and the epilogue is the requant form, so the race times
    the int8 stream it will deploy."""
    from repro_torch.core.quant import (act_scale, quantize_act,
                                        quantize_weight, requant_affine,
                                        requant_epilogue)
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    x = randn(cv.n, cv.c, cv.padded_x, cv.padded_y)
    w = randn(cv.nf, cv.cg, cv.r, cv.s)
    has = epilogue is not None
    residual = randn(cv.n, cv.nf, cv.p, cv.q) \
        if has and epilogue.residual else None
    zeros = torch.zeros(cv.nf, device=dev)
    ones = torch.ones(cv.nf, device=dev)
    if precision == "int8":
        x = quantize_act(x, act_scale(x))
        w, w_scale = quantize_weight(w)
        scale, shift = requant_affine(
            w_scale, epilogue, zeros if has and epilogue.bias else None,
            ones if has and epilogue.scale else None,
            zeros if has and epilogue.scale else None)
        return dict(x_padded=x, w=w, bias=None, scale=scale, shift=shift,
                    residual=residual, epilogue=requant_epilogue(epilogue))
    scaled = has and epilogue.scale
    return dict(x_padded=x, w=w,
                bias=zeros if has and epilogue.bias else None,
                scale=ones if scaled else None,
                shift=zeros if scaled else None,
                residual=residual, epilogue=epilogue)


def measure_schedule_ms(cv: ConvLoopNest, plan: ConvBlockPlan, dataflow: str,
                        *, device: Any = "cuda", reps: int = 3,
                        warmup: int = 1,
                        epilogue: Optional[Epilogue] = None,
                        precision: str = "fp32") -> float:
    """Median-of-``reps`` ms of one fold-kernel call on ``device``.

    Synthesizes the layer's tensors (``_schedule_operands``: a shortcut
    when the deployment ``epilogue`` fuses a residual add, the int8
    operands and requant epilogue with ``precision="int8"``) and times the
    deployed call, ``kernels.conv2d_ws.conv2d_folded`` with the candidate
    plan and dataflow and the same epilogue, so the same CTA tile
    (``fold_tile``) runs as in the forward.  On a CUDA device it is device
    time: after ``warmup`` eager calls (the first loads the kernel
    library), four calls are captured in one CUDA graph and each of
    ``reps`` replays is timed between two CUDA events; the launch counters
    tick in the warm-up and the capture, as for any captured forward.  On
    the CPU (the plain fold loop) it is host time per call."""
    from repro_torch.kernels.conv2d_ws import conv2d_folded
    dev = resolve_device(device)
    ops = _schedule_operands(cv, epilogue, precision, dev)

    def call():
        return conv2d_folded(stride=cv.stride, plan=plan, dataflow=dataflow,
                             groups=cv.groups, **ops)

    ts = []
    with torch.inference_mode():
        for _ in range(max(warmup, 1)):
            call()
        if dev.type != "cuda":
            for _ in range(max(reps, 1)):
                t0 = time.perf_counter()
                call()
                ts.append((time.perf_counter() - t0) * 1e3)
        else:
            inner = 4
            torch.cuda.synchronize(dev)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                for _ in range(inner):
                    call()
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            for _ in range(max(reps, 1)):
                t0.record()
                graph.replay()
                t1.record()
                t1.synchronize()
                ts.append(t0.elapsed_time(t1) / inner)
            del graph
    ts.sort()
    return ts[len(ts) // 2]


def _prove_candidate(cv: ConvLoopNest, plan: ConvBlockPlan, dataflow: str,
                     epilogue: Optional[Epilogue], precision: str,
                     dev: torch.device) -> None:
    """``_verify_schedule`` on one candidate before it is launched: its
    plan, its launch's index maps and, on a CUDA device, the CTA tile
    ``fold_tile`` picks for it (which raises where none fits shared
    memory).  Raises ``FoldLintError`` or ``ValueError``."""
    from repro_torch.core.quant import requant_epilogue
    key = ScheduleKey.from_loopnest(cv, precision)
    sched = ConvSchedule(key=key, nest=cv, plan=plan, dataflow=dataflow,
                         costs=())
    sm_count = None
    if dev.type == "cuda":
        from repro_torch.kernels.conv2d_ws import _sm_count
        sm_count = _sm_count(dev)
    epi = requant_epilogue(epilogue) if precision == "int8" else epilogue
    _verify_schedule(f"tune {key} {dataflow}", cv, sched, epi, cv.groups,
                     sm_count)


def autotune_schedule(cv: ConvLoopNest, cfg: Optional[MavecConfig] = None,
                      *, vmem_limit: int = 64 * 1024 * 1024,
                      device: Any = "cuda",
                      reps: int = 3, warmup: int = 1,
                      epilogue: Optional[Epilogue] = None,
                      timer: Optional[Callable[[ConvBlockPlan, str], float]]
                      = None,
                      precision: str = "fp32") -> ConvSchedule:
    """Race the candidate set on ``device`` and return the measured winner.

    Candidates are ranked strictly by their measured median: a
    measured-slower candidate never outranks a measured-faster one (the
    analytical cost model has no vote once timings exist).  Without a
    ``timer`` each candidate is first proven (``_prove_candidate``: plan,
    index maps, CTA tile) and then timed (``measure_schedule_ms``) with
    the deployment ``epilogue``; a candidate that fails either is recorded
    in ``failed`` and never outranks anything, and one that fails its
    proof is never launched.  ``timer(plan, dataflow)`` replaces both
    (tests inject deterministic fakes)."""
    key = ScheduleKey.from_loopnest(cv, precision)
    if timer is None:
        dev = resolve_device(device)

        def timer(plan, df):
            _prove_candidate(cv, plan, df, epilogue, precision, dev)
            return measure_schedule_ms(cv, plan, df, device=dev, reps=reps,
                                       warmup=warmup, epilogue=epilogue,
                                       precision=precision)
    raced, failed = [], []
    for label, plan, df in tuning_candidates(cv, vmem_limit=vmem_limit):
        try:
            raced.append((float(timer(plan, df)), f"{label}/{df}", plan, df))
        except Exception as e:              # candidate failure isolation:
            failed.append((f"{label}/{df}", e))  # one bad variant must not
            continue                             # abort the whole race
    if not raced:
        raise RuntimeError(
            f"autotune: every candidate failed for {cv} — "
            + "; ".join(f"{lbl}: {e}" for lbl, e in failed))
    raced.sort(key=lambda t: t[0])          # measured-fastest first, always
    best_ms, _, best_plan, best_df = raced[0]
    costs = dataflow_costs(cv, best_plan, cfg, precision)
    return ConvSchedule(key=key, nest=cv, plan=best_plan, dataflow=best_df,
                        costs=tuple(sorted(costs.items())),
                        source="measured", measured_ms=best_ms,
                        timings=tuple((lbl, ms) for ms, lbl, _, _ in raced),
                        failed=tuple((lbl, f"{type(e).__name__}: {e}")
                                     for lbl, e in failed))


def backend_tag(device: Any) -> str:
    """The backend a tuning file's timings belong to: torch, the device
    type and, on CUDA, the card's name (``"torch-cpu"``,
    ``"torch-cuda:NVIDIA H100 80GB HBM3"``).  The JAX package writes
    ``jax.default_backend()`` ("cpu", "tpu", "gpu"), which never equals
    one of these."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return f"torch-cuda:{torch.cuda.get_device_name(dev)}"
    return f"torch-{dev.type}"


# --------------------------------------------------------------------------
# Execution policy
# --------------------------------------------------------------------------

def resolve_execution(policy: str = "auto",
                      device: Any = "cuda") -> Tuple[str, torch.device]:
    """Resolve an execution policy and device to ``(mode, device)``.

      "auto"      — the same as "kernel".
      "kernel"    — the fold kernels: the CUDA kernels on a CUDA device,
                    their plain-torch fold loop on the CPU.
      "reference" — the plain-torch ``conv2d_direct`` everywhere.

    There is no silent fallback: a CUDA device without a usable GPU
    raises.
    """
    if policy not in POLICIES:
        raise ValueError(f"unknown execution policy {policy!r} "
                         f"(want one of {POLICIES})")
    return ("reference" if policy == "reference" else "kernel"), \
        resolve_device(device)


# --------------------------------------------------------------------------
# The schedule registry
# --------------------------------------------------------------------------

@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    replans: int = 0

    @property
    def lookups(self) -> int:
        return self.hits + self.misses

    @property
    def hit_rate(self) -> float:
        return self.hits / self.lookups if self.lookups else 0.0

    def as_dict(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "replans": self.replans, "hit_rate": round(self.hit_rate, 4)}


class ScheduleCache:
    """Registry of fold schedules keyed by filter-fold geometry.

    ``schedule_for`` solves each geometry's plan and dataflow once and
    reuses it for every later layer with the same key; a reused plan is
    clamped to the actual dims by the kernel, so reuse across shrinking
    spatial extents is exact.  A *larger* spatial extent arriving later
    re-plans the entry in place (``stats.replans``).
    """

    def __init__(self, cfg: Optional[MavecConfig] = None,
                 vmem_limit: int = 64 * 1024 * 1024):
        self.cfg = cfg or MavecConfig()
        self.vmem_limit = vmem_limit
        self.stats = CacheStats()
        self._entries: Dict[ScheduleKey, ConvSchedule] = {}
        self._kernels: Dict[Tuple[ScheduleKey, str, Optional[Epilogue]],
                            Callable] = {}
        # the device the measured entries were timed on (tags the JSON)
        self._device: Optional[torch.device] = None

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def distinct(self) -> int:
        return len(self._entries)

    def schedules(self) -> List[ConvSchedule]:
        return list(self._entries.values())

    def _forget_kernels(self, key: ScheduleKey) -> None:
        self._kernels = {k: v for k, v in self._kernels.items()
                         if k[0] != key}

    def _build(self, cv: ConvLoopNest, key: ScheduleKey) -> ConvSchedule:
        plan = plan_conv_blocks(cv, vmem_limit=self.vmem_limit)
        costs = dataflow_costs(cv, plan, self.cfg, key.precision)
        dataflow = select_dataflow(cv, plan, self.cfg, costs=costs)
        return ConvSchedule(key=key, nest=cv, plan=plan, dataflow=dataflow,
                            costs=tuple(sorted(costs.items())))

    def schedule_for(self, cv: ConvLoopNest,
                     precision: str = "fp32") -> ConvSchedule:
        key = ScheduleKey.from_loopnest(cv, precision)
        hit = self._entries.get(key)
        if hit is not None:
            if (cv.padded_x > hit.nest.padded_x
                    or cv.padded_y > hit.nest.padded_y):
                self.stats.replans += 1
                self._entries[key] = self._build(cv, key)
                self._forget_kernels(key)
                return self._entries[key]
            self.stats.hits += 1
            return hit
        self.stats.misses += 1
        sched = self._build(cv, key)
        self._entries[key] = sched
        return sched

    # -- measured autotuning ----------------------------------------------
    def autotune_for(self, cv: ConvLoopNest, *, reps: int = 3,
                     warmup: int = 1, device: Any = "cuda",
                     epilogue: Optional[Epilogue] = None,
                     timer: Optional[Callable[[ConvBlockPlan, str], float]]
                     = None, precision: str = "fp32") -> ConvSchedule:
        """Measured ``schedule_for``: the first layer with a given key
        races ``tuning_candidates`` on ``device``; every later layer (and
        every later session that loads the JSON tuning file) reuses the
        winner — tuning is pay-once per ``ScheduleKey``.

        Candidates are timed with the first-seen layer's ``epilogue``; a
        later same-key layer with another fused epilogue reuses the
        winner's block geometry without re-measuring.  A re-tune drops the
        key's memoized kernels."""
        key = ScheduleKey.from_loopnest(cv, precision)
        hit = self._entries.get(key)
        if (hit is not None and hit.tuned
                and cv.padded_x <= hit.nest.padded_x
                and cv.padded_y <= hit.nest.padded_y):
            self.stats.hits += 1
            return hit
        if hit is None:
            self.stats.misses += 1
        else:                       # model-sourced or spatially outgrown
            self.stats.replans += 1
        if timer is None:
            self._device = resolve_device(device)
        sched = autotune_schedule(cv, self.cfg, vmem_limit=self.vmem_limit,
                                  device=device, reps=reps, warmup=warmup,
                                  epilogue=epilogue, timer=timer,
                                  precision=precision)
        self._entries[key] = sched
        self._forget_kernels(key)
        return sched

    # -- JSON persistence of tuning results --------------------------------
    def _tag(self, device: Any) -> str:
        if device is not None:
            return backend_tag(resolve_device(device))
        if self._device is not None:
            return backend_tag(self._device)
        return backend_tag("cuda" if torch.cuda.is_available() else "cpu")

    def save_tuning(self, path: str, device: Any = None) -> int:
        """Write every measured/loaded schedule to ``path`` (JSON), in the
        JAX package's schema; ``backend`` is ``backend_tag`` of ``device``
        (default: the device the entries were measured on).  Model-sourced
        entries are skipped — only real timings are persisted."""
        entries = []
        for key, s in sorted(self._entries.items(), key=lambda kv: str(kv[0])):
            if not s.tuned:
                continue
            entries.append({
                "key": dataclasses.asdict(key),
                "nest": dataclasses.asdict(s.nest),
                "plan": {"nf_block": s.plan.nf_block,
                         "c_block": s.plan.c_block,
                         "p_block": s.plan.p_block,
                         "grid": list(s.plan.grid),
                         "vmem_bytes": s.plan.vmem_bytes,
                         "groups": s.plan.groups},
                "dataflow": s.dataflow,
                "measured_ms": s.measured_ms,
                "timings": [[lbl, ms] for lbl, ms in s.timings],
            })
        payload = {"version": 1, "backend": self._tag(device),
                   "entries": entries}
        with open(path, "w") as f:
            json.dump(payload, f, indent=2)
        return len(entries)

    @staticmethod
    def _dataclass_kwargs(cls, d: dict) -> dict:
        """Tuning-JSON schema tolerance: drop fields this build doesn't
        know (a newer writer), and let dataclass defaults fill fields the
        file doesn't have (an older writer)."""
        known = {f.name for f in dataclasses.fields(cls)}
        return {k: v for k, v in d.items() if k in known}

    def load_tuning(self, path: str, device: Any = None) -> int:
        """Install previously-measured winners from ``path``; returns how
        many.  Loaded entries hit in both ``schedule_for`` and
        ``autotune_for`` (no re-measurement).

        Schema-tolerant as the JAX package's loader: a pre-``groups`` entry
        loads with ``groups=1``, a pre-int8 one with ``precision="fp32"``,
        unknown fields of a newer writer are ignored.  Timings only
        transfer within a backend: a file whose ``backend`` differs from
        ``backend_tag(device)`` — one the JAX package wrote (on any
        backend), a CPU file on the card or a card's file on the CPU, a
        file from another card model — is ignored with a warning and 0 is
        returned, so the caller re-measures and overwrites.  A missing,
        unreadable or corrupt file, or a corrupt entry, warns and is
        skipped: a deployment never fails to start over a tuning file."""
        try:
            with open(path) as f:
                payload = json.load(f)
            entries = payload["entries"]
            if not isinstance(entries, list):
                raise TypeError(f"entries is {type(entries).__name__}, "
                                "not a list")
            recorded = payload.get("backend")
        except (OSError, ValueError, KeyError, TypeError) as e:
            warnings.warn(f"tuning cache {path!r} is missing or corrupt "
                          f"({type(e).__name__}: {e}); falling back to "
                          "heuristic schedules")
            return 0
        current = self._tag(device)
        if device is not None:
            self._device = resolve_device(device)
        if recorded is not None and recorded != current:
            warnings.warn(f"tuning cache {path!r} was measured on backend "
                          f"{recorded!r} but this session runs {current!r}; "
                          "ignoring it (schedules will be re-measured)")
            return 0
        n = 0
        for e in entries:
            try:
                key = ScheduleKey(**self._dataclass_kwargs(ScheduleKey,
                                                           e["key"]))
                nest = ConvLoopNest(**self._dataclass_kwargs(ConvLoopNest,
                                                             e["nest"]))
                pd = e["plan"]
                plan = ConvBlockPlan(nf_block=int(pd["nf_block"]),
                                     c_block=int(pd["c_block"]),
                                     p_block=int(pd["p_block"]),
                                     grid=tuple(int(g) for g in pd["grid"]),
                                     vmem_bytes=int(pd["vmem_bytes"]),
                                     groups=int(pd.get("groups", 1)))
                dataflow = e["dataflow"]
                measured_ms = e.get("measured_ms")
                timings = tuple((lbl, float(ms))
                                for lbl, ms in e.get("timings", ()))
            except (KeyError, TypeError, ValueError) as err:
                warnings.warn(f"tuning cache {path!r}: skipping corrupt "
                              f"entry ({type(err).__name__}: {err})")
                continue
            costs = dataflow_costs(nest, plan, self.cfg, key.precision)
            self._entries[key] = ConvSchedule(
                key=key, nest=nest, plan=plan, dataflow=dataflow,
                costs=tuple(sorted(costs.items())), source="loaded",
                measured_ms=measured_ms, timings=timings)
            self._forget_kernels(key)
            n += 1
        return n

    def kernel_for(self, sched: ConvSchedule,
                   epilogue: Optional[Epilogue] = None) -> Callable:
        """The fold kernel for a schedule with plan, dataflow and fused
        epilogue bound, memoized per (key, dataflow, epilogue).  Called as
        ``fn(x_padded, w, bias=b)``."""
        from repro_torch.kernels.conv2d_ws import conv2d_folded
        kk = (sched.key, sched.dataflow, epilogue)
        fn = self._kernels.get(kk)
        if fn is None:
            fn = functools.partial(conv2d_folded, plan=sched.plan,
                                   dataflow=sched.dataflow,
                                   epilogue=epilogue,
                                   groups=sched.key.groups)
            self._kernels[kk] = fn
        return fn


# --------------------------------------------------------------------------
# Whole-network compilation: StreamGraph lowering
# --------------------------------------------------------------------------

def kernel_launch_counts() -> Dict[str, int]:
    """Launches so far of every kernel a compiled forward can run: the
    fold kernels (``kernels/conv2d_ws.py``) and the head
    (``kernels/dense.py``), by name."""
    from repro_torch.kernels import conv2d_ws, dense
    return {**conv2d_ws.launch_counts(), **dense.launch_counts()}


def _tensor_leaves(tree, out: List[torch.Tensor]) -> List[torch.Tensor]:
    """The tensors of a parameter tree (dicts, lists and tuples), in
    iteration order, appended to ``out``.  It runs at every jitted call,
    so the containers are matched by ``type``, which costs less than
    ``isinstance``."""
    kind = type(tree)
    if kind is dict:
        for sub in tree.values():
            _tensor_leaves(sub, out)
    elif kind is list or kind is tuple:
        for sub in tree:
            _tensor_leaves(sub, out)
    elif isinstance(tree, torch.Tensor):
        out.append(tree)
    return out


class CapturedForward:
    """The counterpart of ``jax.jit`` for a compiled forward on a CUDA
    device: the eager forward captured as one CUDA graph on its first
    call, and replayed on every later one.

    The first call runs the forward once eagerly on a side stream (kernel
    builds, the head's counters and every other lazy set-up happen there,
    outside any capture), then captures it into a ``torch.cuda.CUDAGraph``
    under ``torch.inference_mode`` with ``capture_error_mode=
    "thread_local"`` (an operation that would synchronise with the host
    raises), reading a static input buffer of the compiled shape and type
    (``dtype``: the network's parameter type, fp32 or bf16).
    The graph has a memory pool of its own, so the graphs of several
    buckets replay in any order.  Each call checks x's shape, type and
    device (``ValueError`` on a mismatch), copies x into the static input,
    replays the graph and returns a clone of the static output: the next
    replay overwrites it, and a caller may still hold this call's result
    (``VisionEngine.run`` reads batch k back after it has dispatched
    k + 1).

    Parameters are captured by address, as the kernels read them.  A call
    whose parameter tensors sit at other addresses than at the capture
    captures again, so new weights are never served by an old graph
    (``captures`` counts the captures; in-place updates of the captured
    tensors are read by the next replay).  The capture holds the tensors
    it read, so no other tensor can take their addresses while its graph
    lives.  The BN fold and the int8 quantize ops run inside the graph at
    every replay, as they run at every eager call.

    ``capture_launches`` holds the kernel launches of the last capture by
    name (``kernel_launch_counts``): the Python launch counters tick during
    the warm-up and the capture, never during a replay.  Nothing falls
    back to the eager forward: a failed capture or replay raises.

    Captures run on the calling thread, and are refused (``RuntimeError``)
    on a thread other than the one that made this object: a capture on one
    thread while another launches on the legacy default stream would be
    invalidated, so a server warms every bucket up (``VisionEngine.
    warmup``) before its worker threads serve, and a worker thread only
    replays.

    A replay records no autograd graph: under grad mode a parameter or
    input that requires grad raises (``jit=False`` trains)."""

    def __init__(self, forward: Callable, input_shape: Tuple[int, ...],
                 device: torch.device, dtype: torch.dtype = torch.float32):
        self.forward = forward
        self.input_shape = tuple(int(d) for d in input_shape)
        self.device = device
        self.dtype = dtype
        self._owner = threading.get_ident()
        self.captures = 0
        self.capture_launches: Dict[str, int] = {}
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._x: Optional[torch.Tensor] = None   # the static input
        self._y: Optional[torch.Tensor] = None   # the static output
        self._params: Tuple[torch.Tensor, ...] = ()
        self._ptrs: Tuple[int, ...] = ()

    def _check(self, x: torch.Tensor) -> None:
        dev = self._x.device if self._x is not None else self.device
        if tuple(x.shape) != self.input_shape or x.dtype != self.dtype \
                or x.device.type != "cuda" \
                or dev.index not in (None, x.device.index):
            raise ValueError(f"the captured forward takes a {self.dtype} "
                             f"input of shape {self.input_shape} on {dev}, "
                             f"got {tuple(x.shape)} {x.dtype} on {x.device}")

    def _capture(self, p: Dict[str, Any], x: torch.Tensor,
                 leaves: List[torch.Tensor], ptrs: Tuple[int, ...]) -> None:
        if threading.get_ident() != self._owner:
            raise RuntimeError(
                "a CUDA-graph capture was asked for on a thread other than "
                "the one that compiled the forward: warm every bucket up "
                "before worker threads serve (a capture racing another "
                "thread's launches is invalidated)")
        # the old graph and its pool go before the new capture
        self._graph = self._y = None
        if self._x is None:
            # a normal tensor, so calls outside inference mode can fill it
            with torch.inference_mode(False):
                self._x = torch.empty(self.input_shape, dtype=self.dtype,
                                      device=x.device)
        self._x.copy_(x)
        main = torch.cuda.current_stream(self._x.device)
        side = torch.cuda.Stream(self._x.device)
        side.wait_stream(main)
        with torch.cuda.stream(side), torch.inference_mode():
            self.forward(p, self._x)
        main.wait_stream(side)
        before = kernel_launch_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.inference_mode(), torch.cuda.graph(
                graph, capture_error_mode="thread_local"):
            y = self.forward(p, self._x)
        after = kernel_launch_counts()
        self.capture_launches = {k: after[k] - before[k] for k in after}
        self._graph, self._y = graph, y
        self._params, self._ptrs = tuple(leaves), ptrs
        self.captures += 1

    def __call__(self, p: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
        from repro_torch.kernels.build import refuse_grad
        self._check(x)
        leaves = _tensor_leaves(p, [])
        refuse_grad("a captured forward (CUDA graph replay)", x, *leaves,
                    hint=", or compile with jit=False to train: the eager "
                    "forward's ops are differentiable")
        ptrs = tuple(t.data_ptr() for t in leaves)
        if self._graph is None or ptrs != self._ptrs:
            self._capture(p, x, leaves, ptrs)
        self._x.copy_(x)
        self._graph.replay()
        return self._y.clone()


# --------------------------------------------------------------------------
# static verification hooks (repro_torch.analysis), memoized per geometry
# --------------------------------------------------------------------------

# schedules already proven this process: keyed on everything the checks
# read (the JAX package's key, plus the SM count the CTA tile is chosen
# for), so the verify=True default costs one lookup per layer after the
# first compile of a geometry.  Imports are lazy to keep the engine's
# import graph acyclic.
_VERIFIED_SCHEDULES: Dict[Tuple, bool] = {}


def _verify_graph(original, fused_graph, fused: bool) -> None:
    """Structural lint (+ fusion-legality diff when the fusion pass ran).
    Shape errors stay the walk's own ``GraphError``s — the lint here is
    params-free so it can never preempt them."""
    from repro_torch.analysis.graph_check import check_fusion, lint_graph
    from repro_torch.analysis.report import FoldLintError
    errors = lint_graph(fused_graph).errors
    if fused:
        errors = errors + check_fusion(original, fused_graph).errors
    if errors:
        raise FoldLintError(errors)


def _verify_schedule(name: str, cv: ConvLoopNest, sched: "ConvSchedule",
                     epi, groups: int, sm_count: Optional[int],
                     dtype: torch.dtype = torch.float32) -> None:
    """Prove one conv layer's schedule before its kernel is bound: the
    clamped block plan's invariants (including, for int8 schedules, the
    int32-accumulator overflow bound), the launch's index-map coverage and
    race analysis (``FoldKernelSpec``) and, with ``sm_count`` (a CUDA
    device), the CTA tile the kernel will run on ``dtype`` operands (the
    tensor-core tiles for bf16) and its shared memory.
    ``epi`` is the epilogue the kernel actually flushes — the requant form
    for int8 schedules."""
    plan = sched.plan.clamped(cv.nf, cv.c, cv.p)
    key = (sched.key, sched.dataflow, plan, epi, cv.n,
           cv.padded_x, cv.padded_y, sm_count, dtype)
    if key in _VERIFIED_SCHEDULES:
        return
    from repro_torch.analysis.index_check import (check_kernel_spec,
                                                  check_launch_tile)
    from repro_torch.analysis.plan_check import check_plan
    from repro_torch.analysis.report import FoldLintError
    from repro_torch.kernels.conv2d_ws import fold_kernel_spec
    rep = check_plan(cv, plan, where=name, precision=sched.key.precision)
    if rep.ok:
        spec = fold_kernel_spec(
            (cv.n, cv.c, cv.padded_x, cv.padded_y),
            (cv.nf, cv.c // groups, cv.r, cv.s),
            stride=cv.stride, plan=plan, dataflow=sched.dataflow,
            epilogue=epi, groups=groups)
        rep.extend(check_kernel_spec(spec, where=name))
        if rep.ok and sm_count is not None:
            rep.extend(check_launch_tile(spec, cv.n, sm_count, where=name,
                                         dtype=dtype))
    if not rep.ok:
        raise FoldLintError(rep.errors)
    _VERIFIED_SCHEDULES[key] = True


@dataclasses.dataclass
class CompiledNetwork:
    """A whole-network static fold schedule plus its forward.

    ``apply`` is the forward a call runs: with ``jit`` on a CUDA device a
    ``CapturedForward`` of ``eager``, otherwise ``eager`` itself.
    ``layer_schedules`` and ``build_stats`` are snapshots taken at compile
    time; ``layer_nests`` holds each conv's own loop nest (its batch and
    spatial extent, which a reused schedule's ``nest`` does not carry).
    """
    apply: Callable[[Dict[str, Any], torch.Tensor], torch.Tensor]
    layer_schedules: Tuple[Tuple[str, ConvSchedule], ...]
    build_stats: CacheStats
    cache: ScheduleCache
    mode: str                # "kernel" | "reference"
    device: torch.device
    fused: bool = False
    graph: Optional[StreamGraph] = None
    layer_nests: Tuple[Tuple[str, ConvLoopNest], ...] = ()
    precision: str = "fp32"  # streamed conv dtype ("fp32" | "int8")
    quant: Optional[Any] = None  # the QuantRecipe the int8 lowering baked in
    jit: bool = False            # whether apply is a CapturedForward
    eager: Optional[Callable] = None  # the eager forward (apply unless jit)
    verify_s: float = 0.0        # host seconds this compile spent verifying
    autotuned: bool = False      # schedules are measured winners
    dtype: torch.dtype = torch.float32  # the input's (the parameters') type

    def __call__(self, params: Dict[str, Any], x: torch.Tensor
                 ) -> torch.Tensor:
        return self.apply(params, x)

    @property
    def captures(self) -> int:
        """CUDA-graph captures of a jitted forward so far (0 unless
        ``jit``)."""
        return self.apply.captures if self.jit else 0

    @property
    def layer_keys(self) -> Tuple[Tuple[str, ScheduleKey], ...]:
        return tuple((name, s.key) for name, s in self.layer_schedules)

    @property
    def distinct_schedules(self) -> int:
        return len({s.key for _, s in self.layer_schedules})

    def fold_reuse(self) -> dict:
        """The paper's fold-reuse metric for this network's build."""
        d = self.build_stats.as_dict()
        d.update(conv_layers=len(self.layer_schedules),
                 distinct_schedules=self.distinct_schedules)
        return d

    def describe(self) -> str:
        lines = [f"CompiledNetwork(mode={self.mode}, device={self.device}, "
                 f"fused={self.fused}, autotuned={self.autotuned}, "
                 f"precision={self.precision}, "
                 f"layers={len(self.layer_schedules)}, "
                 f"schedules={self.distinct_schedules})"]
        for name, sched in self.layer_schedules:
            ms = (f" {sched.measured_ms:.2f}ms"
                  if sched.measured_ms is not None else "")
            lines.append(f"  {name:<10} {str(sched.key):<24} "
                         f"{sched.dataflow:<18} grid={sched.plan.grid}"
                         f" [{sched.source}]{ms}")
        return "\n".join(lines)


def _split_impl(name: str, cv: ConvLoopNest, sched: ConvSchedule, epi,
                groups: int, size: int
                ) -> Tuple[str, ConvLoopNest, ConvSchedule]:
    """What a conv split N_F-wise over ``size`` model ranks runs on its
    slice: the impl, the slice's loop nest and its schedule.  The impl
    names the dataflow the whole layer's kernel resolves to
    (``fold_kernel_spec``'s WS -> OS / psum fallback included), so the
    slice streams its folds as the whole layer would; a slice that would
    resolve otherwise raises.  The schedule is the layer's, except that a
    grouped conv's slice (fewer groups) takes the plan solved for its own
    group count, which is the one its kernel would solve."""
    from repro_torch.kernels.conv2d_ws import fold_kernel_spec
    local = dataclasses.replace(
        cv, nf=cv.nf // size,
        c=cv.c // size if groups > 1 else cv.c,
        groups=groups // size if groups > 1 else 1)
    if local.groups != sched.plan.groups:
        sched = dataclasses.replace(sched, plan=plan_conv_blocks(local))

    def resolved(nest, dataflow):
        return fold_kernel_spec(
            (nest.n, nest.c, nest.padded_x, nest.padded_y),
            (nest.nf, nest.c // nest.groups, nest.r, nest.s),
            stride=nest.stride, plan=sched.plan, dataflow=dataflow,
            epilogue=epi, groups=nest.groups).dataflow
    whole = resolved(dataclasses.replace(cv, groups=groups), sched.dataflow)
    part = resolved(local, whole)
    if part != whole:
        raise GraphError(f"{name}: the filter slice resolves to {part}, "
                         f"the whole layer to {whole}")
    return _IMPL_OF_DATAFLOW[whole], local, sched


def _input_dtype(params: Dict[str, Any], graph) -> torch.dtype:
    """The type a network's input is fed in: its first conv's weights'
    (fp32 or bf16, as ``init_params(dtype=)`` made them).  The JAX package
    computes each conv in x's type, so a bf16 network is one whose input
    is bf16."""
    first = next((nd for nd in graph.nodes if nd.op == "conv"), None)
    if first is None:
        return torch.float32
    dt = params[first.param]["w"].dtype
    return dt if dt in (torch.float32, torch.bfloat16) else torch.float32


def compile_network(params: Dict[str, Any], graph,
                    input_shape: Tuple[int, int, int, int], *,
                    policy: str = "auto",
                    cache: Optional[ScheduleCache] = None,
                    head: Optional[Callable] = None,
                    jit: bool = True,
                    fuse_epilogues: bool = True,
                    autotune: bool = False,
                    tuning_path: Optional[str] = None,
                    autotune_reps: int = 3,
                    autotune_timer: Optional[Callable] = None,
                    verify: bool = True,
                    tracer=None,
                    device: Any = "cuda", precision: str = "fp32",
                    quant=None, shard=None) -> CompiledNetwork:
    """Lower a streaming graph into a static fold schedule + forward.

    ``graph`` is a ``StreamGraph`` (or a legacy conv-spec sequence).  Conv
    and dense weights live at ``params[node.param]["w"]`` (OIHW / (in,
    out)) with biases at ``["b"]``; ``input_shape`` is NCHW.  All schedules
    are built here through the shared ``ScheduleCache``; the forward never
    plans.

    In kernel mode with ``fuse_epilogues`` the graph first runs through
    ``fuse_graph``, so each conv's bias / batch-norm / residual-add /
    ReLU[6] / 2x2-pool chain flushes inside the conv's kernel — one launch
    per conv block; batch-norm statistics fold to the epilogue's
    scale/shift (``bn_scale_shift``) at every call.  Reference mode runs
    the plain-torch conv and standalone ops.  Dense layers run the head
    kernel (``kernels/dense.py``) in both modes, as the JAX package runs
    one dense op in both: its rows do not depend on the batch.  A fused
    pool on an output too small to pool (P or Q < 2) is demoted to a
    standalone op.  The forward
    runs on ``device`` (default "cuda"; "cpu" runs the plain-torch fold
    loop in kernel mode).

    ``jit`` (default True, as in the JAX package): on a CUDA device the
    forward is captured as one CUDA graph on its first call and replayed
    on every later one (``CapturedForward``: the input must have
    ``input_shape``; new parameter tensors capture again).  On the CPU
    there is no graph to capture and ``jit`` runs the eager forward.
    ``jit=False`` runs the eager forward, one Python dispatch per op.

    ``verify=True`` (the default, as in the JAX package) statically
    verifies the lowering with ``repro_torch.analysis`` before any kernel
    is bound: the graph is linted (and, when the fusion pass ran, diffed
    against an independent re-derivation of the fusion rules), and every
    kernel-mode conv schedule's block plan and launch index maps are
    proven in-bounds / race-free / exactly-covering, with, on a CUDA
    device, the CTA tile its kernel will run (coverage, no filter tile
    across a group, shared memory).  Error-severity findings raise
    ``FoldLintError``.  Verification is memoized per schedule geometry
    (``_VERIFIED_SCHEDULES``), so a recompile of a known geometry costs
    one dict lookup per layer; ``verify_s`` on the result is the time
    this compile spent on it.

    ``autotune=True`` replaces the analytical dataflow ranking with
    measured timings (``ScheduleCache.autotune_for``: every candidate
    proven, then timed on ``device`` with the layer's deployment
    epilogue), pay-once per ``ScheduleKey``; with ``tuning_path`` the
    winners round-trip through JSON (loaded before the walk when the file
    exists, saved after it), so a later session measures nothing.
    ``autotune_reps`` is each candidate's timed repetitions (median);
    ``autotune_timer(plan, dataflow)`` replaces the measurement (tests).
    Tuning runs here, before any forward is captured: no timing runs in a
    capture.  ``tracer`` (``obs/trace.py``, duck-typed) records one
    ``plan:<layer>`` span per conv and a ``compile_network`` span on the
    compile track.

    ``shard`` (``distributed/sharding.FilterShard``) splits the convs it
    names N_F-wise over a mesh's model axis: their entries in ``params``
    hold this rank's slice of the filters (and of the bias).  Each such
    conv is planned and verified at its whole geometry, as without a mesh,
    and its slice's geometry is verified too; the forward runs the fold
    kernel on the slice, with the batch-norm scale / shift and the
    residual sliced alike, on the dataflow the whole layer resolves to
    (``_split_impl``), and gathers the output channels over the model
    axis before the next layer.  A grouped conv splits by whole groups,
    its input channels with them.  The gathers are collectives between
    kernels, so a split network is not captured (``jit`` runs eager).

    ``precision="int8"`` lowers every conv through ``conv2d_int8``: int8
    weight and activation blocks, int32 sums, dequant folded into the
    epilogue's scale/shift slot.  ``quant`` is the calibrated
    ``QuantRecipe``; without one, ``default_recipe`` runs the fp32
    reference forward of the pre-fusion graph once to record each conv's
    activation scale.  Schedules live under int8 ``ScheduleKey``s, priced
    with one-byte streams.
    """
    from repro_torch.core.quant import (check_precision, default_recipe,
                                        requant_epilogue)
    check_precision(precision)
    cache = cache if cache is not None else ScheduleCache()
    # spans carry explicit timestamps (add_span), so a GraphError that
    # aborts the walk leaves no open span; tid 3 is the compile track
    tc0 = float(tracer.clock()) if tracer is not None else 0.0
    mode, dev = resolve_execution(policy, device)
    stats_before = dataclasses.replace(cache.stats)
    if autotune and tuning_path and os.path.exists(tuning_path):
        cache.load_tuning(tuning_path, device=dev)
    fused = fuse_epilogues and mode == "kernel"
    base_graph = as_graph(graph)
    g = fuse_graph(base_graph) if fused else base_graph
    verify_s = 0.0
    sm_count = None
    in_dtype = _input_dtype(params, base_graph)
    if verify:
        t0 = time.perf_counter()
        _verify_graph(base_graph, g, fused)
        verify_s += time.perf_counter() - t0
        if mode == "kernel" and dev.type == "cuda":
            from repro_torch.kernels.conv2d_ws import _sm_count
            sm_count = _sm_count(dev)
    if precision == "int8" and quant is None:
        # self-contained calibration on the pre-fusion graph (fusion keeps
        # the conv names, so the recipe's keys match the fused lowering)
        quant = default_recipe(base_graph, params, input_shape, device=dev)

    shapes: Dict[str, Tuple[int, ...]] = {g.input: tuple(input_shape)}
    layer_schedules: List[Tuple[str, ConvSchedule]] = []
    layer_nests: List[Tuple[str, ConvLoopNest]] = []
    steps: List[Tuple] = []   # (op, out, in_names, static payload)

    for nd in g.nodes:
        s_in = shapes[nd.inputs[0]]
        if nd.op == "conv":
            if len(s_in) != 4:
                raise GraphError(f"{nd.name}: conv expects an NCHW tensor, "
                                 f"got shape {s_in}")
            n_, chan, h, w_ = s_in
            nf, cin, r, s = (int(d) for d in params[nd.param]["w"].shape)
            groups = chan if nd.groups == DEPTHWISE else nd.groups
            split = shard is not None and shard.sharded(nd.param)
            if split:
                nf *= shard.size      # the slice's whole layer
                if groups > 1 and groups % shard.size:
                    raise GraphError(
                        f"{nd.name}: {groups} groups do not split over "
                        f"{shard.size} model ranks")
            if cin * groups != chan:
                raise GraphError(
                    f"{nd.name}: weights expect {cin}x{groups} input "
                    f"channels, trunk carries {chan}")
            if nf % groups:
                raise GraphError(
                    f"{nd.name}: groups={groups} must divide the filter "
                    f"count {nf}")
            cv = ConvLoopNest(n=n_, nf=nf, c=chan, r=r, s=s, x=h, y=w_,
                              stride=nd.stride, pad=nd.pad, groups=groups)
            epi, demoted_pool = nd.epilogue, False
            if epi is not None and epi.pool and (cv.p < 2 or cv.q < 2):
                epi = dataclasses.replace(epi, pool=None)
                demoted_pool = True
            if epi is not None and epi.residual:
                if nd.residual is None:
                    raise GraphError(
                        f"{nd.name}: Epilogue(residual=True) needs the "
                        "node's residual skip-edge input set")
                want = (n_, nf, cv.p, cv.q)
                got = shapes[nd.residual]
                if tuple(got) != want:
                    raise GraphError(
                        f"{nd.name}: fused shortcut {nd.residual!r} has "
                        f"shape {got}, conv output is {want}")
            tp0 = float(tracer.clock()) if tracer is not None else 0.0
            if autotune:
                # timed on the compile's device with the deployment
                # epilogue, so the timed kernel is the executed one
                sched = cache.autotune_for(
                    cv, reps=autotune_reps, device=dev, epilogue=epi,
                    timer=autotune_timer, precision=precision)
            else:
                sched = cache.schedule_for(cv, precision=precision)
            if tracer is not None:
                tracer.add_span(f"plan:{nd.name}", "compile", 3, tp0,
                                float(tracer.clock()) - tp0,
                                schedule=str(sched.key),
                                dataflow=sched.dataflow,
                                source=sched.source)
            x_scale = (quant.scale_for(nd.name) if precision == "int8"
                       else None)
            if verify and mode == "kernel":
                # verify the epilogue the kernel actually flushes — the
                # requant affine always occupies the scale slot in int8
                t0 = time.perf_counter()
                _verify_schedule(nd.name, cv, sched,
                                 requant_epilogue(epi) if x_scale is not None
                                 else epi, groups, sm_count,
                                 torch.int8 if x_scale is not None
                                 else in_dtype)
                verify_s += time.perf_counter() - t0
            split_impl = split_plan = None
            if split and mode == "kernel":
                kernel_epi = (requant_epilogue(epi) if x_scale is not None
                              else epi)
                split_impl, cv_local, sched_local = _split_impl(
                    nd.name, cv, sched, kernel_epi, groups, shard.size)
                split_plan = sched_local.plan
                if verify:
                    t0 = time.perf_counter()
                    _verify_schedule(nd.name, cv_local, sched_local,
                                     kernel_epi,
                                     cv_local.groups, sm_count,
                                     torch.int8 if x_scale is not None
                                     else in_dtype)
                    verify_s += time.perf_counter() - t0
            layer_schedules.append((nd.name, sched))
            layer_nests.append((nd.name, cv))
            shapes[nd.name] = (n_, nf) + epilogue_out_hw(nd.epilogue, cv.p,
                                                         cv.q)
            steps.append(("conv", nd.name, nd.all_inputs(),
                          (sched, epi, nd.stride, nd.pad, nd.param,
                           demoted_pool, groups, nd.bn_param, x_scale,
                           split, split_impl, split_plan)))
        elif nd.op in ("bias", "batchnorm", "relu", "relu6"):
            shapes[nd.name] = s_in
            steps.append((nd.op, nd.name, nd.inputs, nd.param))
        elif nd.op == "global_avgpool":
            shapes[nd.name] = (s_in[0], s_in[1], 1, 1)
            steps.append(("global_avgpool", nd.name, nd.inputs, None))
        elif nd.op == "residual_add":
            a, b = (shapes[i] for i in nd.inputs)
            if tuple(a) != tuple(b):
                raise GraphError(f"{nd.name}: residual_add operands differ "
                                 f"in shape: {a} vs {b}")
            shapes[nd.name] = a
            steps.append(("residual_add", nd.name, nd.inputs, None))
        elif nd.op == "maxpool2":
            n_, chan, h, w_ = s_in
            shapes[nd.name] = (n_, chan, h // 2, w_ // 2)
            steps.append(("maxpool2", nd.name, nd.inputs, None))
        elif nd.op == "flatten":
            shapes[nd.name] = (s_in[0], int(math.prod(s_in[1:])))
            steps.append(("flatten", nd.name, nd.inputs, None))
        elif nd.op == "dense":
            din, dout = (int(d) for d in params[nd.param]["w"].shape)
            if len(s_in) != 2 or s_in[1] != din:
                raise GraphError(f"{nd.name}: dense expects (N, {din}), "
                                 f"got {s_in}")
            shapes[nd.name] = (s_in[0], dout)
            steps.append(("dense", nd.name, nd.inputs, nd.param))
        else:  # pragma: no cover — construction validates ops
            raise GraphError(f"{nd.name}: cannot lower op {nd.op!r}")

    steps_t = tuple(steps)
    out_name = g.output

    def forward(p: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
        from repro_torch.kernels.dense import dense
        from repro_torch.kernels.ops import conv2d, conv2d_fused, conv2d_int8
        if x.device.type != dev.type:
            raise ValueError(f"network compiled for {dev}, input is on "
                             f"{x.device}")
        env: Dict[str, torch.Tensor] = {g.input: x}
        for op, out, ins, info in steps_t:
            if op == "conv":
                (sched, epi, stride, pad, pname, demoted_pool, groups,
                 bn_param, x_scale, split, split_impl, split_plan) = info
                xin, w = env[ins[0]], p[pname]["w"]
                impl = "direct" if mode == "reference" else (
                    split_impl or sched.impl())
                plan = split_plan or sched.plan
                # a split conv: this rank's filters, and per-channel
                # operands sliced alike (``chans``); a grouped one reads
                # its own groups' input channels
                chans = shard.channels(w.shape[0]) if split else slice(None)
                if split and groups > 1:
                    cs = xin.shape[1] // shard.size
                    xin = xin[:, shard.index * cs:
                              (shard.index + 1) * cs].contiguous()
                    groups //= shard.size
                if x_scale is not None:
                    # the int8 stream: weights quantize per channel here,
                    # activations with the calibrated scale; bias, BN and
                    # dequant fold into one flush affine
                    b = p[pname]["b"] if epi is not None and epi.bias \
                        else None
                    scale = shift = None
                    if epi is not None and epi.scale:
                        scale, shift = (v[chans] for v in
                                        bn_scale_shift(p[bn_param]))
                    res = env[ins[1]][:, chans] \
                        if epi is not None and epi.residual else None
                    y = conv2d_int8(xin, w, b, x_scale=x_scale,
                                    stride=stride, pad=pad, epilogue=epi,
                                    impl=impl, plan=plan,
                                    residual=res, scale=scale, shift=shift,
                                    groups=groups)
                elif epi is not None:
                    # an epilogue on a conv node is graph semantics and is
                    # honored in every mode
                    b = p[pname]["b"] if epi.bias else None
                    scale = shift = None
                    if epi.scale:
                        scale, shift = (v[chans] for v in
                                        bn_scale_shift(p[bn_param]))
                    res = env[ins[1]][:, chans] if epi.residual else None
                    y = conv2d_fused(xin, w, b, stride=stride, pad=pad,
                                     epilogue=epi, impl=impl,
                                     plan=plan, residual=res,
                                     scale=scale, shift=shift,
                                     groups=groups)
                else:
                    y = conv2d(xin, w, stride=stride, pad=pad, impl=impl,
                               plan=plan, groups=groups)
                y = maxpool2x2(y) if demoted_pool else y
                env[out] = shard.gather(y) if split else y
            elif op == "bias":
                b = p[info]["b"]
                if shard is not None and shard.sharded(info):
                    b = shard.gather(b, dim=0)
                env[out] = env[ins[0]] + b[None, :, None, None]
            elif op == "batchnorm":
                scale, shift = bn_scale_shift(p[info])
                env[out] = (env[ins[0]] * scale[None, :, None, None]
                            + shift[None, :, None, None])
            elif op == "relu":
                env[out] = torch.relu(env[ins[0]])
            elif op == "relu6":
                env[out] = torch.clamp(env[ins[0]], 0.0, 6.0)
            elif op == "global_avgpool":
                env[out] = env[ins[0]].mean(dim=(2, 3), keepdim=True)
            elif op == "residual_add":
                env[out] = env[ins[0]] + env[ins[1]]
            elif op == "maxpool2":
                env[out] = maxpool2x2(env[ins[0]])
            elif op == "flatten":
                v = env[ins[0]]
                env[out] = v.reshape(v.shape[0], -1)
            else:
                # dense: x @ w + b, as in JAX, in every mode, through the
                # head kernel: one sum order per row whatever the batch, so
                # served logits equal a direct forward bitwise
                env[out] = dense(env[ins[0]], p[info]["w"], p[info]["b"])
        y = env[out_name]
        return head(p, y) if head is not None else y

    if autotune and tuning_path:
        cache.save_tuning(tuning_path, device=dev)
    build_stats = CacheStats(
        hits=cache.stats.hits - stats_before.hits,
        misses=cache.stats.misses - stats_before.misses,
        replans=cache.stats.replans - stats_before.replans)
    captured = jit and dev.type == "cuda" and (shard is None
                                               or shard.size == 1)
    apply = CapturedForward(forward, input_shape, dev, in_dtype) \
        if captured else forward
    if tracer is not None:
        tracer.add_span("compile_network", "compile", 3, tc0,
                        float(tracer.clock()) - tc0, mode=mode,
                        batch=int(input_shape[0]),
                        conv_layers=len(layer_schedules),
                        distinct_schedules=len(
                            {s.key for _, s in layer_schedules}))
    return CompiledNetwork(apply=apply,
                           layer_schedules=tuple(layer_schedules),
                           build_stats=build_stats, cache=cache, mode=mode,
                           device=dev, fused=fused, graph=g,
                           layer_nests=tuple(layer_nests),
                           precision=precision, quant=quant, jit=captured,
                           eager=forward, verify_s=verify_s,
                           autotuned=autotune, dtype=in_dtype)


# --------------------------------------------------------------------------
# Per-bucket compiled-forward cache (the serving engine's compile surface)
# --------------------------------------------------------------------------

class BucketCompiler:
    """Memoized ``compile_network`` per batch width over one shared
    ``ScheduleCache``.  ``ScheduleKey`` excludes the batch, so the first
    bucket's compile plans every schedule and every later bucket compiles
    with 100% schedule-cache hits.

    ``precision="int8"``: one ``QuantRecipe`` is calibrated here, once (or
    taken from ``quant``), and handed to every bucket, so every bucket
    width bakes in the same activation scales: a request's logits cannot
    depend on the bucket its batch was padded to.

    ``jit`` goes to every bucket's compile: on a CUDA device each bucket's
    forward is one CUDA graph, with a memory pool of its own.  So does
    ``verify``: a bucket's geometries are proven once (the memo makes the
    later buckets' proofs of shared schedules one lookup a layer).  So do
    ``autotune`` and its options: the first bucket's compile measures every
    schedule, every later bucket hits the shared cache (tuning is pay-once
    across buckets), and ``tuning_path`` is one JSON shared by all.  So
    does ``shard`` (a mesh's filter split, ``compile_network``)."""

    def __init__(self, params: Dict[str, Any], graph, img: int, *,
                 chan: int = 3, policy: str = "auto",
                 cache: Optional[ScheduleCache] = None,
                 head: Optional[Callable] = None, jit: bool = True,
                 fuse_epilogues: bool = True, autotune: bool = False,
                 tuning_path: Optional[str] = None,
                 autotune_reps: int = 3,
                 autotune_timer: Optional[Callable] = None,
                 verify: bool = True, tracer=None,
                 device: Any = "cuda",
                 precision: str = "fp32", quant=None, shard=None):
        from repro_torch.core.quant import check_precision, default_recipe
        check_precision(precision)
        self.params = params
        self.graph = as_graph(graph)
        self.img = int(img)
        self.chan = int(chan)
        self.policy = policy
        self.cache = cache if cache is not None else ScheduleCache()
        self.head = head
        self.jit = jit
        self.fuse_epilogues = fuse_epilogues
        self.autotune = autotune
        self.tuning_path = tuning_path
        self.autotune_reps = autotune_reps
        self.autotune_timer = autotune_timer
        self.verify = verify
        self.tracer = tracer          # duck-typed obs tracer (or None)
        self.device = device
        self.precision = precision
        self.shard = shard
        if precision == "int8" and quant is None:
            _, dev = resolve_execution(policy, device)
            quant = default_recipe(self.graph, params,
                                   (1, self.chan, self.img, self.img),
                                   device=dev)
        self.quant = quant
        self._nets: Dict[int, CompiledNetwork] = {}

    @property
    def buckets(self) -> List[int]:
        """Bucket widths compiled so far, ascending."""
        return sorted(self._nets)

    def __contains__(self, batch: int) -> bool:
        return int(batch) in self._nets

    def network_for(self, batch: int) -> CompiledNetwork:
        """The compiled forward for one bucket width (compiled on first
        use; schedules come from the shared cache)."""
        batch = int(batch)
        if batch < 1:
            raise ValueError(f"bucket width must be >= 1, got {batch}")
        net = self._nets.get(batch)
        if net is None:
            net = compile_network(
                self.params, self.graph,
                (batch, self.chan, self.img, self.img),
                policy=self.policy, cache=self.cache, head=self.head,
                jit=self.jit, fuse_epilogues=self.fuse_epilogues,
                autotune=self.autotune, tuning_path=self.tuning_path,
                autotune_reps=self.autotune_reps,
                autotune_timer=self.autotune_timer, verify=self.verify,
                tracer=self.tracer, device=self.device,
                precision=self.precision, quant=self.quant,
                shard=self.shard)
            self._nets[batch] = net
        return net

    def stats(self) -> dict:
        """Buckets built + the shared schedule cache's fold-reuse
        counters."""
        d = {"buckets": self.buckets,
             "distinct_schedules": self.cache.distinct}
        d.update(self.cache.stats.as_dict())
        return d
