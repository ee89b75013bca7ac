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
  fold-reuse metric.
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
import math
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.core.epilogue import Epilogue, epilogue_out_hw, maxpool2x2
from repro_torch.core.graph import (DEPTHWISE, GraphError, StreamGraph,
                                    as_graph, bn_scale_shift, fuse_graph)
from repro_torch.core.loopnest import ConvLoopNest
from repro_torch.core.mapping import (WS_ACC_BYTES_LIMIT, ConvBlockPlan,
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


@dataclasses.dataclass(frozen=True)
class ConvSchedule:
    """One compiled fold schedule: block plan + selected dataflow.  ``nest``
    is the loop nest the plan was solved against; ``costs`` are the
    estimated cycles per dataflow that drove the selection."""
    key: ScheduleKey
    nest: ConvLoopNest
    plan: ConvBlockPlan
    dataflow: str
    costs: Tuple[Tuple[str, float], ...]

    def impl(self) -> str:
        """The ``kernels.ops.conv2d`` impl string for this dataflow."""
        if self.dataflow == "depthwise":
            return "fold_dw"
        return ("fold_ws" if self.dataflow == "weight_stationary"
                else "fold_os")


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


def plan_and_dataflow(cv: ConvLoopNest, cfg: Optional[MavecConfig] = None
                      ) -> Tuple[ConvBlockPlan, str]:
    """Uncached one-shot planning (the ``impl="fold_auto"`` path)."""
    plan = plan_conv_blocks(cv)
    return plan, select_dataflow(cv, plan, cfg)


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

    @property
    def distinct(self) -> int:
        return len(self._entries)

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
                self._kernels = {k: v for k, v in self._kernels.items()
                                 if k[0] != key}
                return self._entries[key]
            self.stats.hits += 1
            return hit
        self.stats.misses += 1
        sched = self._build(cv, key)
        self._entries[key] = sched
        return sched

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
    raises), reading a static float32 input buffer of the compiled shape.
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
    back to the eager forward: a failed capture or replay raises."""

    def __init__(self, forward: Callable, input_shape: Tuple[int, ...],
                 device: torch.device):
        self.forward = forward
        self.input_shape = tuple(int(d) for d in input_shape)
        self.device = device
        self.captures = 0
        self.capture_launches: Dict[str, int] = {}
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._x: Optional[torch.Tensor] = None   # the static input
        self._y: Optional[torch.Tensor] = None   # the static output
        self._params: Tuple[torch.Tensor, ...] = ()
        self._ptrs: Tuple[int, ...] = ()

    def _check(self, x: torch.Tensor) -> None:
        dev = self._x.device if self._x is not None else self.device
        if tuple(x.shape) != self.input_shape or x.dtype != torch.float32 \
                or x.device.type != "cuda" \
                or dev.index not in (None, x.device.index):
            raise ValueError(f"the captured forward takes a float32 input "
                             f"of shape {self.input_shape} on {dev}, got "
                             f"{tuple(x.shape)} {x.dtype} on {x.device}")

    def _capture(self, p: Dict[str, Any], x: torch.Tensor,
                 leaves: List[torch.Tensor], ptrs: Tuple[int, ...]) -> None:
        # the old graph and its pool go before the new capture
        self._graph = self._y = None
        if self._x is None:
            # a normal tensor, so calls outside inference mode can fill it
            with torch.inference_mode(False):
                self._x = torch.empty(self.input_shape, dtype=torch.float32,
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
        self._check(x)
        leaves = _tensor_leaves(p, [])
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
                     epi, groups: int, sm_count: Optional[int]) -> None:
    """Prove one conv layer's schedule before its kernel is bound: the
    clamped block plan's invariants (including, for int8 schedules, the
    int32-accumulator overflow bound), the launch's index-map coverage and
    race analysis (``FoldKernelSpec``) and, with ``sm_count`` (a CUDA
    device), the CTA tile the kernel will run and its shared memory.
    ``epi`` is the epilogue the kernel actually flushes — the requant form
    for int8 schedules."""
    plan = sched.plan.clamped(cv.nf, cv.c, cv.p)
    key = (sched.key, sched.dataflow, plan, epi, cv.n,
           cv.padded_x, cv.padded_y, sm_count)
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
            rep.extend(check_launch_tile(spec, cv.n, sm_count, where=name))
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

    def __call__(self, params: Dict[str, Any], x: torch.Tensor
                 ) -> torch.Tensor:
        return self.apply(params, x)

    @property
    def captures(self) -> int:
        """CUDA-graph captures of a jitted forward so far (0 unless
        ``jit``)."""
        return self.apply.captures if self.jit else 0

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
                 f"fused={self.fused}, precision={self.precision}, "
                 f"layers={len(self.layer_schedules)}, "
                 f"schedules={self.distinct_schedules})"]
        for name, sched in self.layer_schedules:
            lines.append(f"  {name:<10} {str(sched.key):<24} "
                         f"{sched.dataflow:<18} grid={sched.plan.grid}")
        return "\n".join(lines)


def compile_network(params: Dict[str, Any], graph,
                    input_shape: Tuple[int, int, int, int], *,
                    policy: str = "auto",
                    cache: Optional[ScheduleCache] = None,
                    head: Optional[Callable] = None,
                    jit: bool = True,
                    fuse_epilogues: bool = True,
                    verify: bool = True,
                    device: Any = "cuda", precision: str = "fp32",
                    quant=None) -> CompiledNetwork:
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
    mode, dev = resolve_execution(policy, device)
    stats_before = dataclasses.replace(cache.stats)
    fused = fuse_epilogues and mode == "kernel"
    base_graph = as_graph(graph)
    g = fuse_graph(base_graph) if fused else base_graph
    verify_s = 0.0
    sm_count = None
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
            sched = cache.schedule_for(cv, precision=precision)
            x_scale = (quant.scale_for(nd.name) if precision == "int8"
                       else None)
            if verify and mode == "kernel":
                # verify the epilogue the kernel actually flushes — the
                # requant affine always occupies the scale slot in int8
                t0 = time.perf_counter()
                _verify_schedule(nd.name, cv, sched,
                                 requant_epilogue(epi) if x_scale is not None
                                 else epi, groups, sm_count)
                verify_s += time.perf_counter() - t0
            layer_schedules.append((nd.name, sched))
            layer_nests.append((nd.name, cv))
            shapes[nd.name] = (n_, nf) + epilogue_out_hw(nd.epilogue, cv.p,
                                                         cv.q)
            steps.append(("conv", nd.name, nd.all_inputs(),
                          (sched, epi, nd.stride, nd.pad, nd.param,
                           demoted_pool, groups, nd.bn_param, x_scale)))
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
                 bn_param, x_scale) = info
                xin, w = env[ins[0]], p[pname]["w"]
                impl = "direct" if mode == "reference" else sched.impl()
                if x_scale is not None:
                    # the int8 stream: weights quantize per channel here,
                    # activations with the calibrated scale; bias, BN and
                    # dequant fold into one flush affine
                    b = p[pname]["b"] if epi is not None and epi.bias \
                        else None
                    scale = shift = None
                    if epi is not None and epi.scale:
                        scale, shift = bn_scale_shift(p[bn_param])
                    res = env[ins[1]] if epi is not None and epi.residual \
                        else None
                    y = conv2d_int8(xin, w, b, x_scale=x_scale,
                                    stride=stride, pad=pad, epilogue=epi,
                                    impl=impl, plan=sched.plan,
                                    residual=res, scale=scale, shift=shift,
                                    groups=groups)
                elif epi is not None:
                    # an epilogue on a conv node is graph semantics and is
                    # honored in every mode
                    b = p[pname]["b"] if epi.bias else None
                    scale = shift = None
                    if epi.scale:
                        scale, shift = bn_scale_shift(p[bn_param])
                    res = env[ins[1]] if epi.residual else None
                    y = conv2d_fused(xin, w, b, stride=stride, pad=pad,
                                     epilogue=epi, impl=impl,
                                     plan=sched.plan, residual=res,
                                     scale=scale, shift=shift,
                                     groups=groups)
                else:
                    y = conv2d(xin, w, stride=stride, pad=pad, impl=impl,
                               plan=sched.plan, groups=groups)
                env[out] = maxpool2x2(y) if demoted_pool else y
            elif op == "bias":
                env[out] = env[ins[0]] + p[info]["b"][None, :, None, None]
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

    build_stats = CacheStats(
        hits=cache.stats.hits - stats_before.hits,
        misses=cache.stats.misses - stats_before.misses,
        replans=cache.stats.replans - stats_before.replans)
    captured = jit and dev.type == "cuda"
    apply = CapturedForward(forward, input_shape, dev) if captured \
        else forward
    return CompiledNetwork(apply=apply,
                           layer_schedules=tuple(layer_schedules),
                           build_stats=build_stats, cache=cache, mode=mode,
                           device=dev, fused=fused, graph=g,
                           layer_nests=tuple(layer_nests),
                           precision=precision, quant=quant, jit=captured,
                           eager=forward, verify_s=verify_s)


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
    later buckets' proofs of shared schedules one lookup a layer)."""

    def __init__(self, params: Dict[str, Any], graph, img: int, *,
                 chan: int = 3, policy: str = "auto",
                 cache: Optional[ScheduleCache] = None,
                 head: Optional[Callable] = None, jit: bool = True,
                 fuse_epilogues: bool = True, verify: bool = True,
                 device: Any = "cuda",
                 precision: str = "fp32", quant=None):
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
        self.verify = verify
        self.device = device
        self.precision = precision
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
                verify=self.verify, device=self.device,
                precision=self.precision, quant=self.quant)
            self._nets[batch] = net
        return net

    def stats(self) -> dict:
        """Buckets built + the shared schedule cache's fold-reuse
        counters."""
        d = {"buckets": self.buckets,
             "distinct_schedules": self.cache.distinct}
        d.update(self.cache.stats.as_dict())
        return d
