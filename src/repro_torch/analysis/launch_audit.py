"""Launch auditor: what one call of a compiled network actually ran (the
counterpart of the JAX package's ``analysis/jaxpr_audit.py``, which reads
a traced jaxpr; a torch forward has none, so this one watches a call).

``audit_launches`` runs the network's eager forward once on a zeros input
and records two things:

* fold calls — the fold-kernel calls of the call, by kernel name.  On a
  CUDA device they are the launches the kernel wrappers count
  (``kernels/conv2d_ws.py:launch_counts``); on the CPU, where the plain
  fold walk ticks no launch counter, they are the calls of
  ``conv2d_folded``, named by the kernel their resolved dataflow selects.
* 4-D ops outside the convs — every torch op that dispatches on a tensor
  of rank 4 or more (a ``TorchDispatchMode``), outside the conv entry
  calls of ``kernels/ops.py``.  Inside them run the conv's own padding,
  the int8 quantize steps and, on the CPU, the plain fold walk, which is
  itself 4-D torch ops: those are the conv, not escaped epilogue math.
  Rank-1 batch-norm folds and the 2-D head do not count.

Findings: ``audit.launch-count`` when a kernel-mode network does not run
exactly one fold call per conv layer; ``audit.unfused-op`` when a fused
kernel-mode network runs a 4-D epilogue op (add, mul, relu, clamp,
max-pool) outside its convs.
"""
from __future__ import annotations

import contextlib
import dataclasses
from collections import Counter
from typing import Dict, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis.report import Report

__all__ = ["AuditReport", "audit_launches", "EPILOGUE_OPS"]

# the ops the engine's standalone epilogue steps dispatch, which a fused
# epilogue must NOT leave outside its conv on a 4-D tensor: bias and
# residual adds, the BN affine, relu, relu6 (clamp), the 2x2 max-pool
# (``maxpool2x2``'s amax)
EPILOGUE_OPS = ("add", "mul", "relu", "clamp", "amax")

# the kernel each resolved dataflow launches (``conv2d_ws.LAUNCHERS``)
_KERNEL_OF = {"weight_stationary": "fold_conv_ws",
              "output_stationary": "fold_conv_os",
              "depthwise": "fold_conv_dw",
              "weight_stationary_psum": "fold_conv_psum"}
_CONV_ENTRIES = ("conv2d", "conv2d_fused", "conv2d_int8")


def _op_name(func) -> str:
    """aten op name without its overload or in-place underscore."""
    return func.overloadpacket.__name__.rstrip("_")


class _OpRecorder(TorchDispatchMode):
    """Counts ops by name, and those on a rank >= 4 tensor, while no conv
    entry call is running."""

    def __init__(self):
        super().__init__()
        self.inside = 0
        self.counts: Counter = Counter()
        self.counts4d: Counter = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not self.inside:
            name = _op_name(func)
            self.counts[name] += 1
            flat = list(args) + list(kwargs.values())
            if any(isinstance(a, torch.Tensor) and a.dim() >= 4
                   for a in flat):
                self.counts4d[name] += 1
        return func(*args, **kwargs)


@contextlib.contextmanager
def _watch_convs(recorder: _OpRecorder, calls: Counter):
    """Mark the extent of every conv entry call of ``kernels/ops.py`` on
    ``recorder`` and count its ``conv2d_folded`` calls into ``calls`` by
    kernel name.  The compiled forward looks both up on the module at
    every call, so they are swapped there for this call only."""
    from repro_torch.kernels import conv2d_ws, ops
    saved = {name: getattr(ops, name)
             for name in _CONV_ENTRIES + ("conv2d_folded",)}

    def entry(fn):
        def marked(*args, **kwargs):
            recorder.inside += 1
            try:
                return fn(*args, **kwargs)
            finally:
                recorder.inside -= 1
        return marked

    def folded(x_padded, w, **kw):
        spec = conv2d_ws.fold_kernel_spec(
            tuple(x_padded.shape), tuple(w.shape),
            stride=kw.get("stride", 1), plan=kw.get("plan"),
            dataflow=kw.get("dataflow", "weight_stationary"),
            epilogue=kw.get("epilogue"), groups=kw.get("groups", 1))
        # the instance of x's type: *_i8, *_bf16 or the fp32 one
        calls[conv2d_ws._entry(_KERNEL_OF[spec.dataflow], x_padded)] += 1
        return saved["conv2d_folded"](x_padded, w, **kw)

    for name in _CONV_ENTRIES:
        setattr(ops, name, entry(saved[name]))
    ops.conv2d_folded = folded
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(ops, name, fn)


@dataclasses.dataclass(frozen=True)
class AuditReport:
    """What one call of a compiled network ran (see module docstring)."""
    fold_calls: int
    conv_layers: int
    mode: str                    # "kernel" | "reference"
    fused: bool
    device: str
    launches: Dict[str, int]     # fold calls by kernel name
    n_ops: int                   # ops dispatched outside the convs
    top_counts: Dict[str, int]   # ... by op name
    ops4d: Dict[str, int]        # ... restricted to rank >= 4 operands
    findings: Report

    @property
    def ok(self) -> bool:
        return self.findings.ok

    def top(self, name: str) -> int:
        return self.top_counts.get(name, 0)

    def op4d(self, name: str) -> int:
        return self.ops4d.get(name, 0)

    def as_dict(self) -> dict:
        return {"fold_calls": self.fold_calls,
                "conv_layers": self.conv_layers,
                "mode": self.mode, "fused": self.fused,
                "device": self.device, "launches": dict(self.launches),
                "n_ops": self.n_ops, "top_counts": dict(self.top_counts),
                "ops4d": dict(self.ops4d),
                "report": self.findings.as_dict()}


def audit_launches(net, params, input_shape: Tuple[int, ...],
                   dtype: torch.dtype = torch.float32) -> AuditReport:
    """Run ``net``'s eager forward once on a zeros ``dtype`` input of
    ``input_shape`` (a bf16 network's is bf16) on its device and audit
    what ran.  ``net`` is a ``CompiledNetwork`` (``core/engine.py``); a
    jitted network's eager forward is ``net.eager`` (a graph replay would
    tick no counter and dispatch no op)."""
    from repro_torch.kernels import conv2d_ws
    x0 = torch.zeros(tuple(input_shape), dtype=dtype,
                     device=net.device)
    cuda = torch.device(net.device).type == "cuda"
    recorder, calls = _OpRecorder(), Counter()
    before = conv2d_ws.launch_counts()
    with torch.inference_mode(), _watch_convs(recorder, calls), recorder:
        net.eager(params, x0)
    if cuda:
        torch.cuda.synchronize(net.device)
        after = conv2d_ws.launch_counts()
        launches = {k: after[k] - before[k] for k in after
                    if after[k] != before[k]}
    else:
        launches = dict(calls)
    fold_calls = sum(launches.values())
    conv_layers = len(net.layer_schedules)

    rep = Report()
    if net.mode == "kernel" and fold_calls != conv_layers:
        rep.add("audit.launch-count", "forward",
                f"{fold_calls} fold-kernel call(s) but the network has "
                f"{conv_layers} conv layers — fold kernels were "
                f"duplicated or lost")
    if net.mode == "kernel" and net.fused:
        for op in EPILOGUE_OPS:
            leaked = recorder.counts4d.get(op, 0)
            if leaked:
                rep.add("audit.unfused-op", "forward",
                        f"{leaked} 4-D {op!r} op(s) outside the convs: "
                        f"epilogue math escaped the fused kernels")
    return AuditReport(fold_calls=fold_calls, conv_layers=conv_layers,
                       mode=net.mode, fused=net.fused,
                       device=str(net.device), launches=launches,
                       n_ops=sum(recorder.counts.values()),
                       top_counts=dict(recorder.counts),
                       ops4d=dict(recorder.counts4d), findings=rep)
