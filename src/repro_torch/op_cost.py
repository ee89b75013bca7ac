"""Per-op cost walker over a traced step (the port's counterpart of the
JAX package's ``hlo_cost.py``, which walks compiled HLO text).

``analyze_step(fn, *args, **kw)`` runs ``fn`` under a
``TorchDispatchMode`` and counts every aten op that reaches a plain
tensor: on a sharded step (``DTensor`` operands over a fake process
group, ``launch/dryrun.py``) those are one rank's local ops and the
functional collectives that ``DTensor`` runs, so the counts are per
device, as ``hlo_cost``'s are on an SPMD-partitioned module.  Only ops on
the device of the step's arguments count: the shape inference
``DTensor`` runs on fake tensors and the index bookkeeping it does on
small CPU tensors are skipped.  Run on ``meta`` tensors, nothing is
computed or allocated.

Op costs, by ``hlo_cost``'s rules (its lines 10-20):
  * mm / bmm / addmm / baddbmm   2 * numel(result) * K (the contracted
                                 extent)
  * convolution                  2 * numel(result) * numel(kernel) /
                                 out_features (kernel taps a group)
  * elementwise / reductions     numel(result)
  * bytes_all: every op's operands + result (views move nothing);
    bytes_hbm: dots, convs, reductions and copies at their operands +
    result, gathers and slices at twice the result, in-place updates at
    twice the update; elementwise ops are taken as fused into a neighbour
    (no HBM traffic), and so is a dtype conversion: the op that reads a
    converted tensor (or a view of one) reads the bytes it was converted
    from, as a dot reads a bf16 operand it widens on the fly.
  * collectives: result bytes * the ring factor of the group size (below),
    beside a count of each.

The layers of the port's models are a Python loop, so the trace counts
each layer: there is no ``while`` body to scale.  ``OpCost.trip_counts``
holds the per-layer repeat count of the stacked layers where a caller
traced a cut depth and scaled it (``launch/dryrun.py`` sets it), in place
of ``while`` trip counts.  The walker keeps its own op table (it does not read
``torch.utils.flop_counter``), so its counts do not move with torch's
version.  It also tracks the peak of live bytes the step's own ops hold
(a weakref on each output), the port's estimate of temp memory.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Dict, List, Optional, Sequence, Tuple

import torch

__all__ = ["OpCost", "CollectiveRecord", "analyze_step", "local_bytes",
           "RING_FACTOR"]

# wire bytes per result byte of a ring collective over g ranks
RING_FACTOR = {
    "all-reduce": lambda g: 2.0 * (g - 1) / g,
    "all-gather": lambda g: float(g - 1) / g,
    "reduce-scatter": lambda g: float(g - 1),
    "all-to-all": lambda g: float(g - 1) / g,
    "collective-permute": lambda g: 1.0,
}

_DOTS = {"mm", "bmm", "addmm", "baddbmm", "mv", "addmv", "dot", "addbmm"}
_CONVS = {"convolution", "_convolution", "convolution_backward"}
_REDUCE = {"sum", "mean", "amax", "amin", "max", "min", "prod", "var",
           "std", "var_mean", "std_mean", "norm", "linalg_vector_norm",
           "cumsum", "cumprod", "logsumexp", "_softmax", "_log_softmax",
           "_softmax_backward_data", "_log_softmax_backward_data",
           "argmax", "argmin", "topk", "sort", "argsort", "any", "all",
           "nll_loss_forward", "nll_loss_backward"}
_GATHER = {"index", "index_select", "gather", "embedding", "take",
           "masked_select", "narrow_copy", "slice_copy", "select_copy"}
# in-place updates: the operand that holds the moved data
_UPDATE = {"index_copy": 3, "index_copy_": 3, "index_put": 2,
           "index_put_": 2, "_index_put_impl_": 2, "scatter": 3,
           "scatter_": 3, "scatter_add": 3, "scatter_add_": 3,
           "index_add": 3, "index_add_": 3, "slice_scatter": 1,
           "select_scatter": 1, "masked_scatter": 2, "copy_": 1,
           "embedding_dense_backward": 0}
_COPY = {"clone", "cat", "stack", "repeat", "repeat_interleave",
         "constant_pad_nd", "flip", "roll", "tril", "triu",
         "index_select_backward", "_unsafe_index"}
# no bytes moved and no flops: aliases and bookkeeping
_FREE = {"_unsafe_view", "lift_fresh", "detach", "wait_tensor",
         "_wrap_tensor_autograd", "_local_scalar_dense", "empty",
         "empty_strided", "empty_like", "set_", "resize_",
         "_has_compatible_shallow_copy_type"}
# new tensors: their result written, no flops, no HBM (the hlo broadcast
# and iota, fused into their readers)
_FACTORY = {"zeros", "ones", "full", "arange", "scalar_tensor",
            "zeros_like", "ones_like", "full_like", "new_zeros",
            "new_ones", "new_full", "new_empty", "fill", "fill_", "zero_"}
# dtype conversions: the hlo "convert", fused (no flops, no HBM bytes)
_CONVERT = {"_to_copy", "to", "_to_dtype"}
# the functional collectives and the HLO op each stands for
_COLLECTIVES = {
    ("_c10d_functional", "all_reduce"): "all-reduce",
    ("_c10d_functional", "all_reduce_"): "all-reduce",
    ("_c10d_functional", "all_gather_into_tensor"): "all-gather",
    ("_c10d_functional", "all_gather_into_tensor_out"): "all-gather",
    ("_c10d_functional", "reduce_scatter_tensor"): "reduce-scatter",
    ("_c10d_functional", "all_to_all_single"): "all-to-all",
    ("_c10d_functional_autograd", "all_to_all_single"): "all-to-all",
    ("_c10d_functional_autograd", "all_gather_into_tensor"): "all-gather",
    ("_c10d_functional_autograd", "reduce_scatter_tensor"): "reduce-scatter",
    ("_dtensor", "shard_dim_alltoall"): "all-to-all",
    ("_c10d_functional", "broadcast"): "collective-permute",
    ("c10d", "send"): "collective-permute",
    ("c10d", "recv_"): "collective-permute",
}


@dataclasses.dataclass
class CollectiveRecord:
    """One collective of the trace (``count`` > 1 once scaled): its HLO
    op name, its result bytes on this rank and its group's size."""
    op: str
    result_bytes: float
    group_size: int
    count: float = 1.0

    @property
    def wire_bytes(self) -> float:
        return (self.count * self.result_bytes
                * RING_FACTOR[self.op](max(self.group_size, 2)))


@dataclasses.dataclass
class OpCost:
    """``hlo_cost.HloCost``'s fields, per device: ``bytes_hbm`` is the
    HBM traffic with elementwise ops fused, ``bytes_all`` every op's
    operands and result (what an unfused program would move).  Beside
    them: the collective ``records``, the peak of live bytes the step's
    own ops held (``peak_bytes``), the bytes of its arguments, result and
    donated arguments on this rank (``arg_bytes``, ``out_bytes``,
    ``alias_bytes``) and the number of ops counted (``n_ops``); with
    ``analyze_step(keep_ops=True)`` every counted op in ``ops``."""
    flops: float = 0.0
    bytes_hbm: float = 0.0
    bytes_all: float = 0.0
    coll_wire_bytes: float = 0.0
    coll_result_bytes: float = 0.0
    coll_counts: Optional[Dict[str, float]] = None
    trip_counts: Optional[Dict[str, int]] = None
    records: Optional[List[CollectiveRecord]] = None
    peak_bytes: float = 0.0
    out_bytes: float = 0.0
    n_ops: float = 0.0
    arg_bytes: float = 0.0
    alias_bytes: float = 0.0
    # (op, operand shapes, flops, HBM bytes) of each counted op
    ops: Optional[List[Tuple[str, Tuple, float, float]]] = \
        dataclasses.field(default=None, repr=False, compare=False)

    def scaled(self, k: float) -> "OpCost":
        return OpCost(self.flops * k, self.bytes_hbm * k, self.bytes_all * k,
                      self.coll_wire_bytes * k, self.coll_result_bytes * k,
                      {o: c * k for o, c in (self.coll_counts or {}).items()},
                      dict(self.trip_counts or {}),
                      [dataclasses.replace(r, count=r.count * k)
                       for r in self.records or ()],
                      self.peak_bytes * k, self.out_bytes * k,
                      self.n_ops * k, self.arg_bytes * k,
                      self.alias_bytes * k)

    def add(self, other: "OpCost") -> None:
        self.flops += other.flops
        self.bytes_hbm += other.bytes_hbm
        self.bytes_all += other.bytes_all
        self.coll_wire_bytes += other.coll_wire_bytes
        self.coll_result_bytes += other.coll_result_bytes
        cc = self.coll_counts = self.coll_counts or {}
        for o, c in (other.coll_counts or {}).items():
            cc[o] = cc.get(o, 0) + c
        tc = self.trip_counts = self.trip_counts or {}
        tc.update(other.trip_counts or {})
        self.records = (self.records or []) + list(other.records or ())
        self.peak_bytes += other.peak_bytes
        self.out_bytes += other.out_bytes
        self.n_ops += other.n_ops
        self.arg_bytes += other.arg_bytes
        self.alias_bytes += other.alias_bytes


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree, out=None) -> List[torch.Tensor]:
    """The tensors of a nested structure, in order."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


def local_bytes(tree) -> int:
    """The bytes of a nested structure's tensors on this rank (a
    DTensor's local shard)."""
    return sum(_nbytes(getattr(t, "_local_tensor", t))
               for t in _tensors(tree))


def _group_size(func_args, kwargs) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group
    for a in list(func_args) + list(kwargs.values()):
        if isinstance(a, str):
            try:
                return _resolve_process_group(a).size()
            except (ValueError, RuntimeError, KeyError):
                continue
        if hasattr(a, "size") and hasattr(a, "rank") and \
                not isinstance(a, torch.Tensor):
            return a.size()
    return 2


def _contracted(name: str, tensors: List[torch.Tensor]) -> int:
    """K of a dot: the first operand's last dim (after a bias operand for
    addmm / baddbmm / addmv / addbmm)."""
    lhs = tensors[1] if name in ("addmm", "baddbmm", "addmv", "addbmm") \
        else tensors[0]
    return lhs.shape[-1] if lhs.dim() else 1


class _Walker:
    """The dispatch mode's state: the running totals and the live set."""

    def __init__(self, keep_ops: bool):
        self.cost = OpCost(coll_counts={}, trip_counts={}, records=[])
        self.live = 0
        self.peak = 0
        self.ops: Optional[List[Tuple[str, Tuple, float, float]]] = \
            [] if keep_ops else None
        # id of a converted tensor (or a view of one) -> the bytes its
        # readers read: those it was converted from
        self.src: Dict[int, float] = {}

    def _release(self, n: int) -> None:
        self.live -= n

    def _read(self, t: torch.Tensor) -> float:
        return self.src.get(id(t), _nbytes(t))

    def _reads(self, ts) -> float:
        return sum(self._read(t) for t in ts)

    def _set_src(self, t: torch.Tensor, n: float) -> None:
        if id(t) not in self.src:
            weakref.finalize(t, self.src.pop, id(t), None)
        self.src[id(t)] = n

    def count(self, func, args, kwargs, out) -> None:
        ns = func.namespace
        name = func._overloadpacket.__name__
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        c = self.cost
        res_bytes = sum(_nbytes(t) for t in outs)
        in_bytes = sum(_nbytes(t) for t in ins)
        hbm0 = c.bytes_hbm
        flops = 0.0
        coll = _COLLECTIVES.get((ns, name))
        if coll is not None:
            g = _group_size(args, kwargs or {})
            rec = CollectiveRecord(coll, float(res_bytes), g)
            c.records.append(rec)
            c.coll_result_bytes += res_bytes
            c.coll_wire_bytes += rec.wire_bytes
            c.coll_counts[coll] = c.coll_counts.get(coll, 0) + 1
            c.bytes_all += res_bytes
            c.bytes_hbm += res_bytes
        elif ns != "aten" or name in _FREE or func.is_view:
            if func.is_view and ins and id(ins[0]) in self.src:
                base = max(ins[0].numel(), 1)
                for t in outs:
                    self._set_src(t, self.src[id(ins[0])] * t.numel() / base)
            return self._track(func, ins, outs)
        elif name in _DOTS:
            out_n = sum(t.numel() for t in outs)
            flops = 2.0 * out_n * _contracted(name, ins)
            c.bytes_all += res_bytes + in_bytes
            c.bytes_hbm += res_bytes + self._reads(ins)
        elif name in _CONVS:
            w = ins[1] if len(ins) > 1 else None
            taps = (w.numel() / max(w.shape[0], 1)) if w is not None else 1
            if name == "convolution_backward":
                # (grad_out, input, weight): dx and dw, each a conv's work
                w = ins[2]
                taps = w.numel() / max(w.shape[0], 1)
                flops = 2 * 2.0 * ins[0].numel() * taps
            else:
                flops = 2.0 * sum(t.numel() for t in outs) * taps
            c.bytes_all += res_bytes + in_bytes
            c.bytes_hbm += res_bytes + self._reads(ins)
        elif name in _CONVERT or name in _FACTORY:
            c.bytes_all += res_bytes + in_bytes
            if name in _CONVERT and ins:
                for t in outs:
                    self._set_src(t, self._read(ins[0]))
        elif name in _REDUCE:
            flops = float(sum(t.numel() for t in outs))
            c.bytes_all += res_bytes + in_bytes
            c.bytes_hbm += res_bytes + self._reads(ins)
        elif name in _GATHER:
            c.bytes_all += res_bytes + in_bytes
            c.bytes_hbm += 2 * res_bytes
        elif name in _UPDATE:
            i = _UPDATE[name]
            pos = [a for a in args if isinstance(a, torch.Tensor)]
            upd = pos[min(i, len(pos) - 1)] if name != "copy_" else \
                pos[-1]
            c.bytes_all += res_bytes + in_bytes
            c.bytes_hbm += 2 * _nbytes(upd)
        elif name in _COPY:
            c.bytes_all += res_bytes + in_bytes
            c.bytes_hbm += res_bytes + self._reads(ins)
        elif torch.Tag.pointwise in func.tags or name.endswith("_backward"):
            flops = float(sum(t.numel() for t in outs))
            c.bytes_all += res_bytes + in_bytes
        else:
            # outside the table: its operands and result in bytes_all, no
            # flops, taken as fused
            c.bytes_all += res_bytes + in_bytes
        c.flops += flops
        c.n_ops += 1
        if self.ops is not None:
            self.ops.append((f"{ns}.{name}",
                             tuple(tuple(t.shape) for t in ins),
                             flops, c.bytes_hbm - hbm0))
        self._track(func, ins, outs)

    def _track(self, func, ins, outs) -> None:
        """Add the op's new storage to the live set until its tensor
        object is freed (views and in-place results hold no new
        storage)."""
        if func.is_view:
            return
        ids = {id(t) for t in ins}
        for t in outs:
            if id(t) in ids:
                continue
            n = _nbytes(t)
            if not n:
                continue
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(t, self._release, n)


def analyze_step(fn, *args, donate_argnums: Sequence[int] = (),
                 keep_ops: bool = False, **kw) -> OpCost:
    """The ``OpCost`` of ``fn(*args, **kw)`` on one rank's local shapes.
    ``donate_argnums``: the arguments the step gives up to its results
    (``jax.jit``'s), counted in ``alias_bytes``; ``keep_ops``: the cost's
    ``ops`` lists every counted op (name, operand shapes, flops, HBM
    bytes)."""
    from torch._subclasses.fake_tensor import FakeTensor
    from torch.utils._python_dispatch import TorchDispatchMode

    walker = _Walker(keep_ops)
    fake_key = torch._C._TorchDispatchModeKey.FAKE
    first = _tensors((args, kw))
    device = (getattr(first[0], "_local_tensor", first[0]).device.type
              if first else "cpu")

    class _Mode(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if any(t is not torch.Tensor and t is not FakeTensor
                   and issubclass(t, torch.Tensor) for t in types):
                return NotImplemented     # a DTensor: let it desugar
            out = func(*args, **kwargs)
            ts = _tensors((args, kwargs, out))
            if (any(t.device.type == device for t in ts)
                    and not any(isinstance(t, FakeTensor) for t in ts)
                    and torch._C._get_dispatch_mode(fake_key) is None):
                walker.count(func, args, kwargs, out)
            return out

    with _Mode():
        result = fn(*args, **kw)
    cost = walker.cost
    cost.out_bytes = float(local_bytes(result))
    cost.peak_bytes = float(walker.peak)
    cost.arg_bytes = float(local_bytes(args))
    cost.alias_bytes = float(sum(local_bytes(args[i])
                                 for i in donate_argnums))
    cost.ops = walker.ops
    return cost

