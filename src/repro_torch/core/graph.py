"""Model-agnostic streaming-program IR.

The paper's thesis is that the 7-D loop nest is a *generic* data and
instruction streaming program — any conv network, not one fixed model,
should lower onto the same compiled fold schedules.  ``StreamGraph`` is
the small IR that makes the engine model-agnostic:

* **Nodes** are typed ops — ``conv`` (grouped/depthwise via ``groups``),
  ``bias``, ``batchnorm``, ``relu``, ``relu6``, ``maxpool2``,
  ``residual_add``, ``flatten``, ``dense``, ``global_avgpool`` — in SSA
  form: each node names its value, inputs reference earlier nodes (or the
  graph input), and skip edges are ordinary named inputs, so residual
  topologies are first-class rather than special-cased in any model
  walker.

* **``fuse_graph``** is the fusion pass: it folds each conv's downstream
  bias → batchnorm → residual_add → relu[6] → maxpool2 chain into the
  conv node's ``Epilogue`` (``core/epilogue.py``), turning a whole conv
  block — a ResNet ``relu(conv(x) + b + shortcut)`` or a MobileNet
  ``relu6(bn(conv(x)))`` — into a single node that lowers to one
  kernel launch.  Fusion rules are documented on the function; anything
  that cannot legally merge (multi-consumer intermediates, pool after a
  residual) stays a standalone node.

* **Lowering** (``core/engine.py:compile_network``) walks a graph through
  one shared ``ScheduleCache`` into the eager ``CompiledNetwork`` forward.

Models export graphs (``models/vgg.py:to_graph``); the legacy conv-spec
tuple format is converted by ``StreamGraph.from_conv_spec``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

from repro_torch.core.epilogue import Epilogue

__all__ = ["GraphError", "Node", "StreamGraph", "fuse_graph", "as_graph",
           "lower", "bn_scale_shift", "OPS", "BN_EPS", "DEPTHWISE"]

OPS = ("conv", "bias", "batchnorm", "relu", "relu6", "maxpool2",
       "residual_add", "flatten", "dense", "global_avgpool")

# Inference batch-norm epsilon — one constant shared by the fused epilogue
# lowering and the standalone batchnorm op, so fusing BN is bitwise-exact.
BN_EPS = 1e-5

# ``Node.groups`` sentinel: resolve to the input channel count at lowering
# time (graphs are shape-free; a depthwise conv doesn't know C yet).
DEPTHWISE = 0


class GraphError(ValueError):
    """Malformed streaming graph (unknown op, undefined input, ...)."""


@dataclasses.dataclass(frozen=True)
class Node:
    """One SSA op: ``name`` is the value this node defines.

    ``param`` indexes the parameter tree: ``params[param]["w"]`` (OIHW for
    conv, (in, out) for dense) and ``params[param]["b"]``.  ``stride`` /
    ``pad`` apply to conv only.  ``epilogue`` and ``residual`` are set by
    the fusion pass on conv nodes: the epilogue flushes in-kernel and
    ``residual`` names the skip-edge tensor added before the ReLU.
    """
    name: str
    op: str
    inputs: Tuple[str, ...]
    param: Optional[str] = None
    stride: int = 1
    pad: int = 0
    epilogue: Optional[Epilogue] = None
    residual: Optional[str] = None
    groups: int = 1              # conv channel groups; DEPTHWISE (0) means
    #                              groups == input channels, resolved at
    #                              lowering time
    bn_param: Optional[str] = None   # set by the fusion pass: the folded
    #                                  batch-norm's parameter entry
    #                                  (Epilogue.scale reads it)

    def all_inputs(self) -> Tuple[str, ...]:
        """Data dependencies including the fused skip edge."""
        if self.residual is not None:
            return self.inputs + (self.residual,)
        return self.inputs

    def __str__(self) -> str:
        extra = ""
        if self.op == "conv":
            extra = f" s{self.stride}p{self.pad}"
            if self.groups != 1:
                extra += (" dw" if self.groups == DEPTHWISE
                          else f" g{self.groups}")
            if self.epilogue is not None:
                extra += f" epi[{self.epilogue}]"
            if self.residual is not None:
                extra += f" +{self.residual}"
        return f"{self.name} = {self.op}({', '.join(self.inputs)}){extra}"


class StreamGraph:
    """An ordered (topologically sorted by construction) streaming program.

    Builder methods append a node consuming the current ``output`` by
    default, so linear chains read like the model definition; explicit
    ``src`` / ``residual_add`` inputs express skips.  Names default to
    ``<src>.<op>`` (unique-suffixed) when omitted.
    """

    def __init__(self, name: str = "net", input_name: str = "x"):
        self.name = name
        self.input = input_name
        self.nodes: List[Node] = []
        self._by_name: Dict[str, Node] = {}
        self.output = input_name

    # -- introspection -----------------------------------------------------
    def __len__(self) -> int:
        return len(self.nodes)

    def __iter__(self) -> Iterator[Node]:
        return iter(self.nodes)

    def node(self, name: str) -> Node:
        return self._by_name[name]

    def conv_names(self) -> List[str]:
        return [nd.name for nd in self.nodes if nd.op == "conv"]

    def consumers(self) -> Dict[str, List[Node]]:
        """Value name -> nodes that read it (skip edges included)."""
        out: Dict[str, List[Node]] = {}
        for nd in self.nodes:
            for src in nd.all_inputs():
                out.setdefault(src, []).append(nd)
        return out

    def describe(self) -> str:
        lines = [f"StreamGraph({self.name}: {self.input} -> {self.output}, "
                 f"{len(self.nodes)} nodes)"]
        lines += [f"  {nd}" for nd in self.nodes]
        return "\n".join(lines)

    # -- construction ------------------------------------------------------
    def _defined(self, name: str) -> bool:
        return name == self.input or name in self._by_name

    def _auto_name(self, src: str, op: str) -> str:
        base = f"{src}.{op}"
        name, i = base, 2
        while self._defined(name):
            name, i = f"{base}{i}", i + 1
        return name

    def _append(self, node: Node) -> str:
        if node.op not in OPS:
            raise GraphError(f"unknown op {node.op!r} (want one of {OPS})")
        if self._defined(node.name):
            raise GraphError(f"duplicate node name {node.name!r}")
        for src in node.all_inputs():
            if not self._defined(src):
                raise GraphError(f"{node.name}: input {src!r} is not "
                                 "defined yet (graphs are built in "
                                 "topological order)")
        self.nodes.append(node)
        self._by_name[node.name] = node
        self.output = node.name
        return node.name

    def _add(self, op: str, name: Optional[str], src: Optional[str],
             **attrs) -> str:
        src = src if src is not None else self.output
        if name is None:
            name = self._auto_name(src, op)
        return self._append(Node(name=name, op=op, inputs=(src,), **attrs))

    def conv(self, name: str, src: Optional[str] = None, *,
             param: Optional[str] = None, stride: int = 1,
             pad: int = 1, groups: int = 1) -> str:
        if groups < 0:
            raise GraphError(f"{name}: groups must be >= 1 (or DEPTHWISE), "
                             f"got {groups}")
        return self._add("conv", name, src, param=param or name,
                         stride=int(stride), pad=int(pad),
                         groups=int(groups))

    def depthwise_conv(self, name: str, src: Optional[str] = None, *,
                       param: Optional[str] = None, stride: int = 1,
                       pad: int = 1) -> str:
        """A conv whose group count equals its input channel count (one
        filter per channel, weights (C, 1, R, S)); the channel count — and
        with it the concrete ``groups`` — resolves at lowering time."""
        return self.conv(name, src, param=param, stride=stride, pad=pad,
                         groups=DEPTHWISE)

    def batchnorm(self, name: Optional[str] = None,
                  src: Optional[str] = None, *,
                  param: Optional[str] = None) -> str:
        """Inference batch-norm: ``y*scale + shift`` with scale/shift
        folded from ``params[param]`` ({gamma, beta, mean, var}) at trace
        time (``bn_scale_shift``).  The fusion pass melts it into the
        producing conv's epilogue (``Epilogue.scale``)."""
        if param is None:
            raise GraphError("batchnorm needs its own param entry "
                             "(gamma/beta/mean/var)")
        return self._add("batchnorm", name, src, param=param)

    def relu6(self, name: Optional[str] = None,
              src: Optional[str] = None) -> str:
        return self._add("relu6", name, src)

    def global_avgpool(self, name: Optional[str] = None,
                       src: Optional[str] = None) -> str:
        """Global average pool over the spatial dims -> (N, C, 1, 1)."""
        return self._add("global_avgpool", name, src)

    def bias(self, name: Optional[str] = None, src: Optional[str] = None, *,
             param: Optional[str] = None) -> str:
        """Channel bias add.  ``param`` defaults to the producing conv's
        parameter entry (``params[param]["b"]``)."""
        src = src if src is not None else self.output
        if param is None:
            prod = self._by_name.get(src)
            if prod is None or prod.param is None:
                raise GraphError(f"bias on {src!r}: no param to inherit — "
                                 "pass param= explicitly")
            param = prod.param
        return self._add("bias", name, src, param=param)

    def relu(self, name: Optional[str] = None,
             src: Optional[str] = None) -> str:
        return self._add("relu", name, src)

    def maxpool2(self, name: Optional[str] = None,
                 src: Optional[str] = None) -> str:
        return self._add("maxpool2", name, src)

    def flatten(self, name: Optional[str] = None,
                src: Optional[str] = None) -> str:
        return self._add("flatten", name, src)

    def dense(self, name: str, src: Optional[str] = None, *,
              param: Optional[str] = None) -> str:
        return self._add("dense", name, src, param=param or name)

    def residual_add(self, name: Optional[str], a: str, b: str) -> str:
        if name is None:
            name = self._auto_name(a, "residual_add")
        return self._append(Node(name=name, op="residual_add",
                                 inputs=(a, b)))

    # -- legacy conv-spec conversion ---------------------------------------
    @classmethod
    def from_conv_spec(cls, layers: Sequence, *, input_name: str = "x",
                       name: str = "convnet") -> "StreamGraph":
        """Convert the legacy conv-spec tuple format: ``"M"`` (2x2
        max-pool) or ``(name, cin, cout[, stride, pad])`` conv blocks,
        each conv implicitly followed by bias and ReLU (channel counts in
        the tuple are informational — the weights carry the truth)."""
        g = cls(name=name, input_name=input_name)
        for entry in layers:
            if entry == "M":
                g.maxpool2()
                continue
            conv_name = entry[0]
            stride, pad = ((int(entry[3]), int(entry[4]))
                           if len(entry) >= 5 else (1, 1))
            g.conv(conv_name, stride=stride, pad=pad)
            g.bias()
            g.relu()
        return g


def as_graph(graph_or_spec) -> StreamGraph:
    """Accept a ``StreamGraph`` as-is; convert a legacy conv-spec
    sequence (the tuple format) via ``from_conv_spec``."""
    if isinstance(graph_or_spec, StreamGraph):
        return graph_or_spec
    return StreamGraph.from_conv_spec(graph_or_spec)


# --------------------------------------------------------------------------
# The fusion pass
# --------------------------------------------------------------------------

def _toposort(nodes: List[Node], available: set) -> List[Node]:
    """Stable topological order (skip edges are dependencies too)."""
    out: List[Node] = []
    pending = list(nodes)
    while pending:
        for i, nd in enumerate(pending):
            if all(src in available for src in nd.all_inputs()):
                out.append(pending.pop(i))
                available.add(nd.name)
                break
        else:
            missing = {s for nd in pending for s in nd.all_inputs()
                       if s not in available}
            raise GraphError(f"graph has unresolvable dependencies on "
                             f"{sorted(missing)}")
    return out


def fuse_graph(graph: StreamGraph) -> StreamGraph:
    """Fold bias / batchnorm / residual_add / relu[6] / maxpool2 chains
    into each conv's ``Epilogue`` so one conv block lowers to one kernel
    launch.

    Rules (applied greedily, in epilogue order bias < batchnorm <
    residual < relu/relu6 < pool):

    * a node is absorbed only while it is the *sole* consumer of the
      chain tip, and never past the graph output (its exact value must
      survive);
    * ``bias`` must read the conv's own parameter entry;
    * ``batchnorm`` becomes the epilogue's scale+shift step
      (``Epilogue(scale=True)``): the conv node records the BN parameter
      entry (``Node.bn_param``) and the lowering folds gamma/beta/mean/var
      to the two vectors at trace time — the MobileNet inverted-residual
      chain (1x1 expand → depthwise → 1x1 project + residual) fuses to
      exactly three kernels this way;
    * ``residual_add`` records the other operand as the conv's skip-edge
      input — the shortcut adds to the pre-activation accumulator
      in-kernel (``Epilogue(residual=True)``), and only one conv chain may
      absorb any given add (first in program order wins);
    * ``relu`` and ``relu6`` are exclusive: whichever follows the chain
      tip first claims the activation slot;
    * ``maxpool2`` never fuses after a residual (the shortcut adds to the
      un-pooled output — ``core/epilogue.py`` enforces the same).

    The result is rebuilt in a stable topological order (a fused skip
    edge may reference a conv declared later, e.g. a ResNet downsample
    branch) with absorbed names aliased to their conv, so downstream
    references — including the graph output — stay valid.
    """
    consumers = graph.consumers()
    absorbed: set = set()
    alias: Dict[str, str] = {}
    fused: Dict[str, Tuple[Epilogue, Optional[str], Optional[str]]] = {}

    for nd in graph.nodes:
        if nd.op != "conv":
            continue
        # seed from any pre-existing epilogue (a caller-supplied partially
        # fused graph): absorbed ops extend it, never replace it, and the
        # in-order rules below refuse anything the existing flush already
        # covers or must precede
        epi, res, bn = (nd.epilogue or Epilogue()), nd.residual, nd.bn_param
        tip = nd.name
        while tip != graph.output:
            cands = consumers.get(tip, [])
            if len(cands) != 1:
                break
            c = cands[0]
            if c.name in absorbed:
                break
            if (c.op == "bias" and not (epi.bias or epi.scale
                                        or epi.residual or epi.activation
                                        or epi.pool)
                    and c.param == nd.param):
                epi = dataclasses.replace(epi, bias=True)
            elif (c.op == "batchnorm"
                    and not (epi.scale or epi.residual or epi.activation
                             or epi.pool)):
                epi = dataclasses.replace(epi, scale=True)
                bn = c.param
            elif (c.op == "residual_add"
                    and not (epi.residual or epi.activation or epi.pool)):
                other = [i for i in c.inputs if i != tip]
                if len(other) != 1:
                    break
                epi = dataclasses.replace(epi, residual=True)
                res = other[0]
            elif c.op == "relu" and not (epi.activation or epi.pool):
                epi = dataclasses.replace(epi, relu=True)
            elif c.op == "relu6" and not (epi.activation or epi.pool):
                epi = dataclasses.replace(epi, relu6=True)
            elif (c.op == "maxpool2"
                    and not (epi.pool or epi.residual)):
                epi = dataclasses.replace(epi, pool="max2")
            else:
                break
            absorbed.add(c.name)
            alias[c.name] = nd.name
            tip = c.name
        if not epi.identity:
            fused[nd.name] = (epi, res, bn)

    def rmap(n: Optional[str]) -> Optional[str]:
        return alias.get(n, n) if n is not None else None

    rebuilt: List[Node] = []
    for nd in graph.nodes:
        if nd.name in absorbed:
            continue
        # pre-existing skip edges remap through the alias too, even on
        # convs this pass didn't extend
        repl = dict(inputs=tuple(rmap(i) for i in nd.inputs),
                    residual=rmap(nd.residual))
        if nd.name in fused:
            epi, res, bn = fused[nd.name]
            repl.update(epilogue=epi, residual=rmap(res), bn_param=bn)
        rebuilt.append(dataclasses.replace(nd, **repl))

    out = StreamGraph(name=graph.name, input_name=graph.input)
    for nd in _toposort(rebuilt, {graph.input}):
        out._append(nd)
    out.output = rmap(graph.output)
    return out


def bn_scale_shift(bn: Dict, eps: float = BN_EPS):
    """Fold inference batch-norm statistics to the per-channel affine the
    epilogue applies: ``scale = gamma / sqrt(var + eps)``, ``shift = beta
    - mean * scale``."""
    import torch
    scale = bn["gamma"] / torch.sqrt(bn["var"] + eps)
    return scale, bn["beta"] - bn["mean"] * scale


def lower(graph: StreamGraph, params, input_shape, **compile_kw):
    """Lower a streaming graph through one shared ``ScheduleCache`` into
    the engine's ``CompiledNetwork``: the functional alias of
    ``core/engine.py:compile_network`` (which see for the contract)."""
    from repro_torch.core.engine import compile_network
    return compile_network(params, graph, input_shape, **compile_kw)
