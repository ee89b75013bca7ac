"""StreamGraph linter and independent fusion-legality re-derivation (the
JAX package's ``analysis/graph_check.py``, kept as a copy: the rules and
the codes are the same).

``lint_graph`` re-proves the structural contract ``StreamGraph``
enforces at construction time — SSA form, topological inputs, known ops
— plus properties construction *cannot* see: dead nodes, conflict
states smuggled into frozen ``Epilogue`` instances, dangling skip edges,
missing batch-norm parameters, and (when ``params``/``input_shape`` are
supplied) full shape-inference consistency including residual operand
agreement.

``check_fusion`` re-derives ``fuse_graph``'s legality rules from scratch
(a stage-ordered absorption automaton, deliberately *not* sharing code
with the fusion pass) and diffs the derivation against a fused graph, so a
fusion bug shows up as a classified finding:

  fusion.sole-consumer        a multi-consumer value was absorbed
  fusion.output-preservation  the graph output's exact value did not
                              survive fusion
  fusion.conv-own-bias        a bias reading some other layer's parameter
                              entry was folded into a conv
  fusion.pool-after-residual  a pool was fused into a chain that already
                              absorbed a residual add
  fusion.illegal-absorb       any other absorption the rules forbid
  fusion.mismatch             a conv's fused epilogue/skip-edge/bn-param
                              differs from the legal derivation
  fusion.incomplete           (warning) a legally fusable chain was left
                              unfused — suboptimal, not unsafe
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Set, Tuple

from repro_torch.analysis.report import Report, WARNING
from repro_torch.core.epilogue import Epilogue
from repro_torch.core.graph import DEPTHWISE, OPS, StreamGraph

__all__ = ["lint_graph", "check_fusion"]

Shape = Tuple[int, ...]


# --------------------------------------------------------------------------
# structural + shape lint
# --------------------------------------------------------------------------

def _leaf_shape(tree, key: str, leaf: str) -> Optional[Shape]:
    entry = tree.get(key) if hasattr(tree, "get") else None
    if entry is None:
        return None
    v = entry.get(leaf) if hasattr(entry, "get") else None
    return tuple(v.shape) if v is not None and hasattr(v, "shape") else None


def _infer_shapes(graph: StreamGraph, params, input_shape: Shape,
                  rep: Report) -> None:
    """Mini shape-inference walk over every op the engine lowers; findings
    instead of exceptions, so one pass reports every inconsistency."""
    shapes: Dict[str, Shape] = {graph.input: tuple(input_shape)}
    for nd in graph.nodes:
        srcs = [shapes.get(i) for i in nd.all_inputs()]
        if any(s is None for s in srcs):
            continue                      # upstream already reported
        if nd.op == "conv":
            n, cin, h, w_ = srcs[0]
            wshape = _leaf_shape(params, nd.param, "w")
            if wshape is None or len(wshape) != 4:
                rep.add("graph.missing-param", nd.name,
                        f"conv param {nd.param!r} has no OIHW weight in "
                        f"the parameter tree")
                continue
            nf, cw, r, s = wshape
            groups = cin if nd.groups == DEPTHWISE else nd.groups
            if groups < 1 or cin % groups or nf % groups:
                rep.add("graph.shape", nd.name,
                        f"groups={groups} does not divide C={cin} and "
                        f"N_F={nf}")
                continue
            if cw * groups != cin:
                rep.add("graph.shape", nd.name,
                        f"weight expects {cw * groups} input channels "
                        f"(shape {wshape}, G={groups}) but the input "
                        f"has {cin}")
                continue
            p = (h + 2 * nd.pad - r) // nd.stride + 1
            q = (w_ + 2 * nd.pad - s) // nd.stride + 1
            if p < 1 or q < 1:
                rep.add("graph.shape", nd.name,
                        f"conv output would be {p}x{q} (input {h}x{w_}, "
                        f"filter {r}x{s}, stride {nd.stride}, pad "
                        f"{nd.pad})")
                continue
            epi = nd.epilogue or Epilogue()
            if epi.residual:
                res_shape = shapes.get(nd.residual or "")
                if res_shape is not None and res_shape != (n, nf, p, q):
                    rep.add("graph.shape", nd.name,
                            f"fused skip edge {nd.residual!r} has shape "
                            f"{res_shape} but the conv output is "
                            f"{(n, nf, p, q)}")
            if epi.pool == "max2":
                p, q = p // 2, q // 2
            shapes[nd.name] = (n, nf, p, q)
        elif nd.op in ("bias", "batchnorm", "relu", "relu6"):
            shapes[nd.name] = srcs[0]
        elif nd.op == "maxpool2":
            n, cch, h, w_ = srcs[0]
            shapes[nd.name] = (n, cch, h // 2, w_ // 2)
        elif nd.op == "global_avgpool":
            n, cch = srcs[0][:2]
            shapes[nd.name] = (n, cch, 1, 1)
        elif nd.op == "residual_add":
            a, b = srcs[0], srcs[1]
            if a != b:
                rep.add("graph.shape", nd.name,
                        f"residual_add operands disagree: "
                        f"{nd.inputs[0]}={a} vs {nd.inputs[1]}={b}")
                continue
            shapes[nd.name] = a
        elif nd.op == "flatten":
            n = srcs[0][0]
            size = 1
            for d in srcs[0][1:]:
                size *= d
            shapes[nd.name] = (n, size)
        elif nd.op == "dense":
            wshape = _leaf_shape(params, nd.param, "w")
            if wshape is None or len(wshape) != 2:
                rep.add("graph.missing-param", nd.name,
                        f"dense param {nd.param!r} has no (in, out) "
                        f"weight in the parameter tree")
                continue
            if srcs[0][-1] != wshape[0]:
                rep.add("graph.shape", nd.name,
                        f"dense expects {wshape[0]} features but the "
                        f"input has {srcs[0][-1]}")
                continue
            shapes[nd.name] = (srcs[0][0], wshape[1])


def lint_graph(graph: StreamGraph, params=None,
               input_shape: Optional[Shape] = None) -> Report:
    """Structural lint; add shape-inference consistency when ``params``
    and ``input_shape`` are both given."""
    rep = Report()
    defined: Set[str] = {graph.input}
    for nd in graph.nodes:
        if nd.op not in OPS:
            rep.add("graph.unknown-op", nd.name,
                    f"unknown op {nd.op!r} (want one of {OPS})")
        if nd.name in defined:
            rep.add("graph.duplicate-name", nd.name,
                    "node name defined twice — the graph is not SSA")
        for src in nd.all_inputs():
            if src not in defined:
                rep.add("graph.undefined-input", nd.name,
                        f"input {src!r} is not defined before this node "
                        f"(graphs must be in topological order)")
        if nd.op == "conv":
            if nd.groups < 0:
                rep.add("graph.depthwise-sentinel", nd.name,
                        f"groups={nd.groups} is invalid: want >= 1, or "
                        f"DEPTHWISE ({DEPTHWISE}) to resolve to the "
                        f"input channel count at lowering time")
            epi = nd.epilogue
            if epi is not None:
                for c in epi.conflicts():
                    rep.add("graph.epilogue-conflict", nd.name, c)
                if epi.residual and nd.residual is None:
                    rep.add("graph.residual-edge", nd.name,
                            "epilogue fuses a residual but the node "
                            "has no skip-edge input set")
                if epi.scale and nd.bn_param is None:
                    rep.add("graph.bn-param", nd.name,
                            "epilogue fuses a batch-norm but the node "
                            "records no bn_param entry")
            if nd.residual is not None and (epi is None
                                            or not epi.residual):
                rep.add("graph.residual-edge", nd.name,
                        f"skip edge {nd.residual!r} is set but the "
                        f"epilogue does not fuse a residual")
        elif nd.op == "batchnorm" and nd.param is None:
            rep.add("graph.bn-param", nd.name,
                    "batchnorm needs its own param entry "
                    "(gamma/beta/mean/var)")
        elif nd.epilogue is not None:
            rep.add("graph.epilogue-conflict", nd.name,
                    f"epilogue on a non-conv node ({nd.op}): only conv "
                    f"nodes flush fused epilogues")
        defined.add(nd.name)

    if graph.output not in defined:
        rep.add("graph.undefined-input", graph.output,
                "the graph output names no node (and is not the input)")
    else:
        # dead-node sweep: anything the output cannot reach is never
        # computed by the lowering walk the user thinks they described
        live: Set[str] = set()
        stack = [graph.output]
        by_name = {nd.name: nd for nd in graph.nodes}
        while stack:
            cur = stack.pop()
            if cur in live or cur == graph.input:
                continue
            live.add(cur)
            nd = by_name.get(cur)
            if nd is not None:
                stack.extend(nd.all_inputs())
        for nd in graph.nodes:
            if nd.name not in live:
                rep.add("graph.dead-node", nd.name,
                        f"{nd.op} node is unreachable from the output "
                        f"{graph.output!r} and will never be computed",
                        severity=WARNING)

    if params is not None and input_shape is not None and rep.ok:
        _infer_shapes(graph, params, tuple(input_shape), rep)
    return rep


# --------------------------------------------------------------------------
# independent fusion re-derivation
# --------------------------------------------------------------------------

# absorption stages in epilogue flush order; an op may only be absorbed
# into a strictly earlier-staged epilogue (plus the pool/residual
# exclusion below)
_STAGE = {"bias": 1, "batchnorm": 2, "residual_add": 3,
          "relu": 4, "relu6": 4, "maxpool2": 5}


def _epi_stage(epi: Epilogue) -> int:
    if epi.pool:
        return 5
    if epi.activation:
        return 4
    if epi.residual:
        return 3
    if epi.scale:
        return 2
    if epi.bias:
        return 1
    return 0


@dataclasses.dataclass
class _Derivation:
    fused: Dict[str, Tuple[Epilogue, Optional[str], Optional[str]]]
    absorbed: Set[str]
    alias: Dict[str, str]

    def resolve(self, name: str) -> str:
        return self.alias.get(name, name)


def _derive_fusion(graph: StreamGraph) -> _Derivation:
    """Re-derive the legal fusion of ``graph`` with a stage automaton —
    an implementation deliberately independent of ``fuse_graph``."""
    consumers = graph.consumers()
    d = _Derivation(fused={}, absorbed=set(), alias={})
    for nd in graph.nodes:
        if nd.op != "conv":
            continue
        epi = nd.epilogue or Epilogue()
        res, bn = nd.residual, nd.bn_param
        tip = nd.name
        while tip != graph.output:
            cands = consumers.get(tip, [])
            if len(cands) != 1 or cands[0].name in d.absorbed:
                break
            c = cands[0]
            stage = _STAGE.get(c.op)
            if stage is None or stage <= _epi_stage(epi):
                break
            if c.op == "bias" and c.param != nd.param:
                break                       # conv-own-bias rule
            if c.op == "maxpool2" and epi.residual:
                break                       # no pool after a residual
            if c.op == "residual_add":
                others = [i for i in c.inputs if i != tip]
                if len(others) != 1:
                    break
                res = others[0]
                epi = dataclasses.replace(epi, residual=True)
            elif c.op == "bias":
                epi = dataclasses.replace(epi, bias=True)
            elif c.op == "batchnorm":
                epi = dataclasses.replace(epi, scale=True)
                bn = c.param
            elif c.op in ("relu", "relu6"):
                epi = dataclasses.replace(epi, **{c.op: True})
            else:                           # maxpool2
                epi = dataclasses.replace(epi, pool="max2")
            d.absorbed.add(c.name)
            d.alias[c.name] = nd.name
            tip = c.name
        if not epi.identity:
            d.fused[nd.name] = (epi, res, bn)
    return d


def _classify_illegal(original: StreamGraph, name: str,
                      derived: _Derivation) -> Tuple[str, str]:
    """Name the rule an illegally absorbed node broke."""
    nd = original.node(name)
    consumers = original.consumers()
    producer = nd.inputs[0]
    if len(consumers.get(producer, [])) > 1:
        return ("fusion.sole-consumer",
                f"{nd.op} node consumes {producer!r}, which has "
                f"{len(consumers[producer])} consumers — absorbing it "
                f"changes the other consumers' value")
    # walk the producer chain back to the conv that must have absorbed it
    cur, conv = producer, None
    while True:
        cur = derived.resolve(cur)
        src = original.node(cur) if cur != original.input else None
        if src is None or src.op == "conv":
            conv = src
            break
        cur = src.inputs[0]
    if nd.op == "maxpool2":
        return ("fusion.pool-after-residual",
                "pool absorbed into a chain that already fused a "
                "residual add — the shortcut must add to the un-pooled "
                "output")
    if nd.op == "bias" and conv is not None and nd.param != conv.param:
        return ("fusion.conv-own-bias",
                f"bias reads param {nd.param!r} but the absorbing conv "
                f"owns {conv.param!r}")
    return ("fusion.illegal-absorb",
            f"{nd.op} node was absorbed although the epilogue stage "
            f"order forbids it")


def check_fusion(original: StreamGraph, fused: StreamGraph) -> Report:
    """Diff ``fused`` against the independent legal derivation from
    ``original``; classify each divergence."""
    rep = Report()
    derived = _derive_fusion(original)
    kept = {nd.name for nd in fused.nodes}
    orig_names = [nd.name for nd in original.nodes]
    dropped = set(orig_names) - kept

    for name in sorted(dropped - derived.absorbed):
        code, msg = _classify_illegal(original, name, derived)
        rep.add(code, name, msg)
    for name in sorted(derived.absorbed - dropped):
        rep.add("fusion.incomplete", name,
                f"{original.node(name).op} node could legally fuse into "
                f"its conv's epilogue but was left standalone",
                severity=WARNING)

    for conv, (epi, res, bn) in derived.fused.items():
        if conv not in kept:
            if conv not in dropped - derived.absorbed:
                rep.add("fusion.mismatch", conv,
                        "conv node disappeared during fusion")
            continue
        got = fused.node(conv)
        got_epi = got.epilogue or Epilogue()
        # only compare when the fused graph actually absorbed the chain
        # (an incomplete fusion is already reported above)
        chain = {n for n, a in derived.alias.items() if a == conv}
        if not chain <= dropped:
            continue
        if got_epi != epi:
            rep.add("fusion.mismatch", conv,
                    f"fused epilogue [{got_epi}] != legal derivation "
                    f"[{epi}]")
        want_res = derived.resolve(res) if res is not None else None
        if got.residual != want_res:
            rep.add("fusion.mismatch", conv,
                    f"fused skip edge {got.residual!r} != derived "
                    f"{want_res!r}")
        if got.bn_param != bn:
            rep.add("fusion.mismatch", conv,
                    f"fused bn_param {got.bn_param!r} != derived {bn!r}")

    want_out = derived.resolve(original.output)
    if fused.output != want_out:
        rep.add("fusion.output-preservation", fused.output,
                f"fused graph output {fused.output!r} != the original "
                f"output's surviving value {want_out!r}")
    return rep
