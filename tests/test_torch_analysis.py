"""The port's ``analysis/`` against the JAX package's, and what the port
adds for the card.

* On the zoo at the JAX foldlint's footprint (img 32, width 0.0625), the
  port's ``lint_graph``, ``check_fusion``, ``check_plan`` and
  ``check_kernel_spec`` give the JAX package's findings (code, where,
  severity) on the same graphs, plans and launches, and on seeded
  mutations of each layer's plan and output index map.  The JAX package's
  ``plan.vmem-overflow`` / ``plan.vmem-pressure`` price a TPU's VMEM and
  are not compared (``VMEM_CODES``): the port proves residency on the CTA
  tile instead (``plan.smem-overflow``).
* Each seeded violation of the JAX package's ``tests/test_foldlint.py``
  gives the same codes in the port, one parametrised test per checker.
* The CTA-tile check is clean on every zoo launch at the H100's 132 SMs,
  and flags seeded tiles.
* ``compile_network(verify=True)`` (the default) raises ``FoldLintError``
  before any fold call, and a second compile is a memo hit.
* The launch audit counts one fold call per conv and flags unfused 4-D
  epilogue ops; ``python -m repro_torch.analysis.foldlint --model all
  --device cpu --json`` exits 0.

Shape arithmetic only where it can be: the JAX parameters come from
``jax.eval_shape`` and the port's live on the ``meta`` device, except
where a forward runs (the audit, the CLI)."""
import dataclasses
import importlib
import inspect
import json
import math
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import analysis as j_an  # noqa: E402
from repro.core import engine as j_engine  # noqa: E402
from repro.core import graph as j_graph  # noqa: E402
from repro.core import loopnest as j_loopnest  # noqa: E402
from repro.core import mapping as j_mapping  # noqa: E402
from repro.core.epilogue import Epilogue as JEpilogue  # noqa: E402
from repro.kernels import conv2d_ws as j_kern  # noqa: E402
from repro_torch import analysis as t_an  # noqa: E402
from repro_torch.analysis import foldlint as t_foldlint  # noqa: E402
from repro_torch.analysis.index_check import check_launch_tile  # noqa: E402
from repro_torch.analysis.plan_check import check_tile_residency  # noqa
from repro_torch.analysis.report import FoldLintError  # noqa: E402
from repro_torch.core import engine as t_engine  # noqa: E402
from repro_torch.core import graph as t_graph  # noqa: E402
from repro_torch.core import loopnest as t_loopnest  # noqa: E402
from repro_torch.core import mapping as t_mapping  # noqa: E402
from repro_torch.core.epilogue import Epilogue as TEpilogue  # noqa: E402
from repro_torch.core.quant import requant_epilogue  # noqa: E402
from repro_torch.kernels import conv2d_ws as t_kern  # noqa: E402
from repro_torch.kernels import ops as t_ops  # noqa: E402
from repro_torch.models import zoo as t_zoo  # noqa: E402

# the JAX package's residency codes price a TPU's VMEM: not compared
VMEM_CODES = ("plan.vmem-overflow", "plan.vmem-pressure")
SMS = 132            # the H100's SMs: fold_tile is a pure function of them
MODELS = ("vgg16", "resnet18", "mobilenetv2")
ZOO_MODULE = {"vgg16": "vgg", "resnet18": "resnet",
              "mobilenetv2": "mobilenet"}

# both packages' analysis surfaces, so one case builds on either
J = types.SimpleNamespace(
    an=j_an, StreamGraph=j_graph.StreamGraph, fuse_graph=j_graph.fuse_graph,
    Epilogue=JEpilogue, Nest=j_loopnest.ConvLoopNest,
    Plan=j_mapping.ConvBlockPlan, plan_conv_blocks=j_mapping.plan_conv_blocks,
    spec=j_kern.fold_kernel_spec)
T = types.SimpleNamespace(
    an=t_an, StreamGraph=t_graph.StreamGraph, fuse_graph=t_graph.fuse_graph,
    Epilogue=TEpilogue, Nest=t_loopnest.ConvLoopNest,
    Plan=t_mapping.ConvBlockPlan, plan_conv_blocks=t_mapping.plan_conv_blocks,
    spec=t_kern.fold_kernel_spec)


def _smuggle(obj, **attrs):
    """Mutate a frozen dataclass past its constructor's validation."""
    for k, v in attrs.items():
        object.__setattr__(obj, k, v)
    return obj


def _findings(rep, skip=()):
    return [(f.code, f.where, f.severity) for f in rep.findings
            if f.code not in skip]


def _same_findings(j_rep, t_rep):
    assert _findings(t_rep) == _findings(j_rep, VMEM_CODES)


# --------------------------------------------------------------------------
# the zoo at the JAX foldlint's footprint, layer by layer
# --------------------------------------------------------------------------

def _zoo(name, width=0.0625, img=32, batch=1):
    """Both packages' compiled networks, their parameter shapes and the
    input shape, from shapes alone."""
    mod = ZOO_MODULE[name]
    jmod = importlib.import_module(f"repro.models.{mod}")
    tmod = importlib.import_module(f"repro_torch.models.{mod}")
    jparams = jax.eval_shape(
        lambda k: jmod.init_params(k, width_mult=width, img=img,
                                   classes=10), jax.random.PRNGKey(0))
    tparams = tmod.init_params(torch.Generator(), width_mult=width, img=img,
                               classes=10, device="meta")
    jnet = jmod.compile_forward(jparams, img=img, batch=batch,
                                policy="pallas", verify=False)
    tnet = tmod.compile_forward(tparams, img=img, batch=batch,
                                policy="kernel", device="meta",
                                verify=False)
    return jmod, tmod, jparams, tparams, jnet, tnet, (batch, 3, img, img)


def _layers(net, params, input_shape):
    """(name, nest, schedule, epilogue the kernel flushes, groups) of
    every conv of a compiled network, by the engine's own shape walk."""
    out, scheds = [], dict(net.layer_schedules)
    nests = dict(net.layer_nests)
    for nd in net.graph.nodes:
        if nd.op != "conv":
            continue
        cv = nests[nd.name]
        epi = nd.epilogue
        if epi is not None and epi.pool and (cv.p < 2 or cv.q < 2):
            epi = dataclasses.replace(epi, pool=None)
        out.append((nd.name, cv, scheds[nd.name], epi, cv.groups))
    return out


def _as_j(cv):
    return J.Nest(n=cv.n, nf=cv.nf, c=cv.c, r=cv.r, s=cv.s, x=cv.x, y=cv.y,
                  stride=cv.stride, pad=cv.pad, groups=cv.groups)


def _plan_fields(plan):
    return dict(nf_block=plan.nf_block, c_block=plan.c_block,
                p_block=plan.p_block, grid=tuple(plan.grid),
                vmem_bytes=plan.vmem_bytes, groups=plan.groups)


# seeded mutations of a layer's clamped plan (field dict -> field dict)
PLAN_MUTATIONS = {
    "as planned": lambda f: f,
    "nf_block - 1": lambda f: dict(f, nf_block=f["nf_block"] - 1),
    "c_block + 1": lambda f: dict(f, c_block=f["c_block"] + 1),
    "p grid + 1": lambda f: dict(f, grid=(f["grid"][0], f["grid"][1],
                                          f["grid"][2] + 1)),
    "nf grid - 1": lambda f: dict(f, grid=(f["grid"][0] - 1, f["grid"][1],
                                           f["grid"][2])),
    "p_block x 2": lambda f: dict(f, p_block=2 * f["p_block"]),
    "groups + 1": lambda f: dict(f, groups=f["groups"] + 1),
}


@pytest.mark.parametrize("name", MODELS)
def test_zoo_graph_lint_and_fusion_match_reference(name):
    jmod, tmod, jparams, tparams, jnet, tnet, shape = _zoo(name)
    j_orig, t_orig = jmod.to_graph(), tmod.to_graph()
    _same_findings(j_an.lint_graph(j_orig, jparams, shape),
                   t_an.lint_graph(t_orig, tparams, shape))
    _same_findings(j_an.lint_graph(jnet.graph),
                   t_an.lint_graph(tnet.graph))
    _same_findings(j_an.check_fusion(j_orig, jnet.graph),
                   t_an.check_fusion(t_orig, tnet.graph))


@pytest.mark.parametrize("name", MODELS)
def test_zoo_plan_checks_match_reference(name):
    """Every conv's clamped plan as planned and under each seeded
    mutation, fp32 and int8 (the accumulator bound)."""
    _, _, _, tparams, jnet, tnet, shape = _zoo(name)
    jplans = {n: s.plan for n, s in jnet.layer_schedules}
    layers = _layers(tnet, tparams, shape)
    assert len(layers) == len(jplans)
    seen = set()
    for lname, cv, sched, _, _ in layers:
        plan = sched.plan.clamped(cv.nf, cv.c, cv.p)
        assert _plan_fields(sched.plan) == _plan_fields(jplans[lname])
        for mname, mutate in PLAN_MUTATIONS.items():
            fields = mutate(_plan_fields(plan))
            for precision in ("fp32", "int8"):
                j_rep = j_an.check_plan(_as_j(cv), J.Plan(**fields),
                                        where=lname, precision=precision)
                t_rep = t_an.check_plan(cv, T.Plan(**fields), where=lname,
                                        precision=precision)
                _same_findings(j_rep, t_rep)
                seen.update(f.code for f in t_rep.findings)
    # the mutations reach the rules, not only the clean path
    assert {"plan.grid-coverage", "plan.not-clamped",
            "plan.groups-mismatch"} <= seen


# seeded output index maps: every grid point on block 0 (a write race and
# a coverage gap wherever the grid has more than one output block), and
# every block one past the first axis (out of bounds everywhere)
OUT_MUTATIONS = {
    "aliased": lambda k: (lambda *pt: (0,) * k),
    "one past": lambda k: (lambda *pt: (10 ** 6,) + (0,) * (k - 1)),
}


@pytest.mark.parametrize("name", MODELS)
def test_zoo_kernel_specs_match_reference(name):
    """Every conv's launch as compiled, and with each seeded output index
    map."""
    _, _, _, tparams, _, tnet, shape = _zoo(name)
    for lname, cv, sched, epi, groups in _layers(tnet, tparams, shape):
        plan = sched.plan.clamped(cv.nf, cv.c, cv.p)
        args = ((cv.n, cv.c, cv.padded_x, cv.padded_y),
                (cv.nf, cv.c // groups, cv.r, cv.s))
        kw = dict(stride=cv.stride, dataflow=sched.dataflow, groups=groups)
        t_spec = T.spec(*args, plan=plan, epilogue=epi, **kw)
        j_spec = J.spec(*args, plan=J.Plan(**_plan_fields(plan)),
                        epilogue=(JEpilogue(**dataclasses.asdict(epi))
                                  if epi is not None else None), **kw)
        assert (t_spec.dataflow, t_spec.grid) == (j_spec.dataflow,
                                                  j_spec.grid)
        t_rep = t_an.check_kernel_spec(t_spec, where=lname)
        _same_findings(j_an.check_kernel_spec(j_spec, where=lname), t_rep)
        assert t_rep.ok
        for mname, make in OUT_MUTATIONS.items():
            bad = make(len(t_spec.output.block))
            j_rep = j_an.check_kernel_spec(dataclasses.replace(
                j_spec, output=dataclasses.replace(j_spec.output,
                                                   index_map=bad)),
                where=lname)
            t_rep = t_an.check_kernel_spec(dataclasses.replace(
                t_spec, output=dataclasses.replace(t_spec.output,
                                                   index_map=bad)),
                where=lname)
            _same_findings(j_rep, t_rep)
            if mname == "one past":
                assert t_rep.has("index.oob")


# --------------------------------------------------------------------------
# the JAX package's seeded violations, in both packages
# --------------------------------------------------------------------------

def _nests(m):
    return types.SimpleNamespace(
        dense=m.Nest(n=1, nf=64, c=32, r=3, s=3, x=16, y=16, stride=1,
                     pad=1),
        grouped=m.Nest(n=1, nf=32, c=32, r=3, s=3, x=16, y=16, stride=1,
                       pad=1, groups=4),
        dw=m.Nest(n=1, nf=32, c=32, r=3, s=3, x=16, y=16, stride=1, pad=1,
                  groups=32),
        ragged=m.Nest(n=1, nf=10, c=8, r=3, s=3, x=8, y=8, stride=1, pad=1),
        deep=m.Nest(n=1, nf=8, c=16384, r=3, s=3, x=4, y=4, stride=1,
                    pad=1))


def _planned(m, cv):
    return m.plan_conv_blocks(cv).clamped(cv.nf, cv.c, cv.p)


# case -> (build(m) -> Report, the code it must carry or None for clean)
PLAN_CASES = {
    "planner dense": (lambda m: m.an.check_plan(
        _nests(m).dense, _planned(m, _nests(m).dense)), None),
    "planner grouped": (lambda m: m.an.check_plan(
        _nests(m).grouped, _planned(m, _nests(m).grouped)), None),
    "planner depthwise": (lambda m: m.an.check_plan(
        _nests(m).dw, _planned(m, _nests(m).dw)), None),
    "ragged clamp": (lambda m: m.an.check_plan(
        _nests(m).ragged, _planned(m, _nests(m).ragged)), None),
    "group-straddle": (lambda m: m.an.check_plan(
        _nests(m).grouped, m.Plan(nf_block=8, c_block=6, p_block=16,
                                  grid=(4, 2, 1), vmem_bytes=0, groups=4)),
        "plan.group-straddle"),
    "mxu-align": (lambda m: m.an.check_plan(
        _nests(m).dense, m.Plan(nf_block=12, c_block=32, p_block=16,
                                grid=(6, 1, 1), vmem_bytes=0)),
        "plan.mxu-align"),
    "grid-coverage": (lambda m: m.an.check_plan(
        _nests(m).dense, m.Plan(nf_block=8, c_block=32, p_block=16,
                                grid=(1, 1, 1), vmem_bytes=0)),
        "plan.grid-coverage"),
    "not-clamped": (lambda m: m.an.check_plan(
        _nests(m).dense, m.Plan(nf_block=128, c_block=32, p_block=16,
                                grid=(1, 1, 1), vmem_bytes=0)),
        "plan.not-clamped"),
    "depthwise-shape": (lambda m: m.an.check_plan(
        _nests(m).dw, m.Plan(nf_block=16, c_block=8, p_block=16,
                             grid=(1, 4, 1), vmem_bytes=0, groups=32)),
        "plan.depthwise-shape"),
    "groups-mismatch": (lambda m: m.an.check_plan(
        _nests(m).grouped, m.plan_conv_blocks(_nests(m).dense)),
        "plan.groups-mismatch"),
    "int8 accumulator": (lambda m: m.an.check_plan(
        _nests(m).deep, _planned(m, _nests(m).deep), precision="int8"),
        "quant.acc-overflow"),
}


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_plan_check_seeded(case):
    build, code = PLAN_CASES[case]
    j_rep, t_rep = build(J), build(T)
    _same_findings(j_rep, t_rep)
    if code is None:
        assert t_rep.errors == []
    else:
        assert t_rep.has(code)


def _ws_spec(m, **kw):
    plan = m.Plan(nf_block=16, c_block=16, p_block=16, grid=(2, 1, 1),
                  vmem_bytes=0)
    return m.spec((1, 16, 18, 18), (32, 16, 3, 3), plan=plan, **kw)


def _replace_operand(spec, role, **attrs):
    if role == "out":
        return dataclasses.replace(
            spec, output=dataclasses.replace(spec.output, **attrs))
    inputs = tuple(dataclasses.replace(op, **attrs) if op.role == role
                   else op for op in spec.inputs)
    return dataclasses.replace(spec, inputs=inputs)


def _dw_spec(m):
    plan = m.Plan(nf_block=8, c_block=8, p_block=16, grid=(1, 4, 1),
                  vmem_bytes=0, groups=32)
    return m.spec((1, 32, 18, 18), (32, 1, 3, 3), groups=32,
                  dataflow="depthwise", plan=plan)


INDEX_CASES = {
    "clean ws": (lambda m: _ws_spec(m, dataflow="weight_stationary"),
                 None),
    "clean os": (lambda m: _ws_spec(m, dataflow="output_stationary"),
                 None),
    "clean depthwise": (lambda m: m.spec((1, 32, 18, 18), (32, 1, 3, 3),
                                         groups=32, dataflow="depthwise"),
                        None),
    "clean dw folds": (_dw_spec, None),
    "clean grouped": (lambda m: m.spec((1, 32, 18, 18), (32, 8, 3, 3),
                                       groups=4), None),
    "write-race": (lambda m: _replace_operand(
        _ws_spec(m), "out", index_map=lambda b, f, cc, pp: (b, 0, 0, 0)),
        "index.write-race"),
    "oob": (lambda m: _replace_operand(
        _ws_spec(m), "x", index_map=lambda b, f, cc, pp: (b, cc + 10, 0, 0)),
        "index.oob"),
    "dw-offset": (lambda m: _replace_operand(
        _dw_spec(m), "x", index_map=lambda b, cc, pp: (b, 0, 0, 0)),
        "index.dw-offset"),
    "group-offset": (lambda m: _replace_operand(
        m.spec((1, 32, 18, 18), (32, 8, 3, 3), groups=4), "x",
        index_map=lambda b, f, cc, pp: (b, 0, 0, 0)), "index.group-offset"),
    "block-align": (lambda m: _replace_operand(
        _ws_spec(m), "x", block=(1, 5, 18, 18)), "index.block-align"),
}


@pytest.mark.parametrize("case", sorted(INDEX_CASES))
def test_index_check_seeded(case):
    build, code = INDEX_CASES[case]
    j_rep = j_an.check_kernel_spec(build(J))
    t_rep = t_an.check_kernel_spec(build(T))
    _same_findings(j_rep, t_rep)
    if code is None:
        assert t_rep.errors == []
    else:
        assert t_rep.has(code)
        if code == "index.write-race":
            assert t_rep.has("index.coverage")


def _dead_node(m):
    g = m.StreamGraph()
    g.conv("c1", "x")
    g.conv("c2", "x")                    # output; c1 is now unreachable
    return m.an.lint_graph(g)


def _epilogue_conflict(m):
    g = m.StreamGraph()
    g.conv("c1", "x")
    _smuggle(g.node("c1"), epilogue=_smuggle(m.Epilogue(relu=True),
                                             relu6=True))
    return m.an.lint_graph(g)


def _pool_after_residual(m):
    orig = m.StreamGraph()
    orig.conv("c1", "x")
    orig.residual_add("r", "c1", "x")
    orig.maxpool2("m", "r")
    fused = m.StreamGraph()
    fused.conv("c1", "x")
    _smuggle(fused.node("c1"), residual="x",
             epilogue=_smuggle(m.Epilogue(residual=True), pool="max2"))
    return m.an.check_fusion(orig, fused)


def _sole_consumer(m):
    orig = m.StreamGraph()
    orig.conv("c1", "x")
    orig.relu("rl", "c1")
    orig.residual_add("r", "rl", "c1")   # c1 has two consumers
    fused = m.StreamGraph()
    fused.conv("c1", "x")
    _smuggle(fused.node("c1"), epilogue=m.Epilogue(relu=True))
    fused.residual_add("r", "c1", "c1")
    return m.an.check_fusion(orig, fused)


def _foreign_bias(m):
    orig = m.StreamGraph()
    orig.conv("c1", "x")
    orig.bias("b", "c1", param="other_layer")
    fused = m.StreamGraph()
    fused.conv("c1", "x")
    _smuggle(fused.node("c1"), epilogue=m.Epilogue(bias=True))
    return m.an.check_fusion(orig, fused)


def _legal_fusion(m):
    g = m.StreamGraph()
    g.conv("c1", "x")
    g.bias(None, "c1")
    g.relu("a1")
    g.conv("c2", "a1")
    g.bias(None, "c2")
    g.residual_add("r", "c2.bias", "a1")
    g.relu("a2", "r")
    return m.an.check_fusion(g, m.fuse_graph(g))


GRAPH_CASES = {
    "dead-node": (_dead_node, "graph.dead-node"),
    "epilogue-conflict": (_epilogue_conflict, "graph.epilogue-conflict"),
    "pool-after-residual": (_pool_after_residual,
                            "fusion.pool-after-residual"),
    "sole-consumer": (_sole_consumer, "fusion.sole-consumer"),
    "conv-own-bias": (_foreign_bias, "fusion.conv-own-bias"),
    "legal fusion": (_legal_fusion, None),
}


@pytest.mark.parametrize("case", sorted(GRAPH_CASES))
def test_graph_check_seeded(case):
    build, code = GRAPH_CASES[case]
    j_rep, t_rep = build(J), build(T)
    _same_findings(j_rep, t_rep)
    assert [f.message for f in t_rep.findings] == \
        [f.message for f in j_rep.findings]
    if code is None:
        assert t_rep.errors == []
    else:
        assert t_rep.has(code)


def test_report_and_error_have_the_reference_form():
    reps = []
    for m in (j_an, t_an):
        rep = m.Report()
        rep.add("plan.degenerate", "c1", "boom")
        rep.add("plan.smem-overflow", "c1", "tight", severity="warning")
        reps.append(rep)
    assert reps[1].as_dict() == reps[0].as_dict()
    assert reps[1].to_json() == reps[0].to_json()
    err = FoldLintError(reps[1].errors)
    assert isinstance(err, t_graph.GraphError)
    assert "plan.degenerate" in str(err) \
        and err.findings == (reps[1].errors[0],)


# --------------------------------------------------------------------------
# the residency rule and the CTA tiles of the card
# --------------------------------------------------------------------------

def test_residency_rule_reads_the_cta_tile():
    """The JAX package's plan.vmem-overflow case (a 1 KB budget) in the
    port: the same plan's launch is clean, and its CTA tile one byte over
    the shared memory a CTA may take is plan.smem-overflow."""
    cv = _nests(T).dense
    plan = _planned(T, cv)
    j_rep = j_an.check_plan(_nests(J).dense, _planned(J, _nests(J).dense),
                            vmem_limit=1024)
    assert j_rep.codes() == ["plan.vmem-overflow"]
    spec = T.spec((cv.n, cv.c, cv.padded_x, cv.padded_y),
                  (cv.nf, cv.c, cv.r, cv.s), plan=plan)
    tile = t_kern.fold_tile(spec, cv.n, SMS)
    assert t_an.check_plan(cv, plan).ok and check_tile_residency(tile).ok
    big = dataclasses.replace(tile, smem=t_kern.SMEM_LIMIT + 1)
    assert check_tile_residency(big).codes() == ["plan.smem-overflow"]


ZOO_SHAPES = [("vgg16", 1.0, 224, 1), ("vgg16", 1.0, 224, 4),
              ("vgg16", 1.0, 32, 4), ("resnet18", 1.0, 32, 1),
              ("resnet18", 1.0, 32, 4), ("mobilenetv2", 1.0, 32, 1),
              ("mobilenetv2", 1.0, 32, 4), ("vgg16", 0.0625, 32, 1),
              ("resnet18", 0.0625, 32, 1), ("mobilenetv2", 0.0625, 32, 1)]


@pytest.mark.parametrize("name,width,img,batch", ZOO_SHAPES)
def test_cta_tiles_clean_on_every_zoo_launch(name, width, img, batch):
    """Every WS / OS launch of the model at the smoke's shapes (full width)
    and at the foldlint footprint, in fp32 and int8: the tile fold_tile
    picks at 132 SMs covers every pixel and filter once, and fits."""
    tmod = importlib.import_module(f"repro_torch.models.{ZOO_MODULE[name]}")
    params = tmod.init_params(torch.Generator(), width_mult=width, img=img,
                              classes=10, device="meta")
    net = tmod.compile_forward(params, img=img, batch=batch,
                               policy="kernel", device="meta", verify=False)
    tiled = 0
    for lname, cv, sched, epi, groups in _layers(net, params,
                                                 (batch, 3, img, img)):
        plan = sched.plan.clamped(cv.nf, cv.c, cv.p)
        for e in (epi, requant_epilogue(epi)):
            spec = T.spec((cv.n, cv.c, cv.padded_x, cv.padded_y),
                          (cv.nf, cv.c // groups, cv.r, cv.s),
                          stride=cv.stride, plan=plan,
                          dataflow=sched.dataflow, epilogue=e,
                          groups=groups)
            rep = check_launch_tile(spec, cv.n, SMS, where=lname)
            assert rep.findings == [], [str(f) for f in rep.findings]
            tiled += spec.dataflow != "depthwise"
    assert tiled > 0


def _spec_of(cv, dataflow, epi=None):
    plan = T.plan_conv_blocks(cv).clamped(cv.nf, cv.c, cv.p)
    return T.spec((cv.n, cv.c, cv.padded_x, cv.padded_y),
                  (cv.nf, cv.c // cv.groups, cv.r, cv.s), stride=cv.stride,
                  plan=plan, dataflow=dataflow, epilogue=epi,
                  groups=cv.groups)


def _os_spec():
    # a VGG-16 conv at 32, batch 4: more than one M tile
    return _spec_of(T.Nest(n=4, nf=256, c=128, r=3, s=3, x=8, y=8,
                           stride=1, pad=1), "output_stationary")


def _ws_big_spec():
    return _spec_of(T.Nest(n=1, nf=64, c=64, r=3, s=3, x=224, y=224,
                           stride=1, pad=1), "weight_stationary",
                    TEpilogue(bias=True, relu=True))


def _grouped_spec():
    return _spec_of(_nests(T).grouped, "weight_stationary")


def _psum_spec():
    cv = T.Nest(n=1, nf=64, c=256, r=3, s=3, x=28, y=28, stride=1, pad=1)
    plan = T.Plan(nf_block=64, c_block=64, p_block=28, grid=(1, 4, 1),
                  vmem_bytes=0)
    return T.spec((cv.n, cv.c, cv.padded_x, cv.padded_y),
                  (cv.nf, cv.c, 3, 3), plan=plan,
                  dataflow="weight_stationary_psum")


def _grouped_wide_tile(spec):
    """A grouped launch's tile 4 (16 filters) recast as if the layer were
    dense: its filter tiles run across the 8-filter groups."""
    tile = t_kern.fold_tile(spec, 1, SMS, index=4)
    return dataclasses.replace(tile, groups=1, nfg=spec.nf_pad,
                               n_tiles=math.ceil(spec.nf_pad / tile.bn))


# case -> (spec, seeded tile from the picked one, the code it must carry)
TILE_CASES = {
    "last M tile uncovered, OS": (
        _os_spec, lambda s, t: dataclasses.replace(
            t, grid=(t.grid[0] - 1, t.grid[1])), "tile.m-coverage"),
    "last M tile uncovered, WS": (
        _ws_big_spec, lambda s, t: dataclasses.replace(
            t, grid=(t.grid[0] - 1, t.grid[1])), "tile.m-coverage"),
    "M tiles miscounted": (
        _ws_big_spec, lambda s, t: dataclasses.replace(
            t, m_tiles=t.m_tiles - 1), "tile.m-coverage"),
    "filter tile across a group": (
        _grouped_spec, lambda s, t: _grouped_wide_tile(s),
        "tile.group-straddle"),
    "filter tile missing": (
        _grouped_spec, lambda s, t: dataclasses.replace(
            t, n_tiles=t.n_tiles - t.groups), "tile.n-coverage"),
    "psum folds short": (
        _psum_spec, lambda s, t: dataclasses.replace(t, folds=t.folds - 1),
        "tile.fold-coverage"),
    "shape off its TILES entry": (
        _os_spec, lambda s, t: dataclasses.replace(t, bm=t.bm // 2),
        "tile.shape"),
}


@pytest.mark.parametrize("case", sorted(TILE_CASES))
def test_cta_tile_check_flags_seeded_tiles(case):
    make_spec, seed, code = TILE_CASES[case]
    spec = make_spec()
    n = spec.inputs[0].array_shape[0]
    tile = t_kern.fold_tile(spec, n, SMS)
    assert check_launch_tile(spec, n, SMS, tile=tile).ok
    rep = check_launch_tile(spec, n, SMS, tile=seed(spec, tile))
    assert rep.has(code), [str(f) for f in rep.findings]


def test_cta_tile_check_flags_a_launch_no_tile_fits():
    """A 7x7 depth fold of 512 channels: its resident filter tile alone
    exceeds a CTA's shared memory at every tile of TILES."""
    cv = T.Nest(n=1, nf=64, c=512, r=7, s=7, x=14, y=14, stride=1, pad=3)
    plan = T.Plan(nf_block=64, c_block=512, p_block=14, grid=(1, 1, 1),
                  vmem_bytes=0)
    spec = T.spec((1, 512, cv.padded_x, cv.padded_y), (64, 512, 7, 7),
                  plan=plan, dataflow="weight_stationary")
    assert t_kern.tile_candidates(spec, 1, SMS) == []
    assert check_launch_tile(spec, 1, SMS).codes() == ["plan.smem-overflow"]


def test_cta_tile_check_skips_depthwise():
    spec = T.spec((1, 32, 18, 18), (32, 1, 3, 3), groups=32,
                  dataflow="depthwise")
    assert check_launch_tile(spec, 1, SMS).findings == []


# --------------------------------------------------------------------------
# compile_network(verify=True)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["compile_network", "BucketCompiler"])
def test_verify_defaults_to_true_as_in_the_reference(name):
    got = inspect.signature(getattr(t_engine, name)).parameters["verify"]
    want = inspect.signature(getattr(j_engine, name)).parameters["verify"]
    assert got.default is True and want.default is True
    assert got.kind == want.kind == inspect.Parameter.KEYWORD_ONLY


def _one_conv(nf=64, c=8, seed=0):
    g = t_graph.StreamGraph()
    g.conv("c1", "x", pad=1)
    rng = np.random.default_rng(seed)
    params = {"c1": {"w": torch.from_numpy(
        rng.standard_normal((nf, c, 3, 3)).astype(np.float32)),
        "b": torch.zeros(nf)}}
    return g, params


class _BadPlanCache(t_engine.ScheduleCache):
    """A schedule cache that hands out a filter fold of 12 (not lane
    aligned, and clamping keeps it)."""

    def schedule_for(self, cv, precision="fp32"):
        sched = super().schedule_for(cv, precision=precision)
        return dataclasses.replace(sched, plan=dataclasses.replace(
            sched.plan, nf_block=12))


def _count_fold_calls(monkeypatch):
    calls = []
    real = t_ops.conv2d_folded

    def counted(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)
    monkeypatch.setattr(t_ops, "conv2d_folded", counted)
    return calls


def test_verify_refuses_a_seeded_bad_plan_before_any_fold_call(monkeypatch):
    calls = _count_fold_calls(monkeypatch)
    g, params = _one_conv()
    with pytest.raises(FoldLintError) as ei:
        t_engine.compile_network(params, g, (1, 8, 8, 8),
                                 cache=_BadPlanCache(), device="cpu")
    assert [f.code for f in ei.value.findings] == ["plan.mxu-align"]
    assert calls == []
    net = t_engine.compile_network(params, g, (1, 8, 8, 8),
                                   cache=_BadPlanCache(), device="cpu",
                                   verify=False)
    assert net(params, torch.zeros(1, 8, 8, 8)).shape == (1, 64, 8, 8)
    assert len(calls) == 1


def test_verify_gates_a_smuggled_graph():
    g, params = _one_conv()
    _smuggle(g.node("c1"), epilogue=_smuggle(TEpilogue(relu=True),
                                             relu6=True))
    with pytest.raises(FoldLintError) as ei:
        t_engine.compile_network(params, g, (1, 8, 8, 8), device="cpu",
                                 fuse_epilogues=False)
    assert any(f.code == "graph.epilogue-conflict"
               for f in ei.value.findings)
    net = t_engine.compile_network(params, g, (1, 8, 8, 8), device="cpu",
                                   fuse_epilogues=False, verify=False)
    assert len(net.layer_schedules) == 1


def test_second_compile_is_a_memo_hit(monkeypatch):
    from repro_torch.analysis import plan_check
    g, params = _one_conv(nf=24, c=5, seed=1)
    shape = (3, 5, 10, 10)        # a geometry no other test compiles
    t_engine.compile_network(params, g, shape, device="cpu")
    proofs = []
    real = plan_check.check_plan
    monkeypatch.setattr(plan_check, "check_plan",
                        lambda *a, **k: proofs.append(1) or real(*a, **k))
    size = len(t_engine._VERIFIED_SCHEDULES)
    net = t_engine.compile_network(params, g, shape, device="cpu")
    assert proofs == [] and len(t_engine._VERIFIED_SCHEDULES) == size
    assert net.verify_s >= 0.0
    t_engine.compile_network(params, g, (4,) + shape[1:], device="cpu")
    assert proofs == [1]          # a new batch is a new geometry


# --------------------------------------------------------------------------
# the launch audit and the CLI
# --------------------------------------------------------------------------

# fold calls per forward by kernel at the foldlint footprint (img 32)
LAUNCHES = {"vgg16": {"fold_conv_ws": 2, "fold_conv_os": 11},
            "resnet18": {"fold_conv_ws": 5, "fold_conv_os": 15},
            "mobilenetv2": {"fold_conv_dw": 17, "fold_conv_ws": 7,
                            "fold_conv_os": 28}}


def _cpu_net(name, **kw):
    spec = t_zoo.get_conv_model(name)
    params = spec.init_params(torch.Generator().manual_seed(0),
                              width_mult=0.0625, img=32, classes=10,
                              device="cpu")
    net = t_zoo.compile_forward(name, params, img=32, batch=1, jit=False,
                                device="cpu", **kw)
    return net, params


@pytest.mark.parametrize("name", MODELS)
def test_audit_counts_one_fold_call_per_conv(name):
    net, params = _cpu_net(name)
    audit = t_an.audit_launches(net, params, (1, 3, 32, 32))
    assert audit.ok, [str(f) for f in audit.findings]
    assert audit.fold_calls == audit.conv_layers == len(net.layer_schedules)
    assert audit.launches == LAUNCHES[name]
    assert all(audit.op4d(op) == 0
               for op in ("add", "mul", "relu", "clamp", "amax"))


def test_audit_of_int8_names_the_int8_kernels():
    net, params = _cpu_net("vgg16", precision="int8")
    audit = t_an.audit_launches(net, params, (1, 3, 32, 32))
    assert audit.ok, [str(f) for f in audit.findings]
    assert audit.launches == {"fold_conv_ws_i8": 2, "fold_conv_os_i8": 11}


def test_audit_sees_the_unfused_networks_standalone_ops():
    """MobileNetV2 compiled without the fusion pass: the standalone
    relu6s (stem + head + 2 a block, 1 for the t=1 block: 35, the JAX
    package's count of its clips) run outside the convs; an unfused
    network is not flagged."""
    net, params = _cpu_net("mobilenetv2", fuse_epilogues=False)
    audit = t_an.audit_launches(net, params, (1, 3, 32, 32))
    assert audit.fold_calls == 52 and audit.op4d("clamp") == 35
    assert audit.ok


def _fake_net(eager, layers=1, mode="kernel", fused=True):
    return types.SimpleNamespace(
        eager=eager, apply=eager, mode=mode, fused=fused,
        device=torch.device("cpu"),
        layer_schedules=[(f"c{i}", None) for i in range(layers)])


def test_audit_flags_a_seeded_unfused_add():
    audit = t_an.audit_launches(_fake_net(lambda p, x: (x + 1.0) * 2.0),
                                {}, (1, 3, 8, 8))
    assert not audit.ok
    assert set(audit.findings.codes()) == {"audit.launch-count",
                                           "audit.unfused-op"}
    assert audit.fold_calls == 0 and audit.conv_layers == 1
    assert audit.op4d("add") == 1 and audit.op4d("mul") == 1


def test_audit_ignores_non_4d_math():
    audit = t_an.audit_launches(
        _fake_net(lambda p, x: x @ x.T + 1.0, mode="reference"), {}, (8, 8))
    assert audit.ok and audit.op4d("add") == 0 and audit.top("add") == 1


def test_foldlint_cli_clean_on_the_zoo_on_the_cpu(capsys):
    assert t_foldlint.main(["--model", "all", "--device", "cpu",
                            "--json"]) == 0
    rows = [json.loads(line) for line in
            capsys.readouterr().out.strip().splitlines()]
    assert [r["model"] for r in rows] == list(MODELS)
    for r in rows:
        assert r["ok"] and r["audited"] and r["sm_count"] == SMS
        assert r["fold_calls"] == r["conv_layers"]
        assert r["launches"] == LAUNCHES[r["model"]]
        assert r["report"]["errors"] == 0


def test_foldlint_cli_defaults_to_the_card():
    args = t_foldlint.parser().parse_args([])
    assert (args.device, args.model, args.img, args.width_mult) == \
        ("cuda", "all", 32, 0.0625)
