"""The port's planning layer against the JAX package's: perf model, block
plans, dataflow costs, schedule tables and kernel launch specs must be
identical.  Shape arithmetic only: JAX params come from ``jax.eval_shape``
and the port's live on the ``meta`` device."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import engine as j_engine  # noqa: E402
from repro.core import loopnest as j_loopnest  # noqa: E402
from repro.core import mapping as j_mapping  # noqa: E402
from repro.core import perfmodel as j_perf  # noqa: E402
from repro.core.epilogue import Epilogue as JEpilogue  # noqa: E402
from repro.core.folds import PEArray as JPEArray  # noqa: E402
from repro.kernels import conv2d_ws as j_kern  # noqa: E402
from repro.models import vgg as j_vgg  # noqa: E402
from repro_torch.core import engine as t_engine  # noqa: E402
from repro_torch.core import loopnest as t_loopnest  # noqa: E402
from repro_torch.core import mapping as t_mapping  # noqa: E402
from repro_torch.core import perfmodel as t_perf  # noqa: E402
from repro_torch.core.epilogue import Epilogue as TEpilogue  # noqa: E402
from repro_torch.core.folds import PEArray as TPEArray  # noqa: E402
from repro_torch.kernels import conv2d_ws as t_kern  # noqa: E402
from repro_torch.models import vgg as t_vgg  # noqa: E402

PE_ARRAYS = ((16, 16), (32, 32), (64, 64))


def _pairs():
    """The VGG-16 conv nests in both packages, at batch 1 and 4."""
    out = []
    for (jn, jcv), (tn, tcv) in zip(j_loopnest.vgg16_conv_layers(),
                                    t_loopnest.vgg16_conv_layers()):
        assert jn == tn
        for n in (1, 4):
            out.append((jcv.with_batch(n), tcv.with_batch(n)))
    return out


def _plan(p):
    return (p.nf_block, p.c_block, p.p_block, tuple(p.grid), p.vmem_bytes,
            p.groups)


@pytest.mark.parametrize("rp,cp", PE_ARRAYS)
def test_layer_perf_and_kips_identical(rp, cp):
    layers_j = [cv for _, cv in j_loopnest.vgg16_conv_layers()]
    layers_t = [cv for _, cv in t_loopnest.vgg16_conv_layers()]
    for jcv, tcv in zip(layers_j, layers_t):
        assert (j_perf.layer_perf(jcv, JPEArray(rp, cp)).as_dict()
                == t_perf.layer_perf(tcv, TPEArray(rp, cp)).as_dict())
    assert (j_perf.kips(layers_j, JPEArray(rp, cp))
            == t_perf.kips(layers_t, TPEArray(rp, cp)))


def test_plans_costs_and_dataflow_identical():
    for jcv, tcv in _pairs():
        jp, tp = j_mapping.plan_conv_blocks(jcv), t_mapping.plan_conv_blocks(tcv)
        assert _plan(jp) == _plan(tp)
        assert _plan(jp.clamped(jcv.nf, jcv.c, 7)) == \
            _plan(tp.clamped(tcv.nf, tcv.c, 7))
        assert (j_engine.dataflow_traffic_bytes(jcv, jp)
                == t_engine.dataflow_traffic_bytes(tcv, tp))
        jc, tc = j_engine.dataflow_costs(jcv, jp), t_engine.dataflow_costs(tcv, tp)
        assert jc == tc
        assert (j_engine.select_dataflow(jcv, jp)
                == t_engine.select_dataflow(tcv, tp))
        assert (j_mapping.conv_working_set(jcv, 8, 16, 3)
                == t_mapping.conv_working_set(tcv, 8, 16, 3))
    assert j_mapping.WS_ACC_BYTES_LIMIT == t_mapping.WS_ACC_BYTES_LIMIT
    for n, cap in ((12, 5), (7, 7), (64, 10), (1, 3)):
        assert (j_mapping.largest_divisor_le(n, cap)
                == t_mapping.largest_divisor_le(n, cap))


def _spec_fields(spec):
    ops = tuple((o.role, o.block, o.array_shape,
                 getattr(o.index_map, "func", o.index_map).__name__,
                 getattr(o.index_map, "keywords", {}))
                for o in spec.inputs + (spec.output,))
    skip = {"inputs", "output", "plan", "epilogue"}
    scalar = {f: getattr(spec, f) for f in spec.__dataclass_fields__
              if f not in skip}
    return scalar, ops, _plan(spec.plan), str(spec.epilogue)


def _compiled(width, img, batch=1):
    jparams = jax.eval_shape(
        lambda k: j_vgg.init_params(k, width_mult=width, img=img,
                                    classes=10), jax.random.PRNGKey(0))
    jnet = j_vgg.compile_forward(jparams, img=img, batch=batch,
                                 policy="pallas", verify=False)
    tparams = t_vgg.init_params(torch.Generator(), width_mult=width,
                                img=img, classes=10, device="meta")
    tnet = t_vgg.compile_forward(tparams, img=img, batch=batch,
                                 policy="kernel", device="meta")
    return jnet, tnet


@pytest.mark.parametrize("width,img", [(0.0625, 32), (0.0625, 224),
                                       (1.0, 32), (1.0, 224)])
def test_schedule_table_and_launch_specs_identical(width, img):
    jnet, tnet = _compiled(width, img)
    assert jnet.fold_reuse() == tnet.fold_reuse()
    assert len(jnet.layer_schedules) == len(tnet.layer_schedules) == 13
    for (jn, js), (tn, ts) in zip(jnet.layer_schedules, tnet.layer_schedules):
        assert jn == tn and str(js.key) == str(ts.key)
        assert (js.dataflow, _plan(js.plan), js.costs) == \
            (ts.dataflow, _plan(ts.plan), ts.costs)
    jconvs = [nd for nd in jnet.graph.nodes if nd.op == "conv"]
    tconvs = [nd for nd in tnet.graph.nodes if nd.op == "conv"]
    h = img
    for jnd, tnd, (_, js), (_, ts) in zip(jconvs, tconvs,
                                          jnet.layer_schedules,
                                          tnet.layer_schedules):
        assert str(jnd.epilogue) == str(tnd.epilogue)
        cv = js.nest
        xs, ws = (1, cv.c, h + 2, h + 2), (cv.nf, cv.c, 3, 3)
        assert _spec_fields(j_kern.fold_kernel_spec(
            xs, ws, plan=js.plan, dataflow=js.dataflow,
            epilogue=jnd.epilogue)) == _spec_fields(t_kern.fold_kernel_spec(
                xs, ws, plan=ts.plan, dataflow=ts.dataflow,
                epilogue=tnd.epilogue))
        if jnd.epilogue.pool:
            h //= 2
    if (width, img) == (1.0, 224):
        fr = tnet.fold_reuse()
        assert (fr["conv_layers"], fr["distinct_schedules"], fr["hits"],
                fr["misses"]) == (13, 8, 5, 8)
        assert all(s.dataflow == "weight_stationary"
                   for _, s in tnet.layer_schedules)
        # conv3_3: the pool bumps p_block from 9 to 10, and the bottom rows
        # the last fold reads lie past the padded input
        name, s33 = tnet.layer_schedules[6]
        spec = t_kern.fold_kernel_spec(
            (1, 256, 58, 58), (256, 256, 3, 3), plan=s33.plan,
            epilogue=TEpilogue(bias=True, relu=True, pool="max2"))
        assert name == "conv3_3" and s33.plan.p_block == 9
        assert (spec.p_block, spec.p_pad, spec.x_rows) == (10, 60, 62)


@pytest.mark.parametrize("x_shape,w_shape,groups,dataflow,epi", [
    ((1, 8, 10, 10), (8, 1, 3, 3), 8, "depthwise", {}),
    ((2, 8, 9, 9), (12, 2, 3, 3), 4, "weight_stationary", {"bias": True}),
    ((1, 6, 12, 12), (10, 6, 3, 3), 1, "weight_stationary_psum", {}),
    ((1, 64, 1026, 258), (256, 64, 3, 3), 1, "weight_stationary",
     {"bias": True, "relu": True}),              # WS spill -> OS
    ((1, 64, 1026, 258), (256, 64, 3, 3), 1, "weight_stationary", {}),
    ((3, 5, 11, 8), (7, 5, 3, 3), 1, "output_stationary",
     {"bias": True, "relu": True, "pool": "max2"}),
])
def test_fold_kernel_spec_identical_off_the_vgg_path(x_shape, w_shape, groups,
                                                     dataflow, epi):
    """The spec arithmetic is ported whole, unported dataflows included."""
    assert _spec_fields(j_kern.fold_kernel_spec(
        x_shape, w_shape, dataflow=dataflow, epilogue=JEpilogue(**epi),
        groups=groups)) == _spec_fields(t_kern.fold_kernel_spec(
            x_shape, w_shape, dataflow=dataflow, epilogue=TEpilogue(**epi),
            groups=groups))


def _zoo_compiled(model, width):
    """Planning only: the JAX package's and the port's compiled networks
    for a zoo model at img 32, from parameter shapes alone."""
    import importlib
    jmod = importlib.import_module(f"repro.models.{model}")
    tmod = importlib.import_module(f"repro_torch.models.{model}")
    jparams = jax.eval_shape(
        lambda k: jmod.init_params(k, width_mult=width, img=32, classes=10),
        jax.random.PRNGKey(0))
    jnet = jmod.compile_forward(jparams, img=32, batch=1,
                                policy="pallas", verify=False)
    tparams = tmod.init_params(torch.Generator(), width_mult=width, img=32,
                               classes=10, device="meta")
    tnet = tmod.compile_forward(tparams, img=32, batch=1, policy="kernel",
                                device="meta")
    return jnet, tnet, tmod


@pytest.mark.parametrize("model,width,reuse", [
    ("mobilenet", 0.0625, (52, 27, 25)), ("mobilenet", 1.0, (52, 30, 22)),
    ("resnet", 0.0625, (20, 11, 9)), ("resnet", 1.0, (20, 11, 9))])
def test_zoo_schedule_tables_and_launch_specs_identical(model, width, reuse):
    """Layer by layer: schedule key, dataflow, plan and costs, the fused
    epilogue, and the fold kernel spec at the layer's own shape."""
    jnet, tnet, tmod = _zoo_compiled(model, width)
    fr = tnet.fold_reuse()
    assert (fr["conv_layers"], fr["distinct_schedules"], fr["hits"]) == \
        reuse == (tmod.n_convs(), reuse[1], reuse[2])
    assert jnet.fold_reuse() == fr
    assert len(jnet.layer_schedules) == len(tnet.layer_schedules)
    for (jn, js), (tn, ts) in zip(jnet.layer_schedules, tnet.layer_schedules):
        assert jn == tn and str(js.key) == str(ts.key)
        assert (js.dataflow, _plan(js.plan), js.costs) == \
            (ts.dataflow, _plan(ts.plan), ts.costs)
    # the port's describe() lists every layer with its key and dataflow
    rows = tnet.describe().splitlines()[1:]
    assert [r.split()[:3] for r in rows] == \
        [[n, str(s.key), s.dataflow] for n, s in tnet.layer_schedules]
    jepis = {nd.name: nd.epilogue for nd in jnet.graph.nodes
             if nd.op == "conv"}
    nests = dict(tnet.layer_nests)
    for tnd in (nd for nd in tnet.graph.nodes if nd.op == "conv"):
        assert str(jepis[tnd.name]) == str(tnd.epilogue)
        sched = dict(tnet.layer_schedules)[tnd.name]
        cv = nests[tnd.name]
        xs = (1, cv.c, cv.x + 2 * cv.pad, cv.y + 2 * cv.pad)
        ws = (cv.nf, cv.c // cv.groups, cv.r, cv.s)
        kw = dict(stride=cv.stride, plan=sched.plan,
                  dataflow=sched.dataflow, groups=cv.groups)
        assert _spec_fields(j_kern.fold_kernel_spec(
            xs, ws, epilogue=jepis[tnd.name], **kw)) == \
            _spec_fields(t_kern.fold_kernel_spec(xs, ws,
                                                 epilogue=tnd.epilogue, **kw))
    if (model, width) == ("mobilenet", 1.0):
        # b11_dw .. b16_dw: c_block 512 on 576 or 960 channels pads to 1024
        for i in range(11, 17):
            cv = nests[f"b{i}_dw"]
            spec = t_kern.fold_kernel_spec(
                (1, cv.c, cv.x + 2, cv.y + 2), (cv.nf, 1, 3, 3),
                stride=cv.stride, plan=dict(tnet.layer_schedules)[
                    f"b{i}_dw"].plan, dataflow="depthwise", groups=cv.c)
            assert cv.c in (576, 960) and spec.c_pad == 1024
