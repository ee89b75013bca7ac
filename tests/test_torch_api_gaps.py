"""The port's entry points that the JAX package has and the port lacked
(ROADMAP queue C, item C4), against the reference's: each with the
reference's parameter names, kinds and defaults (``inspect.signature``)
and the reference's result on the same inputs.

* ``kernels/ops.conv1d_causal(x, w, impl=None)``
* ``core/engine.plan_and_dataflow(cv, cfg=None, precision="fp32")``
* ``core/graph.lower(graph, params, input_shape, **compile_kw)``
* ``models/zoo.ConvModelSpec.graph()``

and the package-level names of ``repro.kernels`` (C5):
``conv1d_causal``, ``conv2d``, ``flash_attention_folded``, and
``kernels/conv2d_ws.default_plan``.
"""
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.core import engine as j_engine  # noqa: E402
from repro.core import graph as j_graph  # noqa: E402
from repro.core.loopnest import ConvLoopNest as JNest  # noqa: E402
from repro.kernels import ops as j_ops  # noqa: E402
from repro.models import zoo as j_zoo  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import engine as t_engine  # noqa: E402
from repro_torch.core import graph as t_graph  # noqa: E402
from repro_torch.core.loopnest import ConvLoopNest as TNest  # noqa: E402
from repro_torch.kernels import ops as t_ops  # noqa: E402
from repro_torch.models import zoo as t_zoo  # noqa: E402

IMG, WIDTH, CLASSES = 32, 0.0625, 10


def _params_of(fn):
    """(name, kind, default) of each parameter; annotations aside."""
    return [(p.name, p.kind, p.default)
            for p in inspect.signature(fn).parameters.values()]


@pytest.mark.parametrize("name", ["conv1d_causal", "plan_and_dataflow",
                                  "lower", "ConvModelSpec.graph"])
def test_signature_matches_reference(name):
    pairs = {"conv1d_causal": (t_ops.conv1d_causal, j_ops.conv1d_causal),
             "plan_and_dataflow": (t_engine.plan_and_dataflow,
                                   j_engine.plan_and_dataflow),
             "lower": (t_graph.lower, j_graph.lower),
             "ConvModelSpec.graph": (t_zoo.ConvModelSpec.graph,
                                     j_zoo.ConvModelSpec.graph)}
    got, want = pairs[name]
    assert _params_of(got) == _params_of(want)


@pytest.mark.parametrize("impl", [None, "ref"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv1d_causal_impl_matches_reference(impl, dtype):
    """On a CPU tensor ``impl=None`` and ``"ref"`` are the plain version:
    the reference's numbers bit for bit (its ``"ref"``, which is its CPU
    default)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 9, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jx = jax.numpy.asarray(x).astype(dtype)
    got = t_ops.conv1d_causal(tx, torch.from_numpy(w), impl=impl)
    want = j_ops.conv1d_causal(jx, jax.numpy.asarray(w), impl=impl)
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype("float32")))


def test_conv1d_causal_fold_needs_a_cuda_tensor():
    """``impl="fold"`` forces the kernel: on a CPU tensor it raises, and
    never runs the plain version in its place."""
    x, w = torch.zeros(1, 4, 8), torch.zeros(3, 8)
    with pytest.raises(ValueError, match="CUDA"):
        t_ops.conv1d_causal(x, w, impl="fold")
    with pytest.raises(ValueError, match="unknown conv1d impl"):
        t_ops.conv1d_causal(x, w, impl="xla")


# conv loop nests of the zoo: VGG 3x3, a stride-2 1x1 projection, a
# depthwise 3x3, an expand 1x1 at width, a small late layer
NESTS = [dict(n=1, nf=64, c=64, r=3, s=3, x=224, y=224, stride=1, pad=1),
         dict(n=4, nf=128, c=64, r=1, s=1, x=16, y=16, stride=2, pad=0),
         dict(n=4, nf=144, c=144, r=3, s=3, x=32, y=32, stride=2, pad=1,
              groups=144),
         dict(n=4, nf=192, c=32, r=1, s=1, x=32, y=32, stride=1, pad=0),
         dict(n=2, nf=512, c=512, r=3, s=3, x=4, y=4, stride=1, pad=1)]


@pytest.mark.parametrize("precision", ["fp32", "int8"])
@pytest.mark.parametrize("nest", NESTS, ids=lambda d: "x".join(
    str(d[k]) for k in ("nf", "c", "r", "x", "stride")))
def test_plan_and_dataflow_precision_matches_reference(nest, precision):
    tp, tdf = t_engine.plan_and_dataflow(TNest(**nest), precision=precision)
    jp, jdf = j_engine.plan_and_dataflow(JNest(**nest), precision=precision)
    assert tdf == jdf
    assert (tp.nf_block, tp.c_block, tp.p_block, tuple(tp.grid)) == \
        (jp.nf_block, jp.c_block, jp.p_block, tuple(jp.grid))


@pytest.mark.parametrize("model", ["vgg16", "resnet18", "mobilenetv2"])
def test_spec_graph_and_lower_match_reference(model):
    """``ConvModelSpec.graph()`` exports the reference's graph (node by
    node), and ``lower`` compiles it as ``compile_network`` does: the
    reference's logits on the same weights, and the port's own
    ``compile_network`` bit for bit."""
    tspec, jspec = t_zoo.get_conv_model(model), j_zoo.get_conv_model(model)
    tg, jg = tspec.graph(), jspec.graph()
    assert [(n.name, n.op, n.inputs) for n in tg.nodes] == \
        [(n.name, n.op, n.inputs) for n in jg.nodes]
    jp = jspec.init_params(jax.random.PRNGKey(0), width_mult=WIDTH,
                           img=IMG, classes=CLASSES)
    tp = params_from_jax(jp, device="cpu")
    shape = (2, 3, IMG, IMG)
    x = np.random.default_rng(5).standard_normal(shape).astype(np.float32)
    got = t_graph.lower(tg, tp, shape, policy="reference", device="cpu")
    want = j_graph.lower(jg, jp, shape, policy="reference")
    assert got.layer_keys and len(got.layer_keys) == len(want.layer_schedules)
    y = got(tp, torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(want(jp, x)),
                               rtol=1e-4, atol=1e-4 * max(
                                   1.0, float(np.abs(y.numpy()).max())))
    direct = t_engine.compile_network(tp, tg, shape, policy="reference",
                                      device="cpu", cache=got.cache)
    assert torch.equal(direct(tp, torch.from_numpy(x)), y)


def test_kernels_package_exports_the_reference_names():
    """``repro_torch.kernels`` exports what ``repro.kernels`` does, each
    name the port's op of that name."""
    import repro.kernels as j_kernels
    import repro_torch.kernels as t_kernels
    from repro_torch.kernels import attention_fold as t_af
    assert sorted(t_kernels.__all__) == sorted(j_kernels.__all__)
    assert t_kernels.conv2d is t_ops.conv2d
    assert t_kernels.conv1d_causal is t_ops.conv1d_causal
    assert t_kernels.flash_attention_folded is t_af.flash_attention_folded
    # the JAX op's q_block / k_block / interpret (Pallas tiles and
    # interpret mode) are not accepted: the CUDA kernel picks its tiles
    j_names = set(inspect.signature(
        j_kernels.flash_attention_folded).parameters)
    t_names = set(inspect.signature(
        t_kernels.flash_attention_folded).parameters)
    assert j_names - t_names == {"q_block", "k_block", "interpret"}
    assert t_names <= j_names


@pytest.mark.parametrize("nest", NESTS, ids=lambda d: "x".join(
    str(d[k]) for k in ("nf", "c", "r", "x", "stride")))
def test_default_plan_matches_reference(nest):
    from repro.kernels import conv2d_ws as j_cw
    from repro_torch.kernels import conv2d_ws as t_cw
    assert "default_plan" in t_cw.__all__
    assert _params_of(t_cw.default_plan) == _params_of(j_cw.default_plan)
    tp = t_cw.default_plan(TNest(**nest))
    jp = j_cw.default_plan(JNest(**nest))
    assert (tp.nf_block, tp.c_block, tp.p_block, tuple(tp.grid)) == \
        (jp.nf_block, jp.c_block, jp.p_block, tuple(jp.grid))


# --------------------------------------------------------------------------
# the training slice: every module against its JAX counterpart
# --------------------------------------------------------------------------

# (module in both packages, the names the port defers: the dry-run's
# abstract state, the mesh's axes and the collective, all scale-out work)
TRAIN_MODULES = [
    ("optim.adamw", set()),
    ("optim.schedules", set()),
    ("ckpt.checkpoint", set()),
    ("data.pipeline", set()),
    ("distributed.compression", set()),
    ("train.steps", set()),
    ("train.trainer", set()),
    ("train.evaluate", set()),
    ("models.settings", set()),
]
# (module, qualified name, the port's extra trailing parameters)
TRAIN_FUNCS = [
    # on a mesh, the state's layouts, each leaf laid out as it is made
    ("optim.adamw", "init_opt_state", ("shardings",)),
    ("optim.adamw", "adamw_update", ()),
    ("optim.adamw", "global_norm", ()),
    ("optim.schedules", "warmup_cosine", ()),
    ("optim.schedules", "constant", ()),
    ("ckpt.checkpoint", "save_checkpoint", ()),
    ("ckpt.checkpoint", "restore_checkpoint", ()),
    ("ckpt.checkpoint", "latest_step", ()),
    ("ckpt.checkpoint", "cleanup_old", ()),
    ("data.pipeline", "TokenPipeline.__init__", ()),
    ("data.pipeline", "TokenPipeline.next_batch", ()),
    ("data.pipeline", "TokenPipeline.state", ()),
    ("data.pipeline", "TokenPipeline.restore", ()),
    ("distributed.compression", "int8_roundtrip", ()),
    ("distributed.compression", "ErrorFeedback.init", ()),
    ("distributed.compression", "ErrorFeedback.apply", ()),
    ("train.steps", "make_train_step", ()),
    # the device the trainer runs on ("cuda" unless the caller asks) and
    # the mesh it trains on (ROADMAP 4f.3)
    ("train.trainer", "Trainer.__init__", ("device", "mesh")),
    # on a mesh, the batch rows the trees are laid out for
    ("train.trainer", "Trainer.init_or_restore", ("rows",)),
    ("train.trainer", "Trainer.run", ()),
    ("train.evaluate", "evaluate", ()),
    ("train.evaluate", "make_eval_step", ()),
    ("models.settings", "set_remat", ()),
    ("models.settings", "get_remat", ()),
    ("models.settings", "remat", ()),
    ("models.settings", "maybe_remat", ()),
    ("models.api", "lm_loss", ()),
    ("models.transformer", "lm_loss", ()),
    ("models.encdec", "lm_loss", ()),
]


def _pair(module):
    import importlib
    return (importlib.import_module(f"repro_torch.{module}"),
            importlib.import_module(f"repro.{module}"))


def _attr(mod, qual):
    obj = mod
    for part in qual.split("."):
        obj = getattr(obj, part)
    return obj


@pytest.mark.parametrize("module,deferred", TRAIN_MODULES,
                         ids=[m for m, _ in TRAIN_MODULES])
def test_training_module_exports_the_reference_names(module, deferred):
    t_mod, j_mod = _pair(module)
    # a module without __all__ exports its public functions
    names = getattr(j_mod, "__all__", None) or [
        n for n, v in vars(j_mod).items() if inspect.isfunction(v)
        and v.__module__ == j_mod.__name__ and not n.startswith("_")]
    assert set(names) - set(t_mod.__all__) == deferred


@pytest.mark.parametrize("module,qual,extra", TRAIN_FUNCS,
                         ids=[f"{m}.{q}" for m, q, _ in TRAIN_FUNCS])
def test_training_signature_matches_reference(module, qual, extra):
    t_mod, j_mod = _pair(module)
    got, want = _params_of(_attr(t_mod, qual)), _params_of(_attr(j_mod, qual))
    assert got[:len(want)] == want
    assert tuple(p[0] for p in got[len(want):]) == extra


@pytest.mark.parametrize("module,cls", [("optim.adamw", "AdamWConfig"),
                                        ("data.pipeline", "DataConfig"),
                                        ("train.trainer", "TrainerConfig"),
                                        ("models.common", "DTypePolicy")])
def test_training_config_fields_match_reference(module, cls):
    """The same fields with the same defaults (a dtype by its name)."""
    import dataclasses

    def fields(c):
        return [(f.name, str(f.default).split(".")[-1].replace(
            "'>", "").replace("<class '", "").split(".")[-1])
            for f in dataclasses.fields(c)]
    t_mod, j_mod = _pair(module)
    assert fields(getattr(t_mod, cls)) == fields(getattr(j_mod, cls))
    if cls == "DTypePolicy":
        t_fp32 = getattr(t_mod, cls).fp32()
        j_fp32 = getattr(j_mod, cls).fp32()
        assert [str(getattr(t_fp32, f)).split(".")[-1]
                for f in ("param", "compute", "accum", "master")] == \
            [np.dtype(getattr(j_fp32, f)).name
             for f in ("param", "compute", "accum", "master")]
