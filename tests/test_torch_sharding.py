"""The port's mesh planning against the JAX package's, on the CPU, with
no process group: ``PartitionSpec`` (normalization, equality, printing),
``MappingPlan.partition_spec`` for every plan of ``core/mapping.py``,
``make_rules`` / ``spec_for`` / ``tree_shardings`` / ``zero1_shardings``
for every architecture of ``configs/registry.py`` on meshes of 1x1, 2x2,
16x16 and 2x16x16 built without devices (JAX's ``AbstractMesh``, the
port's rank-less ``Mesh``), the ``param_axes`` / ``cache_axes`` /
``opt_state_axes`` trees equal to JAX's, the ``abstract`` trees with
JAX's shapes and types leaf for leaf on the ``meta`` device, the
``launch/specs.py`` stand-ins, ``vision_shardings`` for the zoo,
``NamedSharding``'s placements and local slices, and ``constrain``:
``x`` itself without a context, checked and unchanged under a one-rank
mesh, an error under more ranks (an LM forward there raises).  The
train step under a 1x1 context equals the step without one bitwise and
matches JAX's step on the setup of ``tests/test_sharding.py``."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from jax.sharding import AbstractMesh  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.configs import registry as j_registry  # noqa: E402
from repro.core import mapping as j_mapping  # noqa: E402
from repro.core.loopnest import ConvLoopNest as JNest  # noqa: E402
from repro.distributed import sharding as j_shd  # noqa: E402
from repro.launch import specs as j_specs  # noqa: E402
from repro.models import api as j_api  # noqa: E402
from repro.models import zoo as j_zoo  # noqa: E402
from repro.optim import adamw as j_adamw  # noqa: E402
from repro_torch.configs import registry as t_registry  # noqa: E402
from repro_torch.core import mapping as t_mapping  # noqa: E402
from repro_torch.core.loopnest import ConvLoopNest as TNest  # noqa: E402
from repro_torch.distributed import sharding as t_shd  # noqa: E402
from repro_torch.launch import specs as t_specs  # noqa: E402
from repro_torch.launch.mesh import Mesh, make_production_mesh  # noqa
from repro_torch.models import api as t_api  # noqa: E402
from repro_torch.models import zoo as t_zoo  # noqa: E402
from repro_torch.optim import adamw as t_adamw  # noqa: E402

TP = t_mapping.PartitionSpec
ARCHS = sorted(j_registry.ARCHS)
MESHES = {"1x1": {"data": 1, "model": 1},
          "2x2": {"data": 2, "model": 2},
          "16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}


def _meshes(name):
    shape = MESHES[name]
    return (Mesh(shape),
            AbstractMesh(tuple(shape.values()), tuple(shape)))


def _flat(tree, prefix=()):
    """(key path, leaf) in sorted key order; a tuple is a leaf."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(_flat(tree[k], prefix + (k,)))
        return out
    return [(prefix, tree)]


def _specs(tree):
    return [(p, tuple(s.spec)) for p, s in _flat(tree)]


def _shapes(tree):
    return [(p, tuple(x.shape), str(x.dtype).split(".")[-1])
            for p, x in _flat(tree)]


# -- PartitionSpec and the directive algebra --------------------------------

PARTS = [(), (None,), ("data",), ("data", None), (("data",), None),
         ((), "model"), (("pod", "data"), None, "model"),
         (None, None, "model", None), (["pod", "data"],)]


@pytest.mark.parametrize("parts", PARTS, ids=str)
def test_partition_spec_matches_jax(parts):
    got, want = TP(*parts), JP(*parts)
    assert repr(got) == repr(want) and str(got) == str(want)
    assert tuple(got) == tuple(want)
    assert got == tuple(want) and want == tuple(got)


def test_partition_spec_equality_is_a_tuples():
    assert TP("data") != TP("data", None)
    assert TP() != TP(None)
    assert TP(("data",), None) == TP("data", None)


def _plans(m):
    cv = (m.__name__, dict(n=2, nf=64, c=32, r=3, s=3, x=16, y=16,
                           stride=1, pad=1))
    nest = (JNest if m is j_mapping else TNest)(**cv[1])
    return {
        "ws_conv": m.weight_stationary_conv_plan(nest),
        "serving": m.serving_conv_plan(8, 512),
        "serving_pod": m.serving_conv_plan(8, 64, data_axis="pod",
                                           model_axis="data"),
        "lm_train": m.lm_train_plan(8, 128, 512),
        "directive": m.MappingPlan(
            name="t", dims={"B": 8, "T": 128, "D": 512},
            directives=(m.SpatialMap("B", "data"),
                        m.SpatialMap("D", "model"),
                        m.TemporalMap("T", 32))),
    }


DIMS = [("N", None, None, None), ("N_F", None, None, None), ("N_F",),
        ("B", "T", "D"), ("N", "N_F"), ("FF", "IF", "PS"), (None,),
        ("C", "R", "S", "X", "Y", "P", "Q"), ()]


@pytest.mark.parametrize("dims", DIMS, ids=str)
@pytest.mark.parametrize("plan", ["ws_conv", "serving", "serving_pod",
                                  "lm_train", "directive"])
def test_plan_partition_spec_matches_jax(plan, dims):
    got = _plans(t_mapping)[plan].partition_spec(dims)
    want = _plans(j_mapping)[plan].partition_spec(dims)
    assert isinstance(got, TP)
    assert tuple(got) == tuple(want) and repr(got) == repr(want)


# -- rules and per-leaf specs ------------------------------------------------

def _cfgs(arch):
    return t_registry.get_config(arch), j_registry.get_config(arch)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_rules_match_jax(arch, mesh):
    tcfg, jcfg = _cfgs(arch)
    tm, jm = _meshes(mesh)
    for kw in ({}, {"seq_shard_kv": True, "shard_batch": False}):
        got = t_shd.make_rules(tcfg, tm, **kw)
        want = j_shd.make_rules(jcfg, jm, **kw)
        assert got.table == want.table and \
            got.seq_shard_kv == want.seq_shard_kv


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_zero1_specs_match_jax(arch, mesh):
    tcfg, jcfg = _cfgs(arch)
    tm, jm = _meshes(mesh)
    trules, jrules = t_shd.make_rules(tcfg, tm), j_shd.make_rules(jcfg, jm)
    tax, jax_ = t_api.param_axes(tcfg), j_api.param_axes(jcfg)
    got = t_shd.tree_shardings(tax, trules, tm)
    assert _specs(got) == _specs(j_shd.tree_shardings(jax_, jrules, jm))
    tabs = t_adamw.abstract_opt_state(t_api.init_params(tcfg, abstract=True))
    jabs = j_adamw.abstract_opt_state(j_api.init_params(jcfg, abstract=True))
    got = t_shd.zero1_shardings(t_adamw.opt_state_axes(tax), tabs, trules,
                                tm)
    want = j_shd.zero1_shardings(j_adamw.opt_state_axes(jax_), jabs,
                                 jrules, jm)
    assert _specs(got) == _specs(want)
    # the cache's specs too; with seq_shard_kv on a mesh with a data axis
    # of more than one rank both packages refuse the KV spec, which maps
    # the data axis to the batch and the sequence
    for kw in ({"seq_shard_kv": False}, {"seq_shard_kv": True}):
        trules = t_shd.make_rules(tcfg, tm, **kw)
        jrules = j_shd.make_rules(jcfg, jm, **kw)
        assert _outcome(lambda: t_shd.tree_shardings(
            t_api.cache_axes(tcfg), trules, tm)) == _outcome(
            lambda: j_shd.tree_shardings(j_api.cache_axes(jcfg), jrules, jm))


def _outcome(fn):
    """The per-leaf specs, or "refused" where the sharding raises."""
    try:
        return _specs(fn())
    except Exception:   # the port's ValueError, JAX's own error type
        return "refused"


def test_spec_for_matches_the_jax_example():
    tm, _ = _meshes("1x1")
    rules = t_shd.make_rules(t_registry.get_config("llama3-8b"), tm)
    assert rules.get("heads") == "model" and rules.get("layers") is None
    assert t_shd.spec_for(("layers", "embed", "heads", "head_dim"),
                          rules) == TP(None, None, "model", None)


# -- axes and abstract trees -------------------------------------------------

def _window(cfgs):
    return tuple(dataclasses.replace(c, window_cache=True) for c in cfgs)


CACHE_CASES = [(a, False) for a in ARCHS] + [("gemma3-12b", True)]


@pytest.mark.parametrize("arch", ARCHS)
def test_param_axes_match_jax(arch):
    tcfg, jcfg = _cfgs(arch)
    assert _flat(t_api.param_axes(tcfg)) == _flat(j_api.param_axes(jcfg))


@pytest.mark.parametrize("arch,window", CACHE_CASES)
def test_cache_axes_match_jax(arch, window):
    cfgs = _cfgs(arch)
    tcfg, jcfg = _window(cfgs) if window else cfgs
    assert _flat(t_api.cache_axes(tcfg)) == _flat(j_api.cache_axes(jcfg))


@pytest.mark.parametrize("arch", ARCHS)
def test_opt_state_axes_match_jax(arch):
    tcfg, jcfg = _cfgs(arch)
    assert _flat(t_adamw.opt_state_axes(t_api.param_axes(tcfg))) == \
        _flat(j_adamw.opt_state_axes(j_api.param_axes(jcfg)))


def _all_meta(tree):
    return all(x.device.type == "meta" for _, x in _flat(tree))


@pytest.mark.parametrize("policy", ["bf16", "fp32"])
@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_match_jax(arch, policy):
    from repro.models.common import DTypePolicy as JPolicy
    from repro_torch.models.common import DTypePolicy as TPolicy
    tcfg, jcfg = _cfgs(arch)
    tp = TPolicy.fp32() if policy == "fp32" else TPolicy()
    jp = JPolicy.fp32() if policy == "fp32" else JPolicy()
    got = t_api.init_params(tcfg, abstract=True, dtype_policy=tp)
    assert _all_meta(got)
    assert _shapes(got) == _shapes(j_api.init_params(jcfg, abstract=True,
                                                     dtype_policy=jp))
    # the axes tree gives each leaf one name a dim
    for (p, a), (q, x) in zip(_flat(t_api.param_axes(tcfg)), _flat(got)):
        assert p == q and len(a) == x.ndim


@pytest.mark.parametrize("arch,window", CACHE_CASES)
def test_abstract_cache_matches_jax(arch, window):
    cfgs = _cfgs(arch)
    tcfg, jcfg = _window(cfgs) if window else cfgs
    got = t_api.init_cache(tcfg, 2, 16, src_len=8, abstract=True)
    assert _all_meta(got)
    assert _shapes(got) == _shapes(j_api.init_cache(jcfg, 2, 16, src_len=8,
                                                    abstract=True))
    for (p, a), (q, x) in zip(_flat(t_api.cache_axes(tcfg)), _flat(got)):
        assert p == q and len(a) == x.ndim


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_opt_state_matches_jax(arch):
    tcfg, jcfg = _cfgs(arch)
    got = t_adamw.abstract_opt_state(t_api.init_params(tcfg, abstract=True))
    assert _all_meta(got)
    assert _shapes(got) == _shapes(j_adamw.abstract_opt_state(
        j_api.init_params(jcfg, abstract=True)))


def test_abstract_trees_allocate_nothing():
    """A full config's trees (20B parameters for internvl2-26b) on the
    meta device: no storage behind any leaf."""
    cfg = t_registry.get_config("internvl2-26b")
    p = t_api.init_params(cfg, abstract=True)
    s = t_adamw.abstract_opt_state(p)
    c = t_api.init_cache(cfg, 8, 4096, abstract=True)
    for _, x in _flat({"p": p, "s": s, "c": c}):
        assert x.is_meta and x.untyped_storage().data_ptr() == 0
    assert sum(x.numel() for _, x in _flat(p)) > 19e9


@pytest.mark.parametrize("shape", sorted(j_registry.SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_jax(arch, shape):
    tcfg, jcfg = _cfgs(arch)
    tshape = t_registry.SHAPES[shape]
    jshape = j_registry.SHAPES[shape]
    for name in ("train_batch_specs", "prefill_batch_specs"):
        got = getattr(t_specs, name)(tcfg, tshape)
        assert _all_meta(got)
        assert _shapes(got) == _shapes(getattr(j_specs, name)(jcfg, jshape))
    for name in ("train_batch_axes", "prefill_batch_axes"):
        assert _flat(getattr(t_specs, name)(tcfg)) == \
            _flat(getattr(j_specs, name)(jcfg))
    got = t_specs.decode_input_specs(tcfg, tshape)
    want = j_specs.decode_input_specs(jcfg, jshape)
    assert [(tuple(x.shape), str(x.dtype).split(".")[-1]) for x in got] == \
        [(tuple(x.shape), str(x.dtype)) for x in want]
    assert t_specs.src_len_for(tcfg, tshape) == \
        j_specs.src_len_for(jcfg, jshape)


# -- vision shardings ---------------------------------------------------------

@pytest.mark.parametrize("mesh", [(1, 1), (2, 1), (1, 2), (2, 2), (4, 8)])
@pytest.mark.parametrize("model", ["vgg16", "resnet18", "mobilenetv2"])
def test_vision_shardings_match_jax(model, mesh):
    shape = {"data": mesh[0], "model": mesh[1]}
    tm, jm = Mesh(shape), AbstractMesh(mesh, ("data", "model"))
    jparams = jax.eval_shape(lambda k: j_zoo.get_conv_model(
        model).init_params(k, width_mult=0.0625, img=32, classes=10),
        jax.random.PRNGKey(0))
    tparams = t_zoo.get_conv_model(model).init_params(
        torch.Generator(), width_mult=0.0625, img=32, classes=10,
        device="meta")
    assert _shapes(tparams) == _shapes(jparams)
    tplan = t_mapping.serving_conv_plan(8, 512)
    jplan = j_mapping.serving_conv_plan(8, 512)
    assert _specs(t_shd.vision_shardings(tparams, tm, tplan)) == \
        _specs(j_shd.vision_shardings(jparams, jm, jplan))
    assert tuple(t_shd.vision_batch_sharding(tm, tplan).spec) == \
        tuple(j_shd.vision_batch_sharding(jm, jplan).spec)


# -- NamedSharding ------------------------------------------------------------

def test_named_sharding_placements():
    from torch.distributed.tensor import Replicate, Shard
    mesh = make_production_mesh(multi_pod=True)
    sh = t_shd.NamedSharding(mesh, TP(("pod", "data"), None, "model"))
    assert sh.placements() == (Shard(0), Shard(0), Shard(2))
    sh = t_shd.NamedSharding(mesh, TP(None, "data"))
    assert sh.placements() == (Replicate(), Shard(1), Replicate())


@pytest.mark.parametrize("coords", [{"pod": 0, "data": 0, "model": 0},
                                    {"pod": 1, "data": 3, "model": 5},
                                    {"pod": 1, "data": 15, "model": 15}])
def test_named_sharding_local_slices(coords):
    mesh = make_production_mesh(multi_pod=True)
    sh = t_shd.NamedSharding(mesh, TP(("pod", "data"), None, "model"))
    shape = (64, 7, 32)
    assert sh.local_shape(shape) == (2, 7, 2)
    sl = sh.local_slice(shape, coords)
    row = coords["pod"] * 16 + coords["data"]
    assert sl == (slice(2 * row, 2 * row + 2), slice(0, 7),
                  slice(2 * coords["model"], 2 * coords["model"] + 2))
    with pytest.raises(ValueError):
        sh.local_shape((63, 7, 32))


def test_production_meshes_have_no_ranks():
    one, two = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert one.shape == {"data": 16, "model": 16} and not one.has_ranks
    assert list(two.shape) == ["pod", "data", "model"] and two.size == 512
    with pytest.raises(RuntimeError):
        two.group("data")


@pytest.mark.parametrize("world,device,want", [
    (1, "cpu", "gloo"), (2, "cpu", "gloo"), (4, "cpu", "gloo"),
    (2, "cuda", None)])
def test_pick_backend_follows_the_ranks_and_the_device(world, device, want):
    """gloo on the CPU and where the ranks outnumber the visible cards,
    NCCL where each rank has a card; a card that is not there raises."""
    from repro_torch.launch.mesh import pick_backend
    if device == "cuda":
        if torch.cuda.is_available():
            n = torch.cuda.device_count()
            assert pick_backend(n, device) == "nccl"
            assert pick_backend(n + 1, device) == "gloo"
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                pick_backend(world, device)
        return
    assert pick_backend(world, device) == want


# -- constrain ----------------------------------------------------------------

@pytest.fixture
def clean_context():
    yield
    t_shd.clear_context()


def test_constrain_without_a_context_is_the_identity(clean_context):
    x = torch.ones(4, 4)
    assert t_shd.constrain(x, ("batch", None)) is x


def test_context_mesh_is_the_installed_mesh(clean_context):
    """``context_mesh`` (what ``compressed_psum`` resolves an axis name
    through) raises without a context and gives the context's mesh
    under one."""
    from repro_torch.distributed.compression import compressed_psum
    with pytest.raises(ValueError, match="no sharding context"):
        t_shd.context_mesh()
    with pytest.raises(ValueError, match="no sharding context"):
        compressed_psum(torch.ones(3), "data")
    mesh = Mesh({"data": 1, "model": 1})
    t_shd.set_context(mesh, t_shd.make_rules(
        t_registry.get_config("qwen3-4b"), mesh))
    assert t_shd.context_mesh() is mesh
    t_shd.clear_context()
    with pytest.raises(ValueError, match="no sharding context"):
        t_shd.context_mesh()


def test_constrain_under_one_rank_checks_and_returns_x(clean_context):
    mesh = Mesh({"data": 1, "model": 1})
    t_shd.set_context(mesh, t_shd.make_rules(
        t_registry.get_config("qwen3-4b"), mesh))
    x = torch.ones(4, 6, 8)
    assert t_shd.constrain(x, ("batch", None, None)) is x
    with pytest.raises(ValueError):
        t_shd.constrain(x, ("batch", None))


def test_constrain_under_more_ranks_raises(clean_context):
    mesh = Mesh({"data": 2, "model": 2})
    cfg = t_registry.get_config("qwen3-4b", reduced=True)
    t_shd.set_context(mesh, t_shd.make_rules(cfg, mesh))
    with pytest.raises(NotImplementedError, match="4f"):
        t_shd.constrain(torch.ones(4, 4, 8), ("batch", None, None))
    params = t_api.init_params(cfg, device="cpu")
    tokens = torch.zeros((2, 8), dtype=torch.long)
    with pytest.raises(NotImplementedError, match="4f"):
        t_api.lm_loss(params, cfg, {"tokens": tokens, "labels": tokens})


def test_forward_under_a_one_rank_context_is_bitwise(clean_context):
    from repro_torch.models import transformer
    cfg = t_registry.get_config("qwen2-moe-a2.7b", reduced=True)
    cfg = dataclasses.replace(cfg, moe_ep_constraint=True)
    params = t_api.init_params(cfg, device="cpu")
    tokens = torch.arange(16).reshape(2, 8) % cfg.vocab
    want = transformer.forward(params, cfg, tokens)
    mesh = Mesh({"data": 1, "model": 1})
    t_shd.set_context(mesh, t_shd.make_rules(cfg, mesh))
    got = transformer.forward(params, cfg, tokens)
    assert torch.equal(got[0], want[0])


def test_train_step_under_local_mesh_constraints(clean_context):
    """``tests/test_sharding.py``'s setup (qwen3-4b reduced, a 1x1 mesh's
    rules installed, one AdamW step on 2 x 16 tokens), fp32: the step
    under the context bitwise the step without it, and against JAX's step
    without a context (JAX's under one fails under this jax) the loss
    within 1e-5 and the new parameters within 2·lr."""
    from repro.models.common import DTypePolicy as JPolicy
    from repro.train.steps import make_train_step as j_make_step
    from repro_torch.convert import params_from_jax
    from repro_torch.train.steps import make_train_step as t_make_step
    from test_torch_train_step import assert_step_close
    jcfg = j_registry.get_config("qwen3-4b", reduced=True)
    tcfg = t_registry.get_config("qwen3-4b", reduced=True)
    jparams = j_api.init_params(jcfg, jax.random.PRNGKey(0),
                                dtype_policy=JPolicy.fp32())
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (2, 17), 0,
                                         jcfg.vocab))
    batch = {"tokens": toks[:, :-1].astype(np.int32),
             "labels": toks[:, 1:].astype(np.int32)}
    jnew, _, jm = jax.jit(j_make_step(jcfg, j_adamw.AdamWConfig()))(
        jparams, j_adamw.init_opt_state(jparams), batch)
    step = t_make_step(tcfg, t_adamw.AdamWConfig())
    tparams = params_from_jax(jparams, "cpu")
    plain = step(tparams, t_adamw.init_opt_state(tparams), batch)
    mesh = Mesh({"data": 1, "model": 1})
    t_shd.set_context(mesh, t_shd.make_rules(tcfg, mesh))
    tnew, tstate, tm = step(tparams, t_adamw.init_opt_state(tparams), batch)
    from repro_torch.tree import leaves
    for a, b in zip(leaves((tnew, tstate)), leaves(plain[:2])):
        assert torch.equal(a, b)
    assert float(tm["loss"]) == float(plain[2]["loss"])
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= \
        1e-5 * max(abs(float(jm["loss"])), 1.0)
    assert_step_close(tnew, jnew, False, "qwen3-4b under a 1x1 context")
