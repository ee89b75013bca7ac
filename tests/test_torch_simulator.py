"""The port's planning and oracle side against the JAX package's: the
fold-execution simulator and its cycle accounting, the 64-bit message
stream, the Spatial/Temporal-Map directive algebra, the im2col and
``F.conv2d`` oracle impls, the per-layer VGG-16 forward and the exports of
``repro_torch.core``.  Integer results (cycles, message counts, words,
plans) must be equal; floating results agree within the stated
tolerances."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as j_core  # noqa: E402
import repro_torch.core as t_core  # noqa: E402
from repro.core import mapping as j_mapping  # noqa: E402
from repro.core import simulator as j_sim  # noqa: E402
from repro.core import streaming as j_stream  # noqa: E402
from repro.core.folds import PEArray as JPEArray  # noqa: E402
from repro.core.folds import decompose as j_decompose  # noqa: E402
from repro.core.loopnest import ConvLoopNest as JNest  # noqa: E402
from repro.models import vgg as j_vgg  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import mapping as t_mapping  # noqa: E402
from repro_torch.core import simulator as t_sim  # noqa: E402
from repro_torch.core import streaming as t_stream  # noqa: E402
from repro_torch.core.folds import PEArray, decompose  # noqa: E402
from repro_torch.core.loopnest import (  # noqa: E402
    ConvLoopNest, synthetic_suite, vgg16_conv_layers)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import vgg as t_vgg  # noqa: E402

FOLD_REL = 1e-5     # the fold walk: fp32 products and in-fold sums
CONV_TOL = 2e-4     # tests/test_kernels.py's oracle tolerance
VGG_REL = 1e-5      # per-layer VGG-16 against the JAX package, fp32

LAYERS = [cv for _, cv in vgg16_conv_layers()] + list(synthetic_suite())


def _jnest(cv: ConvLoopNest) -> JNest:
    return JNest(**dataclasses.asdict(cv))


def _xla_conv(x, w, stride, pad, groups=1):
    return np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (stride, stride),
        [(pad, pad), (pad, pad)], dimension_numbers=("NCHW", "OIHW", "NCHW"),
        feature_group_count=groups))


def _rel_close(got, want, rel, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max()
    assert err <= rel * max(1.0, np.abs(want).max()), (what, err)


# --------------------------------------------------------------------------
# the fold-execution simulator
# --------------------------------------------------------------------------

# (n, nf, c, r=s, x=y, stride, pe rows, pe cols): the ranges of
# tests/test_simulator.py's property test, one or more depth folds and
# row splits each, 1x1 and 3x3, stride 1 and 2
FOLD_CASES = [(1, 4, 8, 3, 12, 1, 4, 24), (2, 6, 5, 3, 9, 2, 2, 8),
              (1, 1, 1, 1, 5, 1, 8, 16), (2, 5, 6, 1, 10, 2, 4, 8),
              (1, 3, 6, 3, 7, 1, 8, 24), (2, 6, 3, 3, 10, 1, 2, 16),
              (1, 6, 6, 3, 8, 2, 4, 8), (2, 2, 4, 1, 6, 1, 2, 24)]


@pytest.mark.parametrize("case", FOLD_CASES, ids=str)
def test_fold_execution_matches_reference(case):
    n, nf, c, rs, x, stride, pe_r, pe_c = case
    cv = ConvLoopNest(n=n, nf=nf, c=c, r=rs, s=rs, x=x, y=x, stride=stride,
                      pad=rs // 2)
    rng = np.random.default_rng(0)
    xt = rng.standard_normal((n, c, x, x)).astype(np.float32)
    wt = rng.standard_normal((nf, c, rs, rs)).astype(np.float32)
    got = t_sim.execute_conv_by_folds(torch.from_numpy(xt),
                                      torch.from_numpy(wt), cv,
                                      PEArray(pe_r, pe_c))
    assert got.dtype == torch.float32
    want = j_sim.execute_conv_by_folds(xt, wt, _jnest(cv),
                                       JPEArray(pe_r, pe_c))
    _rel_close(got.numpy(), want, FOLD_REL, "fold walk vs JAX package")
    np.testing.assert_allclose(got.numpy(),
                               _xla_conv(xt, wt, stride, rs // 2),
                               rtol=1e-4, atol=1e-4)


def test_fold_execution_chunks_the_positions(monkeypatch):
    """A product block smaller than one fold pair's positions walks them
    in chunks, with the same sums."""
    cv = ConvLoopNest(n=1, nf=4, c=8, r=3, s=3, x=12, y=12, stride=1,
                      pad=1)
    g = torch.Generator().manual_seed(3)
    x, w = torch.randn(1, 8, 12, 12, generator=g), \
        torch.randn(4, 8, 3, 3, generator=g)
    whole = t_sim.execute_conv_by_folds(x, w, cv, PEArray(4, 24))
    monkeypatch.setattr(t_sim, "_PRODUCT_ELEMS", 500)
    assert torch.equal(t_sim.execute_conv_by_folds(x, w, cv, PEArray(4, 24)),
                       whole)


@pytest.mark.parametrize("pe", [(16, 16), (64, 64)], ids=str)
@pytest.mark.parametrize("hops", [True, False])
def test_cycles_and_stream_counts_equal_reference(pe, hops):
    """Integer accounting: every VGG-16 and synthetic-suite layer."""
    for cv in LAYERS:
        got = t_sim.simulate_cycles(cv, PEArray(*pe), multicast_hops=hops)
        want = j_sim.simulate_cycles(_jnest(cv), JPEArray(*pe),
                                     multicast_hops=hops)
        assert got.as_dict() == want.as_dict(), cv
        assert (t_stream.stream_counts(decompose(cv, PEArray(*pe)))
                == j_stream.stream_counts(j_decompose(_jnest(cv),
                                                      JPEArray(*pe)))), cv


def test_cycle_report_components_positive():
    cv = vgg16_conv_layers()[3][1]
    rep = t_sim.simulate_cycles(cv, PEArray(64, 64))
    assert rep.t_wl > 0 and rep.t_mt > 0 and rep.t_op > 0
    assert rep.total == rep.t_wl + rep.t_mt + rep.t_op + rep.t_wb


def test_message_transfer_significant_with_hops():
    total_mt = total_op = total_wl = 0
    for _, cv in vgg16_conv_layers():
        rep = t_sim.simulate_cycles(cv, PEArray(64, 64), multicast_hops=True)
        total_mt += rep.t_mt
        total_op += rep.t_op
        total_wl += rep.t_wl
    assert total_mt > 0.3 * total_op
    assert total_mt > 5 * total_wl


def test_multicast_hops_flag_reduces_mt():
    cv = vgg16_conv_layers()[5][1]
    with_hops = t_sim.simulate_cycles(cv, PEArray(32, 32),
                                      multicast_hops=True)
    without = t_sim.simulate_cycles(cv, PEArray(32, 32),
                                    multicast_hops=False)
    assert with_hops.t_mt > without.t_mt


# --------------------------------------------------------------------------
# the 64-bit message stream
# --------------------------------------------------------------------------

# (opcode, row, col, flags, payload): every opcode, the fields' extremes
MESSAGES = list(zip(
    range(11), (0, 1, 17, 255, 128, 3, 64, 200, 9, 31, 250),
    (255, 0, 33, 1, 128, 77, 5, 199, 2, 254, 13),
    (0, 255, 7, 100, 3, 1, 64, 8, 250, 16, 42),
    (0, 2**32 - 1, 1, 0x3F800000, 12345, 2**31, 7, 0xDEADBEEF, 99, 2**16,
     0x7FC00000)))


@pytest.mark.parametrize("fields", MESSAGES, ids=str)
def test_message_words_equal_reference(fields):
    op, row, col, flags, payload = fields
    m = t_stream.Message(t_stream.Opcode(op), row, col, flags, payload)
    word = t_stream.encode(m)
    assert word == j_stream.encode(j_stream.Message(
        j_stream.Opcode(op), row, col, flags, payload))
    assert t_stream.decode(word) == m
    assert 0 <= word < 2**64


def test_message_routing_field_overflow_raises():
    with pytest.raises(ValueError, match="8-bit"):
        t_stream.Message(t_stream.Opcode.MAC, row=256).pack()


@pytest.mark.parametrize("v", [0.0, 1.0, -2.5, 3.1415926, 1e-38, 6.5e4])
def test_f32_payload_equals_reference(v):
    assert t_stream.f32_payload(v) == j_stream.f32_payload(v)


@pytest.mark.parametrize("case", [
    (1, 4, 4, 3, 5, 1, 1, 4, 24), (2, 6, 5, 3, 9, 2, 1, 2, 8),
    (1, 3, 6, 1, 6, 1, 0, 4, 8), (1, 8, 3, 5, 9, 1, 2, 4, 12)], ids=str)
def test_fold_stream_words_equal_reference(case):
    """Every fold's message words bit-identical, and the closed-form
    counts equal to the enumeration (tests/test_infra.py's check)."""
    n, nf, c, rs, x, stride, pad, pe_r, pe_c = case
    cv = ConvLoopNest(n=n, nf=nf, c=c, r=rs, s=rs, x=x, y=x, stride=stride,
                      pad=pad)
    plan = decompose(cv, PEArray(pe_r, pe_c))
    jplan = j_decompose(_jnest(cv), JPEArray(pe_r, pe_c))
    enumerated = {}
    for fold, jfold in zip(plan.filter_folds(), jplan.filter_folds()):
        words = [t_stream.encode(m) for m in t_stream.fold_stream(plan, fold)]
        assert words == [j_stream.encode(m)
                         for m in j_stream.fold_stream(jplan, jfold)]
        for w in words:
            name = t_stream.decode(w).opcode.name
            enumerated[name] = enumerated.get(name, 0) + 1
    counts = t_stream.stream_counts(plan)
    for k, v in enumerated.items():
        assert counts[k] == v, (k, counts[k], v)


# --------------------------------------------------------------------------
# the directive algebra
# --------------------------------------------------------------------------

def test_directive_plan_grid_and_str():
    """tests/test_sharding.py's plan (its PartitionSpec belongs to the
    mesh slice)."""
    plan = t_mapping.MappingPlan(
        name="t", dims={"B": 8, "T": 128, "D": 512},
        directives=(t_mapping.SpatialMap("B", "data"),
                    t_mapping.SpatialMap("D", "model"),
                    t_mapping.TemporalMap("T", 32)))
    plan.validate()
    assert plan.grid() == (4,)
    assert [str(d) for d in plan.spatial()] == ["SpatialMap(B -> data)",
                                                "SpatialMap(D -> model)"]
    jplan = j_mapping.MappingPlan(
        name="t", dims={"B": 8, "T": 128, "D": 512},
        directives=(j_mapping.SpatialMap("B", "data"),
                    j_mapping.SpatialMap("D", "model"),
                    j_mapping.TemporalMap("T", 32)))
    assert str(plan) == str(jplan)


@pytest.mark.parametrize("bad", ["unknown dim", "dim bound twice"])
def test_directive_validate_refuses_what_reference_refuses(bad):
    def directives(m):
        if bad == "unknown dim":
            return (m.SpatialMap("B", "data"), m.TemporalMap("Z", 1))
        return (m.SpatialMap("B", "data"), m.TemporalMap("B", 2))
    for m in (t_mapping, j_mapping):
        plan = m.MappingPlan(name="bad", dims={"B": 4, "T": 8},
                             directives=directives(m))
        with pytest.raises(ValueError, match=bad):
            plan.validate()


def test_canonical_plans_equal_reference():
    for cv in LAYERS:
        got = t_mapping.weight_stationary_conv_plan(cv)
        want = j_mapping.weight_stationary_conv_plan(_jnest(cv))
        assert (str(got), got.grid(), got.dims) == \
            (str(want), want.grid(), want.dims)
    for b, nf in ((1, 64), (8, 512), (3, 10)):
        got = t_mapping.serving_conv_plan(b, nf, data_axis="dp")
        want = j_mapping.serving_conv_plan(b, nf, data_axis="dp")
        assert (str(got), got.grid()) == (str(want), want.grid())
    got, want = (t_mapping.lm_train_plan(8, 4096, 2048),
                 j_mapping.lm_train_plan(8, 4096, 2048))
    assert (str(got), got.grid()) == (str(want), want.grid()) \
        and got.grid() == (1,)


def test_core_exports_the_reference_api():
    assert sorted(t_core.__all__) == sorted(j_core.__all__)
    for name in t_core.__all__:
        assert getattr(t_core, name) is not None


# --------------------------------------------------------------------------
# the im2col and F.conv2d oracle impls
# --------------------------------------------------------------------------

# tests/test_kernels.py's cases: (N, C, X, Y, NF, R, S, stride, pad)
CASES = [(1, 3, 8, 8, 4, 3, 3, 1, 1), (2, 4, 12, 10, 8, 3, 3, 1, 0),
         (1, 8, 9, 9, 16, 3, 3, 2, 1), (2, 2, 7, 7, 5, 1, 1, 1, 0),
         (1, 6, 14, 14, 4, 5, 5, 1, 2), (1, 4, 11, 13, 3, 3, 5, 2, 2)]


@pytest.mark.parametrize("case", CASES, ids=str)
@pytest.mark.parametrize("impl", ["im2col", "torch"])
def test_oracle_impls_match_reference(case, impl):
    from repro.kernels.ref import conv2d_im2col as j_im2col
    n, c, x_, y_, nf, r, s, stride, pad = case
    rng = np.random.default_rng(1)
    x = rng.standard_normal((n, c, x_, y_)).astype(np.float32)
    w = rng.standard_normal((nf, c, r, s)).astype(np.float32)
    out = ops.conv2d(torch.from_numpy(x), torch.from_numpy(w),
                     stride=stride, pad=pad, impl=impl).numpy()
    np.testing.assert_allclose(out, _xla_conv(x, w, stride, pad),
                               rtol=CONV_TOL, atol=CONV_TOL)
    if impl == "im2col":
        np.testing.assert_allclose(
            out, np.asarray(j_im2col(jnp.asarray(x), jnp.asarray(w),
                                     stride, pad)),
            rtol=CONV_TOL, atol=CONV_TOL)


def test_im2col_is_dense_only_and_torch_takes_groups():
    x = torch.randn(1, 4, 6, 6)
    w = torch.randn(4, 2, 3, 3)
    with pytest.raises(ValueError, match="dense-only"):
        ops.conv2d(x, w, pad=1, impl="im2col", groups=2)
    np.testing.assert_allclose(
        ops.conv2d(x, w, pad=1, impl="torch", groups=2).numpy(),
        _xla_conv(x.numpy(), w.numpy(), 1, 1, groups=2),
        rtol=CONV_TOL, atol=CONV_TOL)


def test_default_conv_impl_follows_the_device():
    assert ops.default_conv_impl(torch.zeros(1)) == "direct"
    assert ops.default_conv_impl(torch.zeros(1, device="meta")) == "direct"
    assert "torch" in ops.IMPLS and "im2col" in ops.IMPLS
    assert "torch" not in ops.FOLD_IMPLS


def test_fused_oracle_impls_apply_the_epilogue():
    from repro_torch.core.epilogue import Epilogue
    g = torch.Generator().manual_seed(4)
    x, w = torch.randn(2, 4, 8, 8, generator=g), \
        torch.randn(6, 4, 3, 3, generator=g)
    b = torch.randn(6, generator=g)
    epi = Epilogue(bias=True, relu=True, pool="max2")
    want = ops.conv2d_fused(x, w, b, pad=1, epilogue=epi, impl="direct")
    for impl in ("im2col", "torch"):
        got = ops.conv2d_fused(x, w, b, pad=1, epilogue=epi, impl=impl)
        torch.testing.assert_close(got, want, rtol=CONV_TOL, atol=CONV_TOL)


# --------------------------------------------------------------------------
# the per-layer VGG-16 forward
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_vgg():
    """tests/test_engine.py's fixture: width 0.0625, 32x32, 10 classes,
    batch 2, with the JAX package's im2col oracle logits."""
    params = j_vgg.init_params(jax.random.PRNGKey(0), width_mult=0.0625,
                               img=32, classes=10)
    x = jax.random.normal(jax.random.PRNGKey(1), (2, 3, 32, 32))
    ref = np.asarray(j_vgg.forward(params, x, impl="im2col"))
    return (params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                            "cpu"), torch.from_numpy(np.array(x)), ref,
            params, x)


@pytest.mark.parametrize("impl", ["fold_ws", "fold_os", "fold_auto",
                                  "im2col", "direct", "torch", None])
def test_vgg_forward_matches_reference(tiny_vgg, impl):
    tparams, tx, ref, _, _ = tiny_vgg
    out = t_vgg.forward(tparams, tx, impl=impl)
    assert out.shape == (2, 10)
    _rel_close(out.numpy(), ref, VGG_REL, f"vgg.forward({impl})")


@pytest.mark.parametrize("impl", ["fold_auto", "fold_ws", "fold_os"])
def test_vgg_forward_with_schedule_cache(tiny_vgg, impl):
    """With a ScheduleCache the 13 convs plan 8 geometries (5 hits), and
    the logits match the JAX package's reference-policy compiled network
    and the port's own."""
    from repro.models import vgg as jv
    tparams, tx, ref, params, x = tiny_vgg
    cache = t_core.ScheduleCache()
    out = t_vgg.forward(tparams, tx, impl=impl, cache=cache)
    assert cache.distinct == 8 and cache.stats.hits == 5
    net = jv.compile_forward(params, img=32, batch=2, policy="reference")
    _rel_close(out.numpy(), np.asarray(net(params, x)), VGG_REL,
               "per-layer vs JAX compiled reference")
    tnet = t_vgg.compile_forward(tparams, img=32, batch=2,
                                 policy="reference", device="cpu")
    _rel_close(out.numpy(), tnet(tparams, tx).numpy(), VGG_REL,
               "per-layer vs the port's compiled reference")


def test_vgg_forward_cache_plans_the_reference_schedules(tiny_vgg):
    """The per-layer path asks the cache for the JAX package's
    dataflows."""
    from repro.core.engine import ScheduleCache as JCache
    tparams, tx, _, _, x = tiny_vgg
    cache, jcache = t_core.ScheduleCache(), JCache()
    t_vgg.forward(tparams, tx, impl="fold_auto", cache=cache)
    _plan_like_reference(jcache, x)
    got = [(str(s.key), s.dataflow, s.plan.grid) for s in cache.schedules()]
    want = [(str(s.key), s.dataflow, s.plan.grid)
            for s in jcache.schedules()]
    assert got == want


def _plan_like_reference(jcache, x):
    """The JAX per-layer forward's schedule lookups, without running its
    Pallas kernels: one ``schedule_for`` per conv at the shapes it sees."""
    from repro.core.loopnest import ConvLoopNest as JN
    n, _, h, _ = x.shape
    for entry in j_vgg.VGG_LAYERS:
        if entry == "M":
            h //= 2
            continue
        _, cin, cout = entry
        cin = max(int(cin * 0.0625), 1) if cin != 3 else 3
        cout = max(int(cout * 0.0625), 1)
        jcache.schedule_for(JN(n=n, nf=cout, c=cin, r=3, s=3, x=h, y=h,
                               stride=1, pad=1))
