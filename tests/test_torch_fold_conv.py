"""The port's fold conv against the JAX package's: the plain-torch fold
loops (WS, OS, depthwise, psum staging; fp32 and int8) on the CPU against
the Pallas kernels in interpret mode, with every epilogue the zoo models
fuse, the grouped 1 < G < C walk, the fused and int8 conv entry points,
the direct-conv oracle (grouped included), the CTA tile chooser over every
conv of the zoo, and — on a card — each CUDA kernel (every tile, grouped
included) against its plain version."""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.epilogue import Epilogue as TEpilogue  # noqa: E402
from repro_torch.core.epilogue import apply_epilogue  # noqa: E402
from repro_torch.core.mapping import ConvBlockPlan as TPlan  # noqa: E402
from repro_torch.kernels import conv2d_ws as t_kern  # noqa: E402
from repro_torch.kernels import ops as t_ops  # noqa: E402
from repro_torch.kernels import ref as t_ref  # noqa: E402


@pytest.fixture(scope="module")
def jx():
    """The JAX package, imported only by the tests that compare against it
    (the CUDA cases run where JAX is not installed)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core.epilogue import Epilogue
    from repro.core.mapping import ConvBlockPlan
    from repro.core import quant
    from repro.kernels import conv2d_ws, ops, ref
    return types.SimpleNamespace(jnp=jnp, Epilogue=Epilogue,
                                 Plan=ConvBlockPlan, kern=conv2d_ws,
                                 ops=ops, ref=ref, quant=quant)


TOL = dict(rtol=1e-5, atol=1e-5)   # fp32 at these sizes, two sum orders
ID, BR, BRP = {}, {"bias": True, "relu": True}, \
    {"bias": True, "relu": True, "pool": "max2"}

# (N, C, X, Y, NF, R, S, stride, pad, epilogue, forced (nf_b, c_b, p_b))
FOLD_CASES = [
    (1, 3, 8, 8, 4, 3, 3, 1, 1, ID, None),
    (2, 4, 12, 10, 8, 3, 3, 1, 0, BR, None),
    (2, 6, 9, 11, 5, 3, 3, 1, 1, BRP, None),        # odd P, fused pool
    (2, 8, 10, 10, 12, 3, 3, 1, 1, BRP, (8, 3, 3)),  # g_c = 3, g_nf = 2
    (1, 8, 9, 9, 16, 3, 3, 2, 1, BR, None),          # stride 2
    (2, 5, 7, 9, 6, 3, 3, 1, 1, BR, (4, 2, 2)),      # g_c = 3, ragged NF
]
DIRECT_CASES = [c[:9] for c in FOLD_CASES] + [(1, 6, 14, 14, 4, 5, 5, 1, 2)]

# the epilogues ResNet-18 and MobileNetV2 fuse into the WS / OS kernels
SC, SC6, SCR, BRR = ({"scale": True}, {"scale": True, "relu6": True},
                     {"scale": True, "residual": True},
                     {"bias": True, "residual": True, "relu": True})
# every step at once: no zoo layer fuses it
BSR6 = {"bias": True, "scale": True, "residual": True, "relu6": True}
# (N, C, X, Y, NF, R, S, stride, pad, forced (nf_b, c_b, p_b))
EPI_GEOMS = [
    (2, 8, 10, 10, 12, 3, 3, 1, 1, (8, 3, 3)),       # g_c = 3, g_nf = 2
    (2, 6, 9, 9, 10, 1, 1, 2, 0, None),              # 1x1 stride 2, odd
]
# depthwise: (N, C, X, Y, R, stride, pad, epilogue, forced (c_b, p_b));
# a forced c_b that does not divide C pads the channels (c_pad > C)
DW_CASES = [
    (2, 8, 9, 9, 3, 1, 1, SC6, None),                # odd width
    (2, 6, 11, 11, 3, 2, 1, SC6, (4, 3)),            # stride 2, c_pad 8
    (1, 10, 16, 16, 3, 2, 1, ID, None),              # stride 2, even width
    (2, 12, 8, 10, 3, 1, 1, SCR, (8, 3)),            # residual, c_pad 16
]
# the depthwise kernel's cases on the card: DW_CASES, and its thread strips
# of TQ outputs along Q (dw_geometry's pick) against stride 2, the fused
# pool, the residual and Q not a multiple of TQ (the 5x5 layer takes its
# generic path); tests/test_torch_dw_geometry.py proves their geometry at
# every strip on the CPU
SC6P = {"scale": True, "relu6": True, "pool": "max2"}
DW_CUDA_CASES = DW_CASES + [
    (2, 5, 9, 11, 3, 1, 1, SC6P, None),              # pool, odd P and Q
    (1, 4, 12, 14, 3, 2, 1, SC6P, None),             # stride 2 + pool
    (2, 12, 8, 10, 3, 2, 1, SCR, None),              # stride 2 + residual
    (2, 7, 6, 13, 3, 1, 1, SCR, (4, 3)),             # Q 13, c_pad 8
    (1, 40, 4, 4, 3, 1, 1, SC6, None),               # 4x4: many channels
    (2, 3, 7, 13, 5, 1, 2, SCR, None),               # 5x5, generic path
]


def _inputs(n, c, x, y, nf, r, s, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, c, x, y)).astype(np.float32),
            rng.standard_normal((nf, c, r, s)).astype(np.float32),
            rng.standard_normal((nf,)).astype(np.float32))


def _plan(cls, forced, nf, c):
    if forced is None:
        return None
    nf_b, c_b, p_b = forced
    return cls(nf_block=nf_b, c_block=c_b, p_block=p_b,
               grid=(-(-nf // nf_b), -(-c // c_b), 1), vmem_bytes=0)


def _dw_plan(cls, forced, c):
    if forced is None:
        return None
    c_b, p_b = forced
    return cls(nf_block=c_b, c_block=c_b, p_block=p_b,
               grid=(1, -(-c // c_b), 1), vmem_bytes=0, groups=c)


def _epi_operands(epi, n, nf, p, q, seed=0):
    """numpy bias / scale / shift / residual for an epilogue, as named
    keyword arguments of ``conv2d_folded``."""
    rng = np.random.default_rng(seed + 100)
    out = {}
    if epi.get("bias"):
        out["bias"] = rng.standard_normal(nf).astype(np.float32)
    if epi.get("scale"):
        out["scale"] = (1.0 + 0.2 * rng.standard_normal(nf)).astype(
            np.float32)
        out["shift"] = (0.2 * rng.standard_normal(nf)).astype(np.float32)
    if epi.get("residual"):
        out["residual"] = rng.standard_normal((n, nf, p, q)).astype(
            np.float32)
    return out


def _as(fn, operands):
    return {k: fn(v) for k, v in operands.items()}


@pytest.mark.parametrize("dataflow", ["weight_stationary",
                                      "output_stationary"])
@pytest.mark.parametrize("case", FOLD_CASES)
def test_plain_fold_conv_matches_pallas_interpret(jx, case, dataflow):
    n, c, x_, y_, nf, r, s, stride, pad, epi, forced = case
    x, w, b = _inputs(n, c, x_ + 2 * pad, y_ + 2 * pad, nf, r, s)
    bias = epi.get("bias", False)
    want = jx.kern.conv2d_folded(
        jx.jnp.asarray(x), jx.jnp.asarray(w), stride=stride,
        plan=_plan(jx.Plan, forced, nf, c), dataflow=dataflow,
        interpret=True, epilogue=jx.Epilogue(**epi),
        bias=jx.jnp.asarray(b) if bias else None)
    got = t_kern.conv2d_folded(
        torch.from_numpy(x), torch.from_numpy(w), stride=stride,
        plan=_plan(TPlan, forced, nf, c),
        dataflow=dataflow, epilogue=TEpilogue(**epi),
        bias=torch.from_numpy(b) if bias else None)
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("dataflow", ["weight_stationary",
                                      "output_stationary"])
@pytest.mark.parametrize("epi", [SC, SC6, SCR, BRR, BSR6],
                         ids=["scale", "scale+relu6", "scale+residual",
                              "bias+residual+relu",
                              "bias+scale+residual+relu6"])
@pytest.mark.parametrize("geom", EPI_GEOMS, ids=["3x3_gc3", "1x1_s2"])
def test_plain_epilogues_match_pallas_interpret(jx, geom, epi, dataflow):
    """The scale / ReLU6 / residual epilogues of the WS / OS walks."""
    n, c, x_, y_, nf, r, s, stride, pad, forced = geom
    x, w, _ = _inputs(n, c, x_ + 2 * pad, y_ + 2 * pad, nf, r, s, seed=8)
    p, q = (x_ + 2 * pad - r) // stride + 1, (y_ + 2 * pad - s) // stride + 1
    ops = _epi_operands(epi, n, nf, p, q)
    want = jx.kern.conv2d_folded(
        jx.jnp.asarray(x), jx.jnp.asarray(w), stride=stride,
        plan=_plan(jx.Plan, forced, nf, c), dataflow=dataflow,
        interpret=True, epilogue=jx.Epilogue(**epi),
        **_as(jx.jnp.asarray, ops))
    got = t_kern.conv2d_folded(
        torch.from_numpy(x), torch.from_numpy(w), stride=stride,
        plan=_plan(TPlan, forced, nf, c), dataflow=dataflow,
        epilogue=TEpilogue(**epi), **_as(torch.from_numpy, ops))
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("case", DW_CASES)
def test_plain_depthwise_matches_pallas_interpret(jx, case):
    """The depthwise walk against ``_dw_kernel`` in interpret mode."""
    n, c, x_, y_, r, stride, pad, epi, forced = case
    x, w, _ = _inputs(n, c, x_ + 2 * pad, y_ + 2 * pad, c, r, r, seed=9)
    w = np.ascontiguousarray(w[:, :1])                     # (C, 1, R, S)
    p, q = (x_ + 2 * pad - r) // stride + 1, (y_ + 2 * pad - r) // stride + 1
    ops = _epi_operands(epi, n, c, p, q)
    want = jx.kern.conv2d_folded(
        jx.jnp.asarray(x), jx.jnp.asarray(w), stride=stride,
        plan=_dw_plan(jx.Plan, forced, c), dataflow="depthwise",
        interpret=True, epilogue=jx.Epilogue(**epi), groups=c,
        **_as(jx.jnp.asarray, ops))
    got = t_kern.conv2d_folded(
        torch.from_numpy(x), torch.from_numpy(w), stride=stride,
        plan=_dw_plan(TPlan, forced, c), dataflow="depthwise",
        epilogue=TEpilogue(**epi), groups=c, **_as(torch.from_numpy, ops))
    assert tuple(got.shape) == tuple(want.shape) == (n, c, p, q)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("impl", ["fold_ws", "fold_os", "fold_auto",
                                  "direct"])
def test_conv2d_fused_matches_reference_package(jx, impl):
    x, w, b = _inputs(2, 6, 11, 11, 8, 3, 3, seed=1)
    jnp = jx.jnp
    for epi in (BR, BRP):
        want = jx.ops.conv2d_fused(jnp.asarray(x), jnp.asarray(w),
                                   jnp.asarray(b), pad=1, impl=impl,
                                   epilogue=jx.Epilogue(**epi))
        got = t_ops.conv2d_fused(torch.from_numpy(x), torch.from_numpy(w),
                                 torch.from_numpy(b), pad=1, impl=impl,
                                 epilogue=TEpilogue(**epi))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    want = jx.ops.conv2d(jnp.asarray(x), jnp.asarray(w), pad=1, impl=impl)
    got = t_ops.conv2d(torch.from_numpy(x), torch.from_numpy(w), pad=1,
                       impl=impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("case", DIRECT_CASES)
def test_conv2d_direct_matches_reference_package(jx, case):
    n, c, x_, y_, nf, r, s, stride, pad = case
    x, w, _ = _inputs(n, c, x_, y_, nf, r, s, seed=2)
    want = jx.ref.conv2d_direct(jx.jnp.asarray(x), jx.jnp.asarray(w),
                                stride, pad)
    got = t_ref.conv2d_direct(torch.from_numpy(x), torch.from_numpy(w),
                              stride, pad)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# (N, C, H, W, NF, groups, R, stride, pad)
GROUPED_DIRECT_CASES = [
    (2, 8, 13, 13, 16, 4, 3, 1, 1),      # grouped 3x3, odd width
    (2, 6, 8, 8, 18, 2, 1, 1, 0),        # grouped 1x1
    (2, 16, 9, 9, 16, 16, 3, 1, 1),      # depthwise, odd width
    (2, 10, 15, 15, 10, 10, 3, 2, 1),    # depthwise stride 2, odd width
    (1, 24, 16, 16, 24, 24, 3, 2, 1),    # depthwise stride 2, even width
]


@pytest.mark.parametrize("case", GROUPED_DIRECT_CASES)
def test_grouped_conv2d_direct_matches_reference_package(jx, case):
    n, c, h, w_, nf, g, r, stride, pad = case
    rng = np.random.default_rng(10)
    x = rng.standard_normal((n, c, h, w_)).astype(np.float32)
    w = rng.standard_normal((nf, c // g, r, r)).astype(np.float32)
    want = jx.ref.conv2d_direct(jx.jnp.asarray(x), jx.jnp.asarray(w),
                                stride, pad, g)
    got = t_ref.conv2d_direct(torch.from_numpy(x), torch.from_numpy(w),
                              stride, pad, g)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_schedule_cache_binds_and_memoizes_the_fold_kernel():
    from repro_torch.core.engine import ScheduleCache
    from repro_torch.core.loopnest import ConvLoopNest
    x, w, b = (torch.from_numpy(a) for a in
               _inputs(2, 6, 13, 13, 8, 3, 3, seed=3))
    cache = ScheduleCache()
    sched = cache.schedule_for(ConvLoopNest(n=2, nf=8, c=6, r=3, s=3, x=11,
                                            y=11, pad=1))
    epi = TEpilogue(**BRP)
    fn = cache.kernel_for(sched, epi)
    assert cache.kernel_for(sched, epi) is fn
    want = t_ops.conv2d_fused(x, w, b, impl="direct", epilogue=epi)
    np.testing.assert_allclose(fn(x, w, bias=b).numpy(), want.numpy(),
                               **TOL)


@pytest.mark.parametrize("what", ["depthwise", "psum", "groups", "int8",
                                  "residual", "scale", "relu6", "psum_spill",
                                  "direct_groups", "fused_residual"])
def test_unported_variants_raise(what):
    """Every variant once refused is ported now and matches the plain
    reference (the direct conv, exact int32 for int8, and the reference
    epilogue) within TOL (fp32, two sum orders): depthwise, psum staging
    and the WS spill to it, int8, the residual / scale / ReLU6 epilogues,
    grouped direct conv and, last, grouped 1 < G < C on the WS / OS fold
    (``groups``), which raised until the tile core took it."""
    x, w, _ = (torch.from_numpy(a) for a in _inputs(1, 4, 6, 6, 4, 3, 3,
                                                    seed=11))
    wdw, wg = w[:, :1].contiguous(), w[:, :2].contiguous()
    res = torch.from_numpy(_inputs(1, 4, 4, 4, 4, 1, 1, seed=12)[0])
    scale, shift = torch.linspace(0.5, 1.5, 4), torch.linspace(-1, 1, 4)
    fold = t_kern.conv2d_folded
    direct = t_ref.conv2d_direct
    xs = torch.from_numpy(_inputs(1, 1, 132, 132, 1, 1, 1, seed=13)[0])
    ws_ = torch.from_numpy(_inputs(1, 1, 1, 1, 256, 3, 3, seed=14)[1])
    spill = t_kern.fold_kernel_spec(tuple(xs.shape), tuple(ws_.shape))
    assert spill.dataflow == "weight_stationary_psum"
    calls = {
        "depthwise": lambda: (
            fold(x, wdw, groups=4, dataflow="depthwise"),
            direct(x, wdw, groups=4)),
        "psum": lambda: (fold(x, w, dataflow="weight_stationary_psum"),
                         direct(x, w)),
        "groups": lambda: (fold(x, wg, groups=2),
                           direct(x, wg, groups=2)),
        "int8": lambda: (
            fold(x.to(torch.int8), w.to(torch.int8)),
            direct(x.to(torch.int8), w.to(torch.int8)).float()),
        "residual": lambda: (
            fold(x, w, epilogue=TEpilogue(residual=True), residual=res),
            direct(x, w) + res),
        "scale": lambda: (
            fold(x, w, epilogue=TEpilogue(scale=True), scale=scale,
                 shift=shift),
            apply_epilogue(direct(x, w), None, TEpilogue(scale=True),
                           scale=scale, shift=shift)),
        "relu6": lambda: (
            fold(x, w, epilogue=TEpilogue(relu6=True)),
            torch.clamp(direct(x, w), 0.0, 6.0)),
        # an identity-epilogue WS layer whose accumulator spills lands on
        # psum staging
        "psum_spill": lambda: (
            fold(xs, ws_), direct(xs, ws_)),
        "direct_groups": lambda: (
            direct(x, wg, groups=2),
            torch.cat([direct(x[:, :2], wg[:2]), direct(x[:, 2:], wg[2:])],
                      dim=1)),
        "fused_residual": lambda: (
            t_ops.conv2d_fused(x, w, residual=res, impl="fold_ws"),
            t_ops.conv2d_fused(x, w, residual=res, impl="direct")),
    }
    got, want = calls[what]()
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


# --------------------------------------------------------------------------
# int8 fold streaming and psum staging against the Pallas kernels
# --------------------------------------------------------------------------

# the epilogues the zoo fuses into the int8 WS / OS kernels
INT8_EPIS = {"bias+relu": BR, "scale": SC, "bias+residual+relu": BRR,
             "bias+relu+pool": BRP}
# (N, C, X, Y, NF, R, stride, pad, forced (nf_b, c_b, p_b)): g_c = 3
INT8_GEOM = (2, 8, 9, 9, 8, 3, 1, 1, (4, 3, 3))


def _int8_operands(epi, n, nf, p, q, seed=0):
    """Epilogue operands for ``conv2d_int8``: bias and the BN scale/shift
    (which the requant affine folds) and the shortcut."""
    ops = _epi_operands(epi, n, nf, p, q, seed)
    b = ops.pop("bias", None)
    return b, ops


def _int8_tol(want):
    return 1e-5 * max(1.0, float(np.abs(want).max()))


@pytest.mark.parametrize("impl", ["fold_ws", "fold_os"])
@pytest.mark.parametrize("epi", list(INT8_EPIS.values()),
                         ids=list(INT8_EPIS))
def test_plain_int8_fold_matches_pallas_interpret(jx, epi, impl):
    """``conv2d_int8`` on the plain int32 fold walk against the JAX
    package's ``conv2d_int8`` on the Pallas kernels in interpret mode, with
    the same fp32 operands and calibrated scale: within
    1e-5·max(1, max|ref|) (the sums are exact; the flush rounds the same
    steps)."""
    n, c, x_, y_, nf, r, stride, pad, forced = INT8_GEOM
    x, w, _ = _inputs(n, c, x_, y_, nf, r, r, seed=15)
    p, q = x_ + 2 * pad - r + 1, y_ + 2 * pad - r + 1
    b, ops = _int8_operands(epi, n, nf, p, q, seed=15)
    xs = jx.quant.act_scale(jx.jnp.asarray(x))
    want = jx.ops.conv2d_int8(
        jx.jnp.asarray(x), jx.jnp.asarray(w),
        None if b is None else jx.jnp.asarray(b), x_scale=xs, stride=stride,
        pad=pad, epilogue=jx.Epilogue(**epi), impl=impl,
        plan=_plan(jx.Plan, forced, nf, c), interpret=True,
        **_as(jx.jnp.asarray, ops))
    got = t_ops.conv2d_int8(
        torch.from_numpy(x), torch.from_numpy(w),
        None if b is None else torch.from_numpy(b), x_scale=xs,
        stride=stride, pad=pad, epilogue=TEpilogue(**epi), impl=impl,
        plan=_plan(TPlan, forced, nf, c), **_as(torch.from_numpy, ops))
    want = np.asarray(want)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert np.abs(got.numpy() - want).max() <= _int8_tol(want)


def test_plain_int8_depthwise_matches_pallas_interpret(jx):
    """The int8 depthwise walk (widened before the product) with BN+ReLU6
    against ``_dw_kernel``'s int8 body in interpret mode, c_pad > C."""
    n, c, x_, r, stride, pad = 2, 6, 11, 3, 2, 1
    x, w, _ = _inputs(n, c, x_, x_, c, r, r, seed=16)
    w = np.ascontiguousarray(w[:, :1])
    p = (x_ + 2 * pad - r) // stride + 1
    _, ops = _int8_operands(SC6, n, c, p, p, seed=16)
    xs = jx.quant.act_scale(jx.jnp.asarray(x))
    want = np.asarray(jx.ops.conv2d_int8(
        jx.jnp.asarray(x), jx.jnp.asarray(w), x_scale=xs, stride=stride,
        pad=pad, epilogue=jx.Epilogue(**SC6), impl="fold_dw",
        plan=_dw_plan(jx.Plan, (4, 3), c), interpret=True, groups=c,
        **_as(jx.jnp.asarray, ops)))
    got = t_ops.conv2d_int8(
        torch.from_numpy(x), torch.from_numpy(w), x_scale=xs, stride=stride,
        pad=pad, epilogue=TEpilogue(**SC6), impl="fold_dw",
        plan=_dw_plan(TPlan, (4, 3), c), groups=c,
        **_as(torch.from_numpy, ops))
    assert got.shape == want.shape == (n, c, p, p)
    assert np.abs(got.numpy() - want).max() <= _int8_tol(want)


def test_int8_direct_impl_matches_the_fold_walk():
    """``conv2d_int8(impl="direct")`` (the exact int32 reference conv and
    the unfused epilogue) gives the fold walk's bits: the same int32 sums,
    the same affine steps."""
    x, w, b = (torch.from_numpy(a) for a in _inputs(2, 6, 10, 10, 8, 3, 3,
                                                    seed=17))
    xs = float(x.abs().max()) / 127 + 1e-12
    kw = dict(x_scale=xs, pad=1, epilogue=TEpilogue(**BRP))
    got = t_ops.conv2d_int8(x, w, b, impl="fold_ws", **kw)
    want = t_ops.conv2d_int8(x, w, b, impl="direct", **kw)
    assert torch.equal(got, want)


@pytest.mark.parametrize("forced", [(4, 3, 3), (8, 2, 4)],
                         ids=["gc3_gnf2", "gc4"])
def test_plain_psum_matches_pallas_interpret(jx, forced):
    """The psum-staging walk (g_c >= 2) against ``_ws_psum_kernel`` in
    interpret mode, through ``impl="fold_ws_psum"``: within
    1e-5·max|ref| (fp32, the folds summed in another order)."""
    x, w, _ = _inputs(2, 8, 9, 10, 8, 3, 3, seed=18)
    want = np.asarray(jx.ops.conv2d(
        jx.jnp.asarray(x), jx.jnp.asarray(w), pad=1, impl="fold_ws_psum",
        plan=_plan(jx.Plan, forced, 8, 8), interpret=True))
    got = t_ops.conv2d(torch.from_numpy(x), torch.from_numpy(w), pad=1,
                       impl="fold_ws_psum", plan=_plan(TPlan, forced, 8, 8))
    spec = t_kern.fold_kernel_spec((2, 8, 11, 12), (8, 8, 3, 3),
                                   plan=_plan(TPlan, forced, 8, 8),
                                   dataflow="weight_stationary_psum")
    assert spec.cg_folds >= 2
    assert spec.output.array_shape[0] == spec.cg_folds
    assert got.shape == want.shape
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


def test_int8_on_psum_raises_as_the_reference_does(jx):
    x, w, _ = _inputs(1, 4, 6, 6, 4, 3, 3, seed=19)
    xq, wq = (np.clip(np.round(a * 20), -127, 127).astype(np.int8)
              for a in (x, w))
    with pytest.raises(ValueError, match="legacy psum dataflow cannot "
                                         "stream int8") as got:
        t_kern.conv2d_folded(torch.from_numpy(xq), torch.from_numpy(wq),
                             dataflow="weight_stationary_psum")
    with pytest.raises(ValueError) as want:
        jx.kern.conv2d_folded(jx.jnp.asarray(xq), jx.jnp.asarray(wq),
                              dataflow="weight_stationary_psum",
                              interpret=True)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="int8 activations need int8"):
        t_kern.conv2d_folded(torch.from_numpy(xq), torch.from_numpy(w))
    # an int8 identity-epilogue layer whose WS accumulator would spill
    xs = torch.zeros(1, 1, 132, 132, dtype=torch.int8)
    ws_ = torch.zeros(256, 1, 3, 3, dtype=torch.int8)
    with pytest.raises(ValueError, match="spilled to psum staging"):
        t_kern.conv2d_folded(xs, ws_)


@pytest.mark.parametrize("precision", ["fp32", "int8"])
def test_grouped_variant_still_raises(precision):
    """Grouped 1 < G < C on the WS / OS kernels, which raised until the
    tile core took it, now runs for fp32 and for int8 on both dataflows:
    the fold walk against the grouped direct conv (exact int32 for int8,
    TOL for fp32)."""
    x, w, _ = (torch.from_numpy(a) for a in _inputs(1, 4, 6, 6, 4, 3, 3,
                                                    seed=20))
    wg = w[:, :2].contiguous()
    if precision == "int8":
        x, wg = (torch.round(a * 20).clamp(-127, 127).to(torch.int8)
                 for a in (x, wg))
    want = t_ref.conv2d_direct(x, wg, groups=2).float()
    for df in ("weight_stationary", "output_stationary"):
        got = t_kern.conv2d_folded(x, wg, groups=2, dataflow=df)
        assert got.shape == want.shape
        if precision == "int8":
            assert torch.equal(got, want)
        else:
            np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


# --------------------------------------------------------------------------
# grouped 1 < G < C: the plain walk against the Pallas kernels
# --------------------------------------------------------------------------

# tests/test_mobilenet.py's grouped shapes: (C, NF, G, R, stride, pad, HW)
GROUPED_CASES = [(8, 16, 4, 3, 1, 1, 13), (12, 12, 3, 3, 2, 1, 17),
                 (6, 18, 2, 1, 1, 0, 8)]
GROUPED_TOL = dict(rtol=2e-5, atol=2e-5)    # tests/test_mobilenet.py's
GROUPED_EPIS = {"bias+relu": BR, "bias+relu+pool": BRP,
                "scale+residual": SCR}


@pytest.mark.parametrize("dataflow", ["weight_stationary",
                                      "output_stationary"])
@pytest.mark.parametrize("epi", list(GROUPED_EPIS.values()),
                         ids=list(GROUPED_EPIS))
@pytest.mark.parametrize("case", GROUPED_CASES,
                         ids=["3x3_g4", "3x3_s2_g3", "1x1_g2"])
def test_plain_grouped_walk_matches_pallas_interpret(jx, case, epi,
                                                     dataflow):
    """The grouped WS / OS walk (each filter fold on its own group's
    channels) against ``repro``'s ``conv2d_folded(..., groups=g)`` in
    interpret mode, with the epilogues the zoo fuses."""
    c, nf, g, r, stride, pad, hw = case
    x, w, _ = _inputs(2, c, hw + 2 * pad, hw + 2 * pad, nf, r, r, seed=22)
    w = np.ascontiguousarray(w[:, :c // g])
    p = (hw + 2 * pad - r) // stride + 1
    ops = _epi_operands(epi, 2, nf, p, p, seed=22)
    want = jx.kern.conv2d_folded(
        jx.jnp.asarray(x), jx.jnp.asarray(w), stride=stride,
        dataflow=dataflow, interpret=True, epilogue=jx.Epilogue(**epi),
        groups=g, **_as(jx.jnp.asarray, ops))
    got = t_kern.conv2d_folded(
        torch.from_numpy(x), torch.from_numpy(w), stride=stride,
        dataflow=dataflow, epilogue=TEpilogue(**epi), groups=g,
        **_as(torch.from_numpy, ops))
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **GROUPED_TOL)


# --------------------------------------------------------------------------
# the CTA tile chooser over every conv of the zoo
# --------------------------------------------------------------------------

def _zoo_specs(model, img, batch):
    """(layer, launch spec) of every WS / OS conv of a zoo model at full
    width, from the engine's own schedules (meta tensors: no data)."""
    from repro_torch.models import zoo
    spec = zoo.get_conv_model(model)
    params = spec.init_params(torch.Generator(), img=img, device="meta")
    net = zoo.compile_forward(spec, params, img=img, batch=batch,
                              device="meta")
    epis = {nd.name: nd.epilogue or TEpilogue() for nd in net.graph.nodes
            if nd.op == "conv"}
    nests = dict(net.layer_nests)
    out = []
    for name, sched in net.layer_schedules:
        cv = nests[name]
        if sched.dataflow == "depthwise":
            continue
        out.append((name, t_kern.fold_kernel_spec(
            (batch, cv.c, cv.x + 2 * cv.pad, cv.y + 2 * cv.pad),
            (cv.nf, cv.c // cv.groups, cv.r, cv.s), stride=cv.stride,
            plan=sched.plan, dataflow=sched.dataflow, epilogue=epis[name],
            groups=cv.groups)))
    return out


def _m_ranges(tile):
    """The [m0, m1) pixel ranges of the M tiles, CTA column by CTA column,
    as the kernel walks them."""
    out = []
    for cx in range(tile.grid[0]):
        lo = cx * tile.m_per_cta
        out += [(t * tile.bm, min(tile.m, (t + 1) * tile.bm))
                for t in range(lo, min(tile.m_tiles, lo + tile.m_per_cta))]
    return out


def _filter_ranges(tile):
    """The [f0, f1) real filters of each CTA row."""
    tpg = -(-tile.nfg // tile.bn)
    return [(g * tile.nfg + t * tile.bn,
             min((g + 1) * tile.nfg, g * tile.nfg + (t + 1) * tile.bn))
            for g in range(tile.groups) for t in range(tpg)]


@pytest.mark.parametrize("model,img", [("vgg16", 224), ("vgg16", 32),
                                       ("resnet18", 32),
                                       ("mobilenetv2", 32)])
def test_tile_chooser_covers_every_zoo_conv(model, img):
    """For every WS / OS conv of the model at full width, batch 1 and 4,
    on an H100's 132 SMs: the CTAs' M tiles cover the layer's pixels
    exactly once and its filters exactly once, no filter tile straddles a
    group, shared memory stays within one CTA's, and the length of each
    output's sum (its K order: c, then r, then s, in one thread) is the
    same at both batches."""
    orders = {}
    for batch in (1, 4):
        for name, spec in _zoo_specs(model, img, batch):
            tile = t_kern.fold_tile(spec, batch, 132)
            assert tile.smem <= t_kern.SMEM_LIMIT, name
            ms = _m_ranges(tile)
            assert ms[0][0] == 0 and ms[-1][1] == tile.m, name
            assert all(a[1] == b[0] for a, b in zip(ms, ms[1:])), name
            assert all(a < b for a, b in ms), name
            fs = _filter_ranges(tile)
            assert len(fs) == tile.n_tiles == tile.grid[1], name
            covered = sorted(f for a, b in fs for f in range(a, b))
            assert covered == list(range(spec.nf_pad)), name
            nfg = spec.nf_pad // spec.groups
            assert all(a // nfg == (b - 1) // nfg for a, b in fs), name
            assert tile.k_len == spec.c_pad // spec.groups * spec.r * spec.s
            orders.setdefault(batch, []).append((name, tile.k_len))
    assert orders[1] == orders[4]


@pytest.mark.parametrize("g_c", [1, 4])
def test_psum_tile_runs_the_depth_folds_side_by_side(g_c):
    """The psum launch of each VGG-16 conv at 224, batch 1, on the WS / OS
    tile core: its grid's third axis is the depth folds, each CTA's sum is
    one fold long, the M tiles cover the pixels once and the resident
    filter tile fits one CTA."""
    import dataclasses
    seen = 0
    for name, spec in _zoo_specs("vgg16", 224, 1):
        if spec.c < 4 * g_c:
            continue
        plan = dataclasses.replace(
            spec.plan, c_block=spec.c // g_c,
            grid=(spec.plan.grid[0], g_c, spec.plan.grid[2]))
        psum = t_kern.fold_kernel_spec(
            (1, spec.c, spec.x_rows, spec.inputs[0].array_shape[3]),
            (spec.nf, spec.c, 3, 3), plan=plan,
            dataflow="weight_stationary_psum")
        assert psum.cg_folds == g_c, name
        tile = t_kern.fold_tile(psum, 1, 132)
        assert tile.folds == g_c and tile.smem <= t_kern.SMEM_LIMIT, name
        assert tile.k_len == spec.c // g_c * 9, name
        ms = _m_ranges(tile)
        assert ms[0][0] == 0 and ms[-1][1] == tile.m == psum.p_pad * psum.q
        assert all(a[1] == b[0] for a, b in zip(ms, ms[1:])), name
        seen += 1
    assert seen == 12                        # conv1_1 has 3 channels


# --------------------------------------------------------------------------
# on the card: each CUDA kernel against its plain version
# --------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the fold kernels are CUDA-only")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dataflow", ["weight_stationary",
                                      "output_stationary"])
@pytest.mark.parametrize("case", FOLD_CASES)
def test_cuda_kernel_matches_plain_version(cuda_device, case, dataflow):
    n, c, x_, y_, nf, r, s, stride, pad, epi, forced = case
    x, w, b = (torch.from_numpy(a).to(cuda_device) for a in
               _inputs(n, c, x_ + 2 * pad, y_ + 2 * pad, nf, r, s))
    kw = dict(stride=stride, plan=_plan(TPlan, forced, nf, c),
              dataflow=dataflow, epilogue=TEpilogue(**epi),
              bias=b if epi.get("bias") else None)
    name = ("fold_conv_ws" if dataflow == "weight_stationary"
            else "fold_conv_os")
    before = t_kern.launch_counts()[name]
    got = t_kern.conv2d_folded(x, w, **kw)
    torch.cuda.synchronize()
    assert t_kern.launch_counts()[name] == before + 1
    want = t_kern.conv2d_folded_plain(x, w, **kw)
    tol = 1e-4 * max(1.0, want.abs().max().item())
    assert (got - want).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dataflow", ["weight_stationary",
                                      "output_stationary"])
@pytest.mark.parametrize("epi", [SC, SC6, SCR, BRR, BSR6],
                         ids=["scale", "scale+relu6", "scale+residual",
                              "bias+residual+relu",
                              "bias+scale+residual+relu6"])
@pytest.mark.parametrize("geom", EPI_GEOMS, ids=["3x3_gc3", "1x1_s2"])
def test_cuda_epilogues_match_plain_version(cuda_device, geom, epi,
                                            dataflow):
    """The WS / OS kernels' new epilogue steps against the plain walk:
    within 1e-4·max|plain| (FFMA against separate multiply and add)."""
    n, c, x_, y_, nf, r, s, stride, pad, forced = geom
    x, w, _ = (torch.from_numpy(a).to(cuda_device) for a in
               _inputs(n, c, x_ + 2 * pad, y_ + 2 * pad, nf, r, s, seed=8))
    p, q = (x_ + 2 * pad - r) // stride + 1, (y_ + 2 * pad - s) // stride + 1
    kw = dict(stride=stride, plan=_plan(TPlan, forced, nf, c),
              dataflow=dataflow, epilogue=TEpilogue(**epi),
              **_as(lambda a: torch.from_numpy(a).to(cuda_device),
                    _epi_operands(epi, n, nf, p, q)))
    got = t_kern.conv2d_folded(x, w, **kw)
    want = t_kern.conv2d_folded_plain(x, w, **kw)
    tol = 1e-4 * max(1.0, want.abs().max().item())
    assert (got - want).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("case", DW_CUDA_CASES)
def test_cuda_dw_kernel_matches_plain_version(cuda_device, case):
    """``fold_conv_dw`` against the plain depthwise walk: within
    1e-4·max|plain| (FFMA against separate multiply and add)."""
    n, c, x_, y_, r, stride, pad, epi, forced = case
    x, w, _ = (torch.from_numpy(a).to(cuda_device) for a in
               _inputs(n, c, x_ + 2 * pad, y_ + 2 * pad, c, r, r, seed=9))
    w = w[:, :1].contiguous()
    p, q = (x_ + 2 * pad - r) // stride + 1, (y_ + 2 * pad - r) // stride + 1
    kw = dict(stride=stride, plan=_dw_plan(TPlan, forced, c),
              dataflow="depthwise", epilogue=TEpilogue(**epi), groups=c,
              **_as(lambda a: torch.from_numpy(a).to(cuda_device),
                    _epi_operands(epi, n, c, p, q)))
    before = t_kern.launch_counts()["fold_conv_dw"]
    got = t_kern.conv2d_folded(x, w, **kw)
    torch.cuda.synchronize()
    assert t_kern.launch_counts()["fold_conv_dw"] == before + 1
    want = t_kern.conv2d_folded_plain(x, w, **kw)
    tol = 1e-4 * max(1.0, want.abs().max().item())
    span = 2 if epi.get("pool") else 1
    assert got.shape == want.shape == (n, c, p // span, q // span)
    assert (got - want).abs().max().item() <= tol


def _int8_kernel_case(device, epi, impl, forced, geom=INT8_GEOM, seed=21):
    """Quantized operands and the requant vectors of one int8 layer, as
    ``conv2d_folded`` keyword arguments, on ``device``."""
    from repro_torch.core import quant as t_quant
    n, c, x_, y_, nf, r, stride, pad, _ = geom
    x, w, _b = (torch.from_numpy(a).to(device) for a in
                _inputs(n, c, x_, y_, nf, r, r, seed=seed))
    p, q = x_ + 2 * pad - r + 1, y_ + 2 * pad - r + 1
    b, ops = _int8_operands(epi, n, nf, p, q, seed=seed)
    ops = _as(lambda a: torch.from_numpy(a).to(device), ops)
    b = None if b is None else torch.from_numpy(b).to(device)
    xs = t_quant.act_scale(x)
    wq, w_scale = t_quant.quantize_weight(w)
    xq = torch.nn.functional.pad(t_quant.quantize_act(x, xs),
                                 (pad, pad, pad, pad))
    epi_t = TEpilogue(**epi)
    scale, shift = t_quant.requant_affine(
        w_scale * torch.tensor(xs, device=device), epi_t, b,
        ops.pop("scale", None), ops.pop("shift", None))
    kw = dict(stride=stride, plan=_plan(TPlan, forced, nf, c),
              dataflow=impl, epilogue=t_quant.requant_epilogue(epi_t),
              scale=scale, shift=shift, **ops)
    return xq, wq, kw


@pytest.mark.cuda
@pytest.mark.parametrize("dataflow", ["weight_stationary",
                                      "output_stationary"])
@pytest.mark.parametrize("epi", list(INT8_EPIS.values()),
                         ids=list(INT8_EPIS))
@pytest.mark.parametrize("forced", [None, (4, 3, 3)], ids=["auto", "gc3"])
def test_cuda_int8_kernel_is_bitwise_its_plain_version(cuda_device, epi,
                                                       dataflow, forced):
    """``fold_conv_ws_i8`` / ``fold_conv_os_i8`` against the plain int32
    walk: bitwise (exact int32 sums, the flush rounded step by step)."""
    xq, wq, kw = _int8_kernel_case(cuda_device, epi, dataflow, forced)
    name = ("fold_conv_ws_i8" if dataflow == "weight_stationary"
            else "fold_conv_os_i8")
    before = t_kern.launch_counts()[name]
    got = t_kern.conv2d_folded(xq, wq, **kw)
    torch.cuda.synchronize()
    assert t_kern.launch_counts()[name] == before + 1
    assert torch.equal(got, t_kern.conv2d_folded_plain(xq, wq, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("case", DW_CUDA_CASES)
def test_cuda_int8_dw_kernel_is_bitwise_its_plain_version(cuda_device,
                                                          case):
    from repro_torch.core import quant as t_quant
    n, c, x_, y_, r, stride, pad, epi, forced = case
    x, w, _ = (torch.from_numpy(a).to(cuda_device) for a in
               _inputs(n, c, x_ + 2 * pad, y_ + 2 * pad, c, r, r, seed=9))
    wq, w_scale = t_quant.quantize_weight(w[:, :1].contiguous())
    xs = t_quant.act_scale(x)
    p, q = (x_ + 2 * pad - r) // stride + 1, (y_ + 2 * pad - r) // stride + 1
    ops = _as(lambda a: torch.from_numpy(a).to(cuda_device),
              _epi_operands(epi, n, c, p, q))
    epi_t = TEpilogue(**epi)
    scale, shift = t_quant.requant_affine(
        w_scale * torch.tensor(xs, device=cuda_device), epi_t, None,
        ops.pop("scale", None), ops.pop("shift", None))
    kw = dict(stride=stride, plan=_dw_plan(TPlan, forced, c),
              dataflow="depthwise", epilogue=t_quant.requant_epilogue(epi_t),
              groups=c, scale=scale, shift=shift, **ops)
    xq = t_quant.quantize_act(x, xs)
    before = t_kern.launch_counts()["fold_conv_dw_i8"]
    got = t_kern.conv2d_folded(xq, wq, **kw)
    torch.cuda.synchronize()
    assert t_kern.launch_counts()["fold_conv_dw_i8"] == before + 1
    assert torch.equal(got, t_kern.conv2d_folded_plain(xq, wq, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [None] + list(range(len(t_kern.TILES))),
                         ids=["picked"] + [f"tile{i}" for i in
                                           range(len(t_kern.TILES))])
@pytest.mark.parametrize("forced", [None, (8, 8, 4), (4, 3, 3), (8, 2, 4)],
                         ids=["auto", "gc1", "gc3_gnf2", "gc4"])
def test_cuda_psum_kernel_matches_plain_version(cuda_device, forced, tile):
    """``fold_conv_psum`` against the plain psum walk, with the tile the
    chooser picks and with each CTA tile forced, at g_c = 1, 3 and 4 and a
    ragged P and Q (9 x 10 outputs): within 1e-4·max(1, max|plain|) (FFMA
    against separate multiply and add)."""
    x, w, _ = (torch.from_numpy(a).to(cuda_device) for a in
               _inputs(2, 8, 11, 12, 8, 3, 3, seed=18))
    plan = _plan(TPlan, forced, 8, 8)
    kw = dict(plan=plan, dataflow="weight_stationary_psum")
    spec, *ops = t_kern.prepare(x, w, 1, plan, "weight_stationary_psum",
                                None, TEpilogue(), 1, None, None, None)
    assert forced is None or spec.cg_folds == 8 // forced[1] + (
        8 % forced[1] > 0)
    before = t_kern.launch_counts()["fold_conv_psum"]
    got = t_kern._finish(spec, t_kern.launch_psum(spec, *ops, tile=tile))
    torch.cuda.synchronize()
    assert t_kern.launch_counts()["fold_conv_psum"] == before + 1
    want = t_kern.conv2d_folded_plain(x, w, **kw)
    tol = 1e-4 * max(1.0, want.abs().max().item())
    assert got.shape == want.shape
    assert (got - want).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dataflow", ["weight_stationary",
                                      "output_stationary"])
@pytest.mark.parametrize("epi", list(GROUPED_EPIS.values()),
                         ids=list(GROUPED_EPIS))
@pytest.mark.parametrize("case", GROUPED_CASES,
                         ids=["3x3_g4", "3x3_s2_g3", "1x1_g2"])
def test_cuda_grouped_kernel_matches_plain_version(cuda_device, case, epi,
                                                   dataflow):
    """Grouped 1 < G < C on ``fold_conv_ws`` / ``fold_conv_os`` against the
    grouped plain walk: within 1e-4·max(1, max|plain|) (FFMA against
    separate multiply and add)."""
    c, nf, g, r, stride, pad, hw = case
    x, w, _ = _inputs(2, c, hw + 2 * pad, hw + 2 * pad, nf, r, r, seed=22)
    x, w = (torch.from_numpy(a).to(cuda_device)
            for a in (x, np.ascontiguousarray(w[:, :c // g])))
    p = (hw + 2 * pad - r) // stride + 1
    kw = dict(stride=stride, dataflow=dataflow, epilogue=TEpilogue(**epi),
              groups=g, **_as(lambda a: torch.from_numpy(a).to(cuda_device),
                              _epi_operands(epi, 2, nf, p, p, seed=22)))
    name = ("fold_conv_ws" if dataflow == "weight_stationary"
            else "fold_conv_os")
    before = t_kern.launch_counts()[name]
    got = t_kern.conv2d_folded(x, w, **kw)
    torch.cuda.synchronize()
    assert t_kern.launch_counts()[name] == before + 1
    want = t_kern.conv2d_folded_plain(x, w, **kw)
    assert got.shape == want.shape
    assert (got - want).abs().max().item() <= \
        1e-4 * max(1.0, want.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("dataflow", ["weight_stationary",
                                      "output_stationary"])
@pytest.mark.parametrize("case", GROUPED_CASES,
                         ids=["3x3_g4", "3x3_s2_g3", "1x1_g2"])
def test_cuda_grouped_int8_kernel_is_bitwise_its_plain_version(
        cuda_device, case, dataflow):
    """Grouped int8 on ``fold_conv_ws_i8`` / ``fold_conv_os_i8``: bitwise
    the plain int32 walk, bias+ReLU+pool in its requant form."""
    c, nf, g, r, stride, pad, hw = case
    xq, wq, kw = _int8_kernel_case(
        cuda_device, BRP if r == 3 and stride == 1 else BR, dataflow, None,
        geom=(2, c, hw, hw, nf, r, stride, pad, None), seed=23)
    wq = wq[:, :c // g].contiguous()
    kw["groups"] = g
    got = t_kern.conv2d_folded(xq, wq, **kw)
    assert torch.equal(got, t_kern.conv2d_folded_plain(xq, wq, **kw))


# a geometry every tile can run (no pool): g_c = 3, ragged NF, stride 1
TILE_GEOM = (2, 40, 9, 11, 30, 3, 1, 1, (24, 16, 5))
_TYPES = {"fp32": torch.float32, "int8": torch.int8, "bf16": torch.bfloat16}
# (tile, dataflow, precision): every tile of the core each instance runs
# on (``tile_core``: the tensor-core tiles for bf16; ``tile_count``)
EVERY_TILE = [(t, df, prec) for t in range(max(len(t_kern.TILES),
                                               len(t_kern.TC_TILES)))
              for df in ("weight_stationary", "output_stationary")
              for prec in _TYPES
              if t < t_kern.tile_count(t_kern.tile_core(df, _TYPES[prec]),
                                       df)]


@pytest.mark.cuda
@pytest.mark.parametrize("tile,dataflow,precision", EVERY_TILE,
                         ids=["-".join(map(str, c)) for c in EVERY_TILE])
def test_cuda_every_tile_matches_plain_version(cuda_device, tile, dataflow,
                                               precision):
    """Each CTA tile of the instance's core, forced through the launcher,
    against the plain walk with the scale + residual epilogue: fp32 within
    1e-4·max(1, max|plain|), int8 bitwise, bf16 within one bf16 step of
    each element plus 1e-4·max(1, max|plain|)."""
    n, c, x_, y_, nf, r, stride, pad, plan = TILE_GEOM
    if precision == "int8":
        x, w, kw = _int8_kernel_case(cuda_device, SCR, dataflow, plan,
                                     geom=TILE_GEOM, seed=24)
    else:
        dt = _TYPES[precision]
        x, w, _ = (torch.from_numpy(a).to(cuda_device, dt) for a in
                   _inputs(n, c, x_ + 2 * pad, y_ + 2 * pad, nf, r, r,
                           seed=24))
        p, q = x_ + 2 * pad - r + 1, y_ + 2 * pad - r + 1
        kw = dict(stride=stride, plan=_plan(TPlan, plan, nf, c),
                  dataflow=dataflow, epilogue=TEpilogue(**SCR),
                  **_as(lambda a: torch.from_numpy(a).to(cuda_device, dt),
                        _epi_operands(SCR, n, nf, p, q, seed=24)))
    spec, *ops = t_kern.prepare(
        x, w, kw["stride"], kw["plan"], kw["dataflow"], kw.get("bias"),
        kw["epilogue"], 1, kw.get("residual"), kw.get("scale"),
        kw.get("shift"))
    got = t_kern._finish(spec, t_kern.LAUNCHERS[spec.dataflow](
        spec, *ops, tile=tile))
    want = t_kern.conv2d_folded_plain(x, w, **kw)
    if precision == "int8":
        assert torch.equal(got, want)
    elif precision == "bf16":
        assert got.dtype == want.dtype == torch.bfloat16
        err = (got.float() - want.float()).abs()
        assert (err <= 2.0 ** -7 * want.float().abs() + 1e-4 * max(
            1.0, want.float().abs().max().item())).all()
    else:
        assert (got - want).abs().max().item() <= \
            1e-4 * max(1.0, want.abs().max().item())
