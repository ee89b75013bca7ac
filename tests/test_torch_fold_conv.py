"""The port's fold conv against the JAX package's: the plain-torch fold
loop on the CPU against the Pallas kernels in interpret mode, the fused
conv entry point, the direct-conv oracle, the refusal of unported
variants, and — on a card — each CUDA kernel against its plain version."""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.epilogue import Epilogue as TEpilogue  # noqa: E402
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
    from repro.kernels import conv2d_ws, ops, ref
    return types.SimpleNamespace(jnp=jnp, Epilogue=Epilogue,
                                 Plan=ConvBlockPlan, kern=conv2d_ws,
                                 ops=ops, ref=ref)


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
    x = torch.zeros(1, 4, 6, 6)
    w = torch.zeros(4, 4, 3, 3)
    fold = t_kern.conv2d_folded
    calls = {
        "depthwise": lambda: fold(x, torch.zeros(4, 1, 3, 3), groups=4,
                                  dataflow="depthwise"),
        "psum": lambda: fold(x, w, dataflow="weight_stationary_psum"),
        "groups": lambda: fold(x, torch.zeros(4, 2, 3, 3), groups=2),
        "int8": lambda: fold(x.to(torch.int8), w.to(torch.int8)),
        "residual": lambda: fold(x, w, epilogue=TEpilogue(residual=True)),
        "scale": lambda: fold(x, w, epilogue=TEpilogue(scale=True)),
        "relu6": lambda: fold(x, w, epilogue=TEpilogue(relu6=True)),
        # an identity-epilogue WS layer whose accumulator spills lands on
        # the unported psum staging
        "psum_spill": lambda: fold(torch.zeros(1, 1, 1026, 258),
                                   torch.zeros(256, 1, 3, 3)),
        "direct_groups": lambda: t_ref.conv2d_direct(
            x, torch.zeros(4, 2, 3, 3), groups=2),
        "fused_residual": lambda: t_ops.conv2d_fused(
            x, w, residual=torch.zeros(1, 4, 4, 4), impl="fold_ws"),
    }
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        calls[what]()


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
