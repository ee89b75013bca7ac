"""The port's LM-side kernels against the JAX package's: the causal conv1d's
plain version against ``conv1d_causal_folded`` (Pallas, interpret mode)
and ``conv1d_causal_ref``, the fold attention's plain version against
``flash_attention_folded`` (interpret mode) on the JAX kernel test's cases,
the bf16 attention kernel's rounding points (emulated in torch ops)
against both, and — on a card — each CUDA kernel against its plain
version."""
import importlib
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import attention_fold as t_attn  # noqa: E402
# the module: the package's name ``conv1d_causal`` is the op, as in
# ``repro.kernels``
t_conv = importlib.import_module("repro_torch.kernels.conv1d_causal")
from repro_torch.kernels import ops as t_ops  # noqa: E402
from repro_torch.kernels import ref as t_ref  # noqa: E402


@pytest.fixture(scope="module")
def jx():
    """The JAX package, imported only by the tests that compare against it
    (the CUDA cases run where JAX is not installed)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import ops, ref
    from repro.kernels.attention_fold import flash_attention_folded
    return types.SimpleNamespace(jnp=jnp, ops=ops, ref=ref,
                                 attention=flash_attention_folded)


# tests/test_kernels.py's conv1d shapes: (T, D, K), x (2, T, D)
CONV_SHAPES = [(16, 8, 4), (33, 16, 4), (8, 5, 3), (64, 128, 4), (7, 1, 2)]
# tests/test_attention_kernel.py's cases:
# (B, T, H, KV, hd, causal, window, q_block, k_block)
ATTN_CASES = [
    (2, 64, 8, 2, 16, True, 0, 16, 16),
    (1, 48, 4, 4, 32, True, 12, 16, 8),
    (2, 32, 6, 3, 16, False, 0, 8, 16),
    (1, 128, 2, 1, 64, True, 0, 32, 64),   # MQA
    (1, 33, 4, 2, 16, True, 0, 16, 16),    # T not a multiple of the block
]
# that file's tolerances: fp32 sums in another order; bf16 output rounding
ATTN_TOL = {"float32": 2e-5, "bfloat16": 3e-2}
BF16_STEP = 2.0 ** -7     # one bf16 step (ulp) relative to the value
# on the card only: the CUDA kernels' tile paths (64-row q and kv tiles)
# that the cases above do not reach, same fields (the blocks are the plain
# version's kv block)
CUDA_ATTN_CASES = [
    (2, 1000, 4, 2, 64, True, 0, 64, 256),      # ragged last q and kv tile
    (1, 2048, 4, 4, 64, True, 1024, 64, 256),   # a 1024-token window
    (1, 300, 4, 2, 16, True, 0, 64, 256),       # hd 16
    (1, 300, 4, 2, 32, True, 0, 64, 256),       # hd 32
    (1, 300, 4, 2, 128, True, 0, 64, 256),      # hd 128
    (2, 256, 8, 1, 64, True, 0, 64, 256),       # MQA, KV = 1
    (1, 512, 8, 4, 64, False, 0, 64, 256),      # non-causal
    (1, 200, 4, 1, 32, False, 100, 64, 256),    # non-causal window, MQA
]


def _conv_inputs(t, d, k, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, t, d)).astype(np.float32),
            rng.standard_normal((k, d)).astype(np.float32))


def _attn_inputs(b, t, h, kv, hd, seed=42):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, t, h, hd)).astype(np.float32),
            rng.standard_normal((b, t, kv, hd)).astype(np.float32),
            rng.standard_normal((b, t, kv, hd)).astype(np.float32))


def _bf16_np(a):
    """An fp32 array rounded to bf16 and back (the same values on both
    sides)."""
    return torch.from_numpy(a).bfloat16().float().numpy()


def _tensor_core_arithmetic(q, k, v, *, causal, window, kv_tile=64):
    """The bf16 attention kernel's rounding points in torch ops
    (``csrc/attention_fold.cu``, ``attention_tc_kernel``): q.k of the bf16
    inputs with fp32 sums (the products are exact), hd^-1/2 · log2 e applied
    to the fp32 scores, the online softmax in fp32 (base 2) over kv tiles
    of ``kv_tile`` rows, P split into bf16 hi and lo parts for P.V with
    fp32 sums, and one bf16 rounding of acc / max(den, 1e-30)."""
    b, t, h, hd = q.shape
    s, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    qf = q.float().transpose(1, 2)
    kf = k.float().transpose(1, 2).repeat_interleave(g, dim=1)
    vf = v.float().transpose(1, 2).repeat_interleave(g, dim=1)
    sl2 = torch.tensor(hd ** -0.5, dtype=torch.float32) \
        * torch.tensor(1.4426950408889634, dtype=torch.float32)
    qpos = torch.arange(t)[:, None]
    m = torch.full((b, h, t), -1e30)
    den = torch.zeros((b, h, t))
    acc = torch.zeros((b, h, t, hd))
    for k0 in range(0, s, kv_tile):
        k1 = min(s, k0 + kv_tile)
        sc = (qf @ kf[:, :, k0:k1].transpose(-1, -2)) * sl2
        kpos = torch.arange(k0, k1)[None, :]
        mask = torch.ones((t, k1 - k0), dtype=torch.bool)
        if causal:
            mask &= kpos <= qpos
        if window > 0:
            mask &= kpos > qpos - window
        sc = torch.where(mask, sc, torch.tensor(-1e30))
        m_new = torch.maximum(m, sc.amax(dim=-1))
        p = torch.exp2(sc - m_new[..., None])
        corr = torch.exp2(m - m_new)
        den = den * corr + p.sum(dim=-1)
        hi = p.bfloat16().float()
        lo = (p - hi).bfloat16().float()
        vt = vf[:, :, k0:k1]
        acc = acc * corr[..., None] + (hi @ vt + lo @ vt)
        m = m_new
    out = acc / torch.clamp(den, min=1e-30)[..., None]
    return out.transpose(1, 2).bfloat16()


def _within_one_bf16_step(got, want):
    """Each element within one bf16 step of ``want`` plus the fp32
    tolerance for the sums' order (chip_smoke.py holds the card to it)."""
    got, want = got.float(), want.float()
    scale = max(1.0, want.abs().max().item())
    return bool(((got - want).abs() <= BF16_STEP * want.abs()
                 + ATTN_TOL["float32"] * scale).all())


# --------------------------------------------------------------------------
# the causal conv1d
# --------------------------------------------------------------------------

@pytest.mark.parametrize("t,d,k", CONV_SHAPES)
def test_conv1d_plain_matches_reference(jx, t, d, k):
    """fp32: within 1e-6·max|ref| (the Pallas kernel may contract a
    product and a sum into one rounding)."""
    x, w = _conv_inputs(t, d, k)
    got = t_conv.conv1d_causal_folded(torch.from_numpy(x),
                                      torch.from_numpy(w)).numpy()
    for want in (jx.ops.conv1d_causal(jx.jnp.asarray(x), jx.jnp.asarray(w),
                                      impl="fold"),
                 jx.ref.conv1d_causal_ref(jx.jnp.asarray(x),
                                          jx.jnp.asarray(w))):
        want = np.asarray(want)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())


def test_conv1d_plain_bf16_is_bitwise_the_reference(jx):
    """bf16 operands: every product is exact in fp32 and the sums run in
    one order, so the bf16 outputs agree bit for bit."""
    x, w = (_bf16_np(a) for a in _conv_inputs(33, 16, 4, seed=3))
    got = t_conv.conv1d_causal_folded(torch.from_numpy(x).bfloat16(),
                                      torch.from_numpy(w).bfloat16())
    assert got.dtype == torch.bfloat16
    for impl in ("fold", "ref"):
        want = jx.ops.conv1d_causal(jx.jnp.asarray(x, jx.jnp.bfloat16),
                                    jx.jnp.asarray(w, jx.jnp.bfloat16),
                                    impl=impl)
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))


def test_conv1d_ops_default_is_the_reference_on_cpu():
    """``ops.conv1d_causal`` on a CPU tensor is the reference's numbers,
    with no kernel launched, and refuses a w that does not match x."""
    x, w = (torch.from_numpy(a) for a in _conv_inputs(16, 8, 4))
    before = t_conv.launch_counts()
    want = t_ref.conv1d_causal_ref(x, w)
    assert torch.equal(t_ops.conv1d_causal(x, w), want)
    assert t_conv.launch_counts() == before
    with pytest.raises(ValueError, match=r"\(K, D\)"):
        t_ops.conv1d_causal(x, w[:, :3])


# --------------------------------------------------------------------------
# fold attention
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case", ATTN_CASES)
def test_attention_plain_matches_reference(jx, case):
    b, t, h, kv, hd, causal, window, qb, kb = case
    q, k, v = _attn_inputs(b, t, h, kv, hd)
    got = t_attn.flash_attention_folded_plain(
        *(torch.from_numpy(a) for a in (q, k, v)), causal=causal,
        window=window, k_block=kb).numpy()
    want = np.asarray(jx.attention(*(jx.jnp.asarray(a) for a in (q, k, v)),
                                   causal=causal, window=window, q_block=qb,
                                   k_block=kb))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_plain_dtypes_match_reference(jx, dtype):
    q, k, v = _attn_inputs(1, 32, 4, 2, 16, seed=0)
    if dtype == "bfloat16":
        q, k, v = (_bf16_np(a) for a in (q, k, v))
    tt = getattr(torch, dtype)
    got = t_attn.flash_attention_folded_plain(
        *(torch.from_numpy(a).to(tt) for a in (q, k, v)), k_block=8)
    assert got.dtype == tt
    jt = getattr(jx.jnp, dtype)
    want = jx.attention(*(jx.jnp.asarray(a, jt) for a in (q, k, v)),
                        q_block=8, k_block=8)
    tol = ATTN_TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("case", ATTN_CASES)
def test_attention_bf16_kernel_arithmetic_within_one_bf16_step(jx, case):
    """The tensor-core kernel's arithmetic, emulated, on bf16 inputs:
    within one bf16 step (plus the fp32 tolerance) of the JAX kernel in
    interpret mode and of the port's plain version, element by element.
    P rounded to bf16 once, without its lo part, misses that limit."""
    b, t, h, kv, hd, causal, window, qb, kb = case
    q, k, v = (_bf16_np(a) for a in _attn_inputs(b, t, h, kv, hd))
    qt, kt, vt = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    got = _tensor_core_arithmetic(qt, kt, vt, causal=causal, window=window)
    assert got.shape == qt.shape and got.dtype == torch.bfloat16
    plain = t_attn.flash_attention_folded_plain(qt, kt, vt, causal=causal,
                                                window=window, k_block=kb)
    ref = np.asarray(jx.attention(*(jx.jnp.asarray(a, jx.jnp.bfloat16)
                                    for a in (q, k, v)),
                                  causal=causal, window=window, q_block=qb,
                                  k_block=kb), np.float32)
    assert _within_one_bf16_step(got, plain)
    assert _within_one_bf16_step(got, torch.from_numpy(ref))


# --------------------------------------------------------------------------
# on the card: each CUDA kernel against its plain version
# --------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the LM kernels are CUDA-only")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,d,k", CONV_SHAPES + [(1, 300, 4), (2, 130, 4),
                                                 (200, 4224, 4)])
def test_cuda_conv1d_kernel_is_bitwise_its_plain_version(cuda_device, t, d,
                                                         k, dtype):
    x, w = (torch.from_numpy(a).to(cuda_device, getattr(torch, dtype))
            for a in _conv_inputs(t, d, k))
    before = t_conv.launch_counts()[t_conv.KERNEL]
    got = t_conv.conv1d_causal_folded(x, w)
    torch.cuda.synchronize()
    assert t_conv.launch_counts()[t_conv.KERNEL] == before + 1
    assert torch.equal(got, t_conv.conv1d_causal_plain(x, w))


# the kernel's two paths (csrc/conv1d_causal.cu): (B, T, D, K, a storage
# offset of one element, the cache-prefixed form).  The vector path takes
# D a multiple of its 16-byte word (8 bf16, 4 fp32) on 16-byte boundaries,
# over tiles of 8 steps; the scalar path the rest (D = 300 in bf16 only)
CONV_PATH_CASES = [
    (2, 2048, 4224, 4, False, False),   # zamba2's prefill shape
    (2, 203, 4224, 4, False, False),    # T not a multiple of the tile
    (2, 203, 256, 1, False, False),     # K = 1
    (2, 203, 256, 4, False, False),
    (2, 203, 256, 8, False, False),     # K = KMAX
    (2, 1, 256, 4, False, False),       # T = 1
    (1, 2, 256, 4, False, False),       # T < K - 1
    (1, 5, 256, 8, False, False),
    (1, 8, 256, 8, False, False),       # one whole tile
    (2, 77, 300, 4, False, False),      # the scalar tail in bf16
    (2, 77, 267, 1, False, False),      # D = 8k + 3
    (2, 77, 267, 4, False, False),
    (2, 77, 267, 8, False, False),
    (1, 2, 267, 4, False, False),
    (2, 77, 4224, 4, True, False),      # x off the 16-byte grid
    (2, 77, 256, 8, True, False),
    (2, 16, 4224, 4, False, True),      # the model's cache prefix
    (2, 16, 300, 4, False, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CONV_PATH_CASES)
def test_cuda_conv1d_kernel_paths_are_bitwise_the_plain_version(
        cuda_device, case, dtype):
    """Each path of the conv1d kernel bitwise its plain version, the path
    the launcher takes being the one the case is for; a bf16 x with its w
    in bf16 (read as it is, widened in the kernel) and in fp32."""
    b, t, d, k, offset, prefix = case
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((b, t + (k - 1 if prefix else 0), d))
    w = torch.from_numpy(rng.standard_normal((k, d))).to(cuda_device, dt)
    x = torch.from_numpy(x).to(cuda_device, dt)
    if offset:
        buf = torch.empty(x.numel() + 1, device=cuda_device, dtype=dt)
        buf[1:] = x.reshape(-1)
        x = buf[1:].view(x.shape)
    word = 16 // x.element_size()
    assert t_conv.vector_path(x, w) == (d % word == 0 and not offset)
    drop = k - 1 if prefix else 0      # the cached rows' outputs
    want = t_conv.conv1d_causal_plain(x, w)[:, drop:]
    for wk in [w] if dtype == "float32" else [w, w.float()]:
        before = t_conv.launch_counts()[t_conv.KERNEL]
        got = t_conv.launch(x, wk)
        torch.cuda.synchronize()
        assert t_conv.launch_counts()[t_conv.KERNEL] == before + 1
        assert got.dtype == dt and torch.equal(got[:, drop:], want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ATTN_CASES + CUDA_ATTN_CASES)
def test_cuda_attention_kernel_matches_plain_version(cuda_device, case,
                                                     dtype):
    b, t, h, kv, hd, causal, window, _, kb = case
    q, k, v = (torch.from_numpy(a).to(cuda_device, getattr(torch, dtype))
               for a in _attn_inputs(b, t, h, kv, hd))
    before = t_attn.launch_counts()[t_attn.KERNEL]
    got = t_attn.flash_attention_folded(q, k, v, causal=causal,
                                        window=window)
    torch.cuda.synchronize()
    assert t_attn.launch_counts()[t_attn.KERNEL] == before + 1
    want = t_attn.flash_attention_folded_plain(q, k, v, causal=causal,
                                               window=window, k_block=kb)
    assert got.shape == want.shape and got.dtype == want.dtype
    got, want = got.float(), want.float()
    err = (got - want).abs()
    scale = max(1.0, want.abs().max().item())
    assert err.max().item() <= ATTN_TOL[dtype] * scale
    if dtype == "bfloat16":
        # both sides do fp32 math on the same bf16 inputs and round once:
        # each element within one bf16 step of the plain one, plus the fp32
        # tolerance for the sums' order
        assert bool((err <= BF16_STEP * want.abs()
                     + ATTN_TOL["float32"] * scale).all())
