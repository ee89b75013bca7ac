"""bf16 through the port's fold engine against the JAX package's: the
plain fold loops (WS, OS, grouped, depthwise, psum staging; every epilogue
the zoo fuses) against the Pallas kernels in interpret mode on the same
bf16 operands, the bf16 head against ``x @ w + b`` in jnp, mixed
fp32 / bf16 operands and ``out_dtype``, ``init_params(dtype=)``, and
compiled reduced VGG-16, ResNet-18 and MobileNetV2 in bf16 against
``repro``'s ``compile_network`` (``policy="reference"``) on the CPU; on a
card, the bf16 kernel instances against their plain versions and a bf16
network jitted against its eager forward.

Tolerance, element by element: ``2**-7 * |ref| + 1e-4 * max(1, max|ref|)``
(one bf16 step of the value, plus the fp32 sums taken in another order),
and at most ``3e-2 * max(1, max|ref|)`` (``tests/test_kernels.py:58``)."""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.engine import compile_network  # noqa: E402
from repro_torch.core.epilogue import Epilogue as TEpilogue  # noqa: E402
from repro_torch.core.mapping import ConvBlockPlan as TPlan  # noqa: E402
from repro_torch.kernels import conv2d_ws as t_kern  # noqa: E402
from repro_torch.kernels import dense as t_dense  # noqa: E402
from repro_torch.models import zoo  # noqa: E402

BF16 = torch.bfloat16
MODELS = ("vgg16", "resnet18", "mobilenetv2")
IMG, WIDTH, CLASSES = 32, 0.0625, 10


@pytest.fixture(scope="module")
def jx():
    """The JAX package, imported only by the tests that compare against it
    (the CUDA cases run where JAX is not installed)."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.core.engine import compile_network as j_compile
    from repro.core.epilogue import Epilogue
    from repro.core.mapping import ConvBlockPlan
    from repro.kernels import conv2d_ws
    from repro.models import mobilenet, resnet, vgg
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, Epilogue=Epilogue, Plan=ConvBlockPlan,
        kern=conv2d_ws, compile=j_compile,
        models={"vgg16": vgg, "resnet18": resnet, "mobilenetv2": mobilenet})


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the bf16 kernel instances run on "
                    "one")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def within(got, want):
    """The element rule above; ``got`` / ``want`` as fp32 numpy."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    err = np.abs(got - want)
    assert (err <= 2.0 ** -7 * np.abs(want) + 1e-4 * scale).all(), \
        float(err.max())
    assert err.max() <= 3e-2 * scale


def bf16_np(a):
    """fp32 values on the bf16 grid (so both packages start from the same
    bf16 numbers)."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        BF16).float().numpy()


def to_jax(jx, a, dtype):
    return jx.jnp.asarray(a).astype(dtype)


def to_np(a):
    """A JAX array as fp32 numpy."""
    return np.asarray(a.astype("float32"))


# ---------------------------------------------------------------------------
# the plain fold loops
# ---------------------------------------------------------------------------

ID, BR, BRP = {}, {"bias": True, "relu": True}, \
    {"bias": True, "relu": True, "pool": "max2"}
SC6, SCR, BRR = ({"scale": True, "relu6": True},
                 {"scale": True, "residual": True},
                 {"bias": True, "residual": True, "relu": True})
# (dataflow, N, C, X, NF, R, stride, groups, epilogue, forced plan
#  (nf_b, c_b, p_b) or None)
CASES = [
    ("weight_stationary", 2, 8, 10, 12, 3, 1, 1, BR, (8, 3, 3)),  # g_c 3
    ("weight_stationary", 2, 8, 10, 12, 3, 1, 1, BRP, None),
    ("weight_stationary", 2, 6, 9, 10, 1, 2, 1, SCR, None),
    ("output_stationary", 2, 8, 10, 12, 3, 1, 1, BRP, (8, 3, 3)),
    ("output_stationary", 2, 8, 10, 8, 3, 1, 1, BRR, None),
    ("output_stationary", 1, 8, 9, 16, 3, 2, 1, SC6, None),
    ("weight_stationary", 2, 8, 10, 8, 3, 1, 4, SC6, None),      # grouped
    ("output_stationary", 2, 8, 10, 16, 3, 1, 2, BRR, None),     # grouped
    ("depthwise", 2, 8, 9, 8, 3, 1, 8, SC6, None),
    ("depthwise", 2, 6, 11, 6, 3, 2, 6, SC6, (4, 4, 3)),         # c_pad 8
    ("depthwise", 2, 12, 8, 12, 3, 1, 12, SCR, None),
    ("weight_stationary_psum", 2, 8, 10, 12, 3, 1, 1, ID, (8, 3, 3)),
    ("weight_stationary_psum", 1, 16, 9, 8, 3, 1, 1, ID, (4, 4, 4)),
]


def _operands(n, c, x, nf, r, stride, groups, seed):
    rng = np.random.default_rng(seed)
    p = (x - r) // stride + 1
    return dict(
        x=bf16_np(rng.standard_normal((n, c, x, x))),
        w=bf16_np(rng.standard_normal((nf, c // groups, r, r))
                  / np.sqrt(c // groups * r * r)),
        bias=bf16_np(rng.standard_normal(nf)),
        scale=bf16_np(rng.uniform(0.5, 1.5, nf)),
        shift=bf16_np(rng.standard_normal(nf)),
        residual=bf16_np(rng.standard_normal((n, nf, p, p))))


def _plan(cls, forced, nf, c):
    if forced is None:
        return None
    nf_b, c_b, p_b = forced
    return cls(nf_block=nf_b, c_block=c_b, p_block=p_b,
               grid=(-(-nf // nf_b), -(-c // c_b), 1), vmem_bytes=0)


def _both(jx, case, seed, x_dtype="bf16", w_dtype="bf16", out_dtype=None):
    """One case through the port's plain walk and the Pallas kernel in
    interpret mode; returns (port output, reference output)."""
    df, n, c, x, nf, r, stride, groups, epi, forced = case
    ops = _operands(n, c, x, nf, r, stride, groups, seed)
    jd = {"bf16": jx.jnp.bfloat16, "fp32": jx.jnp.float32}
    td = {"bf16": BF16, "fp32": torch.float32}
    jkw = dict(stride=stride, dataflow=df, groups=groups,
               epilogue=jx.Epilogue(**epi),
               plan=_plan(jx.Plan, forced, nf, c))
    tkw = dict(stride=stride, dataflow=df, groups=groups,
               epilogue=TEpilogue(**epi), plan=_plan(TPlan, forced, nf, c))
    for key, on in (("bias", epi.get("bias")), ("scale", epi.get("scale")),
                    ("shift", epi.get("scale")),
                    ("residual", epi.get("residual"))):
        if on:
            dt = x_dtype if key == "residual" else "bf16"
            jkw[key] = to_jax(jx, ops[key], jd[dt])
            tkw[key] = torch.from_numpy(ops[key]).to(td[dt])
    if out_dtype is not None:
        jkw["out_dtype"] = jd[out_dtype]
        tkw["out_dtype"] = td[out_dtype]
    want = jx.kern.conv2d_folded(to_jax(jx, ops["x"], jd[x_dtype]),
                                 to_jax(jx, ops["w"], jd[w_dtype]),
                                 interpret=True, **jkw)
    got = t_kern.conv2d_folded(torch.from_numpy(ops["x"]).to(td[x_dtype]),
                               torch.from_numpy(ops["w"]).to(td[w_dtype]),
                               **tkw)
    return got, want


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-g{c[7]}-"
                         + "".join(k[:2] for k in c[8]))
def test_plain_bf16_fold_matches_reference_interpret(jx, case):
    got, want = _both(jx, case, seed=len(case[8]) + case[7])
    assert got.dtype == BF16 and str(want.dtype) == "bfloat16"
    within(got.float().numpy(), to_np(want))


@pytest.mark.parametrize("x_dtype,w_dtype", [("fp32", "bf16"),
                                             ("bf16", "fp32")])
@pytest.mark.parametrize("case", [CASES[0], CASES[4], CASES[8], CASES[11]],
                         ids=lambda c: c[0])
def test_mixed_operands_give_x_dtype(jx, case, x_dtype, w_dtype):
    """fp32 and bf16 mix as in the reference: each operand widened, the
    output in x's type."""
    got, want = _both(jx, case, seed=3, x_dtype=x_dtype, w_dtype=w_dtype)
    assert got.dtype == {"bf16": BF16, "fp32": torch.float32}[x_dtype]
    assert str(want.dtype) == {"bf16": "bfloat16", "fp32": "float32"}[x_dtype]
    within(got.float().numpy(), to_np(want))


@pytest.mark.parametrize("x_dtype,out_dtype", [("bf16", "fp32"),
                                               ("fp32", "bf16")])
@pytest.mark.parametrize("case", [CASES[3], CASES[9], CASES[12]],
                         ids=lambda c: c[0])
def test_out_dtype_is_honored(jx, case, x_dtype, out_dtype):
    got, want = _both(jx, case, seed=5, x_dtype=x_dtype, w_dtype=x_dtype,
                      out_dtype=out_dtype)
    assert got.dtype == {"bf16": BF16, "fp32": torch.float32}[out_dtype]
    assert str(want.dtype) == {"bf16": "bfloat16",
                               "fp32": "float32"}[out_dtype]
    within(got.float().numpy(), to_np(want))


def test_operand_types_refused_as_the_reference_refuses():
    x = torch.zeros(1, 4, 6, 6, dtype=BF16)
    w = torch.zeros(4, 4, 3, 3, dtype=torch.int8)
    with pytest.raises(ValueError, match="fp32 / bf16 or int8"):
        t_kern.conv2d_folded(x, w)
    with pytest.raises(ValueError, match="fp32 / bf16 or int8"):
        t_kern.conv2d_folded(x.double(), w.double())
    with pytest.raises(ValueError, match="int8 activations need int8"):
        t_kern.conv2d_folded(x.to(torch.int8), w.to(BF16))


# ---------------------------------------------------------------------------
# the head
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rows,k,n", [(1, 64, 10), (3, 200, 37),
                                      (8, 512, 128)])
def test_bf16_head_matches_reference(jx, rows, k, n):
    """``dense`` on bf16 operands gives the JAX package's bf16 ``x @ w +
    b``: the product rounded to bf16, then the sum with the bias."""
    rng = np.random.default_rng(rows + k)
    x = bf16_np(rng.standard_normal((rows, k)))
    w = bf16_np(rng.standard_normal((k, n)) / np.sqrt(k))
    b = bf16_np(rng.standard_normal(n))
    jb = jx.jnp.bfloat16
    want = to_jax(jx, x, jb) @ to_jax(jx, w, jb) + to_jax(jx, b, jb)
    got = t_dense.dense(*(torch.from_numpy(a).to(BF16) for a in (x, w, b)))
    assert got.dtype == BF16 and str(want.dtype) == "bfloat16"
    within(got.float().numpy(), to_np(want))
    # row i is the same at every batch width
    one = t_dense.dense_plain(*(torch.from_numpy(a).to(BF16)
                                for a in (x[-1:], w, b)))
    assert torch.equal(one[0], got[-1])
    # a mix of fp32 and bf16 promotes to fp32, as jnp does
    mixed = t_dense.dense(torch.from_numpy(x), *(torch.from_numpy(a).to(BF16)
                                                 for a in (w, b)))
    jmixed = jx.jnp.asarray(x) @ to_jax(jx, w, jb) + to_jax(jx, b, jb)
    assert mixed.dtype == torch.float32 and str(jmixed.dtype) == "float32"
    np.testing.assert_allclose(mixed.numpy(), np.asarray(jmixed),
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# parameters and whole networks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model", MODELS)
def test_init_params_dtype(model):
    """``init_params(dtype=)``: every leaf in that type, the fp32 draw of
    the same generator rounded once."""
    spec = zoo.get_conv_model(model)
    kw = dict(width_mult=WIDTH, img=IMG, classes=CLASSES, device="cpu")
    p32 = spec.init_params(torch.Generator().manual_seed(4), **kw)
    p16 = spec.init_params(torch.Generator().manual_seed(4), dtype=BF16,
                           **kw)
    assert p32.keys() == p16.keys()
    for name in p32:
        for leaf in p32[name]:
            assert p32[name][leaf].dtype == torch.float32
            assert p16[name][leaf].dtype == BF16
            assert torch.equal(p16[name][leaf], p32[name][leaf].to(BF16))


def _bf16_params(jx, model, seed=0):
    """The JAX package's bf16 params (batch-norm statistics drawn, so the
    fold is not an identity), and the port's copy of them."""
    jm = jx.models[model]
    jp = jm.init_params(jx.jax.random.PRNGKey(seed), width_mult=WIDTH,
                        img=IMG, classes=CLASSES, dtype=jx.jnp.bfloat16)
    rng = np.random.default_rng(seed + 1)
    for leaf in jp.values():
        if "gamma" in leaf:
            c = leaf["gamma"].shape[0]
            for key, a in (("gamma", rng.uniform(0.5, 1.5, c)),
                           ("beta", rng.normal(0, 0.1, c)),
                           ("mean", rng.normal(0, 0.1, c)),
                           ("var", rng.uniform(0.5, 1.5, c))):
                leaf[key] = to_jax(jx, a, jx.jnp.bfloat16)
        elif "b" in leaf:
            leaf["b"] = to_jax(jx, rng.normal(0, 0.1, leaf["b"].shape[0]),
                               jx.jnp.bfloat16)
    tp = params_from_jax(jp, device="cpu")
    return jm, jp, tp


@pytest.mark.parametrize("model", MODELS)
def test_bf16_leaves_cross_from_jax(jx, model):
    _, jp, tp = _bf16_params(jx, model)
    for name, leaf in jp.items():
        for key, a in leaf.items():
            assert tp[name][key].dtype == BF16
            np.testing.assert_array_equal(tp[name][key].float().numpy(),
                                          to_np(a))


@pytest.mark.parametrize("model", MODELS)
def test_compiled_bf16_network_matches_reference(jx, model):
    """A compiled reduced network in bf16 (``policy="reference"``) gives
    bf16 logits within the rule of ``repro``'s ``compile_network``; the
    kernel policy's plain fold loops run the same network in bf16."""
    jm, jp, tp = _bf16_params(jx, model)
    x = bf16_np(np.random.default_rng(9).standard_normal((2, 3, IMG, IMG)))
    shape = (2, 3, IMG, IMG)
    jnet = jx.compile(jp, jm.to_graph(), shape, policy="reference")
    want = jnet(jp, to_jax(jx, x, jx.jnp.bfloat16))
    spec = zoo.get_conv_model(model)
    net = compile_network(tp, spec.graph(), shape, policy="reference",
                          device="cpu")
    assert net.dtype == BF16
    got = net(tp, torch.from_numpy(x).to(BF16))
    assert got.dtype == BF16 and str(want.dtype) == "bfloat16"
    within(got.float().numpy(), to_np(want))
    kernel = compile_network(tp, spec.graph(), shape, policy="kernel",
                             device="cpu", cache=net.cache)
    out = kernel(tp, torch.from_numpy(x).to(BF16))
    assert out.dtype == BF16 and out.shape == got.shape
    assert torch.isfinite(out.float()).all()


def test_vision_engine_serves_a_bf16_network():
    """``VisionEngine`` on bf16 parameters takes fp32 images, rounds them
    to bf16 and returns its logits widened to fp32, bitwise a direct bf16
    forward of the same images."""
    from repro_torch.serve.vision import VisionEngine
    spec = zoo.get_conv_model("mobilenetv2")
    params = spec.init_params(torch.Generator().manual_seed(2),
                              width_mult=WIDTH, img=IMG, classes=CLASSES,
                              device="cpu", dtype=BF16)
    eng = VisionEngine(params, spec.to_graph(), img=IMG, buckets=(1, 2),
                       policy="reference", device="cpu")
    assert eng.input_dtype == BF16
    im = np.random.default_rng(1).standard_normal(
        (2, 3, IMG, IMG)).astype(np.float32)
    req = eng.submit(im)
    eng.run()
    assert req.outcome.value == "ok" and req.logits.dtype == np.float32
    direct = zoo.compile_forward(spec, params, img=IMG, batch=2,
                                 policy="reference", device="cpu")
    want = direct(params, torch.from_numpy(im).to(BF16)).float().numpy()
    np.testing.assert_array_equal(req.logits, want)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-g{c[7]}-"
                         + "".join(k[:2] for k in c[8]))
def test_cuda_bf16_kernel_matches_plain(cuda_device, case):
    df, n, c, x, nf, r, stride, groups, epi, forced = case
    ops = {k: torch.from_numpy(v).to(cuda_device, BF16)
           for k, v in _operands(n, c, x, nf, r, stride, groups, 1).items()}
    kw = dict(stride=stride, dataflow=df, groups=groups,
              epilogue=TEpilogue(**epi), plan=_plan(TPlan, forced, nf, c))
    for key, on in (("bias", epi.get("bias")), ("scale", epi.get("scale")),
                    ("shift", epi.get("scale")),
                    ("residual", epi.get("residual"))):
        if on:
            kw[key] = ops[key]
    before = t_kern.launch_counts()
    got = t_kern.conv2d_folded(ops["x"], ops["w"], **kw)
    torch.cuda.synchronize()
    after = t_kern.launch_counts()
    launched = {k for k in after if after[k] != before[k]}
    assert len(launched) == 1 and launched.pop().endswith("_bf16")
    want = t_kern.conv2d_folded_plain(ops["x"], ops["w"], **kw)
    assert got.dtype == BF16
    within(got.float().cpu().numpy(), want.float().cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("rows,k,n", [(1, 25088, 4096), (3, 512, 10),
                                      (9, 1280, 1000), (2, 100, 7)])
def test_cuda_bf16_head_matches_plain(cuda_device, rows, k, n):
    g = torch.Generator(device=cuda_device).manual_seed(rows)
    x = torch.randn(rows, k, generator=g, device=cuda_device).to(BF16)
    w = (torch.randn(k, n, generator=g, device=cuda_device)
         / k ** 0.5).to(BF16)
    b = torch.randn(n, generator=g, device=cuda_device).to(BF16)
    before = t_dense.launch_counts()[t_dense.KERNEL_BF16]
    got = t_dense.dense(x, w, b)
    assert t_dense.launch_counts()[t_dense.KERNEL_BF16] == before + 1
    within(got.float().cpu().numpy(),
           t_dense.dense_plain(x, w, b).float().cpu().numpy())
    one = t_dense.dense(x[-1:], w, b)
    assert torch.equal(one[0], got[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("model", MODELS)
def test_cuda_bf16_network_jitted_is_the_eager_forward(cuda_device, model):
    spec = zoo.get_conv_model(model)
    params = spec.init_params(
        torch.Generator(device=cuda_device).manual_seed(3), width_mult=0.25,
        img=IMG, classes=CLASSES, device=cuda_device, dtype=BF16)
    jitted = zoo.compile_forward(spec, params, img=IMG, batch=2,
                                 device=cuda_device)
    eager = zoo.compile_forward(spec, params, img=IMG, batch=2, jit=False,
                                cache=jitted.cache, device=cuda_device)
    x = torch.randn(2, 3, IMG, IMG, device=cuda_device).to(BF16)
    with torch.inference_mode():
        want = eager(params, x)
        for _ in range(2):
            assert torch.equal(jitted(params, x), want)
        with pytest.raises(ValueError):
            jitted(params, x.float())
    assert want.dtype == BF16 and jitted.captures == 1
