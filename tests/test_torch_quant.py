"""The port's int8 path against the JAX package's: the quantizers and the
requant affine, the exact int32 reference accumulator, the calibration
pass, the int8 schedule tables of the three zoo models, whole-network
int8 logits with the JAX recipe carried across, the grouped 1 < G < C
int8 fold, and the serving surface
(one recipe for every bucket and for the reference rung), on the CPU.
Width 0.0625, img 32."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core import quant as j_quant  # noqa: E402
from repro.core.epilogue import Epilogue as JEpilogue  # noqa: E402
from repro.core.engine import compile_network as j_compile  # noqa: E402
from repro.core.engine import \
    dataflow_traffic_bytes as j_traffic  # noqa: E402
from repro.models.zoo import get_conv_model as j_model  # noqa: E402
from repro_torch.convert import recipe_from_jax  # noqa: E402
from repro_torch.core import quant as t_quant  # noqa: E402
from repro_torch.core.engine import BucketCompiler  # noqa: E402
from repro_torch.core.engine import compile_network  # noqa: E402
from repro_torch.core.engine import \
    dataflow_traffic_bytes as t_traffic  # noqa: E402
from repro_torch.core.epilogue import Epilogue as TEpilogue  # noqa: E402
from repro_torch.kernels import ref as t_ref  # noqa: E402
from repro_torch.models import vgg as t_vgg  # noqa: E402
from repro_torch.models import zoo  # noqa: E402
from repro_torch.serve.vision import VisionEngine  # noqa: E402

IMG, WIDTH, CLASSES = 32, 0.0625, 10
MODELS = ("vgg16", "resnet18", "mobilenetv2")


def _rng_tensor(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


# --------------------------------------------------------------------------
# (a) quantizers, (b) requant affine, (c) the exact int32 accumulator
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape,seed", [((2, 5, 7, 9), 0), ((16, 3, 3, 3), 1),
                                        ((4, 1, 3, 3), 2)])
def test_quantizers_are_bitwise_equal_to_the_reference(shape, seed):
    """quantize_act / quantize_weight / quantize_int8: the int8 tensors and
    the scales are bitwise the JAX package's (fp32 scales, round half to
    even, clip, cast)."""
    x = _rng_tensor(shape, seed, 3.0)
    x.flat[::7] = np.round(x.flat[::7] * 2) / 2      # ties on the grid
    xs_j, xs_t = j_quant.act_scale(jnp.asarray(x)), \
        t_quant.act_scale(torch.from_numpy(x))
    assert xs_t == xs_j
    np.testing.assert_array_equal(
        t_quant.quantize_act(torch.from_numpy(x), xs_t).numpy(),
        np.asarray(j_quant.quantize_act(jnp.asarray(x), xs_j)))
    wq_t, ws_t = t_quant.quantize_weight(torch.from_numpy(x))
    wq_j, ws_j = j_quant.quantize_weight(jnp.asarray(x))
    np.testing.assert_array_equal(wq_t.numpy(), np.asarray(wq_j))
    np.testing.assert_array_equal(ws_t.numpy(), np.asarray(ws_j))
    q_t, s_t = t_quant.quantize_int8(torch.from_numpy(x))
    q_j, s_j = j_quant.quantize_int8(jnp.asarray(x))
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    assert s_t.item() == float(s_j)
    np.testing.assert_array_equal(
        t_quant.dequantize_int8(q_t, s_t).numpy(),
        np.asarray(j_quant.dequantize_int8(q_j, s_j)))
    assert t_quant.int32_accumulator_bound(512, 3, 3) == \
        j_quant.int32_accumulator_bound(512, 3, 3)


@pytest.mark.parametrize("epi", [{}, {"bias": True}, {"scale": True},
                                 {"bias": True, "scale": True}],
                         ids=["none", "bias", "scale", "bias+scale"])
def test_requant_affine_matches_within_one_ulp(epi):
    nf = 24
    dq = np.abs(_rng_tensor(nf, 3, 1e-3)) + 1e-4
    b, s, t = _rng_tensor(nf, 4), 1 + _rng_tensor(nf, 5, 0.2), \
        _rng_tensor(nf, 6, 0.2)
    want = j_quant.requant_affine(
        jnp.asarray(dq), JEpilogue(**epi), jnp.asarray(b), jnp.asarray(s),
        jnp.asarray(t))
    got = t_quant.requant_affine(
        torch.from_numpy(dq), TEpilogue(**epi), torch.from_numpy(b),
        torch.from_numpy(s), torch.from_numpy(t))
    for g, w in zip(got, want):
        np.testing.assert_array_max_ulp(g.numpy(), np.asarray(w), maxulp=1)
    want_epi = j_quant.requant_epilogue(JEpilogue(**epi, relu=True))
    got_epi = t_quant.requant_epilogue(TEpilogue(**epi, relu=True))
    assert str(got_epi) == str(want_epi) == "scale+relu"


# (N, C, H, W, NF, groups, R, stride, pad)
ACC_CASES = [
    (2, 6, 9, 11, 8, 1, 3, 1, 1),
    (1, 8, 10, 10, 12, 1, 3, 2, 1),
    (2, 8, 7, 7, 8, 8, 3, 1, 1),          # depthwise
    (2, 8, 6, 6, 4, 2, 1, 1, 0),          # grouped 1x1
]


@pytest.mark.parametrize("case", ACC_CASES)
def test_int32_accumulator_is_bitwise_the_reference(case):
    """The exact int32 reference conv against ``lax.conv_general_dilated``
    with an int32 accumulator, on random int8 operands."""
    n, c, h, w_, nf, g, r, stride, pad = case
    rng = np.random.default_rng(7)
    x = rng.integers(-127, 128, (n, c, h, w_)).astype(np.int8)
    w = rng.integers(-127, 128, (nf, c // g, r, r)).astype(np.int8)
    want = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (stride, stride),
        [(pad, pad), (pad, pad)], dimension_numbers=("NCHW", "OIHW", "NCHW"),
        feature_group_count=g, preferred_element_type=jnp.int32)
    got = t_ref.conv2d_direct(torch.from_numpy(x), torch.from_numpy(w),
                              stride, pad, g)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("sign", [1, -1], ids=["plus", "minus"])
def test_int32_accumulator_at_saturation(sign):
    """Every operand at the int8 extreme over a 2048-channel 3x3 depth:
    127*127*2048*9 accumulates exactly, as in the JAX package's test."""
    cg, r = 2048, 3
    x = np.full((1, cg, r, r), 127 * sign, np.int8)
    w = np.full((4, cg, r, r), 127, np.int8)
    want = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (1, 1), [(0, 0), (0, 0)],
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
        preferred_element_type=jnp.int32)
    got = t_ref.conv2d_direct(torch.from_numpy(x), torch.from_numpy(w))
    bound = t_quant.int32_accumulator_bound(cg, r, r)
    assert 0 < bound <= t_quant.INT32_ACC_MAX
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.flatten().tolist() == [sign * bound] * 4


# tests/test_quant.py's grouped int8 layer: NF = C = 8, 6x6, G = 2, 3x3
GROUPED_EPIS = {"bias+relu": {"bias": True, "relu": True},
                "bias+relu+pool": {"bias": True, "relu": True,
                                   "pool": "max2"},
                "scale+residual": {"scale": True, "residual": True}}


@pytest.mark.parametrize("impl", ["fold_ws", "fold_os"])
@pytest.mark.parametrize("epi", list(GROUPED_EPIS.values()),
                         ids=list(GROUPED_EPIS))
def test_grouped_int8_fold_matches_the_reference(epi, impl):
    """Grouped 1 < G < C int8 through ``conv2d_int8`` on the plain int32
    fold walk against the JAX package's ``conv2d_int8(..., groups=2)`` on
    the Pallas kernels in interpret mode, the same numpy operands and
    calibrated scale: within 1e-5 (tests/test_quant.py's tolerance; the
    int32 sums are exact, the flush rounds the same steps)."""
    n, c, nf, hw, g = 2, 8, 8, 6, 2
    x, w = _rng_tensor((n, c, hw, hw), 30), _rng_tensor((nf, c // g, 3, 3),
                                                       31)
    ops = {}
    if epi.get("bias"):
        ops["b"] = _rng_tensor(nf, 32)
    if epi.get("scale"):
        ops["scale"] = 1 + _rng_tensor(nf, 33, 0.2)
        ops["shift"] = _rng_tensor(nf, 34, 0.2)
    if epi.get("residual"):
        ops["residual"] = _rng_tensor((n, nf, hw, hw), 35)
    xs = j_quant.act_scale(jnp.asarray(x))
    from repro.kernels.ops import conv2d_int8 as j_conv2d_int8
    from repro_torch.kernels.ops import conv2d_int8 as t_conv2d_int8
    want = np.asarray(j_conv2d_int8(
        jnp.asarray(x), jnp.asarray(w), x_scale=xs, pad=1,
        epilogue=JEpilogue(**epi), impl=impl, interpret=True, groups=g,
        **{k: jnp.asarray(v) for k, v in ops.items()}))
    got = t_conv2d_int8(
        torch.from_numpy(x), torch.from_numpy(w), x_scale=xs, pad=1,
        epilogue=TEpilogue(**epi), impl=impl, groups=g,
        **{k: torch.from_numpy(v) for k, v in ops.items()})
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------------
# (e) calibration, (f) schedule tables, (g) whole networks
# --------------------------------------------------------------------------

def _randomize_bn(params, seed=7):
    """Random batch-norm statistics, as the JAX package's MobileNetV2
    tests draw them (the init statistics are the identity)."""
    rng = np.random.default_rng(seed)
    for name, leaf in params.items():
        if name.endswith("_bn"):
            n = leaf["gamma"].shape[0]
            draws = {"gamma": 1.0 + 0.2 * rng.standard_normal(n),
                     "beta": 0.2 * rng.standard_normal(n),
                     "mean": 0.3 * rng.standard_normal(n),
                     "var": rng.uniform(0.5, 1.5, n)}
            for k, v in draws.items():
                leaf[k] = torch.as_tensor(v, dtype=torch.float32)
    return params


@pytest.fixture(scope="module")
def nets():
    """Per model: the port's params (random BN statistics on MobileNetV2),
    the same weights as numpy for the JAX package, and a numpy batch."""
    out = {}
    for i, m in enumerate(MODELS):
        tp = _randomize_bn(zoo.get_conv_model(m).init_params(
            torch.Generator().manual_seed(i), width_mult=WIDTH, img=IMG,
            classes=CLASSES, device="cpu"))
        jp = {k: {kk: vv.numpy() for kk, vv in leaf.items()}
              for k, leaf in tp.items()}
        out[m] = (tp, jp, _rng_tensor((2, 3, IMG, IMG), 20 + i))
    return out


@pytest.fixture(scope="module")
def jax_recipes(nets):
    """The JAX package's own calibration of VGG-16 and ResNet-18 on each
    network's numpy batch (MobileNetV2's takes ~24 s of eager JAX here and
    is left out: ``test_whole_network_int8`` hands both packages the
    port's recipe for it)."""
    return {m: j_quant.quantize_graph(j_model(m).to_graph(), nets[m][1],
                                      jnp.asarray(nets[m][2]))
            for m in ("vgg16", "resnet18")}


@pytest.mark.parametrize("model", ["vgg16", "resnet18"])
def test_quantize_graph_matches_the_reference(nets, jax_recipes, model):
    """The same numpy calibration batch through both packages: the same
    conv names, activation scales equal to rel 1e-6, weight scales
    bitwise."""
    tp, _, x = nets[model]
    got = t_quant.quantize_graph(zoo.get_conv_model(model).to_graph(), tp,
                                 torch.from_numpy(x))
    want = jax_recipes[model]
    assert list(got.act_scales) == list(want.act_scales)
    for k, v in want.act_scales.items():
        assert got.act_scales[k] == pytest.approx(v, rel=1e-6)
        np.testing.assert_array_equal(got.w_scales[k].numpy(),
                                      np.asarray(want.w_scales[k]))
    assert got.scale_for(next(iter(got.act_scales))) > 0
    with pytest.raises(ValueError, match="no calibrated activation"):
        got.scale_for("not_a_conv")


def _describe_rows(text):
    """The per-layer rows of a ``describe()``, without the JAX package's
    trailing ``[model]`` source tag."""
    return [ln.split(" [")[0].rstrip() for ln in text.splitlines()[1:]]


@pytest.mark.parametrize("model", MODELS)
def test_int8_schedule_table_matches_the_reference(nets, model):
    """Int8 ``describe()``: the same schedule table with ``/int8`` keys
    and the same fold reuse as the JAX package's, fp32 keys untouched."""
    tp, jp, _ = nets[model]
    shape = (2, 3, IMG, IMG)
    recipe = t_quant.quantize_graph(zoo.get_conv_model(model).to_graph(), tp,
                                    torch.from_numpy(nets[model][2]))
    j_recipe = j_quant.QuantRecipe(act_scales=dict(recipe.act_scales),
                                   w_scales={})
    want = j_compile(jp, j_model(model).to_graph(), shape, policy="pallas",
                     precision="int8", quant=j_recipe, jit=False)
    got = zoo.compile_forward(model, tp, img=IMG, batch=2, device="cpu",
                              precision="int8", quant=recipe)
    assert got.precision == "int8" and got.quant is recipe
    assert "precision=int8" in got.describe().splitlines()[0]
    assert _describe_rows(got.describe()) == _describe_rows(want.describe())
    assert all(str(s.key).endswith("/int8") for _, s in got.layer_schedules)
    assert got.fold_reuse() == want.fold_reuse()
    # the traffic model prices the one-byte streams alike
    for (_, gs), (_, ws) in zip(got.layer_schedules, want.layer_schedules):
        assert t_traffic(gs.nest, gs.plan, precision="int8") == \
            pytest.approx(j_traffic(ws.nest, ws.plan, precision="int8"))
    fp32 = zoo.compile_forward(model, tp, img=IMG, batch=2, device="cpu")
    assert [s.dataflow for _, s in fp32.layer_schedules] == \
        [s.dataflow for _, s in got.layer_schedules]
    assert not any("/int8" in str(s.key) for _, s in fp32.layer_schedules)


@pytest.mark.parametrize("model", MODELS)
def test_whole_network_int8_matches_the_reference(nets, jax_recipes, model,
                                                  monkeypatch):
    """Whole-network int8 logits with one recipe in both packages (the JAX
    package's own, carried across with ``recipe_from_jax``; for
    MobileNetV2 the port's, carried the other way).

    The port's reference policy against the JAX reference policy within
    1e-4·max|ref|: both are unfused, so they round at the same steps; the
    int8 activations the two feed their convs are recorded, and none may
    differ.  The port's kernel policy (fused, the plain walk here) against
    the JAX reference within 1e-3·max|ref| with top-1 agreement 1.0: the
    fused flush folds BN into the requant scale, ``acc·(dq·s) + (b·s +
    t)`` against ``((acc·dq) + b)·s + t`` unfused."""
    tp, jp, x = nets[model]
    if model in jax_recipes:
        j_recipe = jax_recipes[model]
        recipe = recipe_from_jax(j_recipe, device="cpu")
    else:
        recipe = t_quant.quantize_graph(zoo.get_conv_model(model).to_graph(),
                                        tp, torch.from_numpy(x))
        j_recipe = j_quant.QuantRecipe(
            act_scales=dict(recipe.act_scales),
            w_scales={k: v.numpy() for k, v in recipe.w_scales.items()})
    # record every quantized activation, in order, in both packages
    j_acts, t_acts = [], []
    j_orig, t_orig = j_quant.quantize_act_jit, t_quant.quantize_act

    def j_record(v, s):
        q = j_orig(v, s)
        jax.debug.callback(lambda a: j_acts.append(np.asarray(a)), q,
                           ordered=True)
        return q

    monkeypatch.setattr(j_quant, "quantize_act_jit", j_record)
    monkeypatch.setattr(t_quant, "quantize_act",
                        lambda v, s: t_acts.append(t_orig(v, s)) or
                        t_acts[-1])
    want = np.asarray(j_compile(jp, j_model(model).to_graph(), x.shape,
                                policy="reference", precision="int8",
                                quant=j_recipe)(jp, jnp.asarray(x)))
    jax.effects_barrier()
    xt = torch.from_numpy(x)
    ref = zoo.compile_forward(model, tp, img=IMG, batch=2, device="cpu",
                              precision="int8", quant=recipe,
                              policy="reference")
    with torch.inference_mode():
        got_ref = ref(tp, xt).numpy()
    n_convs = len(ref.layer_schedules)
    assert len(j_acts) == len(t_acts) == n_convs
    differ = sum(int((a.numpy() != b).sum()) for a, b in zip(t_acts, j_acts))
    assert differ == 0, f"{differ} int8 activation elements differ"
    kern = zoo.compile_forward(model, tp, img=IMG, batch=2, device="cpu",
                               precision="int8", quant=recipe)
    with torch.inference_mode():
        got_kern = kern(tp, xt).numpy()
    scale = np.abs(want).max()
    assert np.abs(got_ref - want).max() <= 1e-4 * scale
    assert np.abs(got_kern - want).max() <= 1e-3 * scale
    assert (got_kern.argmax(-1) == want.argmax(-1)).mean() == 1.0


# --------------------------------------------------------------------------
# serving: one recipe for every bucket and for the reference rung
# --------------------------------------------------------------------------

def test_bucket_compiler_calibrates_once(nets, monkeypatch):
    tp, _, _ = nets["vgg16"]
    calls = []
    real = t_quant.quantize_graph
    monkeypatch.setattr(t_quant, "quantize_graph",
                        lambda *a: calls.append(1) or real(*a))
    bc = zoo.bucket_compiler("vgg16", tp, img=IMG, device="cpu",
                             precision="int8")
    nets_ = [bc.network_for(b) for b in (1, 2, 4)]
    assert len(calls) == 1
    assert all(n.quant is bc.quant and n.precision == "int8" for n in nets_)
    # the int8 trunk gives the same rows at every bucket width
    x = torch.from_numpy(_rng_tensor((4, 3, IMG, IMG), 30))
    trunks = {b: compile_network(tp, t_vgg.to_graph(include_head=False),
                                 (b, 3, IMG, IMG), device="cpu",
                                 precision="int8", quant=bc.quant)
              for b in (1, 4)}
    with torch.inference_mode():
        t4 = trunks[4](tp, x)
        for i in range(4):
            assert torch.equal(trunks[1](tp, x[i:i + 1])[0], t4[i])


def test_direct_compile_calibrates_as_the_bucket_compiler(nets):
    """Without a recipe, a direct int8 compile at batch 1 and a bucket
    compiler draw the same calibration images, so they bake in the same
    activation scales."""
    tp, _, _ = nets["vgg16"]
    bc = zoo.bucket_compiler("vgg16", tp, img=IMG, device="cpu",
                             precision="int8")
    net = zoo.compile_forward("vgg16", tp, img=IMG, batch=1, device="cpu",
                              precision="int8")
    assert net.quant is not bc.quant
    assert net.quant.act_scales == bc.quant.act_scales


def test_reference_rung_reuses_the_recipe_by_identity(nets):
    """The reference rung's compiler of an int8 engine takes the primary
    compiler's ``QuantRecipe`` object itself (as the JAX engine's
    ``reference_compiler`` does), so a request served on either rung sees
    the same scales."""
    tp, _, _ = nets["vgg16"]
    eng = VisionEngine(tp, zoo.get_conv_model("vgg16").to_graph(), img=IMG,
                       buckets=(1, 2), device="cpu", precision="int8")
    rung = eng.reference_compiler
    assert isinstance(rung, BucketCompiler) and rung is not eng.compiler
    assert rung.policy == "reference" and rung.precision == "int8"
    assert rung.quant is eng.compiler.quant
    assert rung.cache is eng.compiler.cache
    assert eng.reference_compiler is rung
    assert rung.network_for(2).quant is eng.compiler.quant
    ref_eng = VisionEngine(tp, zoo.get_conv_model("vgg16").to_graph(),
                           img=IMG, buckets=(1,), device="cpu",
                           policy="reference", precision="int8")
    assert ref_eng.reference_compiler is ref_eng.compiler


def test_int8_serving_on_the_cpu(capsys):
    """``launch.serve --precision int8`` on the CPU: every request served,
    the summary under ``serving_int8``, served logits equal to a direct
    forward with the same recipe."""
    import json
    from repro_torch.launch.serve import main
    d = main(["--vision", "--model", "vgg16", "--requests", "4",
              "--buckets", "1,2,4", "--precision", "int8", "--device",
              "cpu"])
    printed = json.loads(capsys.readouterr().out)
    assert list(printed) == ["serving_int8"]
    assert printed["serving_int8"]["workload"]["precision"] == "int8"
    assert d["robustness"]["lost_requests"] == 0
    assert d["robustness"]["outcomes"] == {"ok": 4}
    assert d["compile"]["distinct_schedules"] == 8
    assert d["verify"]["max_abs_err"] <= 1e-5 * d["verify"]["max_abs_ref"]


def test_precision_is_checked():
    with pytest.raises(ValueError, match="unknown precision"):
        t_quant.check_precision("fp16")
    tp = zoo.get_conv_model("vgg16").init_params(
        torch.Generator(), width_mult=WIDTH, img=IMG, classes=CLASSES,
        device="cpu")
    with pytest.raises(ValueError, match="unknown precision"):
        zoo.compile_forward("vgg16", tp, img=IMG, device="cpu",
                            precision="fp16")
