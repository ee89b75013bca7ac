"""The port's MobileNetV2 against the JAX package's: the weight bridge with
batch-norm entries, whole-network logits against ``repro``'s reference
policy, the graph-free oracle, fusion (one conv node per kernel launch,
fused bitwise-equal to unfused), the trunk across batch widths, serving,
``serving_summary`` and the launcher, on the CPU.  Width 0.0625, img 32,
batch 2: the depthwise layers run the plain depthwise walk."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import mobilenet as j_mnv2  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.engine import compile_network  # noqa: E402
from repro_torch.core.graph import fuse_graph  # noqa: E402
from repro_torch.models import mobilenet as t_mnv2  # noqa: E402
from repro_torch.serve.vision import VisionEngine  # noqa: E402

IMG, WIDTH, CLASSES = 32, 0.0625, 10
# relative to max|ref|: fp32 through 52 convs, two packages' sum orders
# (the depthwise taps and the 1x1 channel sums in another order)
TOL = 1e-5


def _randomize_bn(params, seed=7):
    """Non-trivial batch-norm statistics, drawn as the JAX package's own
    MobileNetV2 tests draw them (init statistics are the identity)."""
    rng = np.random.default_rng(seed)
    for name, leaf in params.items():
        if not name.endswith("_bn"):
            continue
        n = leaf["gamma"].shape[0]
        leaf["gamma"] = (1.0 + 0.2 * rng.standard_normal(n)).astype(
            np.float32)
        leaf["beta"] = (0.2 * rng.standard_normal(n)).astype(np.float32)
        leaf["mean"] = (0.3 * rng.standard_normal(n)).astype(np.float32)
        leaf["var"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
    return params


@pytest.fixture(scope="module")
def jax_params():
    """numpy weights in the JAX package's tree (its init's shapes, from
    ``jax.eval_shape``), drawn from a seed with its init's law: OIHW and
    dense weights normal / sqrt(shape[0]), biases zero."""
    shapes = jax.eval_shape(
        lambda k: j_mnv2.init_params(k, width_mult=WIDTH, img=IMG,
                                     classes=CLASSES), jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    tree = {name: {k: ((rng.standard_normal(s.shape) / np.sqrt(s.shape[0]))
                       if k == "w" else np.zeros(s.shape)).astype(np.float32)
                   for k, s in leaf.items()}
            for name, leaf in shapes.items()}
    return _randomize_bn(tree)


@pytest.fixture(scope="module")
def params(jax_params):
    return params_from_jax(jax_params, device="cpu")


@pytest.fixture(scope="module")
def x2():
    return np.random.default_rng(4).standard_normal(
        (2, 3, IMG, IMG)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_logits(jax_params, x2):
    net = j_mnv2.compile_forward(jax_params, img=IMG, batch=2,
                                 policy="reference")
    return np.asarray(net(jax_params, jnp.asarray(x2)))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * np.abs(want).max())


def test_params_from_jax_round_trips(jax_params, params):
    assert set(params) == set(jax_params)
    for name, leaf in jax_params.items():
        assert set(params[name]) == set(leaf)
        for k, arr in leaf.items():
            np.testing.assert_array_equal(params[name][k].numpy(), arr)
    own = t_mnv2.init_params(torch.Generator().manual_seed(0),
                             width_mult=WIDTH, img=IMG, classes=CLASSES,
                             device="cpu")
    assert {k: {kk: tuple(v.shape) for kk, v in d.items()}
            for k, d in own.items()} == \
        {k: {kk: v.shape for kk, v in d.items()}
         for k, d in jax_params.items()}
    assert float(own["b3_dw_bn"]["var"].min()) == 1.0     # identity stats
    w = own["b3_exp"]["w"] * own["b3_exp"]["w"].shape[0] ** 0.5
    assert float(w.abs().max()) <= 2.0                    # truncated law


@pytest.mark.parametrize("policy", ["kernel", "reference", "auto"])
def test_compile_forward_matches_reference_package(params, x2, jax_logits,
                                                   policy):
    net = t_mnv2.compile_forward(params, img=IMG, batch=2, policy=policy,
                                 device="cpu")
    fr = net.fold_reuse()
    assert (fr["conv_layers"], fr["distinct_schedules"], fr["hits"]) == \
        (t_mnv2.n_convs(), 27, 25) == (52, 27, 25)
    by_name = dict(net.layer_schedules)
    assert all(by_name[f"{n}_dw"].dataflow == "depthwise"
               and by_name[f"{n}_dw"].impl() == "fold_dw"
               for n, *_ in t_mnv2.block_specs())
    with torch.inference_mode():
        got = net(params, torch.from_numpy(x2)).numpy()
    assert got.shape == (2, CLASSES)
    _close(got, jax_logits)


def test_forward_oracle_matches_reference_package(params, x2, jax_logits):
    """The port's graph-free walk gives the JAX package's logits, on the
    direct conv and on the fold kernels."""
    for impl in ("direct", "fold_auto"):
        with torch.inference_mode():
            got = t_mnv2.forward(params, torch.from_numpy(x2),
                                 impl=impl).numpy()
        _close(got, jax_logits)


def test_fusion_leaves_one_node_per_conv():
    """After fusion every BN, ReLU6 and residual add lives in a conv's
    epilogue: the fused graph holds the 52 convs and the head only."""
    g = t_mnv2.to_graph()
    ops = [nd.op for nd in g]
    assert (ops.count("conv"), ops.count("batchnorm"), ops.count("relu6"),
            ops.count("residual_add")) == \
        (52, 52, 35, t_mnv2.n_residual_adds()) == (52, 52, 35, 10)
    fused = fuse_graph(g)
    assert [nd.op for nd in fused] == ["conv"] * 52 + [
        "global_avgpool", "flatten", "dense"]
    epis = [str(nd.epilogue) for nd in fused if nd.op == "conv"]
    assert (epis.count("scale+relu6"), epis.count("scale"),
            epis.count("scale+residual")) == (35, 7, 10)


def test_fused_bitwise_equals_unfused(params, x2):
    """Folding BN, ReLU6 and the skip add into the kernels' flush changes
    no bit: each epilogue step rounds as the standalone op does."""
    fused = t_mnv2.compile_forward(params, img=IMG, batch=2, device="cpu")
    unfused = t_mnv2.compile_forward(params, img=IMG, batch=2,
                                     fuse_epilogues=False,
                                     cache=fused.cache, device="cpu")
    assert fused.fused and not unfused.fused
    with torch.inference_mode():
        x = torch.from_numpy(x2)
        assert torch.equal(fused(params, x), unfused(params, x))


def test_trunk_rows_identical_across_batch_widths(params):
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((3, 3, IMG, IMG))
                         .astype(np.float32))
    graph = t_mnv2.to_graph(include_head=False)
    wide = compile_network(params, graph, (3, 3, IMG, IMG), device="cpu")
    one = compile_network(params, graph, (1, 3, IMG, IMG), device="cpu")
    with torch.inference_mode():
        rows = wide(params, x)
        for i in range(3):
            np.testing.assert_allclose(one(params, x[i:i + 1])[0].numpy(),
                                       rows[i].numpy(), rtol=1e-6,
                                       atol=1e-6)


def test_served_logits_equal_direct_forward(params):
    rng = np.random.default_rng(3)
    imgs = [rng.standard_normal((n, 3, IMG, IMG)).astype(np.float32)
            for n in (3, 1, 2)]
    eng = VisionEngine(params, t_mnv2.to_graph(), img=IMG, buckets=(2, 4),
                       device="cpu")
    reqs = [eng.submit(im) for im in imgs]
    eng.run()
    assert eng.metrics_dict()["robustness"]["lost_requests"] == 0
    for req, im in zip(reqs, imgs):
        direct = t_mnv2.compile_forward(params, img=IMG, batch=im.shape[0],
                                        cache=eng.compiler.cache,
                                        device="cpu")
        with torch.inference_mode():
            want = direct(params, torch.from_numpy(im)).numpy()
        assert req.outcome.value == "ok"
        assert req.logits.shape == (im.shape[0], CLASSES)
        _close(req.logits, want)


@pytest.mark.parametrize("entry", ["serving_summary", "launcher"])
def test_serving_summary_and_launcher(entry, capsys):
    """The launcher's summary at a tiny width on the CPU: every request
    served, none lost, served logits equal to a direct forward."""
    import json
    if entry == "serving_summary":
        from repro_torch.serve.vision import serving_summary
        d = serving_summary("mobilenetv2", requests=5, img=IMG,
                            width_mult=WIDTH, buckets=(1, 2, 4), seed=11,
                            device="cpu")
    else:
        from repro_torch.launch.serve import main
        d = main(["--vision", "--model", "mobilenetv2", "--requests", "5",
                  "--buckets", "1,2,4", "--seed", "11", "--device", "cpu"])
        assert json.loads(capsys.readouterr().out) == \
            json.loads(json.dumps(d))
    assert d["workload"]["model"] == "mobilenetv2"
    assert d["requests"] == 5 and d["images"] >= 5
    assert d["robustness"]["lost_requests"] == 0
    assert d["robustness"]["outcomes"] == {"ok": 5}
    assert d["compile"]["distinct_schedules"] == 27
    assert d["verify"]["requests"] == 5
    assert d["verify"]["max_abs_err"] <= TOL * d["verify"]["max_abs_ref"]


def test_zoo_registers_the_three_models():
    from repro_torch.models.zoo import conv_model_names, get_conv_model
    assert conv_model_names() == ["mobilenetv2", "resnet18", "vgg16"]
    g = get_conv_model("mobilenetv2").to_graph()
    assert sum(1 for nd in g if nd.op == "conv") == t_mnv2.n_convs()
