"""The port's ResNet-18 against the JAX package's: whole-network logits
against ``repro``'s reference policy, the graph-free oracle, the fused
residual blocks (fused bitwise-equal to unfused), the engine's shape
checks on skip edges, serving and the launcher, on the CPU.  Width
0.0625, img 32, batch 2."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import resnet as j_resnet  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.engine import compile_network  # noqa: E402
from repro_torch.core.graph import GraphError, StreamGraph  # noqa: E402
from repro_torch.core.graph import fuse_graph  # noqa: E402
from repro_torch.models import resnet as t_resnet  # noqa: E402
from repro_torch.serve.vision import VisionEngine  # noqa: E402

IMG, WIDTH, CLASSES = 32, 0.0625, 10
TOL = 1e-5   # relative to max|ref|: fp32 through 20 convs, two sum orders


@pytest.fixture(scope="module")
def jax_params():
    """numpy weights in the JAX package's tree (its init's shapes, from
    ``jax.eval_shape``), drawn from a seed with its init's law: OIHW and
    dense weights normal / sqrt(shape[0]), biases zero."""
    shapes = jax.eval_shape(
        lambda k: j_resnet.init_params(k, width_mult=WIDTH, img=IMG,
                                       classes=CLASSES), jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    tree = {name: {k: ((rng.standard_normal(s.shape) / np.sqrt(s.shape[0]))
                       if k == "w" else np.zeros(s.shape)).astype(np.float32)
                   for k, s in leaf.items()}
            for name, leaf in shapes.items()}
    return tree


@pytest.fixture(scope="module")
def params(jax_params):
    return params_from_jax(jax_params, device="cpu")


@pytest.fixture(scope="module")
def x2():
    return np.random.default_rng(4).standard_normal(
        (2, 3, IMG, IMG)).astype(np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * np.abs(want).max())


def test_init_params_match_the_reference_tree(jax_params):
    own = t_resnet.init_params(torch.Generator().manual_seed(0),
                               width_mult=WIDTH, img=IMG, classes=CLASSES,
                               device="cpu")
    assert {k: {kk: tuple(v.shape) for kk, v in d.items()}
            for k, d in own.items()} == \
        {k: {kk: v.shape for kk, v in d.items()}
         for k, d in jax_params.items()}
    assert t_resnet.n_convs() == 20


@pytest.mark.parametrize("policy", ["kernel", "reference"])
def test_compile_forward_matches_reference_package(jax_params, params, x2,
                                                   policy):
    jnet = j_resnet.compile_forward(jax_params, img=IMG, batch=2,
                                    policy="reference")
    want = np.asarray(jnet(jax_params, jnp.asarray(x2)))
    net = t_resnet.compile_forward(params, img=IMG, batch=2, policy=policy,
                                   device="cpu")
    fr = net.fold_reuse()
    assert (fr["conv_layers"], fr["distinct_schedules"], fr["hits"]) == \
        (20, 11, 9)
    flows = [s.dataflow for _, s in net.layer_schedules]
    assert (flows.count("weight_stationary"),
            flows.count("output_stationary")) == (5, 15)
    with torch.inference_mode():
        got = net(params, torch.from_numpy(x2)).numpy()
    assert got.shape == (2, CLASSES)
    _close(got, want)
    with torch.inference_mode():
        oracle = t_resnet.forward(params, torch.from_numpy(x2)).numpy()
    _close(oracle, want)


def test_residual_blocks_fuse_and_match_unfused(params, x2):
    """Each block is two fused convs (bias+relu; bias+residual+relu) plus
    the fused 1x1 projection on downsample blocks, and fusion changes no
    bit of the logits."""
    fused_g = fuse_graph(t_resnet.to_graph())
    epis = [str(nd.epilogue) for nd in fused_g if nd.op == "conv"]
    assert (epis.count("bias+relu"), epis.count("bias+residual+relu"),
            epis.count("bias")) == (9, 8, 3)
    assert not [nd for nd in fused_g
                if nd.op in ("bias", "relu", "residual_add")]
    fused = t_resnet.compile_forward(params, img=IMG, batch=2, device="cpu")
    unfused = t_resnet.compile_forward(params, img=IMG, batch=2,
                                       fuse_epilogues=False,
                                       cache=fused.cache, device="cpu")
    with torch.inference_mode():
        x = torch.from_numpy(x2)
        assert torch.equal(fused(params, x), unfused(params, x))


@pytest.mark.parametrize("what", ["residual_add", "fused_shortcut"])
def test_skip_edges_of_the_wrong_shape_are_refused(what):
    """The engine checks every skip edge's shape at compile time."""
    g = StreamGraph(name="bad")
    g.conv("a", param="a", pad=1)
    g.conv("b", src="x", param="b", stride=2, pad=1)
    g.residual_add("add", "a", "b")
    p = {"a": {"w": torch.zeros(4, 3, 3, 3)},
         "b": {"w": torch.zeros(4, 3, 3, 3)}}
    if what == "fused_shortcut":
        g = fuse_graph(g)
        assert g.node("a").residual == "b"
    with pytest.raises(GraphError, match="shape"):
        compile_network(p, g, (1, 3, 8, 8), device="cpu")


def test_served_logits_equal_direct_forward(params):
    rng = np.random.default_rng(3)
    imgs = [rng.standard_normal((n, 3, IMG, IMG)).astype(np.float32)
            for n in (2, 1, 3)]
    eng = VisionEngine(params, t_resnet.to_graph(), img=IMG, buckets=(2, 4),
                       device="cpu")
    reqs = [eng.submit(im) for im in imgs]
    eng.run()
    for req, im in zip(reqs, imgs):
        direct = t_resnet.compile_forward(params, img=IMG,
                                          batch=im.shape[0],
                                          cache=eng.compiler.cache,
                                          device="cpu")
        with torch.inference_mode():
            want = direct(params, torch.from_numpy(im)).numpy()
        _close(req.logits, want)


def test_launcher_serves_resnet18(capsys):
    from repro_torch.launch.serve import main
    d = main(["--vision", "--model", "resnet18", "--requests", "4",
              "--buckets", "2,4", "--device", "cpu"])
    assert '"resnet18"' in capsys.readouterr().out
    assert d["robustness"]["lost_requests"] == 0
    assert d["robustness"]["outcomes"] == {"ok": 4}
    assert d["compile"]["distinct_schedules"] == 11
    assert d["verify"]["max_abs_err"] <= TOL * d["verify"]["max_abs_ref"]


def test_launcher_serves_the_rwkv6_token_path(capsys):
    """Without ``--vision`` the launcher serves tokens, whatever
    ``--model`` says: rwkv6 (reduced) serves every request."""
    from repro_torch.launch.serve import main
    d = main(["--model", "resnet18", "--arch", "rwkv6-1.6b", "--device",
              "cpu", "--requests", "3", "--new-tokens", "5"])
    assert '"rwkv6-1.6b-smoke"' in capsys.readouterr().out
    assert d["requests_done"] == 3 and d["requests_lost"] == 0
    assert d["tokens"] == 15
