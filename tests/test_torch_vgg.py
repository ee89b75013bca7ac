"""The port's VGG-16 slice against the JAX package's: the weight bridge,
whole-network logits in both policies, and serving (batcher + engine) on
the CPU."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import vgg as j_vgg  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import vgg as t_vgg  # noqa: E402
from repro_torch.serve.batcher import BucketPolicy, ImageBatcher  # noqa: E402
from repro_torch.serve.vision import VisionEngine  # noqa: E402

IMG, WIDTH, CLASSES = 32, 0.0625, 10
TOL = 1e-5   # relative to max|ref|: fp32, two packages' sum orders


@pytest.fixture(scope="module")
def jax_params():
    tree = j_vgg.init_params(jax.random.PRNGKey(0), width_mult=WIDTH,
                             img=IMG, classes=CLASSES)
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def params(jax_params):
    return params_from_jax(jax_params, device="cpu")


@pytest.fixture(scope="module")
def jax_reference(jax_params):
    """The JAX package's reference-policy forward, by batch size."""
    nets = {}

    def forward(x: np.ndarray) -> np.ndarray:
        b = x.shape[0]
        if b not in nets:
            nets[b] = j_vgg.compile_forward(jax_params, img=IMG, batch=b,
                                            policy="reference")
        return np.asarray(nets[b](jax_params, jnp.asarray(x)))
    return forward


def _requests(rng, sizes):
    return [rng.standard_normal((n, 3, IMG, IMG)).astype(np.float32)
            for n in sizes]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * np.abs(want).max())


def test_params_from_jax_round_trips(jax_params, params):
    assert set(params) == set(jax_params)
    for name, leaf in jax_params.items():
        assert set(params[name]) == set(leaf)
        for k, arr in leaf.items():
            t = params[name][k]
            assert t.dtype == torch.float32 and t.device.type == "cpu"
            assert tuple(t.shape) == arr.shape       # nothing transposed
            np.testing.assert_array_equal(t.numpy(), arr)
    # the port's own init gives the same tree shape
    own = t_vgg.init_params(torch.Generator().manual_seed(0),
                            width_mult=WIDTH, img=IMG, classes=CLASSES,
                            device="cpu")
    assert {k: {kk: tuple(v.shape) for kk, v in d.items()}
            for k, d in own.items()} == \
        {k: {kk: v.shape for kk, v in d.items()}
         for k, d in jax_params.items()}


def test_init_params_draws_the_reference_law():
    p = t_vgg.init_params(torch.Generator().manual_seed(3), img=IMG,
                          width_mult=0.25, classes=CLASSES, device="cpu")
    w = p["conv4_1"]["w"]                         # (128, 64, 3, 3)
    scaled = w * w.shape[0] ** 0.5
    assert float(scaled.abs().max()) <= 2.0
    assert abs(float(scaled.std()) - 0.88) < 0.02   # truncated N(0,1) std
    assert not p["conv4_1"]["b"].any()


@pytest.mark.parametrize("policy", ["kernel", "reference", "auto"])
def test_compile_forward_matches_reference_package(params, jax_reference,
                                                   policy):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 3, IMG, IMG)).astype(np.float32)
    net = t_vgg.compile_forward(params, img=IMG, batch=2, policy=policy,
                                device="cpu")
    assert net.mode == ("reference" if policy == "reference" else "kernel")
    assert net.fused == (policy != "reference")
    fr = net.fold_reuse()
    assert (fr["conv_layers"], fr["distinct_schedules"], fr["hits"]) == \
        (13, 8, 5)
    with torch.inference_mode():
        got = net(params, torch.from_numpy(x)).numpy()
    _close(got, jax_reference(x))


def test_vgg_head_completes_the_trunk(params):
    """The callable head on the compiled trunk gives the compiled
    network's logits."""
    from repro_torch.core.engine import compile_network
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((2, 3, IMG, IMG))
                         .astype(np.float32))
    trunk = compile_network(params, t_vgg.to_graph(include_head=False),
                            (2, 3, IMG, IMG), head=t_vgg.vgg_head,
                            device="cpu")
    full = t_vgg.compile_forward(params, img=IMG, batch=2, device="cpu")
    with torch.inference_mode():
        np.testing.assert_array_equal(trunk(params, x).numpy(),
                                      full(params, x).numpy())


def test_trunk_rows_identical_across_batch_widths(params):
    """The fold loop gives each image the same trunk whatever the batch."""
    from repro_torch.core.engine import compile_network
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((3, 3, IMG, IMG))
                         .astype(np.float32))
    graph = t_vgg.to_graph(include_head=False)
    wide = compile_network(params, graph, (3, 3, IMG, IMG), device="cpu")
    one = compile_network(params, graph, (1, 3, IMG, IMG), device="cpu")
    with torch.inference_mode():
        rows = wide(params, x)
        for i in range(3):
            np.testing.assert_allclose(one(params, x[i:i + 1])[0].numpy(),
                                       rows[i].numpy(), rtol=1e-6,
                                       atol=1e-6)


def test_vision_engine_fifo_and_logits(params, jax_reference):
    rng = np.random.default_rng(2)
    imgs = _requests(rng, (1, 3, 2, 4, 1))
    eng = VisionEngine(params, t_vgg.to_graph(), img=IMG, buckets=(2, 4),
                       device="cpu")
    assert eng.warmup() == (2, 4)
    reqs = [eng.submit(im) for im in imgs]
    m = eng.run()
    assert [r.outcome.value for r in reqs] == ["ok"] * len(imgs)
    done = sorted(reqs, key=lambda r: (r.t_done, r.rid))
    assert [r.rid for r in done] == [r.rid for r in reqs]   # FIFO
    assert (m.images, m.requests) == (11, 5)
    d = eng.metrics_dict()
    assert d["robustness"]["lost_requests"] == 0
    assert d["robustness"]["outcomes"] == {"ok": 5}
    assert d["compile"]["distinct_schedules"] == 8
    assert sum(d["per_bucket_batches"].values()) == m.batches
    for req, im in zip(reqs, imgs):
        assert req.logits.shape == (im.shape[0], CLASSES)
        direct = t_vgg.compile_forward(params, img=IMG, batch=im.shape[0],
                                       cache=eng.compiler.cache,
                                       device="cpu")
        with torch.inference_mode():
            want = direct(params, torch.from_numpy(im)).numpy()
        _close(req.logits, want)
        _close(req.logits, jax_reference(im))


def test_vision_engine_expires_and_steps(params):
    clock = [0.0]
    eng = VisionEngine(params, t_vgg.to_graph(), img=IMG, buckets=(1, 2),
                       device="cpu")
    eng.batcher._clock = lambda: clock[0]
    rng = np.random.default_rng(7)
    late, ok = (eng.submit(im, deadline_s=d) for im, d in
                zip(_requests(rng, (1, 2)), (1.0, None)))
    clock[0] = 5.0
    assert eng.step() == 2 and eng.step() == 0
    assert late.outcome.value == "expired" and ok.outcome.value == "ok"
    assert eng.metrics_dict()["robustness"]["outcomes"] == \
        {"expired": 1, "ok": 1}


# --------------------------------------------------------------------------
# the batcher (ported from tests/test_vision_serving.py)
# --------------------------------------------------------------------------

def test_bucket_selection_deterministic():
    pol = BucketPolicy((1, 2, 4, 8))
    assert [pol.bucket_for(n) for n in (1, 2, 3, 4, 5, 8)] == \
           [1, 2, 4, 4, 8, 8]
    assert all(pol.bucket_for(n) == pol.bucket_for(n) for n in range(1, 9))
    with pytest.raises(ValueError, match="exceed"):
        pol.bucket_for(9)
    with pytest.raises(ValueError):
        BucketPolicy(())
    assert BucketPolicy((1, 2, 4, 6)).aligned(4).widths == (4, 8)


def test_batcher_packs_fifo_and_pads():
    b = ImageBatcher(BucketPolicy((1, 2, 4)), IMG)
    rng = np.random.default_rng(0)
    for imgs in _requests(rng, (2, 1, 3, 1)):
        b.submit(imgs)
    fb1 = b.form()                      # 2+1 fit, 3 would overflow max=4
    assert [r.rid for r in fb1.requests] == [0, 1]
    assert (fb1.bucket, fb1.n_images) == (4, 3)
    assert fb1.x.shape == (4, 3, IMG, IMG)
    assert not fb1.x[3].any()           # zero padding row
    np.testing.assert_array_equal(fb1.x[:2], fb1.requests[0].images)
    assert fb1.occupancy == pytest.approx(3 / 4)
    fb2 = b.form()                      # 3+1 fills the max bucket exactly
    assert [r.rid for r in fb2.requests] == [2, 3]
    assert (fb2.bucket, fb2.n_images, fb2.occupancy) == (4, 4, 1.0)
    assert b.form() is None


def test_batcher_rejects_oversize_and_bad_shape():
    b = ImageBatcher(BucketPolicy((1, 2)), IMG)
    with pytest.raises(ValueError, match="split it client-side"):
        b.submit(np.zeros((3, 3, IMG, IMG), np.float32))
    with pytest.raises(ValueError, match="must be"):
        b.submit(np.zeros((1, 3, IMG, IMG // 2), np.float32))
    with pytest.raises(ValueError, match="non-finite"):
        b.submit(np.full((1, 3, IMG, IMG), np.nan, np.float32))
    req = b.submit(np.zeros((3, IMG, IMG), np.float32))
    assert req.n == 1


def test_scatter_slices_per_request():
    b = ImageBatcher(BucketPolicy((4,)), IMG)
    rng = np.random.default_rng(1)
    for imgs in _requests(rng, (1, 2)):
        b.submit(imgs)
    fb = b.form()
    logits = np.arange(4 * CLASSES, dtype=np.float32).reshape(4, CLASSES)
    ImageBatcher.scatter(fb, logits)
    r1, r2 = fb.requests
    np.testing.assert_array_equal(r1.logits, logits[:1])
    np.testing.assert_array_equal(r2.logits, logits[1:3])
    assert r1.done and r2.done and r1.latency_s >= 0.0
