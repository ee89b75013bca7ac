"""The port's ``jit``: a compiled forward captured as one CUDA graph (the
counterpart of the JAX package's ``jax.jit``).  On the CPU: ``jit`` has
the reference's name, default and place among the keywords, runs the
eager forward bit for bit, and ``VisionEngine`` serves bitwise.  On a
card (marked ``cuda``), for a small VGG-16, ResNet-18 and MobileNetV2 in
fp32 and int8: the captured forward is bitwise the eager one, a result
outlives the next call, new parameter tensors capture again, a wrong
input shape raises, and the capture launches what the eager forward
launches; and the head kernel's counters survive a wider eager head
between replays."""
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import engine as t_engine  # noqa: E402
from repro_torch.kernels import dense as t_dense  # noqa: E402
from repro_torch.models import zoo  # noqa: E402
from repro_torch.serve import vision as t_vision  # noqa: E402

IMG, WIDTH, CLASSES = 32, 0.0625, 10
MODELS = ["vgg16", "resnet18", "mobilenetv2"]
# the keywords both packages' compile surfaces share, in the reference's
# order: jit sits between head and fuse_epilogues
SHARED = ("policy", "cache", "head", "jit", "fuse_epilogues", "precision",
          "quant")


def _model(name, device, seed=0):
    spec = zoo.get_conv_model(name)
    gen = torch.Generator(device=device).manual_seed(seed)
    return spec, spec.init_params(gen, width_mult=WIDTH, img=IMG,
                                  classes=CLASSES, device=device)


def _images(n, seed=1):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, 3, IMG, IMG)).astype(np.float32)


@pytest.mark.parametrize("name", ["compile_network", "BucketCompiler"])
def test_jit_keyword_matches_reference_package(name):
    """``jit`` defaults to True, as in ``repro.core.engine``, and sits at
    the reference's place among the keywords the two share."""
    pytest.importorskip("jax")
    from repro.core import engine as j_engine
    got = inspect.signature(getattr(t_engine, name))
    want = inspect.signature(getattr(j_engine, name))
    assert got.parameters["jit"].default is True
    assert got.parameters["jit"].default == want.parameters["jit"].default
    assert got.parameters["jit"].kind == want.parameters["jit"].kind \
        == inspect.Parameter.KEYWORD_ONLY
    order = [k for k in got.parameters if k in SHARED]
    assert order == [k for k in want.parameters if k in SHARED]


@pytest.mark.parametrize("jit", [True, False])
def test_compile_forward_passes_jit_through(monkeypatch, jit):
    """``zoo.compile_forward`` and ``zoo.bucket_compiler`` hand ``jit`` to
    the engine, and ``BucketCompiler`` hands it to every bucket."""
    seen = []
    real = t_engine.compile_network

    def spy(*args, **kw):
        seen.append(kw.get("jit"))
        return real(*args, **kw)
    monkeypatch.setattr(t_engine, "compile_network", spy)
    _, params = _model("vgg16", "cpu")
    zoo.compile_forward("vgg16", params, img=IMG, jit=jit, device="cpu")
    bc = zoo.bucket_compiler("vgg16", params, img=IMG, jit=jit,
                             device="cpu")
    bc.network_for(2)
    assert bc.jit is jit and seen == [jit, jit]


def test_cpu_jit_runs_the_eager_forward_bitwise():
    """On the CPU there is no graph to capture: ``jit=True`` runs the
    eager forward, and its logits are bitwise ``jit=False``'s."""
    spec, params = _model("vgg16", "cpu")
    x = torch.from_numpy(_images(2))
    nets = {j: zoo.compile_forward(spec, params, img=IMG, batch=2, jit=j,
                                   device="cpu") for j in (True, False)}
    for net in nets.values():
        assert not net.jit and net.captures == 0 and net.apply is net.eager
    with torch.inference_mode():
        y = {j: net(params, x) for j, net in nets.items()}
    assert y[True].shape == (2, CLASSES)
    assert torch.equal(y[True], y[False])


def test_cpu_vision_engine_serves_bitwise_with_jit_default():
    """``VisionEngine`` (its ``BucketCompiler`` at the default ``jit``)
    on the CPU: a padded request's logits equal an eager direct forward's
    bit for bit."""
    spec, params = _model("vgg16", "cpu")
    eng = t_vision.VisionEngine(params, spec.to_graph(), img=IMG,
                                buckets=(2, 4), device="cpu")
    assert eng.compiler.jit is True
    imgs = [_images(n, seed=n) for n in (3, 1)]
    reqs = [eng.submit(im) for im in imgs]
    eng.run()
    for req, im in zip(reqs, imgs):
        direct = zoo.compile_forward(spec, params, img=IMG,
                                     batch=im.shape[0],
                                     cache=eng.compiler.cache, jit=False,
                                     device="cpu")
        with torch.inference_mode():
            want = direct(params, torch.from_numpy(im))
        assert torch.equal(torch.from_numpy(req.logits), want)


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA graph is captured on one")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _pair(name, precision, device, batch=2):
    """A model's jitted and eager forwards at one batch width, sharing
    one schedule cache and (int8) one recipe."""
    spec, params = _model(name, device)
    jitted = zoo.compile_forward(spec, params, img=IMG, batch=batch,
                                 device=device, precision=precision)
    eager = zoo.compile_forward(spec, params, img=IMG, batch=batch,
                                jit=False, cache=jitted.cache,
                                device=device, precision=precision,
                                quant=jitted.quant)
    assert jitted.jit and not eager.jit
    return params, jitted, eager


def _cuda_images(device, n=2, seed=1):
    return torch.from_numpy(_images(n, seed)).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["fp32", "int8"])
@pytest.mark.parametrize("model", MODELS)
def test_cuda_jit_is_bitwise_the_eager_forward(cuda_device, model,
                                              precision):
    params, jitted, eager = _pair(model, precision, cuda_device)
    x = _cuda_images(cuda_device)
    with torch.inference_mode():
        want = eager(params, x)
        for _ in range(2):                 # the capturing call, a replay
            assert torch.equal(jitted(params, x), want)
    assert jitted.captures == 1


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["fp32", "int8"])
@pytest.mark.parametrize("model", MODELS)
def test_cuda_jit_result_outlives_the_next_call(cuda_device, model,
                                               precision):
    """Each call returns its own tensor: call 1's logits are unchanged
    after call 2 on other images, as ``VisionEngine.run`` needs (it reads
    batch k back after dispatching k + 1)."""
    params, jitted, eager = _pair(model, precision, cuda_device)
    x1, x2 = (_cuda_images(cuda_device, seed=s) for s in (1, 2))
    with torch.inference_mode():
        y1 = jitted(params, x1)
        y2 = jitted(params, x2)
        assert torch.equal(y1, eager(params, x1))
        assert torch.equal(y2, eager(params, x2))
    assert not torch.equal(y1, y2)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["fp32", "int8"])
@pytest.mark.parametrize("model", MODELS)
def test_cuda_jit_captures_again_for_new_params(cuda_device, model,
                                               precision):
    """New parameter tensors (other addresses) capture again, and the
    replay computes with the new weights, never the captured ones; the
    same tensors updated in place are read by the next replay."""
    params, jitted, eager = _pair(model, precision, cuda_device)
    x = _cuda_images(cuda_device)
    _, fresh = _model(model, cuda_device, seed=7)
    with torch.inference_mode():
        old = jitted(params, x)
        new = jitted(fresh, x)
        assert jitted.captures == 2
        assert torch.equal(new, eager(fresh, x))
        assert not torch.equal(new, old)
        assert torch.equal(jitted(params, x), old)     # back: a capture
        assert jitted.captures == 3
        for leaf in params.values():                   # in place
            for t in leaf.values():
                t.mul_(0.5)
        assert torch.equal(jitted(params, x), eager(params, x))
    assert jitted.captures == 3


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["fp32", "int8"])
@pytest.mark.parametrize("model", MODELS)
def test_cuda_jit_refuses_a_wrong_input(cuda_device, model, precision):
    params, jitted, _ = _pair(model, precision, cuda_device)
    with torch.inference_mode():
        jitted(params, _cuda_images(cuda_device))
        for bad in (_cuda_images(cuda_device, n=3),
                    _cuda_images(cuda_device).double(),
                    _cuda_images(cuda_device).cpu()):
            with pytest.raises(ValueError):
                jitted(params, bad)
    assert jitted.captures == 1


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["fp32", "int8"])
@pytest.mark.parametrize("model", MODELS)
def test_cuda_jit_capture_launches_what_eager_launches(cuda_device, model,
                                                      precision):
    """The Python launch counters tick in the capture, never in a replay:
    the capture's launches by kernel equal one eager forward's, and a
    replay adds none."""
    params, jitted, eager = _pair(model, precision, cuda_device)
    x = _cuda_images(cuda_device)
    with torch.inference_mode():
        before = t_engine.kernel_launch_counts()
        eager(params, x)
        after = t_engine.kernel_launch_counts()
        jitted(params, x)
        replay0 = t_engine.kernel_launch_counts()
        jitted(params, x)
        replay1 = t_engine.kernel_launch_counts()
    want = {k: after[k] - before[k] for k in after}
    assert jitted.apply.capture_launches == want
    assert want[t_dense.KERNEL] == sum(nd.op == "dense"
                                       for nd in jitted.graph.nodes)
    assert replay1 == replay0


@pytest.mark.cuda
def test_cuda_head_counters_survive_a_wider_eager_head(cuda_device):
    """Two buckets captured, then a head wider than the counter buffer
    run eagerly (the buffer is replaced, the old one kept), then both
    buckets replayed: bitwise their eager forwards."""
    spec, params = _model("vgg16", cuda_device)
    bc = zoo.bucket_compiler(spec, params, img=IMG, device=cuda_device)
    xs = {b: _cuda_images(cuda_device, n=b, seed=b) for b in (1, 4)}
    with torch.inference_mode():
        want = {b: bc.network_for(b).eager(params, x) for b, x in xs.items()}
        for b, x in xs.items():
            assert torch.equal(bc.network_for(b)(params, x), want[b])
        # one counter per (8-row tile, 32-column tile): more than there are
        old = t_dense._counters(cuda_device, 1)
        k, n = 512, 4096
        rows = 8 * (old.numel() // (n // 32) + 2)
        gen = torch.Generator(device=cuda_device).manual_seed(3)
        xw, w, b = (torch.randn(*s, device=cuda_device, generator=gen)
                    for s in ((rows, k), (k, n), (n,)))
        wide = t_dense.dense(xw, w, b)
        assert t_dense._counters(cuda_device, 1) is not old
        assert torch.equal(wide, torch.cat([t_dense.dense(xw[i:i + 8], w, b)
                                            for i in range(0, rows, 8)]))
        for b_, x in xs.items():
            assert torch.equal(bc.network_for(b_)(params, x), want[b_])
    assert all(bc.network_for(b_).captures == 1 for b_ in xs)
    assert int(old.abs().sum()) == 0
