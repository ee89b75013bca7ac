"""The port's vision-serving metrics and served logits against the JAX
package's: ``ServingMetrics.as_dict`` has the reference's keys, nesting and
rounding for the same counts (the robust-serving counters included),
``metrics_dict`` files ``lost_requests`` under ``"robustness"``, and
served logits equal a direct forward of the same images bitwise, for each
zoo model in fp32 and int8, on the CPU."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.serve import vision as j_vision  # noqa: E402
from repro_torch.models import zoo  # noqa: E402
from repro_torch.serve import vision as t_vision  # noqa: E402

# the reference's robust-serving counters the port lacks: none since the
# port's admission controller, degradation ladder and watchdog count them
ROBUST_TO_COME = set()
IMG, WIDTH, CLASSES = 32, 0.0625, 10


def _fill(m, seed):
    """The same served work, latencies and outcomes into either package's
    ``ServingMetrics``."""
    rng = np.random.default_rng(seed)
    m.images, m.requests, m.batches = 37, 14, 6
    m.elapsed_s = float(rng.uniform(0.01, 2.0))
    for v in rng.uniform(1e-4, 0.2, 14):
        m.latency_hist.record(float(v))
    for v in rng.uniform(0.3, 1.0, 6):
        m.occupancy_hist.record(float(v))
    m.per_bucket = {4: 3, 2: 2, 8: 1}
    m.submitted, m.expired = 16, 2
    m.outcomes = {"ok": 14, "expired": 2}
    m.shed, m.failed = int(rng.integers(0, 3)), int(rng.integers(0, 3))
    m.degraded_batches, m.nonfinite_batches = 2, 1
    m.hung_batches, m.straggler_events = 1, int(rng.integers(0, 4))
    m.deadline_total, m.deadline_hits = 7, int(rng.integers(0, 7))
    return m


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_as_dict_matches_reference_package(seed):
    m = _fill(t_vision.ServingMetrics(), seed)
    got = m.as_dict()
    want = _fill(j_vision.ServingMetrics(), seed).as_dict()
    assert set(got) == set(want)
    assert set(want["robustness"]) - set(got["robustness"]) == \
        ROBUST_TO_COME
    assert set(got["robustness"]) == set(want["robustness"])
    for key, value in got.items():
        if key != "robustness":
            assert value == want[key], key
    for key, value in got["robustness"].items():
        assert value == want["robustness"][key], key
    assert got["kips"] == round(m.images / m.elapsed_s / 1e3, 6)


def test_empty_metrics_match_reference_package():
    got = t_vision.ServingMetrics().as_dict()
    want = j_vision.ServingMetrics().as_dict()
    assert {k: v for k, v in got.items() if k != "robustness"} == \
        {k: v for k, v in want.items() if k != "robustness"}
    assert got["kips"] == 0.0 and got["latency"]["p99_s"] == 0.0


def _model(name, seed=0):
    spec = zoo.get_conv_model(name)
    params = spec.init_params(torch.Generator().manual_seed(seed),
                              width_mult=WIDTH, img=IMG, classes=CLASSES,
                              device="cpu")
    return spec, params


def test_metrics_dict_files_lost_requests_under_robustness():
    spec, params = _model("vgg16")
    eng = t_vision.VisionEngine(params, spec.to_graph(), img=IMG,
                                buckets=(1, 2), device="cpu")
    rng = np.random.default_rng(4)
    for n in (1, 2, 1):
        eng.submit(rng.standard_normal((n, 3, IMG, IMG)).astype(np.float32))
    eng.step()                               # one batch served, two queued
    d = eng.metrics_dict()
    assert "lost_requests" not in d and "outcomes" not in d
    assert d["robustness"]["lost_requests"] == 0
    assert d["robustness"]["submitted"] == 3
    assert d["robustness"]["outcomes"] == {"ok": 1}
    assert d["kips"] == round(d["images"] / eng.metrics.elapsed_s / 1e3, 6)


@pytest.mark.parametrize("precision", ["fp32", "int8"])
@pytest.mark.parametrize("model", ["vgg16", "resnet18", "mobilenetv2"])
def test_served_logits_bitwise_equal_direct_forward(model, precision):
    """Requests of 1, 3 and 2 images served over buckets (2, 4): the
    1-image and 3-image requests ride padded batches, and each request's
    logits equal a direct forward of its own images bit for bit (the
    reference's invariant, tests/test_vision_serving.py)."""
    spec, params = _model(model, seed=3)
    eng = t_vision.VisionEngine(params, spec.to_graph(), img=IMG,
                                buckets=(2, 4), device="cpu",
                                precision=precision)
    rng = np.random.default_rng(5)
    imgs = [rng.standard_normal((n, 3, IMG, IMG)).astype(np.float32)
            for n in (1, 3, 2)]
    reqs = [eng.submit(im) for im in imgs]
    eng.run()
    assert eng.metrics.per_bucket and all(r.outcome.value == "ok"
                                          for r in reqs)
    for req, im in zip(reqs, imgs):
        direct = zoo.compile_forward(spec, params, img=IMG,
                                     batch=im.shape[0],
                                     cache=eng.compiler.cache, device="cpu",
                                     precision=precision,
                                     quant=eng.compiler.quant)
        with torch.inference_mode():
            want = direct(params, torch.from_numpy(im))
        assert torch.equal(torch.from_numpy(req.logits), want)
