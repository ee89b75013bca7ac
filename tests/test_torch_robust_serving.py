"""The port's fault-tolerant serving runtime against the JAX package's:
the admission controller's decisions and the watchdog's verdicts on the
same observation sequences, the chaos schedules for the same (profile,
seed), the injector's semantics on torch tensors, and ``VisionEngine``
under every chaos profile — the same outcomes and robustness counters as
the JAX engine (``policy="reference"``, the oracle) on the same request
stream; then the degradation ladder, deadlines, the preemption drain and
``chaos_summary`` through the port alone, on the CPU."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.serve import admission as j_adm  # noqa: E402
from repro.serve import chaos as j_chaos  # noqa: E402
from repro_torch.ft import fault_tolerance as t_ft  # noqa: E402
from repro_torch.models import zoo  # noqa: E402
from repro_torch.serve import admission as t_adm  # noqa: E402
from repro_torch.serve import chaos as t_chaos  # noqa: E402
from repro_torch.serve import vision as t_vision  # noqa: E402
from repro_torch.serve.admission import RequestOutcome  # noqa: E402
from repro_torch.serve.batcher import ImageRequest  # noqa: E402

IMG, WIDTH, CLASSES = 32, 0.0625, 10


def _imgs(rng, n):
    return rng.standard_normal((n, 3, IMG, IMG)).astype(np.float32)


# --------------------------------------------------------------------------
# the control plane, decision by decision
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_admission_decisions_match_reference_package(seed):
    rng = np.random.default_rng(seed)
    widths = (1, 2, 4, 8)
    ts, js = (m.AdmissionController(widths, alpha=0.3, slack=1.2)
              for m in (t_adm, j_adm))
    for _ in range(200):
        if rng.random() < 0.4:
            b, s = int(rng.choice(widths)), float(rng.uniform(0, 0.2))
            ts.observe(b, s)
            js.observe(b, s)
        n, pending = int(rng.integers(1, 9)), int(rng.integers(0, 40))
        dl = None if rng.random() < 0.3 else float(rng.uniform(0, 1))
        assert ts.admit(n, pending, dl) == js.admit(n, pending, dl)
        assert ts.predicted_wait_s(pending, n) == \
            js.predicted_wait_s(pending, n)
        for w in widths:
            assert ts.estimate_s(w) == js.estimate_s(w)
    assert ts.observations == js.observations


def test_admission_registry_series_match_reference_package():
    from repro.obs.metrics import MetricsRegistry as JReg
    from repro_torch.obs.metrics import MetricsRegistry as TReg
    regs = TReg(), JReg()
    acs = [m.AdmissionController((1, 2), registry=r)
           for m, r in zip((t_adm, j_adm), regs)]
    for ac in acs:
        ac.observe(2, 0.05)
        ac.admit(1, 0, 1e-9)
        ac.admit(1, 0, None)
    assert regs[0].snapshot() == regs[1].snapshot()
    assert regs[0].to_prometheus() == regs[1].to_prometheus()


@pytest.mark.parametrize("seed", range(4))
def test_watchdog_verdicts_match_reference_package(seed):
    rng = np.random.default_rng(seed)
    clk = {"t": 0.0}
    kw = dict(hang_timeout_s=0.5, window=8, threshold=2.0,
              clock=lambda: clk["t"])
    tw, jw = (m.DispatchWatchdog((1, 2, 4, 8), **kw) for m in (t_adm, j_adm))
    for _ in range(300):
        b = int(rng.choice((1, 2, 4, 8)))
        d = float(rng.exponential(0.05 * b ** rng.uniform(0.5, 1.5)))
        if rng.random() < 0.03:
            d += 1.0
        clk["t"] += float(rng.uniform(0, 0.3))
        got, want = tw.observe(b, d), jw.observe(b, d)
        assert (got.hung, got.straggler) == (want.hung, want.straggler)
        assert tw.healthy() == jw.healthy()
    clk["t"] += 10.0
    assert not tw.healthy() and not jw.healthy()
    assert (tw.hung, tw.straggler_events) == (jw.hung, jw.straggler_events)
    assert tw.hung > 0 and tw.straggler_events > 0


def test_fault_tolerance_control_plane_matches_reference_package():
    from repro.ft import fault_tolerance as j_ft
    for n, mp, gb in ((8, 2, 64), (7, 1, 96), (16, 4, 1024), (5, 2, 30)):
        assert t_ft.solve_elastic_mesh(n, mp, gb).__dict__ == \
            j_ft.solve_elastic_mesh(n, mp, gb).__dict__
    with pytest.raises(ValueError):
        t_ft.solve_elastic_mesh(1, 2, 8)
    sd = t_ft.StragglerDetector(3, window=4, threshold=1.5)
    for r, t in ((0, 1.0), (1, 1.0), (2, 3.0)):
        sd.record(r, t)
    assert sd.stragglers() == [2]
    with t_ft.PreemptionGuard() as guard:
        assert not guard.requested
        guard._handler(15, None)
        assert guard.requested


@pytest.mark.parametrize("profile", t_chaos.PROFILES)
@pytest.mark.parametrize("seed,period", [(0, 3), (7, 3), (11, 4), (3, 2)])
def test_chaos_schedules_match_reference_package(profile, seed, period):
    got = t_chaos.ChaosInjector.from_profile(profile, seed, period=period)
    want = j_chaos.ChaosInjector.from_profile(profile, seed, period=period)
    assert {i: (f.kind, f.slow_s) for i, f in got.schedule.items()} == \
        {i: (f.kind, f.slow_s) for i, f in want.schedule.items()}
    assert got.describe() == want.describe()
    assert t_chaos.PROFILE_EXPECTATIONS == j_chaos.PROFILE_EXPECTATIONS


def test_chaos_call_on_tensors():
    chaos = t_chaos.ChaosInjector({1: t_chaos.Fault("kernel"),
                                   2: t_chaos.Fault("nan"),
                                   3: t_chaos.Fault("slow", slow_s=0.25)},
                                  sleep=(slept := []).append)
    x = torch.ones(2, 3)
    assert torch.equal(chaos.call(lambda a: a * 2, x), x * 2)
    with pytest.raises(t_chaos.ChaosKernelFault):
        chaos.call(lambda a: a, x)
    y = chaos.call(lambda a: a * 2, x)
    assert isinstance(y, torch.Tensor) and y.shape == x.shape \
        and bool(torch.isnan(y).all())
    assert torch.equal(chaos.call(lambda a: a, x), x) and slept == [0.25]
    # recovery never consumes the schedule; poison fires on both streams
    assert chaos.dispatches == 4
    poison = t_chaos.ChaosInjector(fault_on_nan_input=True)
    bad = torch.tensor([1.0, float("inf")])
    for stream in ("primary", "recovery"):
        with pytest.raises(t_chaos.ChaosKernelFault, match="poisoned"):
            poison.call(lambda a: a, bad, stream=stream)
    assert poison.injected == {"kernel": 0, "nan": 0, "slow": 0,
                               "poison": 2}
    with pytest.raises(ValueError, match="unknown fault kind"):
        t_chaos.Fault("meteor")


# --------------------------------------------------------------------------
# the engine under every chaos profile, against the JAX engine
# --------------------------------------------------------------------------

def _torch_params(model, seed=0):
    spec = zoo.get_conv_model(model)
    return spec, spec.init_params(torch.Generator().manual_seed(seed),
                                  width_mult=WIDTH, img=IMG,
                                  classes=CLASSES, device="cpu")


def _jax_params(params):
    import jax.numpy as jnp
    return {k: {n: jnp.asarray(t.numpy()) for n, t in v.items()}
            for k, v in params.items()}


def _chaos_run(engine, sizes, rng_seed):
    """``chaos_summary``'s loop: submit one, step one, then drain; a
    deadline no batch can meet on every third request (shed once the
    admission EWMA is live)."""
    rng = np.random.default_rng(rng_seed)
    engine.warmup()
    reqs = []
    for i, n in enumerate(sizes):
        dl = 1e-9 if i and i % 3 == 0 else None
        reqs.append(engine.submit(_imgs(rng, int(n)), deadline_s=dl))
        engine.step()
    engine.run()
    return reqs


@pytest.mark.parametrize("profile", t_chaos.PROFILES)
def test_engine_under_chaos_matches_reference_package(profile):
    """Same (profile, seed), the same request stream, one bucket lane (so
    no straggler verdict depends on this host's timings), a hang timeout
    far from both a forward and the slow fault: the same outcome and rung
    per request, the same robustness counters and faults fired, and the
    served logits within fp32 tolerance of the JAX engine's."""
    from repro.models import vgg as j_vgg
    from repro.serve.vision import VisionEngine as JEngine
    spec, params = _torch_params("vgg16")
    sizes = np.random.default_rng(5).integers(1, 5, 10)
    kw = dict(img=IMG, buckets=(4,), hang_timeout_s=0.25)
    runs = []
    for eng in (
            t_vision.VisionEngine(
                params, spec.to_graph(), device="cpu",
                chaos=t_chaos.ChaosInjector.from_profile(profile, 7,
                                                         slow_s=0.5),
                **kw),
            JEngine(_jax_params(params), j_vgg.to_graph(),
                    policy="reference",
                    chaos=j_chaos.ChaosInjector.from_profile(profile, 7,
                                                             slow_s=0.5),
                    **kw)):
        runs.append((eng, _chaos_run(eng, sizes, 9)))
    (teng, treqs), (jeng, jreqs) = runs
    assert [(r.outcome.value, r.served_by) for r in treqs] == \
        [(r.outcome.value, r.served_by) for r in jreqs]
    got, want = (e.metrics_dict()["robustness"] for e in (teng, jeng))
    assert got == want
    assert all(got[k] for k in t_chaos.PROFILE_EXPECTATIONS[profile])
    assert got["lost_requests"] == 0 and got["shed"] > 0
    for t, j in zip(treqs, jreqs):
        if t.outcome is RequestOutcome.OK:
            np.testing.assert_allclose(t.logits, np.asarray(j.logits),
                                       rtol=0, atol=1e-4 * float(
                                           np.abs(j.logits).max()) + 1e-9)


@pytest.mark.parametrize("model", ["vgg16", "resnet18", "mobilenetv2"])
def test_quarantine_bisection_isolates_exactly_the_poison(model):
    """A request whose data crashes the kernel on every rung fails alone;
    every batchmate is served by the reference rung, bitwise equal to the
    reference rung's direct forward of its own images."""
    spec, params = _torch_params(model)
    eng = t_vision.VisionEngine(
        params, spec.to_graph(), img=IMG, buckets=(1, 2, 4), device="cpu",
        chaos=t_chaos.ChaosInjector(fault_on_nan_input=True))
    rng = np.random.default_rng(4)
    good = [_imgs(rng, 1), _imgs(rng, 1), _imgs(rng, 1)]
    poison = _imgs(rng, 1)
    poison[0, 0, 0, 0] = np.inf
    # slip the poison past submit's validation straight into the queue
    reqs = [eng.submit(good[0]), eng.submit(good[1])]
    bad = ImageRequest(rid=999, images=poison)
    eng.batcher.queue.append(bad)
    eng.metrics.submitted += 1
    reqs.append(eng.submit(good[2]))
    m = eng.run()
    assert bad.outcome is RequestOutcome.FAILED and "quarantined" in bad.error
    assert m.outcomes == {"ok": 3, "failed": 1} and m.failed == 1
    assert m.degraded_batches == 1
    assert eng.metrics_dict()["robustness"]["lost_requests"] == 0
    for req, im in zip(reqs, good):
        assert req.served_by == "reference"
        want = t_chaos._direct_logits(eng, im, "reference")
        np.testing.assert_array_equal(req.logits, want)


def test_kernel_fault_degrades_batch_to_reference_bitwise():
    spec, params = _torch_params("vgg16")
    eng = t_vision.VisionEngine(
        params, spec.to_graph(), img=IMG, buckets=(2,), device="cpu",
        chaos=t_chaos.ChaosInjector({1: t_chaos.Fault("kernel")}))
    rng = np.random.default_rng(2)
    imgs = [_imgs(rng, 2) for _ in range(3)]
    reqs = [eng.submit(im) for im in imgs]
    m = eng.run()
    assert [r.served_by for r in reqs] == ["primary", "reference",
                                           "primary"]
    assert m.degraded_batches == 1 and m.failed == 0
    for req, im, policy in zip(reqs, imgs, ("auto", "reference", "auto")):
        np.testing.assert_array_equal(
            req.logits, t_chaos._direct_logits(eng, im, policy))


@pytest.mark.parametrize("with_chaos", [False, True])
def test_wrapper_error_fails_the_run_instead_of_degrading(monkeypatch,
                                                          with_chaos):
    """A kernel wrapper that raises something other than an injected fault
    (a library that did not build, a launch it refuses) propagates out of
    ``run``: the reference rung never serves what a broken kernel could
    not, with or without a chaos injector wrapping the dispatch."""
    from repro_torch.kernels import conv2d_ws as cw
    spec, params = _torch_params("vgg16")
    eng = t_vision.VisionEngine(
        params, spec.to_graph(), img=IMG, buckets=(2,), device="cpu",
        chaos=t_chaos.ChaosInjector() if with_chaos else None)
    eng.warmup()

    def refuse(*args, **kwargs):
        raise RuntimeError("fold_conv: launch refused")
    for dataflow in list(cw._PLAIN_WALKS):
        monkeypatch.setitem(cw._PLAIN_WALKS, dataflow, refuse)
    eng.submit(_imgs(np.random.default_rng(3), 2))
    with pytest.raises(RuntimeError, match="launch refused"):
        eng.run()
    m = eng.metrics
    assert (m.degraded_batches, m.failed, m.requests) == (0, 0, 0)
    assert eng._ref_compiler is None


def test_nan_output_detected_and_slow_batch_flagged_hung():
    spec, params = _torch_params("vgg16")
    rng = np.random.default_rng(3)
    eng = t_vision.VisionEngine(
        params, spec.to_graph(), img=IMG, buckets=(2,), device="cpu",
        chaos=t_chaos.ChaosInjector({0: t_chaos.Fault("nan")}))
    req = eng.submit(_imgs(rng, 2))
    m = eng.run()
    assert req.outcome is RequestOutcome.OK and req.served_by == "reference"
    assert np.isfinite(req.logits).all()
    assert m.nonfinite_batches == 1 and m.degraded_batches == 1
    eng = t_vision.VisionEngine(
        params, spec.to_graph(), img=IMG, buckets=(2,), device="cpu",
        hang_timeout_s=0.05,
        chaos=t_chaos.ChaosInjector({0: t_chaos.Fault("slow", slow_s=0.2)}))
    req = eng.submit(_imgs(rng, 2))
    m = eng.run()
    assert req.outcome is RequestOutcome.OK and req.served_by == "primary"
    assert m.hung_batches == 1 and m.degraded_batches == 0
    assert eng.watchdog.hung == 1


def test_admission_shed_and_deadlines_through_engine():
    spec, params = _torch_params("vgg16")
    eng = t_vision.VisionEngine(params, spec.to_graph(), img=IMG,
                                buckets=(1, 2), device="cpu")
    eng.warmup()
    rng = np.random.default_rng(6)
    ok = eng.submit(_imgs(rng, 1), deadline_s=60.0)
    eng.step()                                  # the EWMA goes live
    assert eng.admission.observations >= 1 and ok.deadline_met
    shed = eng.submit(_imgs(rng, 1), deadline_s=1e-9)
    assert shed.outcome is RequestOutcome.REJECTED
    assert "admission" in shed.error and shed.predicted_wait_s > 0
    assert eng.pending == 0
    m = eng.metrics
    assert (m.shed, m.deadline_total, m.deadline_hits) == (1, 2, 1)
    assert m.deadline_hit_rate == 0.5
    d = eng.metrics_dict()
    assert d["robustness"]["deadline_hit_rate"] == 0.5
    assert d["observability"]["conv_layers"] == 13


def test_metrics_dict_robustness_keys_match_reference_package():
    """The robustness section's keys (``lost_requests`` and, with chaos,
    ``chaos_injected`` included) and the top-level keys, against the JAX
    engine's; the port adds its device and the runtime's host µs a batch,
    and nothing else."""
    from repro.models import vgg as j_vgg
    from repro.serve.vision import VisionEngine as JEngine
    spec, params = _torch_params("vgg16")
    rng = np.random.default_rng(7)
    x = _imgs(rng, 2)
    dicts = []
    for eng in (t_vision.VisionEngine(params, spec.to_graph(), img=IMG,
                                      buckets=(2,), device="cpu",
                                      chaos=t_chaos.ChaosInjector()),
                JEngine(_jax_params(params), j_vgg.to_graph(), img=IMG,
                        buckets=(2,), policy="reference",
                        chaos=j_chaos.ChaosInjector())):
        eng.submit(x)
        eng.run()
        dicts.append(eng.metrics_dict())
    got, want = dicts
    assert set(got) - set(want) == {"device", "host_us_per_batch"}
    assert got["host_us_per_batch"] > 0
    assert not set(want) - set(got)
    assert got["mesh"] is None and want["mesh"] is None
    assert set(got["robustness"]) == set(want["robustness"])
    assert got["robustness"] == want["robustness"]
    assert set(got["observability"]) == set(want["observability"])


def test_serving_summary_preemption_drain():
    class TrippedAfter:
        def __init__(self, n):
            self.n = n

        @property
        def requested(self):
            self.n -= 1
            return self.n < 0

    d = t_vision.serving_summary("vgg16", requests=8, img=IMG,
                                 width_mult=WIDTH, buckets=(1, 2), seed=0,
                                 guard=TrippedAfter(3), device="cpu")
    assert d["workload"]["preempted"] == 5
    assert d["robustness"]["submitted"] == 3
    assert d["robustness"]["lost_requests"] == 0
    assert sum(d["robustness"]["outcomes"].values()) == 3
    assert d["verify"]["bitwise"] and d["verify"]["requests"] == 3


def test_chaos_summary_verifies_every_invariant():
    d = t_chaos.chaos_summary("vgg16", profile="mixed", seed=7, requests=10,
                              img=IMG, width_mult=WIDTH, device="cpu",
                              deadline_s=1e-9)
    rb = d["robustness"]
    assert rb["lost_requests"] == 0 and rb["degraded_batches"] > 0
    assert rb["submitted"] == 10 == sum(rb["outcomes"].values())
    assert rb["shed"] + rb["expired"] > 0
    assert d["chaos"]["profile"] == "mixed"
    assert d["workload"]["device"] == "cpu"


def test_verify_chaos_run_reports_a_wrong_response():
    spec, params = _torch_params("vgg16")
    eng = t_vision.VisionEngine(params, spec.to_graph(), img=IMG,
                                buckets=(2,), device="cpu",
                                chaos=t_chaos.ChaosInjector())
    x = _imgs(np.random.default_rng(8), 2)
    req = eng.submit(x)
    eng.run()
    assert t_chaos.verify_chaos_run(eng, [req], [x], profile="kernel-fault",
                                    shedding=False) == [
        "profile 'kernel-fault': expected nonzero degraded_batches, got 0"]
    req.logits = req.logits + 1.0
    assert any("differ from the direct" in p for p in
               t_chaos.verify_chaos_run(eng, [req], [x], profile="mixed",
                                        shedding=True))
