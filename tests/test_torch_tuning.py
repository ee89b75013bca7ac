"""The port's measured autotuner against the JAX package's: the candidate
set (labels, blocks, grid, dataflows) on every conv geometry of the three
zoo models and a grouped ResNeXt layer, the winner and timings under the
same deterministic timer, the tuning JSON's schema (all but ``backend``)
and its loader's tolerance, ``compile_network(autotune=True)``'s
schedules and compile-track spans, and the keyword sets of the engine's
entry points.  ``cuda`` cases time real candidates on the card."""
import dataclasses
import inspect
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import engine as t_engine  # noqa: E402
from repro_torch.core.loopnest import ConvLoopNest  # noqa: E402
from repro_torch.models import zoo  # noqa: E402
from repro_torch.obs import trace as t_trace  # noqa: E402
from repro_torch.serve import vision as t_vision  # noqa: E402

IMG, WIDTH, CLASSES = 32, 0.0625, 10
MODELS = ("vgg16", "resnet18", "mobilenetv2")


def _ref(name):
    """A module of the JAX package, imported where a case compares with
    it: the cases marked ``cuda`` run where JAX is not installed."""
    import importlib
    return importlib.import_module(f"repro.{name}")
# ResNeXt-50 32x4d's first grouped 3x3 (C = NF = 128, G = 32): no zoo model
# is grouped with 1 < G < C
GROUPED = ConvLoopNest(n=1, nf=128, c=128, r=3, s=3, x=56, y=56, stride=1,
                       pad=1, groups=32)


def _nests(model, width):
    """The conv loop nests of a model's compile: the walk reads only the
    weights' shapes, so they live on the meta device."""
    spec = zoo.get_conv_model(model)
    params = spec.init_params(None, width_mult=width, img=IMG,
                              classes=CLASSES, device="meta")
    net = zoo.compile_forward(spec, params, img=IMG, batch=2,
                              policy="reference", jit=False, verify=False,
                              device="cpu")
    return [cv for _, cv in net.layer_nests]


def _geometries():
    out = {}
    for model in MODELS:
        for width in (WIDTH, 1.0):
            for cv in _nests(model, width):
                out.setdefault(dataclasses.astuple(cv), cv)
    out[dataclasses.astuple(GROUPED)] = GROUPED
    return list(out.values())


GEOMETRIES = _geometries()


def _jnest(cv):
    return _ref("core.loopnest").ConvLoopNest(**dataclasses.asdict(cv))


def _plan_tuple(plan):
    return (plan.nf_block, plan.c_block, plan.p_block, tuple(plan.grid),
            plan.vmem_bytes, plan.groups)


def _fake_timer(plan, df):
    """Deterministic, distinct-ish times from a plan's blocks."""
    return ((plan.nf_block * 7 + plan.c_block * 13 + plan.p_block * 3)
            % 17 + 0.5 * (df == "weight_stationary")) / 10.0 + 0.01


def test_candidate_geometries_cover_grouped_and_depthwise():
    assert any(cv.depthwise for cv in GEOMETRIES)
    assert any(1 < cv.groups < cv.c for cv in GEOMETRIES)
    assert len(GEOMETRIES) > 40


@pytest.mark.parametrize("cv", GEOMETRIES, ids=str)
def test_tuning_candidates_match_reference_package(cv):
    got = [(label, _plan_tuple(plan), df)
           for label, plan, df in t_engine.tuning_candidates(cv)]
    want = [(label, _plan_tuple(plan), df)
            for label, plan, df in _ref("core.engine").tuning_candidates(_jnest(cv))]
    assert got == want


@pytest.mark.parametrize("precision", ["fp32", "int8"])
@pytest.mark.parametrize("cv", GEOMETRIES[::4] + [GROUPED], ids=str)
def test_autotune_schedule_picks_the_reference_winner(cv, precision):
    got = t_engine.autotune_schedule(cv, timer=_fake_timer,
                                     precision=precision)
    want = _ref("core.engine").autotune_schedule(_jnest(cv), timer=_fake_timer,
                                      precision=precision)
    assert str(got.key) == str(want.key)
    assert _plan_tuple(got.plan) == _plan_tuple(want.plan)
    assert got.dataflow == want.dataflow
    assert got.timings == want.timings
    assert got.measured_ms == want.measured_ms
    assert got.costs == want.costs
    assert (got.source, got.tuned) == (want.source, want.tuned) == \
        ("measured", True)
    assert got.cost_dict == want.cost_dict


def test_autotune_isolates_failing_candidates_and_ranks_by_time():
    cv = ConvLoopNest(n=1, nf=16, c=8, r=3, s=3, x=12, y=12, stride=1, pad=1)

    def timer(plan, df):
        if df == "output_stationary":
            raise RuntimeError("no such kernel")
        return 1.0 / plan.p_block

    s = t_engine.autotune_schedule(cv, timer=timer)
    assert s.dataflow == "weight_stationary"
    assert [ms for _, ms in s.timings] == sorted(ms for _, ms in s.timings)
    assert s.failed and all(lbl.endswith("/output_stationary")
                            for lbl, _ in s.failed)
    with pytest.raises(RuntimeError, match="every candidate failed"):
        t_engine.autotune_schedule(cv, timer=lambda p, d: 1 / 0)


def test_autotune_proves_and_times_candidates_on_the_cpu():
    """Without a timer each candidate is proven, then timed on the device
    (here the plain fold loop); the winner runs and matches the oracle."""
    cv = ConvLoopNest(n=1, nf=8, c=4, r=3, s=3, x=8, y=8, stride=1, pad=1)
    s = t_engine.autotune_schedule(cv, device="cpu", reps=1)
    assert s.source == "measured" and not s.failed
    assert len(s.timings) == len(t_engine.tuning_candidates(cv))
    assert all(ms > 0 for _, ms in s.timings)


def _cache_pair():
    cvs = [ConvLoopNest(n=1, nf=8, c=4, r=3, s=3, x=8, y=8, stride=1, pad=1),
           ConvLoopNest(n=1, nf=16, c=16, r=3, s=3, x=8, y=8, stride=1,
                        pad=1, groups=16),
           ConvLoopNest(n=2, nf=32, c=8, r=1, s=1, x=6, y=6, stride=1,
                        pad=0)]
    tc, jc = t_engine.ScheduleCache(), _ref("core.engine").ScheduleCache()
    for cv in cvs:
        for precision in ("fp32", "int8"):
            tc.autotune_for(cv, timer=_fake_timer, precision=precision)
            jc.autotune_for(_jnest(cv), timer=_fake_timer,
                            precision=precision)
    return cvs, tc, jc


def test_save_tuning_schema_matches_reference_package(tmp_path):
    cvs, tc, jc = _cache_pair()
    assert len(tc) == len(jc) == 6 and tc.stats.as_dict() == \
        jc.stats.as_dict()
    # pay-once: a second lookup of a tuned key measures nothing
    tc.autotune_for(cvs[0], timer=lambda p, d: 1 / 0)
    assert tc.stats.hits == 1
    tp, jp = tmp_path / "t.json", tmp_path / "j.json"
    assert tc.save_tuning(str(tp), device="cpu") == 6
    assert jc.save_tuning(str(jp)) == 6
    got, want = json.loads(tp.read_text()), json.loads(jp.read_text())
    assert got.pop("backend") == "torch-cpu"
    assert want.pop("backend") == "cpu"
    assert got == want
    fresh = t_engine.ScheduleCache()
    assert fresh.load_tuning(str(tp), device="cpu") == 6
    by_key = {s.key: s for s in tc.schedules()}
    for s in fresh.schedules():
        t = by_key[s.key]
        assert (s.source, s.plan, s.dataflow, s.timings, s.measured_ms) == \
            ("loaded", t.plan, t.dataflow, t.timings, t.measured_ms)
    # loaded entries hit in both lookups, no re-measurement
    assert fresh.autotune_for(cvs[1], timer=lambda p, d: 1 / 0).tuned
    assert fresh.schedule_for(cvs[2]).source == "loaded"


@pytest.mark.parametrize("tag", ["cpu", "tpu", "gpu",
                                 "torch-cuda:NVIDIA H100 80GB HBM3",
                                 "torch-cuda:another card"])
def test_load_tuning_rejects_foreign_backend(tmp_path, tag):
    """A file the JAX package wrote (on any backend), a card's file on the
    CPU, a file from another card model: ignored with a warning."""
    _, tc, jc = _cache_pair()
    path = tmp_path / "tuning.json"
    if tag in ("cpu", "tpu", "gpu"):
        jc.save_tuning(str(path))
        payload = json.loads(path.read_text())
        payload["backend"] = tag
    else:
        tc.save_tuning(str(path), device="cpu")
        payload = json.loads(path.read_text())
        payload["backend"] = tag
    path.write_text(json.dumps(payload))
    fresh = t_engine.ScheduleCache()
    with pytest.warns(UserWarning, match="measured on backend"):
        assert fresh.load_tuning(str(path), device="cpu") == 0
    assert len(fresh) == 0


def test_load_tuning_tolerates_old_new_missing_and_corrupt(tmp_path):
    _, tc, _ = _cache_pair()
    path = tmp_path / "tuning.json"
    tc.save_tuning(str(path), device="cpu")
    payload = json.loads(path.read_text())
    # an older writer: no backend, no groups / precision fields
    old = dict(payload)
    del old["backend"]
    old["entries"] = [dict(e, key={k: v for k, v in e["key"].items()
                                   if k not in ("groups", "precision")})
                      for e in payload["entries"]
                      if e["key"]["groups"] == 1
                      and e["key"]["precision"] == "fp32"]
    for e in old["entries"]:
        e["plan"] = {k: v for k, v in e["plan"].items() if k != "groups"}
        e["nest"]["future_field"] = 1          # a newer writer's extra
    path.write_text(json.dumps(old))
    fresh = t_engine.ScheduleCache()
    assert fresh.load_tuning(str(path), device="cpu") == 2
    assert {s.key.groups for s in fresh.schedules()} == {1}
    # missing file, corrupt payloads, one corrupt entry among good ones
    with pytest.warns(UserWarning, match="missing or corrupt"):
        assert t_engine.ScheduleCache().load_tuning(
            str(tmp_path / "nope.json")) == 0
    for bad in ("not json", json.dumps({"entries": {}}), json.dumps([])):
        path.write_text(bad)
        with pytest.warns(UserWarning, match="missing or corrupt"):
            assert t_engine.ScheduleCache().load_tuning(str(path)) == 0
    payload["entries"][0] = {"key": {"nf": 1}}
    path.write_text(json.dumps(payload))
    with pytest.warns(UserWarning, match="skipping corrupt entry"):
        assert t_engine.ScheduleCache().load_tuning(
            str(path), device="cpu") == 5


class _UnitScales:
    def scale_for(self, name):
        return 1.0


class FakeClock:
    def __init__(self, step=0.001):
        self.t = 0.0
        self.step = step

    def __call__(self):
        self.t += self.step
        return self.t


@pytest.mark.parametrize("precision", ["fp32", "int8"])
@pytest.mark.parametrize("model", MODELS)
def test_compile_network_autotune_matches_reference_package(
        tmp_path, model, precision):
    """The same timer gives the same per-layer schedules, the same
    compile-track spans under a fake clock, and a JSON that the next
    compile loads without measuring; the tuned forward matches the
    reference policy."""
    from repro.models import zoo as j_zoo
    spec, jspec = zoo.get_conv_model(model), j_zoo.get_conv_model(model)
    params = spec.init_params(torch.Generator().manual_seed(0),
                              width_mult=WIDTH, img=IMG, classes=CLASSES,
                              device="cpu")
    # the JAX compile reads only the weights' shapes (and, in int8, each
    # conv's activation scale, which no schedule depends on)
    jparams = {k: {n: t.numpy() for n, t in v.items()}
               for k, v in params.items()}
    path = str(tmp_path / "tuning.json")
    tt, jt = t_trace.Tracer(FakeClock()), _ref("obs.trace").Tracer(FakeClock())
    net = zoo.compile_forward(spec, params, img=IMG, batch=2,
                              policy="reference", autotune=True,
                              tuning_path=path, autotune_timer=_fake_timer,
                              tracer=tt, device="cpu", precision=precision)
    jnet = j_zoo.compile_forward(jspec, jparams, img=IMG, batch=2,
                                 policy="reference", autotune=True,
                                 autotune_timer=_fake_timer, tracer=jt,
                                 precision=precision, quant=_UnitScales())
    assert net.autotuned and jnet.autotuned
    assert [(n, str(k)) for n, k in net.layer_keys] == \
        [(n, str(k)) for n, k in jnet.layer_keys]
    for (_, s), (_, j) in zip(net.layer_schedules, jnet.layer_schedules):
        assert (_plan_tuple(s.plan), s.dataflow, s.timings, s.source) == \
            (_plan_tuple(j.plan), j.dataflow, j.timings, j.source)
    assert net.fold_reuse() == jnet.fold_reuse()
    assert json.dumps(tt.to_json(), sort_keys=True) == \
        json.dumps(jt.to_json(), sort_keys=True)
    assert "[measured]" in net.describe()
    again = zoo.compile_forward(spec, params, img=IMG, batch=2,
                                autotune=True, tuning_path=path,
                                autotune_timer=lambda p, d: 1 / 0,
                                device="cpu", precision=precision,
                                quant=net.quant)
    assert all(s.source == "loaded" for _, s in again.layer_schedules)
    # fp32: within the kernels' tolerance of the reference policy; int8:
    # the int32 sums are exact whatever the plan, so the tuned forward is
    # bitwise the untuned one (the reference policy's unfused epilogue
    # may round an activation across a quantization step)
    want_net = zoo.compile_forward(
        spec, params, img=IMG, batch=2, device="cpu", precision=precision,
        quant=net.quant,
        policy="reference" if precision == "fp32" else "auto")
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 3, IMG, IMG)).astype(np.float32))
    with torch.inference_mode():
        got, want = again(params, x), want_net(params, x)
    if precision == "int8":
        assert want_net.layer_schedules != again.layer_schedules
        assert torch.equal(got, want)
    else:
        assert torch.allclose(got, want, rtol=0, atol=1e-4 * float(
            want.abs().max()) + 1e-12)


def test_bucket_compiler_tunes_once_across_buckets():
    spec = zoo.get_conv_model("vgg16")
    params = spec.init_params(torch.Generator().manual_seed(0),
                              width_mult=WIDTH, img=IMG, classes=CLASSES,
                              device="cpu")
    calls = []

    def timer(plan, df):
        calls.append(df)
        return _fake_timer(plan, df)
    bc = zoo.bucket_compiler(spec, params, img=IMG, autotune=True,
                             autotune_timer=timer, device="cpu")
    bc.network_for(1)
    n = len(calls)
    bc.network_for(4)
    assert n > 0 and len(calls) == n and 4 in bc and 2 not in bc
    assert bc.cache.stats.hits > 0


def _served_and_trunks(device, model, precision, timer=None):
    """A tuned ``VisionEngine`` over buckets (2, 4): each request's served
    logits against a direct forward from the same cache, and the tuned
    network's rows (trunk and head kernel) at batch 1 against batch 4."""
    from repro_torch.core.engine import compile_network
    spec = zoo.get_conv_model(model)
    gen = torch.Generator(device=device).manual_seed(3)
    width = WIDTH if device.type == "cpu" else 1.0
    params = spec.init_params(gen, width_mult=width, img=IMG,
                              classes=CLASSES, device=device)
    eng = t_vision.VisionEngine(params, spec.to_graph(), img=IMG,
                                buckets=(2, 4), autotune=True,
                                autotune_timer=timer, device=device,
                                precision=precision)
    assert all(s.tuned for s in eng.compiler.cache.schedules())
    rng = np.random.default_rng(5)
    imgs = [rng.standard_normal((n, 3, IMG, IMG)).astype(np.float32)
            for n in (1, 3, 2)]
    reqs = [eng.submit(im) for im in imgs]
    eng.run()
    kw = dict(cache=eng.compiler.cache, device=device, precision=precision,
              quant=eng.compiler.quant, autotune=True,
              autotune_timer=lambda p, d: 1 / 0)
    for req, im in zip(reqs, imgs):
        assert req.served_by == "primary"
        direct = zoo.compile_forward(spec, params, img=IMG,
                                     batch=im.shape[0], jit=False, **kw)
        with torch.inference_mode():
            want = direct(params, torch.from_numpy(im).to(device))
        assert torch.equal(torch.from_numpy(req.logits).to(device), want)
    trunk = spec.to_graph()
    x = torch.from_numpy(imgs[0].repeat(4, axis=0) + rng.standard_normal(
        (4, 3, IMG, IMG)).astype(np.float32)).to(device)
    nets = {b: compile_network(params, trunk, (b, 3, IMG, IMG), **kw)
            for b in (1, 4)}
    with torch.inference_mode():
        t4 = nets[4](params, x)
        for i in range(4):
            assert torch.equal(nets[1](params, x[i:i + 1])[0], t4[i])


@pytest.mark.parametrize("precision", ["fp32", "int8"])
@pytest.mark.parametrize("model", MODELS)
def test_tuned_serving_and_trunks_are_bitwise(model, precision):
    """With ``autotune=True`` (one schedule per key, shared by every
    bucket) served logits equal a direct forward bitwise and a network's
    rows are the same bits at batch 1 and batch 4, in fp32 and int8."""
    _served_and_trunks(torch.device("cpu"), model, precision,
                       timer=_fake_timer)


def _kw(fn, drop=()):
    return {k: (p.default, p.kind) for k, p in
            inspect.signature(fn).parameters.items() if k not in drop}


# what the port adds: its device, CUDA graphs, and the compiler's side of
# a mesh's filter split (``shard``, which ``VisionEngine(mesh=)`` builds)
PORT_ONLY = {"device", "jit", "shard"}


@pytest.mark.parametrize("name,where", [
    ("compile_network", "core.engine"), ("BucketCompiler", "core.engine"),
    ("VisionEngine", "serve.vision"), ("serving_summary", "serve.vision")])
def test_entry_point_keywords_match_reference_package(name, where):
    """Every keyword of the JAX package's entry point (the mesh's
    included) is there with its default and kind, in its order; the port
    adds only its device, ``jit`` and ``shard``."""
    mod = t_vision if where == "serve.vision" else t_engine
    every = _kw(getattr(mod, name))
    want = _kw(getattr(_ref(where), name))
    got = {k: v for k, v in every.items() if k in want}
    assert got == want
    assert list(got) == list(want)
    assert set(every) - set(want) <= PORT_ONLY


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the candidates are timed on it")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["fp32", "int8"])
@pytest.mark.parametrize("model", MODELS)
def test_cuda_autotuned_forward_is_proven_bitwise_jit_and_reloads(
        cuda_device, tmp_path, model, precision):
    spec = zoo.get_conv_model(model)
    params = spec.init_params(
        torch.Generator(device=cuda_device).manual_seed(0), width_mult=1.0,
        img=IMG, classes=CLASSES, device=cuda_device)
    path = str(tmp_path / "tuning.json")
    net = zoo.compile_forward(spec, params, img=IMG, batch=2, autotune=True,
                              tuning_path=path, device=cuda_device,
                              precision=precision)
    assert all(s.source == "measured" and s.measured_ms > 0
               for _, s in net.layer_schedules)
    x = torch.randn(2, 3, IMG, IMG, device=cuda_device)
    ref = zoo.compile_forward(spec, params, img=IMG, batch=2,
                              policy="reference", device=cuda_device,
                              precision=precision, quant=net.quant)
    with torch.inference_mode():
        y, ye, yr = net(params, x), net.eager(params, x), ref(params, x)
    assert torch.equal(y, ye)
    assert float((y - yr).abs().max()) <= 1e-4 * float(yr.abs().max()) \
        + 1e-6
    payload = json.loads(open(path).read())
    assert payload["backend"] == \
        f"torch-cuda:{torch.cuda.get_device_name(cuda_device)}"
    fresh = t_engine.ScheduleCache()
    assert fresh.load_tuning(path, device=cuda_device) == len(net.cache)
    with pytest.warns(UserWarning, match="measured on backend"):
        assert t_engine.ScheduleCache().load_tuning(path,
                                                    device="cpu") == 0
    os.remove(path)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["fp32", "int8"])
@pytest.mark.parametrize("model", MODELS)
def test_cuda_tuned_serving_and_trunks_are_bitwise(cuda_device, model,
                                                   precision):
    _served_and_trunks(cuda_device, model, precision)
