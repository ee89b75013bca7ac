"""The port's observability layer against the JAX package's: the tracer's
event JSON under a fake clock, the trace validator, the metrics
registry's ``snapshot()`` and ``to_prometheus()`` for the same
recordings and the snapshot validator, the fold counters' model-side
columns on the same networks, a served request stream's trace (every
request a lifetime span with a terminal outcome) and registry series,
the report CLI and the launcher's ``--trace`` / ``--metrics-json``, on
the CPU."""
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.obs import folds as j_folds  # noqa: E402
from repro.obs import metrics as j_metrics  # noqa: E402
from repro.obs import trace as j_trace  # noqa: E402
from repro_torch.models import zoo  # noqa: E402
from repro_torch.obs import folds as t_folds  # noqa: E402
from repro_torch.obs import metrics as t_metrics  # noqa: E402
from repro_torch.obs import report as t_report  # noqa: E402
from repro_torch.obs import trace as t_trace  # noqa: E402
from repro_torch.serve import vision as t_vision  # noqa: E402

IMG, WIDTH, CLASSES = 32, 0.0625, 10
MODELS = ("vgg16", "resnet18", "mobilenetv2")


class FakeClock:
    """Deterministic injectable clock: each call advances a fixed step."""

    def __init__(self, step=0.001):
        self.t = 0.0
        self.step = step

    def __call__(self):
        self.t += self.step
        return self.t


def _drive(tr):
    """Every tracer call the serving stack makes, in one script."""
    tr.metadata(0, "engine")
    with tr.span("outer", tid=0, k=1):
        with tr.span("inner", tid=0):
            tr.instant("tick", cat="error", tid=0, request_id=3)
    h = tr.begin("solo", "serve", 1, bucket=4)
    tr.end(h, outcome="ok")
    kid = tr.add_span("kernel", "device", 1, 0.5, 0.25, bucket=2)
    tr.add_span("conv0", "layer", 1, 0.5, 0.1, parent=kid,
                apportioned=True)
    outer = tr.begin("outer2", tid=2)
    tr.begin("dangling", tid=2)
    tr.end(outer)                          # closes the dangling child
    tr.end(tr.begin("idle", tid=0), discard=True)
    try:
        with tr.span("boom", tid=3):
            raise RuntimeError("x")
    except RuntimeError:
        pass


def test_trace_json_matches_reference_package(tmp_path):
    got, want = t_trace.Tracer(FakeClock(), pid=7), \
        j_trace.Tracer(FakeClock(), pid=7)
    _drive(got)
    _drive(want)
    assert got.to_json() == want.to_json()
    assert t_trace.validate_trace(got.to_json()) == []
    assert t_trace.span_tree(got.to_json()) == \
        j_trace.span_tree(want.to_json())
    tp, jp = tmp_path / "t.json", tmp_path / "j.json"
    got.save(str(tp))
    want.save(str(jp))
    assert tp.read_bytes() == jp.read_bytes()
    assert (t_trace.TID_ENGINE, t_trace.TID_DISPATCH, t_trace.TID_COMPLETE,
            t_trace.TID_COMPILE, t_trace.REQ_TID0) == \
        (j_trace.TID_ENGINE, j_trace.TID_DISPATCH, j_trace.TID_COMPLETE,
         j_trace.TID_COMPILE, j_trace.REQ_TID0)


BAD_TRACES = [
    {"traceEvents": [
        {"name": "a", "cat": "c", "ph": "X", "ts": 1.0, "pid": 0, "tid": 0},
        {"cat": "c", "ph": "i", "ts": -1, "pid": 0, "tid": 0},
        {"name": "b", "cat": "c", "ph": "X", "ts": 0, "dur": 1, "pid": 0,
         "tid": 0, "args": {"parent_id": 99}},
        {"name": "d", "cat": "c", "ph": "Q", "ts": True, "pid": 0,
         "tid": 0, "args": {"span_id": 1}},
        {"name": "e", "cat": "c", "ph": "i", "ts": 0, "pid": 0, "tid": 0,
         "args": {"span_id": 1}},
        "not an event"]},
    {"events": []},
    [],
]


@pytest.mark.parametrize("trace", BAD_TRACES)
def test_validate_trace_matches_reference_package(trace):
    got = t_trace.validate_trace(trace)
    assert got and got == j_trace.validate_trace(trace)


def test_null_tracer_is_inert():
    nt = t_trace.NULL_TRACER
    assert nt.enabled is False and isinstance(nt, t_trace.NullTracer)
    with nt.span("anything"):
        nt.instant("x")
    nt.end(nt.begin("y"))
    assert nt.add_span("k", "device", 1, 0.0, 1.0) == 0
    assert nt.to_json() == {"traceEvents": [], "displayTimeUnit": "ms"}
    with pytest.raises(RuntimeError):
        nt.save("never.json")


def _record(m, seed):
    """The same recordings into either package's registry."""
    rng = np.random.default_rng(seed)
    reg = m.MetricsRegistry(max_series=16)
    reg.counter("serve_requests_total", "Requests", outcome="ok").inc(7)
    reg.counter("serve_requests_total", outcome="failed").inc(1)
    reg.counter("plain_total").set_total(int(rng.integers(1, 100)))
    reg.gauge("serve_kips", "KIPS").set(float(rng.uniform(0, 3)))
    g = reg.gauge("depth", shard="a")
    g.inc(3)
    g.dec(0.5)
    h = reg.histogram("serve_latency_seconds", "Latency")
    h.record_many(rng.lognormal(-3, 1.0, 500))
    h.record(0.0)
    h.record(float("nan"))
    h.record(1e5)
    hist = m.LogHistogram(lo=1e-3, hi=2.0)
    hist.record_many(rng.uniform(0.2, 1.0, 50))
    reg.register_histogram("serve_slot_occupancy", hist, "Occupancy",
                           worker="w0")
    reg.histogram("empty_seconds")
    return reg


@pytest.mark.parametrize("seed", range(3))
def test_registry_exports_match_reference_package(seed):
    got, want = _record(t_metrics, seed), _record(j_metrics, seed)
    assert got.snapshot() == want.snapshot()
    assert got.to_prometheus() == want.to_prometheus()
    assert len(got) == len(want)
    assert t_metrics.validate_metrics_snapshot(got.snapshot()) == []


def test_registry_errors_match_reference_package():
    for m in (t_metrics, j_metrics):
        reg = m.MetricsRegistry(max_series=2)
        reg.counter("c_total", shard="0")
        reg.counter("c_total", shard="1")
        with pytest.raises(ValueError, match="label cardinality"):
            reg.counter("c_total", shard="2")
        with pytest.raises(ValueError):
            reg.gauge("c_total")
        with pytest.raises(ValueError):
            reg.counter("bad name!")
        with pytest.raises(ValueError):
            reg.counter("x_total", **{"bad-label": "1"})
        c = m.Counter()
        c.set_total(5)
        with pytest.raises(ValueError):
            c.set_total(4)
        with pytest.raises(ValueError):
            c.inc(-1)


BAD_SNAPSHOTS = [
    {"counters": {"x": -1, "y": 1.5, "z": True}, "gauges": {"g": "1"},
     "histograms": {"h": {"count": 2, "sum": 1.0, "min": 0, "max": 1,
                          "mean": 0.5, "p50": 0.5, "p95": 1, "p99": 1,
                          "buckets": {"3": 1}},
                    "k": {"count": 1}, "j": []}},
    {"counters": [], "gauges": {}},
    [],
]


@pytest.mark.parametrize("snap", BAD_SNAPSHOTS)
def test_validate_metrics_snapshot_matches_reference_package(snap):
    got = t_metrics.validate_metrics_snapshot(snap)
    assert got and got == j_metrics.validate_metrics_snapshot(snap)


@pytest.mark.parametrize("seed", range(3))
def test_log_histogram_matches_reference_package(seed):
    rng = np.random.default_rng(seed)
    vals = rng.lognormal(-2.5, 1.2, 2000)
    got, want = t_metrics.LogHistogram(), j_metrics.LogHistogram()
    got.record_many(vals)
    want.record_many(vals)
    assert got.snapshot() == want.snapshot()
    for q in (0.0, 0.01, 0.5, 0.9, 0.99, 1.0):
        assert got.quantile(q) == want.quantile(q)


def _networks(model):
    """The same network compiled by both packages (reference policy, the
    JAX package reading the port's weights as numpy)."""
    from repro.models import zoo as j_zoo
    spec = zoo.get_conv_model(model)
    params = spec.init_params(torch.Generator().manual_seed(0),
                              width_mult=WIDTH, img=IMG, classes=CLASSES,
                              device="cpu")
    net = zoo.compile_forward(spec, params, img=IMG, batch=4,
                              policy="reference", jit=False, device="cpu")
    jparams = {k: {n: t.numpy() for n, t in v.items()}
               for k, v in params.items()}
    jnet = j_zoo.compile_forward(model, jparams, img=IMG, batch=4,
                                 policy="reference", jit=False)
    return net, jnet


MODEL_COLUMNS = ("key", "dataflow", "precision", "layers", "util_model_pct",
                 "t_ops_cycles", "gflops_model")


@pytest.mark.parametrize("model", MODELS)
def test_fold_counters_match_reference_package(model):
    """The model-side columns agree exactly; the apportioned measured
    columns agree to rounding for the same measured intervals."""
    net, jnet = _networks(model)
    got, want = t_folds.FoldStreamCounters(), j_folds.FoldStreamCounters()
    parts = []
    for fc, ls in ((got, net.layer_schedules), (want, jnet.layer_schedules)):
        fc.observe_compile(ls)
        for items, t in ((4, 0.01), (3, 0.02), (4, 0.015)):
            p = fc.observe_dispatch(ls, items, t)
        parts.append(p)
    rows_g, rows_w = got.rows(), want.rows()
    assert [{k: r[k] for k in MODEL_COLUMNS} for r in rows_g] == \
        [{k: r[k] for k in MODEL_COLUMNS} for r in rows_w]
    for rg, rw in zip(rows_g, rows_w):
        for k in ("dispatches", "items"):
            assert rg[k] == rw[k]
        for k in ("measured_s", "bytes_moved_model", "achieved_gflops",
                  "achieved_vs_model_pct"):
            assert math.isclose(rg[k], rw[k], rel_tol=1e-6, abs_tol=1e-6)
    assert [(n, k) for n, k, _ in parts[0]] == [(n, k) for n, k, _ in
                                                parts[1]]
    assert all(math.isclose(a[2], b[2], rel_tol=1e-9)
               for a, b in zip(*parts))
    assert math.isclose(sum(d for _, _, d in parts[0]), 0.015)
    assert got.util_model_pct == want.util_model_pct
    g, w = got.as_dict(), want.as_dict()
    assert {k: g[k] for k in ("pe_array", "distinct_schedules",
                              "conv_layers", "util_model_pct")} == \
        {k: w[k] for k in ("pe_array", "distinct_schedules", "conv_layers",
                           "util_model_pct")}
    # the table's model-side columns (schedule .. GF/s(mdl)), line by line
    cut = len(f"{'schedule':<24} {'dataflow':<18} {'lyr':>3} {'util%':>6} "
              f"{'GF/s(mdl)':>10}")
    assert [ln[:cut] for ln in got.table().splitlines()[:-1]] == \
        [ln[:cut] for ln in want.table().splitlines()[:-1]]
    assert got.table().splitlines()[-1] == want.table().splitlines()[-1]


def test_fold_counter_shares_are_computed_once_per_network():
    net, _ = _networks("vgg16")
    fc = t_folds.FoldStreamCounters()
    first = fc.prepare(net.layer_schedules)
    assert fc.prepare(net.layer_schedules) is first
    layers, keys = first
    assert len(layers) == 13 and len(keys) == 8
    assert math.isclose(sum(s for _, _, s in layers), 1.0)
    assert math.isclose(sum(s for _, s in keys), 1.0)


def _stream(engine, sizes, seed):
    rng = np.random.default_rng(seed)
    reqs = [engine.submit(rng.standard_normal((n, 3, IMG, IMG))
                          .astype(np.float32),
                          deadline_s=60.0 if i % 2 else None)
            for i, n in enumerate(sizes)]
    engine.run()
    return reqs


def _shape(trace):
    """What a trace records, less its times and the compile track (the
    port compiles the first bucket in the constructor, the JAX engine on
    first use)."""
    return [(e["name"], e["cat"], e["ph"], e["tid"],
             sorted(k for k in e["args"] if k != "predicted_wait_s"))
            for e in trace["traceEvents"] if e["cat"] != "compile"]


def test_serving_trace_and_registry_match_reference_package(tmp_path):
    """One served stream with the tracer and registry on, through both
    engines: the same spans in the same order (names, categories, tracks,
    argument keys), every request a lifetime span with a terminal
    outcome, the same registry series, valid artifacts."""
    from repro.models import vgg as j_vgg
    from repro.obs.report import check_trace_outcomes as j_check
    from repro.serve.vision import VisionEngine as JEngine
    spec = zoo.get_conv_model("vgg16")
    params = spec.init_params(torch.Generator().manual_seed(0),
                              width_mult=WIDTH, img=IMG, classes=CLASSES,
                              device="cpu")
    sizes = (2, 1, 4, 1, 3)
    tt, jt = t_trace.Tracer(FakeClock(0.0005)), \
        j_trace.Tracer(FakeClock(0.0005))
    treg, jreg = t_metrics.MetricsRegistry(), j_metrics.MetricsRegistry()
    teng = t_vision.VisionEngine(params, spec.to_graph(), img=IMG,
                                 policy="reference", buckets=(1, 2, 4),
                                 tracer=tt, registry=treg, device="cpu")
    import jax.numpy as jnp
    jeng = JEngine({k: {n: jnp.asarray(t.numpy()) for n, t in v.items()}
                    for k, v in params.items()}, j_vgg.to_graph(), img=IMG,
                   policy="reference", buckets=(1, 2, 4), tracer=jt,
                   registry=jreg)
    treqs, jreqs = _stream(teng, sizes, 2), _stream(jeng, sizes, 2)
    assert all(r.done for r in treqs + jreqs)
    trace = tt.to_json()
    assert t_trace.validate_trace(trace) == []
    assert t_report.check_trace_outcomes(trace, len(sizes)) == [] == \
        j_check(jt.to_json(), len(sizes))
    assert _shape(trace) == _shape(jt.to_json())
    compile_spans = [e["name"] for e in trace["traceEvents"]
                     if e["cat"] == "compile"]
    built = len(teng.compiler.buckets)
    assert compile_spans.count("compile_network") == built == 2
    assert sum(n.startswith("plan:") for n in compile_spans) == built * 13
    layer = [e for e in trace["traceEvents"] if e["cat"] == "layer"]
    assert layer and all(e["args"]["apportioned"] for e in layer)
    tsnap = teng.snapshot_registry(treg).snapshot()
    jsnap = jeng.snapshot_registry(jreg).snapshot()
    for sec in ("counters", "gauges", "histograms"):
        assert set(tsnap[sec]) == set(jsnap[sec]), sec
    assert t_metrics.validate_metrics_snapshot(tsnap) == []
    assert tsnap["counters"]['serve_requests_total{outcome="ok"}'] == 5
    assert tsnap["counters"]["serve_deadline_hits_total"] == 2
    labeled = teng.snapshot_registry(t_metrics.MetricsRegistry(),
                                     labels={"worker": "w0"}).snapshot()
    assert 'serve_images_total{worker="w0"}' in labeled["counters"]
    path = tmp_path / "trace.json"
    tt.save(str(path))
    assert t_report.main(["--validate-trace", str(path),
                          "--expect-requests", str(len(sizes))]) == 0
    assert t_report.main(["--validate-trace", str(path),
                          "--expect-requests", "6"]) == 1
    mpath = tmp_path / "metrics.json"
    mpath.write_text(json.dumps(tsnap))
    assert t_report.main(["--validate-metrics", str(mpath)]) == 0
    mpath.write_text(json.dumps({"counters": {"x": -1}}))
    assert t_report.main(["--validate-metrics", str(mpath)]) == 1


def test_report_model_table_on_the_cpu(capsys):
    assert t_report.main(["--model", "resnet18", "--device", "cpu",
                          "--json"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert got["conv_layers"] == 20 and got["distinct_schedules"] == 11
    assert got["pe_array"] == "16x16"
    assert t_report.main(["--model", "vgg16", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "mean model utilization" in out and "fold reuse" in out
    with pytest.raises(SystemExit):
        t_report.main([])


def test_launcher_writes_valid_trace_and_metrics(tmp_path, capsys):
    from repro_torch.launch.serve import main
    trace, metrics = tmp_path / "t.json", tmp_path / "m.json"
    tuning = tmp_path / "tune.json"
    d = main(["--vision", "--model", "vgg16", "--device", "cpu",
              "--requests", "6", "--trace", str(trace), "--metrics-json",
              str(metrics), "--deadline-s", "60", "--deadline-every", "2",
              "--autotune", "--tuning-path", str(tuning)])
    out = json.loads(capsys.readouterr().out)
    assert out["robustness"] == d["robustness"]
    assert d["robustness"]["deadline_total"] == 3
    assert d["workload"]["autotune"] and tuning.exists()
    assert t_report.main(["--validate-trace", str(trace),
                          "--expect-requests", "6",
                          "--validate-metrics", str(metrics)]) == 0
    snap = json.loads(metrics.read_text())
    assert snap["gauges"]["foldlint_ok"] == 1.0
    assert 'foldlint_findings_total{severity="error"}' in snap["counters"]


def test_launcher_chaos_smoke(capsys):
    from repro_torch.launch.serve import main
    d = main(["--vision", "--device", "cpu", "--chaos", "7",
              "--chaos-profile", "nan", "--requests", "8",
              "--deadline-every", "3"])
    out = json.loads(capsys.readouterr().out)
    assert out["chaos"]["robustness"] == d["robustness"]
    assert d["robustness"]["nonfinite_batches"] > 0
    assert d["robustness"]["lost_requests"] == 0
