"""The harness's parts on the CPU: the generator and the weights from the
seed, the operation and byte counts against hand counts, the references
against the port's own reference path, the trace reduction and the
readers."""
import json
import math
import types

import numpy as np
import pytest
import torch

from portbench.lib import cost, traffic, weights
from portbench.lib.bench import Bench
from portbench.lib.profile import reduce
from portbench.tests.conftest import ROOT, small_mobilenet, small_vgg

BENCH = Bench(ROOT)
VGG = BENCH.config("vgg16-224")
MBV2 = BENCH.config("mobilenetv2-cifar")


def _stream(p, seed, **kw):
    return traffic.make(BENCH.arrivals(p["arrivals"]), p, seed, **kw)


def test_streams_repeat_from_the_seed_and_hold_the_same_work():
    p = traffic.params(BENCH.mix("poisson"), {"rate_rps": 90})
    a = _stream(p, 2 ** 31 + 7, widest=4, seconds=20)
    b = _stream(p, 2 ** 31 + 7, widest=4, seconds=20)
    c = _stream(p, 12345, widest=4, seconds=20)
    assert np.array_equal(a.sizes, b.sizes) and np.array_equal(a.due_s,
                                                                b.due_s)
    assert not np.array_equal(a.sizes, c.sizes)
    # another seed: the same sizes and gaps, in another order
    assert sorted(a.sizes) == sorted(c.sizes)
    assert len(a) == 1800 and np.bincount(a.sizes)[1:].tolist() == [450] * 4
    assert 0 <= a.due_s.min() and a.due_s.max() < 20
    s = _stream(traffic.params(BENCH.mix("saturated"), {}), 3, widest=8,
                seconds=20)
    assert s.due_s is None
    assert s.sizes.min() == 1 and s.sizes.max() == 8
    # a closed loop cycles through its block, one run of the pool each
    idx = [s.request(k) for k in range(3 * len(s))]
    assert all(len(i) == s.sizes[k % len(s)] for k, i in enumerate(idx))
    flat = np.concatenate(idx)
    assert np.array_equal(flat, np.arange(len(flat)) % s.pool)


def test_gaps_are_the_same_set_for_every_seed():
    p = traffic.params(BENCH.mix("poisson"), {"rate_rps": 50})
    u = (np.arange(500) + 0.5) / 500
    every = np.round(-np.log1p(-u) / 50, 12)
    for seed in (1, 2, 2 ** 31 + 3):
        gaps = np.round(np.diff(_stream(p, seed, widest=4,
                                        seconds=10).due_s), 12)
        # the first 499 of the 500 gaps of the one set, in the seed's order
        assert len(gaps) == 499 and np.isin(gaps, every).all()


def test_weights_and_images_repeat_from_the_seed():
    specs = BENCH.reference("mobilenetv2").param_specs(small_mobilenet(MBV2))
    cpu = torch.device("cpu")
    a = weights.make_params(specs, 99, cpu)
    b = weights.make_params(specs, 99, cpu)
    c = weights.make_params(specs, 100, cpu)
    for name, leaf in a.items():
        for key, t in leaf.items():
            assert torch.equal(t, b[name][key])
            assert t.storage_offset() % weights.ALIGN == 0
    assert not torch.equal(a["stem"]["w"], c["stem"]["w"])
    var = a["b0_dw_bn"]["var"]
    assert float(var.min()) >= 0.5 and float(var.max()) <= 1.5
    assert np.array_equal(weights.make_images(3, 8, 5, cpu),
                          weights.make_images(3, 8, 5, cpu))
    assert len(set(weights.sub_seeds(2 ** 33 + 1, 3))) == 3


def test_flops_against_hand_counts():
    vgg = cost.flops_per_image(BENCH.reference("vgg").layers(VGG, 1))
    mb = cost.flops_per_image(BENCH.reference("mobilenetv2").layers(MBV2, 1))
    assert vgg == 30_940_528_640 == VGG["flops_per_image"]     # 30.94 GFLOP
    assert mb == 175_952_896 == MBV2["flops_per_image"]        # 0.176 GFLOP
    convs = [g for g in BENCH.reference("mobilenetv2").layers(MBV2, 1)
             if g["kind"] == "conv"]
    assert len(convs) == 52 and sum(g["groups"] > 1 for g in convs) == 17
    params = sum(math.prod(s[2]) for s in
                 BENCH.reference("vgg").param_specs(VGG))
    assert params == VGG["parameters"] == 138_357_544


def test_bytes_and_bound_by_hand():
    conv = {"kind": "conv", "n": 4, "c": 64, "nf": 64, "r": 3, "s": 3,
            "h": 224, "w": 224, "stride": 1, "pad": 1, "groups": 1,
            "pool": True, "residual": False, "vectors": 1}
    x, w, y = 4 * 64 * 224 * 224, 64 * 64 * 9, 4 * 64 * 112 * 112
    assert cost.layer_bytes(conv, "fp32") == 4 * (x + w + y) + 4 * 64
    flops = 2 * 4 * 64 * 64 * 9 * 224 * 224
    assert cost.layer_flops(conv) == flops
    kind = "NVIDIA H100 80GB HBM3"
    assert cost.bound_s(conv, "fp32", kind) == flops / 67e12
    dw = {**conv, "c": 960, "nf": 960, "groups": 960, "h": 4, "w": 4,
          "pool": False, "vectors": 2}
    assert cost.bound_s(dw, "fp32", kind) == \
        cost.layer_bytes(dw, "fp32") / 3.35e12
    assert cost.bound_s(conv, "fp32", "a card not in the table") is None


def _port_params(params):
    return {k: dict(v) for k, v in params.items()}


def test_vgg_reference_matches_the_ports_reference_path():
    from repro_torch.models import vgg as port_vgg
    cfg = small_vgg(VGG)
    ref = BENCH.reference("vgg")
    params = weights.make_params(ref.param_specs(cfg), 4, torch.device("cpu"))
    x = torch.from_numpy(weights.make_images(3, 32, 8, torch.device("cpu")))
    want = port_vgg.forward(_port_params(params), x, impl="direct")
    got = ref.forward(params, x, cfg)
    assert torch.allclose(got, want, rtol=0, atol=1e-5 * float(
        want.abs().max()))


def test_mobilenet_reference_matches_the_ports_reference_path():
    from repro_torch.models import mobilenet as port_mb
    cfg = small_mobilenet(MBV2)
    ref = BENCH.reference("mobilenetv2")
    params = weights.make_params(ref.param_specs(cfg), 4, torch.device("cpu"))
    x = torch.from_numpy(weights.make_images(3, 32, 8, torch.device("cpu")))
    want = port_mb.forward(_port_params(params), x, impl="direct")
    got = ref.forward(params, x, cfg)
    assert torch.allclose(got, want, rtol=0, atol=1e-5 * float(
        want.abs().max()))


def test_round_tf32_keeps_ten_mantissa_bits():
    from portbench.reference.common import round_tf32
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -1.0 - 2 ** -11,
                      1.0 + 2 ** -10, 3.0], dtype=torch.float32)
    got = round_tf32(x)
    # ties to even: 1 + 2^-11 -> 1, 1 + 3*2^-11 -> 1 + 2^-9
    assert got.tolist() == [1.0, 1.0 + 2 ** -9, -1.0, 1.0 + 2 ** -10, 3.0]


def _trace_file(tmp_path):
    ev = []

    def x(cat, name, ts, dur, tid=1):
        ev.append({"ph": "X", "cat": cat, "name": name, "ts": ts,
                   "dur": dur, "pid": 0, "tid": tid})
    # host: the form span, a copy, a sync
    x("user_annotation", "portbench.form", 0, 50, tid=7)
    x("cpu_op", "aten::copy_", 60, 40, tid=7)
    x("cuda_runtime", "cudaMemcpyAsync", 70, 20, tid=7)
    x("cpu_op", "other thread", 0, 1000, tid=8)
    # device: a copy, two WS kernels 2 us apart, a gap of 100 us
    x("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 10, 10)
    x("kernel", "void (anonymous namespace)::ws_kernel<T, float>(...)",
      20, 30)
    x("kernel", "void (anonymous namespace)::ws_kernel<T, float>(...)",
      52, 8)
    x("kernel", "void (anonymous namespace)::dense_kernel<4>(...)", 160, 40)
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return path


def test_trace_reduction(tmp_path):
    tr = reduce(str(_trace_file(tmp_path)))
    assert tr.span_s == pytest.approx(190e-6)
    assert tr.busy_s == pytest.approx(40e-6 + 8e-6 + 40e-6)
    assert tr.kernel_seconds(r"(?<![A-Za-z0-9_])ws_kernel<") == \
        pytest.approx((38e-6, 2))
    gaps = dict(tr.idle_gaps)
    # the 2 us gap is the device's own; the 100 us one (60 to 160) is
    # split over what the engine's thread did meanwhile: aten::copy_ alone
    # (60-70, 90-100), inside it cudaMemcpyAsync (70-90), then no op; the
    # other thread's op is not the engine's
    assert gaps["aten::copy_"] == pytest.approx(20e-6)
    assert gaps["cudaMemcpyAsync"] == pytest.approx(20e-6)
    assert gaps["host: Python outside any recorded op"] == \
        pytest.approx(60e-6)
    assert gaps["device: gaps under 10 us between queued work"] == \
        pytest.approx(2e-6)
    assert len(gaps) == 4
    assert tr.device_ops[0][0].startswith("void (anonymous namespace)::de")


def test_readers(tmp_path):
    tr = reduce(str(_trace_file(tmp_path)))
    layer = {"kind": "conv", "n": 2, "c": 8, "nf": 8, "r": 3, "s": 3,
             "h": 8, "w": 8, "stride": 1, "pad": 1, "groups": 1,
             "pool": False, "residual": False, "vectors": 1}
    kind = "NVIDIA H100 80GB HBM3"
    art = types.SimpleNamespace(
        trace=tr, profiled=[(2, 2), (2, 1)], precision="fp32",
        device_kind=kind,
        dataflows={2: [("a", "weight_stationary"), ("b", "depthwise")]},
        layers=lambda b: {"a": {**layer, "n": b}, "b": layer},
        counters={"batches": 4, "images": 10, "host_s": 0.002},
        images_in_window=100, seconds=2.0, flops_per_image=1e9,
        peak_flops=67e12, latencies_ms=np.arange(1.0, 101.0), setup_s=3.0)
    want = 100 * 2 * cost.bound_s(layer, "fp32", kind) / 38e-6
    assert BENCH.reader("ws_roofline").read(art) == pytest.approx(want)
    assert BENCH.reader("dw_roofline").read(art) is None   # no dw kernel
    assert BENCH.reader("device_idle_share.saturated").read(art) == \
        pytest.approx(100 * (1 - 88 / 190))
    assert BENCH.reader("host_us_per_batch.poisson").read(art) == 500.0
    assert BENCH.reader("batch_images_mean.poisson").read(art) == 2.5
    # on the host clock: the window's 100 images in 2 s, not the trace's
    assert BENCH.reader("mfu").read(art) == pytest.approx(
        100 * 50 * 1e9 / 67e12)
    assert BENCH.reader("images_per_s").read(art) == 50.0
    assert BENCH.reader("latency_p95_ms").read(art) == pytest.approx(95.05)
    art.trace = None
    assert BENCH.reader("ws_roofline").read(art) is None
    assert BENCH.reader("device_idle_share.poisson").read(art) is None
    # one reader serves every name that shares its part before the dot
    assert BENCH.reader("host_us_per_batch.saturated") is \
        BENCH.reader("host_us_per_batch.poisson")


def test_profiler_stops_at_its_time_or_its_batch_cap(monkeypatch):
    from portbench.lib import profile
    calls = []

    class Session:
        def start(self):
            calls.append("start")

        def stop(self):
            calls.append("stop")
    monkeypatch.setattr(profile.Profiler, "_profile",
                        staticmethod(lambda: Session()))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    prof = profile.Profiler(1.0, 3.0, 5)
    prof.anchor(100.0)
    prof.tick(100.5, 0)
    assert not prof.active and calls == []
    prof.tick(101.0, 0)
    prof.tick(101.5, 4)
    assert prof.active and calls == ["start"]
    prof.tick(101.6, 5)             # the cap, well before the stop time
    assert prof.done and not prof.active and calls == ["start", "stop"]
    prof = profile.Profiler(1.0, 3.0, 500)
    prof.anchor(0.0)
    prof.tick(1.0, 0)
    prof.tick(3.0, 10)              # the stop time, under the cap
    assert prof.done and calls == ["start", "stop", "start", "stop"]
