"""A run end to end on the CPU at small widths: the result line, the
checks printed last, the files a later change adds being found by name,
the refusals without a card and without the port, and the import check."""
import json
import os
import pathlib
import subprocess
import sys

import pytest

from portbench.lib.guard import forbidden_modules
from portbench.tests.conftest import (LIMITS, ROOT, add_cell, copy_bench,
                                      run_main, small_vgg)

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.mark.parametrize("cell", ["vgg-small.saturated",
                                  "mbv2-small.saturated",
                                  "vgg-small.poisson"])
def test_last_line_keys_and_checks(small_root, capsys, cell):
    rc, res, err = run_main(small_root, ["--workload", cell, "--seed",
                                         "3000000019", "--seconds", "1.5",
                                         "--trace", "0"], capsys)
    assert rc == 0
    assert list(res) == KEYS            # checks last; no breakdown untraced
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] > 0
    spec = json.loads((small_root / "BENCHMARK.json").read_text())
    want = {m["name"] for m in spec["end_to_end"]
            if "workloads" not in m or cell in m["workloads"]}
    assert set(res["metrics"]) == want
    for name, m in res["metrics"].items():
        assert m["value"] > 0, name
    assert res["device"]["count"] == 1
    assert set(res["checks"]) == {"logit_rel_gap", "requests_not_served"}
    # the last lines of standard error: each number beside its limit
    tail = err[-len(res["checks"]):]
    assert all(ln.startswith("[check] ") and " limit " in ln for ln in tail)


@pytest.mark.parametrize("cell", ["mbv2-small.saturated",
                                  "vgg-small.poisson"])
def test_traced_run_checks_its_segment_too(small_root, capsys, cell):
    """``--trace 1``: the window, then a segment of the same traffic (the
    profiler's, on a card); the segment's requests are checked too, and
    the per-layer metrics with nothing to read here (no trace, no peak of
    the CPU) are left out."""
    argv = ["--workload", cell, "--seed", "2147483659", "--seconds", "1"]
    rc, plain, _ = run_main(small_root, argv + ["--trace", "0"], capsys)
    rc_t, res, err = run_main(small_root, argv + ["--trace", "1"], capsys)
    assert rc == rc_t == 0 and res["correct"] is True and res["failed"] == 0
    assert res["attempted"] > plain["attempted"]
    spec = json.loads((small_root / "BENCHMARK.json").read_text())
    want = {m["name"] for m in spec["per_layer"] if cell in m["workloads"]}
    counters = {"host_us_per_batch.saturated", "host_us_per_batch.poisson",
                "batch_images_mean.poisson"}
    assert set(res["metrics"]) == want & counters, res["metrics"]
    assert "busy_s" not in res["device"]        # no trace on the CPU


ONE_IN_FLIGHT = """
import time

from portbench.lib.drive import FormHook, Served, Window, take


def drive(system, stream, pool, seconds, p, profiler=None):
    worker = system.worker()
    worker.start(warmup=False)
    served = []
    t0 = time.monotonic()
    try:
        with FormHook(system, t0 + seconds, None, profiler) as hook:
            while time.monotonic() < t0 + seconds:
                idx = stream.request(len(served))
                s = Served(idx=idx, due=time.monotonic())
                s.req = worker.submit(take(pool, idx)).result(timeout=60)
                served.append(s)
    finally:
        worker.stop(drain=False, timeout=60)
    return Window(t0=t0, t_end=t0 + seconds, served=served,
                  counters=hook.at_close or system.counters(),
                  profiled=hook.profiled, drained_at=time.monotonic())
"""

STEADY = """
import numpy as np

from portbench.lib.traffic import Stream, request_sizes


def make(p, rng, *, widest, seconds):
    count = max(1, round(p["rate_rps"] * seconds))
    due = np.arange(count) / p["rate_rps"]
    return Stream.of(request_sizes(p, rng, count, widest), p, due)
"""

# a mix of a new way of offering load (one request in flight, a loop of
# its own) and one of a new arrival shape (evenly spaced, for the open
# loop), each with the code it needs as new files
NEW_MIXES = {
    "single": ({"loop": "one_in_flight", "arrivals": "backlog",
                "images_min": 1, "images_max": 1, "block_requests": 16,
                "pool_images": 12}, "loops/one_in_flight.py", ONE_IN_FLIGHT),
    "steady": ({"loop": "open", "arrivals": "steady", "rate_rps": 30,
                "images_min": 1, "images_max": 2, "pool_images": 12},
               "arrivals/steady.py", STEADY),
}


@pytest.mark.parametrize("mix", sorted(NEW_MIXES))
def test_files_added_are_found_by_name(small_root, capsys, mix):
    """A configuration, a mix with the traffic code it names, a cell and a
    metric added as files, with entries in BENCHMARK.json, run without an
    edit to any file."""
    bench_dir = small_root / "portbench"
    params, code_path, code = NEW_MIXES[mix]
    (bench_dir / "mixes" / f"{mix}.json").write_text(json.dumps(params))
    (bench_dir / code_path).write_text(code)
    (bench_dir / "metrics" / "requests_per_s.py").write_text(
        "def read(art):\n"
        "    return art.counters['batches'] and art.images_in_window"
        " / art.seconds / 1.5\n")
    cfg = small_vgg(json.loads(
        (bench_dir / "configs" / "vgg16-224.json").read_text()))
    cfg["name"] = "vgg-narrow"
    cell = add_cell(small_root, cfg, mix, {"limits": LIMITS})
    spec = json.loads((small_root / "BENCHMARK.json").read_text())
    spec["end_to_end"].append({
        "name": "requests_per_s", "unit": "requests/s", "better": "higher",
        "bound": 0.05, "source": "host_clock", "workloads": [cell]})
    (small_root / "BENCHMARK.json").write_text(json.dumps(spec))
    rc, res, _ = run_main(small_root, ["--workload", cell, "--seed", "5",
                                       "--seconds", "1", "--trace", "0"],
                          capsys)
    assert rc == 0 and res["correct"] is True, res
    assert res["attempted"] > 2 and res["failed"] == 0
    assert res["metrics"]["requests_per_s"]["value"] > 0
    assert set(res["metrics"]) == {"requests_per_s", "setup_s"}
    # every file the benchmark had is there, byte for byte
    for path in (ROOT / "portbench").rglob("*"):
        if path.is_file() and not {"tests", "__pycache__"} & set(
                path.parts):
            copy = bench_dir / path.relative_to(ROOT / "portbench")
            assert copy.read_bytes() == path.read_bytes(), path


def test_no_card_no_result(capsys):
    """Without a CUDA device the run exits 3 and prints no result."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from portbench import run
    rc = run.main(["--workload", "vgg16-224.saturated", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    out, err = capsys.readouterr()
    assert rc == 3 and out == "" and "CUDA" in err


def test_bare_directory_fails(tmp_path):
    """In a directory holding only BENCHMARK.json and portbench/ the run
    exits non-zero with no result (no card, or no port to import)."""
    copy_bench(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "vgg16-224.saturated", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, env=env, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout == ""


def test_forbidden_modules_by_whole_top_level_name():
    names = ["repro_torch", "repro_torch.serve.vision", "reprox", "jax_like",
             "numpy", "repro", "repro.core.engine", "jax.numpy", "jaxlib",
             "flax.linen"]
    assert forbidden_modules(names) == sorted(
        ["repro", "repro.core.engine", "jax.numpy", "jaxlib", "flax.linen"])


def test_run_loads_no_jax(small_root, capsys):
    rc, res, _ = run_main(small_root, ["--workload", "mbv2-small.poisson",
                                       "--seed", "9", "--seconds", "1",
                                       "--trace", "0"], capsys)
    assert rc == 0 and res is not None
    assert forbidden_modules() == []


def test_reference_loads_nothing_of_the_port_or_jax():
    code = ("import sys; sys.path.insert(0, %r); "
            "import portbench.reference.vgg, portbench.reference.mobilenetv2;"
            " import portbench.lib.check; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))"
            % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    top = set(eval(out))
    assert not top & {"repro_torch", "repro", "jax", "jaxlib", "flax"}


def test_benchmark_reads_nothing_of_the_jax_benchmarks():
    """``benchmarks/`` (the JAX package's) is neither imported nor read."""
    for path in pathlib.Path(ROOT, "portbench").rglob("*.py"):
        if "tests" in path.parts:
            continue
        text = path.read_text()
        assert "benchmarks" not in text and "baseline.json" not in text, \
            path
