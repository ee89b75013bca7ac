"""The port's examples run end to end on the CPU at their smallest sizes
(``--device cpu``: the fold kernels' plain versions), each in its own
process, as a user runs them."""
import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _run(script, *args, env=None):
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / script), "--device", "cpu",
         *args], capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
             **(env or {})})
    assert out.returncode == 0, out.stderr
    return out.stdout


def test_quickstart():
    out = _run("torch_quickstart.py")
    errs = [float(line.rsplit(" ", 1)[1]) for line in out.splitlines()
            if "max |err|" in line]
    assert len(errs) == 2 and max(errs) < 1e-4, out
    assert "MappingPlan[ws-conv[" in out


@pytest.mark.parametrize("impl", ["fold_auto", "im2col"])
def test_vgg16_pipeline(impl):
    out = _run("torch_vgg16_pipeline.py", "--width", "0.0625", "--img",
               "32", "--batch", "1", "--impl", impl)
    assert "8 schedules for 13 conv layers (5 fold-reuse hits)" in out, out
    diff = [line for line in out.splitlines()
            if line.startswith("max |engine - per-layer|")]
    assert float(diff[0].rsplit(" ", 1)[1]) < 1e-3, out


@pytest.mark.parametrize("arch,extra", [("qwen3-4b", ()),
                                        ("gemma3-12b", ("--window-cache",)),
                                        ("zamba2-1.2b", ()),
                                        ("rwkv6-1.6b", ()),
                                        ("seamless-m4t-medium", ())])
def test_serve_lm(arch, extra):
    out = _run("torch_serve_lm.py", "--arch", arch, "--requests", "3",
               "--batch", "2", "--prompt-len", "4", "--new-tokens", "4",
               *extra)
    assert "served 3 requests / 12 tokens" in out, out


def test_elastic_restart():
    """The JAX demo's four phases: its dead-rank line, its plan line (as
    the JAX demo prints ``repro``'s plan) and its ``OK`` line, word for
    word, and the loss falling from phase 1's first step to phase 4's
    last."""
    from repro.ft.fault_tolerance import solve_elastic_mesh
    # one thread: its 60 small steps run 6x the CPU time on eight
    out = _run("torch_elastic_restart.py", env={"OMP_NUM_THREADS": "1"})
    lines = out.splitlines()
    plan = solve_elastic_mesh(available_devices=508, model_parallel=16,
                              global_batch=256)
    want = (f"elastic plan: mesh {plan.mesh_shape} ({plan.devices_used} of "
            f"508 devices, {plan.dropped_devices} idle), "
            f"per-device batch {plan.per_device_batch} x accum "
            f"{plan.grad_accum}")
    assert "heartbeat monitor: dead ranks = [217]" in lines, out
    assert want in lines, out
    assert lines[-1] == "OK: survived the failure with exact data-cursor " \
        "resume", out
    loss = [ln for ln in lines if ln.startswith("loss ")]
    assert len(loss) == 1 and loss[0].endswith(
        " across failure + re-mesh + restart"), out
    first, last = (float(x) for x in loss[0].split()[1:4:2])
    assert last < first, out
    steps = [int(ln.split(":")[0].split()[1]) for ln in lines
             if ln.startswith("step ")]
    assert steps == [1, 10, 20, 30, 31, 40, 50, 60], out
