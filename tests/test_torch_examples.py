"""The port's examples run end to end on the CPU at their smallest sizes
(``--device cpu``: the fold kernels' plain versions), each in its own
process, as a user runs them."""
import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _run(script, *args):
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / script), "--device", "cpu",
         *args], capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
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
