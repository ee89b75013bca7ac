"""Fixtures of the benchmark's own tests: a copy of the benchmark with
small configurations beside the real ones, runnable on the CPU.

Run from the root of the checkout: ``python -m pytest portbench/tests``.
Tests that need the card carry the ``cuda`` marker and skip without one.
"""
import json
import pathlib
import shutil
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

LIMITS = {"logit_rel_gap": 1e-4, "requests_not_served": 0}


def small_vgg(cfg: dict) -> dict:
    """VGG-16 at 1/16 of its widths, 32 px, 10 classes."""
    return {**cfg, "name": "vgg-small", "img": 32, "classes": 10,
            "fc": [64, 64],
            "layers": [e if e == "M" else
                       [e[0], e[1] if e[1] == 3 else e[1] // 16, e[2] // 16]
                       for e in cfg["layers"]]}


def small_mobilenet(cfg: dict) -> dict:
    """MobileNetV2-CIFAR at 1/8 of its widths."""
    return {**cfg, "name": "mbv2-small", "stem": 4, "head": 16,
            "blocks": [[t, max(c // 8, 1), n, s]
                       for t, c, n, s in cfg["blocks"]]}


def copy_bench(dest: pathlib.Path) -> pathlib.Path:
    """The benchmark's files (without its tests) under ``dest``."""
    shutil.copytree(ROOT / "portbench", dest / "portbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    return dest


def add_cell(root: pathlib.Path, cfg: dict, traffic: str,
             cell_params: dict) -> str:
    """Adds a configuration file and a cell over it, as a later change
    would: new files and new entries, no file edited but the list."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    name = cfg["name"]
    path = f"portbench/configs/{name}.json"
    (root / path).write_text(json.dumps(cfg))
    if name not in [c["name"] for c in spec["configs"]]:
        spec["configs"].append({"name": name, "source": cfg["source"],
                                "file": path, "reduced": [],
                                "why": "a small copy for the CPU tests"})
    cell = f"{name}.{traffic}"
    spec["workloads"].append({"name": cell, "config": name,
                              "traffic": traffic, "chips": 1,
                              "why": "a small copy for the CPU tests"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m and any(
                w.endswith("." + traffic) for w in m["workloads"]):
            m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    (root / "portbench" / "cells" / f"{cell}.json").write_text(
        json.dumps(cell_params))
    return cell


@pytest.fixture
def small_root(tmp_path):
    """A copy of the benchmark with the small VGG-16 and MobileNetV2
    configurations in cells of both mixes."""
    root = copy_bench(tmp_path)
    configs = root / "portbench" / "configs"
    vgg = small_vgg(json.loads((configs / "vgg16-224.json").read_text()))
    mb = small_mobilenet(json.loads(
        (configs / "mobilenetv2-cifar.json").read_text()))
    for cfg in (vgg, mb):
        for traffic in ("saturated", "poisson"):
            add_cell(root, cfg, traffic, {"pool_images": 24, "rate_rps": 40,
                                          "limits": LIMITS})
    return root


def run_main(root, argv, capsys):
    """``run.main`` on the CPU: (exit code, result line or None, stderr
    lines)."""
    from portbench import run
    rc = run.main(argv, root=root, device="cpu")
    out, err = capsys.readouterr()
    lines = [ln for ln in out.splitlines() if ln.strip()]
    return rc, (json.loads(lines[-1]) if lines else None), err.splitlines()


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)
