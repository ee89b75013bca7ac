"""How ``correct`` is decided, shown to fail: a run with the timed path
broken underneath reads ``correct`` false for each fault a serving cell
can have, and the control (the reference in TF32, the precision below the
configurations' fp32) lands above each cell's limit at the cell's own
widths.  The chip's readings are in ``calibrate.py``; these run where a
test run can hold them."""
import json

import numpy as np
import pytest
import torch

from portbench.lib import check, weights
from portbench.lib.bench import Bench
from portbench.tests.conftest import ROOT, run_main

BENCH = Bench(ROOT)


def _stale(orig):
    """The state left unchanged: each call returns the previous call's
    output of the same network (the first call computes)."""
    last = {}

    def call(self, params, x):
        out = orig(self, params, x)
        prev = last.get(id(self))
        last[id(self)] = out
        return out if prev is None else prev
    return call


def _half_batch(orig):
    """Half of the batch left out: the rows after the first half get the
    mean of the first half's logits."""
    def call(self, params, x):
        out = orig(self, params, x).clone()
        keep = (len(out) + 1) // 2
        out[keep:] = out[:keep].mean(dim=0)
        return out
    return call


def _altered(orig):
    """An answer altered where it is produced: one logit of each batch
    moved by 1e-3 of its row's largest."""
    def call(self, params, x):
        out = orig(self, params, x).clone()
        out[0, 0] += 1e-3 * out[0].abs().max()
        return out
    return call


@pytest.mark.parametrize("cell", ["vgg-small.saturated",
                                  "vgg-small.poisson"])
@pytest.mark.parametrize("fault", [None, _stale, _half_batch, _altered])
def test_a_broken_timed_path_reads_incorrect(small_root, capsys,
                                             monkeypatch, cell, fault):
    from repro_torch.core.engine import CompiledNetwork
    if fault is not None:
        monkeypatch.setattr(CompiledNetwork, "__call__",
                            fault(CompiledNetwork.__call__))
    rc, res, _ = run_main(small_root, ["--workload", cell, "--seed", "77",
                                       "--seconds", "1", "--trace", "0"],
                          capsys)
    assert rc == 0
    assert res["correct"] is (fault is None), res["checks"]


@pytest.mark.parametrize("cell,images", [("vgg16-224.saturated", 2),
                                         ("mobilenetv2-cifar.saturated", 8),
                                         ("vgg16-224.poisson", 2)])
def test_control_fails_each_cell_at_its_own_widths(cell, images):
    """The reference with every operand rounded to TF32 against the fp32
    reference, on a few images of the cell's own configuration."""
    c = BENCH.cell(cell)
    cfg = BENCH.config(c.config)
    ref = BENCH.reference(cfg["family"])
    cpu = torch.device("cpu")
    pool = weights.make_images(images, cfg["img"], 5, cpu)
    want = check.reference_table(ref, cfg, pool, 6, cpu)
    got = check.reference_table(ref, cfg, pool, 6, cpu, round_tf32=True)
    limit = c.params["limits"]["logit_rel_gap"]
    assert check.rel_gap(got, want) > 3 * limit
    assert check.rel_gap(want, want) == 0.0


@pytest.mark.cuda
def test_control_on_the_card(cuda_device):
    """The same, with cuDNN and cuBLAS on their own TF32 paths."""
    for cell, images in (("vgg16-224.saturated", 8),
                         ("mobilenetv2-cifar.saturated", 64)):
        c = BENCH.cell(cell)
        cfg = BENCH.config(c.config)
        ref = BENCH.reference(cfg["family"])
        pool = weights.make_images(images, cfg["img"], 5, cuda_device)
        want = check.reference_table(ref, cfg, pool, 6, cuda_device)
        got = check.reference_table(ref, cfg, pool, 6, cuda_device,
                                    tf32_paths=True)
        assert check.rel_gap(got, want) > 3 * c.params["limits"][
            "logit_rel_gap"], cell


def test_missing_and_non_finite_answers_fail():
    want = torch.ones(3, 4)
    assert check.rel_gap(want[:2], want) > 1e300
    bad = want.clone()
    bad[1, 2] = float("nan")
    assert check.rel_gap(bad, want) > 1e300
    ok, checks = check.verdict({"logit_rel_gap": 0.0,
                                "requests_not_served": 1.0},
                               {"logit_rel_gap": 1e-5,
                                "requests_not_served": 0})
    assert not ok and json.dumps(checks)
    assert np.isfinite(checks["logit_rel_gap"]["limit"])
