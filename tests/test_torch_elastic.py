"""The port's elastic restart against the JAX package's, on the CPU.

* ``HeartbeatMonitor``, ``StragglerDetector`` and ``solve_elastic_mesh``
  (``ft/fault_tolerance.py``) against ``repro``'s on seeded schedules and
  a grid of plans: every probe and every field equal, the heartbeat's
  timeout edge (a rank silent exactly ``timeout_s`` is alive) included,
  and the 512-rank schedule of ``examples/elastic_restart.py``.
* ``examples/torch_elastic_restart.py``'s phases: its control plane and
  plan are the JAX demo's; its phase 1 writes a checkpoint (fp32, from
  the JAX package's fp32 weights at step 0) that the JAX ``Trainer`` and
  the port's ``restart_trainer`` both restore, each splitting its steps
  into the plan's two microbatches: their losses within 1e-5·|loss| and
  their parameters within 2·lr (``tests/test_torch_mesh_lm.py``'s
  contract for the port's steps against the JAX package's)."""
import dataclasses
import pathlib
import shutil
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from jax import tree_util as jtu  # noqa: E402

from repro.ckpt import checkpoint as j_ckpt  # noqa: E402
from repro.configs import registry as j_registry  # noqa: E402
from repro.data.pipeline import DataConfig as JData  # noqa: E402
from repro.ft import fault_tolerance as j_ft  # noqa: E402
from repro.models import api as j_api  # noqa: E402
from repro.models.common import DTypePolicy as JPolicy  # noqa: E402
from repro.optim import adamw as j_adamw  # noqa: E402
from repro.train import trainer as j_trainer  # noqa: E402
from repro_torch.ckpt import checkpoint as t_ckpt  # noqa: E402
from repro_torch.ft import fault_tolerance as t_ft  # noqa: E402
from repro_torch.tree import leaves_with_path  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "examples"))
import torch_elastic_restart as ex  # noqa: E402

REL = 1e-5              # the port's step against the JAX package's: loss


# -- HeartbeatMonitor ---------------------------------------------------------

class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _monitors(n, timeout_s):
    clock = _Clock()
    return (clock, t_ft.HeartbeatMonitor(n, timeout_s=timeout_s, clock=clock),
            j_ft.HeartbeatMonitor(n, timeout_s=timeout_s, clock=clock))


def _probe(mine, theirs):
    assert mine.dead_ranks() == theirs.dead_ranks()
    assert mine.healthy() == theirs.healthy()
    return mine.dead_ranks()


@pytest.mark.parametrize("seed,n_ranks", [(0, 3), (1, 5), (2, 17), (3, 64),
                                          (4, 512)])
def test_heartbeat_monitor_matches_the_jax_package(seed, n_ranks):
    """Seeded beats and whole-second clock advances (so a rank is often
    silent exactly ``timeout_s``: not dead, as the edge is strict),
    every probe's dead ranks and health equal."""
    rng = np.random.default_rng(seed)
    timeout = float(rng.integers(3, 8))
    clock, mine, theirs = _monitors(n_ranks, timeout)
    last = {r: 0.0 for r in range(n_ranks)}
    edge = dead_seen = 0
    for step in range(60):
        live = rng.random(n_ranks) < rng.uniform(0.2, 1.0)
        for r in np.nonzero(live)[0]:
            mine.beat(int(r), step)
            theirs.beat(int(r), step)
            last[int(r)] = clock.t
        clock.t += float(rng.integers(0, 4))
        dead = _probe(mine, theirs)
        edge += sum(clock.t - t == timeout for t in last.values())
        dead_seen += bool(dead)
        assert dead == [r for r, t in last.items() if clock.t - t > timeout]
    assert edge and dead_seen


def test_heartbeat_monitor_on_the_demos_schedule():
    """``examples/elastic_restart.py``'s 512 ranks, rank 217 silent after
    step 30: both monitors probed at every clock point, and the port's
    example phase declares the same rank dead."""
    clock, mine, theirs = _monitors(512, 60.0)
    assert _probe(mine, theirs) == []
    for m in (mine, theirs):
        for r in range(512):
            m.beat(r, step=30)
    clock.t = 90.0
    assert _probe(mine, theirs) == list(range(512))
    for m in (mine, theirs):
        for r in range(512):
            if r != 217:
                m.beat(r, step=31)
    assert _probe(mine, theirs) == [217]
    clock.t = 140.0
    assert _probe(mine, theirs) == [217]
    assert ex.phase_control_plane() == [217]


def test_control_plane_sized_to_two_ranks():
    """The example's phase 2 as the smoke drives it: two ranks' beats of
    a run first, then rank 1 silent, at a timeout of a few steps."""
    beats = [(1.5, 0, 1), (1.6, 1, 1), (3.0, 0, 2), (3.2, 1, 2)]
    assert ex.phase_control_plane(n_ranks=2, dead_rank=1, step=2,
                                  timeout_s=4.5, beats=beats) == [1]
    assert ex.phase_control_plane(n_ranks=3, dead_rank=0, step=5,
                                  timeout_s=1.0) == [0]


# -- StragglerDetector --------------------------------------------------------

@pytest.mark.parametrize("seed", range(6))
def test_straggler_detector_matches_the_jax_package(seed):
    rng = np.random.default_rng(100 + seed)
    n = int(rng.integers(2, 40))
    window = int(rng.integers(1, 12))
    threshold = float(rng.uniform(1.05, 2.0))
    mine = t_ft.StragglerDetector(n, window=window, threshold=threshold)
    theirs = j_ft.StragglerDetector(n, window=window, threshold=threshold)
    slow = set(rng.choice(n, size=max(1, n // 8), replace=False).tolist())
    flagged = 0
    assert mine.stragglers() == theirs.stragglers() == []
    for _ in range(40):
        for r in rng.choice(n, size=int(rng.integers(1, n + 1)),
                            replace=False):
            t = float(rng.uniform(0.9, 1.1)) * (2.5 if r in slow else 1.0)
            mine.record(int(r), t)
            theirs.record(int(r), t)
        got = mine.stragglers()
        assert got == theirs.stragglers()
        flagged += bool(got)
    assert flagged


# -- solve_elastic_mesh -------------------------------------------------------

def _plans(*args, **kw):
    try:
        mine = t_ft.solve_elastic_mesh(*args, **kw)
    except ValueError as e:
        with pytest.raises(ValueError, match="cannot keep"):
            j_ft.solve_elastic_mesh(*args, **kw)
        return str(e), None
    theirs = j_ft.solve_elastic_mesh(*args, **kw)
    assert mine.__dict__ == theirs.__dict__
    assert mine.devices_used == theirs.devices_used
    return mine, theirs


@pytest.mark.parametrize("model_parallel", [1, 2, 4, 16])
@pytest.mark.parametrize("max_per_device", [1, 2, 64])
def test_solve_elastic_mesh_matches_the_jax_package(model_parallel,
                                                   max_per_device):
    for available in (1, 2, 3, 7, 8, 16, 31, 63, 64, 255, 256, 508, 512):
        for batch in (1, 2, 4, 6, 30, 96, 97, 256, 1024):
            mine, _ = _plans(available, model_parallel, batch,
                             max_per_device_batch=max_per_device)
            if isinstance(mine, str):
                assert available < model_parallel
                continue
            assert (mine.mesh_shape[0] * mine.per_device_batch
                    * mine.grad_accum) == batch
            assert mine.per_device_batch <= max_per_device


def test_the_named_plans():
    """The JAX demo's plan, the survivor's plan on one card, and a plan
    whose per-device batch folds into accumulation."""
    demo, _ = _plans(508, 16, 256)
    assert ex.plan_line(ex.replan()) == ex.plan_line(demo)
    assert (demo.mesh_shape, demo.devices_used, demo.dropped_devices,
            demo.per_device_batch, demo.grad_accum) == ((16, 16), 256, 252,
                                                        16, 1)
    card, _ = _plans(1, 1, 4, max_per_device_batch=2)
    assert (card.mesh_shape, card.per_device_batch, card.grad_accum) == \
        ((1, 1), 2, 2)
    folded, _ = _plans(6, 2, 96, max_per_device_batch=8)
    assert (folded.mesh_shape, folded.per_device_batch,
            folded.grad_accum) == ((3, 2), 8, 4)
    with pytest.raises(ValueError, match="cannot keep model_parallel=4"):
        ex.replan(available=3, model_parallel=4, global_batch=8)


# -- phase 4: the port's checkpoint restored by both Trainers -----------------

PARITY_STEPS = 2        # phase 1 writes steps 1 and 2, phase 4 runs 3 and 4
PARITY_BATCH, PARITY_SEQ = 4, 16


def _t_by_key(tree):
    return {"__".join(map(str, path)): v.numpy()
            for path, v in leaves_with_path(tree)}


def _j_by_key(tree):
    return {"__".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path): np.asarray(v)
            for path, v in jtu.tree_flatten_with_path(tree)[0]}


def test_restart_matches_the_jax_trainer_with_the_plans_accumulation(
        tmp_path):
    cfg, data, opt = ex.setup()
    data = dataclasses.replace(data, seq_len=PARITY_SEQ,
                               global_batch=PARITY_BATCH)
    jcfg = j_registry.get_config(ex.ARCH, reduced=True)
    p0 = j_api.init_params(jcfg, jax.random.PRNGKey(0),
                           dtype_policy=JPolicy.fp32())
    phase1 = tmp_path / "phase1"
    j_ckpt.save_checkpoint(str(phase1), 0,
                           {"params": p0, "opt": j_adamw.init_opt_state(p0)},
                           extra={"data": {"step": 0}})
    t1 = ex.train_with_checkpoints(cfg, data, opt, str(phase1), "cpu",
                                   total_steps=PARITY_STEPS, ckpt_every=1)
    assert t1.history[0]["step"] == 1
    assert t_ckpt.latest_step(str(phase1)) == PARITY_STEPS
    # one survivor of two: the 4-row batch as two microbatches of 2
    plan = ex.replan(available=1, model_parallel=1,
                     global_batch=data.global_batch, max_per_device_batch=2)
    assert plan.grad_accum == 2
    total = 2 * PARITY_STEPS
    mine_dir, theirs_dir = tmp_path / "port", tmp_path / "jax"
    shutil.copytree(phase1, mine_dir)
    shutil.copytree(phase1, theirs_dir)
    mine = ex.restart_trainer(plan, cfg, data, opt, str(mine_dir), "cpu",
                              total_steps=total, ckpt_every=total,
                              log_every=1)
    t_params, t_opt = mine.run()
    theirs = j_trainer.Trainer(
        jcfg, j_trainer.TrainerConfig(total_steps=total,
                                      ckpt_dir=str(theirs_dir),
                                      ckpt_every=total, log_every=1,
                                      n_micro=plan.grad_accum),
        opt_cfg=j_adamw.AdamWConfig(lr=opt.lr),
        data_cfg=JData(vocab=data.vocab, seq_len=data.seq_len,
                       global_batch=data.global_batch, seed=data.seed))
    j_params, j_opt = theirs.run()
    assert [h["step"] for h in mine.history] == \
        [h["step"] for h in theirs.history] == \
        list(range(PARITY_STEPS + 1, total + 1))
    for a, b in zip(mine.history, theirs.history):
        assert abs(a["loss"] - b["loss"]) <= REL * abs(b["loss"]), (a, b)
    assert int(t_opt["step"]) == int(j_opt["step"]) == total
    got, want = _t_by_key(t_params), _j_by_key(j_params)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype == np.float32, k
        assert np.abs(got[k] - w).max() <= 2 * opt.lr, k
