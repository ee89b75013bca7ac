"""The port's one-step training against the JAX package's, on the fp32
policy: every arch of ``configs/registry.py`` reduced, the JAX weights
carried across (``convert.params_from_jax``) and one ``TokenPipeline``
batch (a few labels masked, the VLM's patches and the enc-dec's source
frames included).  ``lm_loss`` and its metrics within 1e-5 of JAX's, each
leaf's gradient within 1e-4 of the leaf's max |grad| of ``jax.grad``'s,
``adamw_update`` alone within 1e-6 relative, and the whole step's new
parameters within 2·lr per element (step 1's update is lr·(g/|g| + wd·
master): a gradient near 0 may take either sign, the decay term is the
same).  The bf16 policy is ``test_torch_train_bf16.py``'s, the step's
options ``test_torch_train_options.py``'s; both import the helpers
here."""
import functools
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from jax import tree_util as jtu  # noqa: E402

from repro.configs import registry as j_registry  # noqa: E402
from repro.models import api as j_api  # noqa: E402
from repro.models.common import DTypePolicy as JPolicy  # noqa: E402
from repro.optim import adamw as j_adamw  # noqa: E402
from repro_torch.configs import registry as t_registry  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.data.pipeline import DataConfig, TokenPipeline  # noqa: E402
from repro_torch.optim import adamw as t_adamw  # noqa: E402
from repro_torch.train.steps import batch_to, lm_grads  # noqa: E402
from repro_torch.train.steps import make_train_step as t_make_step  # noqa
from repro_torch.tree import leaves_with_path  # noqa: E402

ARCHS = sorted(j_registry.ARCHS)
LR = 1e-3
REL_LOSS = 1e-5       # fp32 loss: one model, sums in other orders
REL_GRAD = 1e-4       # fp32 grad, of the leaf's max |grad|
REL_ADAMW = 1e-6


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread for the port's small CPU ops while a test runs:
    under ``-n 6`` every worker's default thread pool would oversubscribe
    the cores (the thread count is put back after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def batch_for(cfg, seq=16, rows=2, seed=0):
    """One synthetic batch of the port's ``TokenPipeline`` (the JAX
    package's bit for bit), three labels masked, and for the enc-dec a
    seeded (rows, seq, d) source."""
    b = TokenPipeline(DataConfig(
        vocab=cfg.vocab, seq_len=seq, global_batch=rows, seed=seed,
        frontend=cfg.frontend, frontend_len=cfg.frontend_len,
        d_model=cfg.d_model)).next_batch()
    b["labels"][0, :3] = -1
    if cfg.is_encdec:
        b["src_embeds"] = np.random.default_rng(seed).standard_normal(
            (rows, seq, cfg.d_model)).astype(np.float32)
    return b


def j_grads_by_key(tree):
    """{key path joined by "__": fp32 numpy} of a JAX tree."""
    return {"__".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path): np.asarray(v, np.float32)
            for path, v in jtu.tree_flatten_with_path(tree)[0]}


def t_by_key(tree):
    return {"__".join(map(str, path)): v.detach().float().numpy()
            for path, v in leaves_with_path(tree)}


@functools.lru_cache(maxsize=None)
def case(arch, policy="fp32"):
    """JAX's loss, metrics and grads of one batch on reduced ``arch``
    (seeded weights), and the port's copy of the weights."""
    cfg = j_registry.get_config(arch, reduced=True)
    dp = JPolicy.fp32() if policy == "fp32" else JPolicy()
    params = j_api.init_params(cfg, jax.random.PRNGKey(0), dtype_policy=dp)
    batch = batch_for(cfg)
    (total, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p, b: j_api.lm_loss(p, cfg, b), has_aux=True))(params, batch)
    return types.SimpleNamespace(
        cfg=cfg, tcfg=t_registry.get_config(arch, reduced=True),
        params=params, batch=batch, total=float(total),
        metrics={k: float(v) for k, v in metrics.items()}, grads=grads,
        tparams=params_from_jax(params, "cpu"))


def assert_leaves_close(got, want, rel, what):
    assert sorted(got) == sorted(want), what
    for key in want:
        g, w = got[key], want[key]
        assert g.shape == w.shape, (what, key)
        err = np.abs(g - w).max()
        assert err <= rel * max(np.abs(w).max(), 1e-30), (what, key, err)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_metrics_match_reference(arch):
    c = case(arch)
    with torch.no_grad():
        from repro_torch.models import api as t_api
        total, m = t_api.lm_loss(c.tparams, c.tcfg, batch_to(c.batch, "cpu"))
    for got, want in ((float(total), c.total),
                      (float(m["loss"]), c.metrics["loss"]),
                      (float(m["aux_loss"]), c.metrics["aux_loss"])):
        assert abs(got - want) <= REL_LOSS * max(abs(want), 1.0), \
            (arch, got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_grads_match_reference(arch):
    c = case(arch)
    _, grads = lm_grads(c.tparams, c.tcfg, batch_to(c.batch, "cpu"))
    assert_leaves_close(t_by_key(grads), j_grads_by_key(c.grads), REL_GRAD,
                        arch)


@pytest.mark.parametrize("clip,schedule", [(0.0, False), (1.0, False),
                                           (1.0, True)])
def test_adamw_update_matches_reference(clip, schedule):
    """``adamw_update`` alone on identical inputs, two steps (the bias
    corrections at step 2), fp32 and bf16 leaves."""
    from repro.optim.schedules import warmup_cosine as j_wc
    from repro_torch.optim.schedules import warmup_cosine as t_wc
    rng = np.random.default_rng(4)
    p = {"a": rng.standard_normal((6, 5)).astype(np.float32),
         "b": {"c": rng.standard_normal(7).astype(np.float32)}}
    gs = [{"a": rng.standard_normal((6, 5)).astype(np.float32) * 3,
           "b": {"c": rng.standard_normal(7).astype(np.float32)}}
          for _ in range(2)]
    kw = dict(lr=0.01, weight_decay=0.1, grad_clip=clip)
    jcfg = j_adamw.AdamWConfig(**kw, schedule=j_wc(0.01, 1, 10)
                               if schedule else None)
    tcfg = t_adamw.AdamWConfig(**kw, schedule=t_wc(0.01, 1, 10)
                               if schedule else None)
    jp = jax.tree.map(jnp.asarray, p)
    jp["b"]["c"] = jp["b"]["c"].astype(jnp.bfloat16)
    tp = params_from_jax(jp, "cpu")
    js, ts = j_adamw.init_opt_state(jp), t_adamw.init_opt_state(tp)
    for g in gs:
        jp, js, jm = j_adamw.adamw_update(jp, jax.tree.map(jnp.asarray, g),
                                          js, jcfg)
        tp, ts, tm = t_adamw.adamw_update(
            tp, params_from_jax(g, "cpu"), ts, tcfg)
        for k in ("grad_norm", "lr"):
            assert float(tm[k]) == pytest.approx(float(jm[k]),
                                                 rel=REL_ADAMW)
    assert int(ts["step"]) == int(js["step"]) == 2
    assert ts["step"].dtype == torch.int32
    for got, want in ((tp, jp), (ts["mu"], js["mu"]), (ts["nu"], js["nu"]),
                      (ts["master"], js["master"])):
        assert_leaves_close(t_by_key(got), j_grads_by_key(want),
                            REL_ADAMW, "adamw")
    assert tp["b"]["c"].dtype == torch.bfloat16


def assert_step_close(tparams, jparams, bf16_ulp, what):
    """Each element within 2·lr; with ``bf16_ulp``, plus one bf16 step at
    the larger of the two elements (each side rounds its fp32 master to
    bf16, half a step of its own value at most)."""
    want = j_grads_by_key(jparams)
    got = t_by_key(tparams)
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        bound = 2 * LR
        if bf16_ulp:
            mag = np.maximum(np.maximum(np.abs(w), np.abs(got[key])),
                             2.0 ** -126)
            bound = bound + 2.0 ** (np.floor(np.log2(mag)) - 7)
        err = np.abs(got[key] - w)
        assert (err <= bound).all(), (what, key, err.max())


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch):
    """The port's whole step against JAX's step on the same grads (its
    ``make_train_step`` is ``value_and_grad`` then ``adamw_update``)."""
    c = case(arch)
    jopt = j_adamw.AdamWConfig(lr=LR)
    jnew, jstate, jm = jax.jit(j_adamw.adamw_update, static_argnums=3)(
        c.params, c.grads, j_adamw.init_opt_state(c.params), jopt)
    step = t_make_step(c.tcfg, t_adamw.AdamWConfig(lr=LR))
    tnew, tstate, tm = step(c.tparams, t_adamw.init_opt_state(c.tparams),
                            c.batch)
    assert sorted(tm) == ["aux_loss", "grad_norm", "loss", "lr"]
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                   rel=1e-5)
    assert int(tstate["step"]) == 1
    assert_step_close(tnew, jnew, False, arch)
