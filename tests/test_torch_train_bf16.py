"""The port's one-step training against the JAX package's on the bf16
policy (bf16 parameters and activations, fp32 master weights): every arch
of ``configs/registry.py`` reduced, the JAX weights carried across and
one ``TokenPipeline`` batch (the helpers of ``test_torch_train_step.py``).

Two bf16 programs that round in other places differ by bf16 noise, which
the backward carries through every layer (MoE routing can flip an
expert, as it can between JAX's own bf16 and fp32).  So each leaf's
gradient is held to ``jax.grad``'s bf16 one within
``3e-2·max|g_jax| + 2·max|g_jax - g_fp32|``: 3% of the leaf's scale plus
twice the JAX bf16 gradient's own distance from the fp32 gradient at the
same (bf16-valued) weights, taken as the port's fp32 gradient, which
``test_torch_train_step.py`` holds to JAX's fp32 within 1e-4.  The loss
within ``1e-2`` of JAX's.  The step's new parameters within 2·lr plus one
bf16 step at the larger of the two elements (the two fp32 masters differ
by at most 2·lr, and each side's rounding to bf16 moves it by half a step
of its own value at most)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from test_torch_train_step import (one_torch_thread,  # noqa: F401
                                   ARCHS, LR, assert_step_close,  # noqa
                                   case, j_grads_by_key, t_by_key)

from repro.optim import adamw as j_adamw  # noqa: E402
from repro_torch.optim import adamw as t_adamw  # noqa: E402
from repro_torch.train.steps import batch_to, lm_grads  # noqa: E402
from repro_torch.train.steps import make_train_step as t_make_step  # noqa
from repro_torch.tree import leaves, tree_map  # noqa: E402

REL_BF16 = 3e-2


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_loss_and_grads_match_reference(arch):
    c = case(arch, "bf16")
    b = batch_to(c.batch, "cpu")
    m, grads = lm_grads(c.tparams, c.tcfg, b)
    assert abs(float(m["loss"]) - c.metrics["loss"]) <= 1e-2 * abs(
        c.metrics["loss"])
    _, g32 = lm_grads(tree_map(lambda t: t.float(), c.tparams), c.tcfg, b)
    for g, p in zip(leaves(grads), leaves(c.tparams)):
        assert g.dtype == p.dtype       # a gradient in its leaf's type
    got, want, fp32 = (t_by_key(grads), j_grads_by_key(c.grads),
                       t_by_key(g32))
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        bound = REL_BF16 * np.abs(w).max() + 2 * np.abs(w - fp32[key]).max()
        err = np.abs(got[key] - w).max()
        assert err <= bound, (arch, key, err, bound)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_train_step_matches_reference(arch):
    c = case(arch, "bf16")
    jnew, _, _ = jax.jit(j_adamw.adamw_update, static_argnums=3)(
        c.params, c.grads, j_adamw.init_opt_state(c.params),
        j_adamw.AdamWConfig(lr=LR))
    tnew, tstate, _ = t_make_step(c.tcfg, t_adamw.AdamWConfig(lr=LR))(
        c.tparams, t_adamw.init_opt_state(c.tparams), c.batch)
    assert all(t.dtype == torch.float32 for t in leaves(tstate["master"]))
    assert_step_close(tnew, jnew, True, arch)
