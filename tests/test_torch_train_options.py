"""The train step's options against the JAX package's, on reduced configs
with the fp32 policy and the JAX weights carried across (the helpers of
``test_torch_train_step.py``): ``n_micro=2`` (fp32 grads accumulated over
the microbatches, the MoE pair too), ``compress_grads=True`` (the int8
round trip), ``attn_impl="blockwise"`` (its grads under the no-save
checkpoint), the MoE aux loss in the total and in the router's gradient;
and the port on its own: remat ``full`` and ``dots`` bitwise ``none`` on
five families, ``dots`` keeping the matmuls."""
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from test_torch_train_step import (one_torch_thread,  # noqa: F401
                                   LR, REL_GRAD, REL_LOSS,  # noqa: E402
                                   assert_leaves_close, assert_step_close,
                                   batch_for, case, j_grads_by_key, t_by_key)

from repro.models import api as j_api  # noqa: E402
from repro.optim import adamw as j_adamw  # noqa: E402
from repro.train.steps import make_train_step as j_make_step  # noqa: E402
from repro_torch.configs import registry as t_registry  # noqa: E402
from repro_torch.models import api as t_api  # noqa: E402
from repro_torch.models.common import DTypePolicy  # noqa: E402
from repro_torch.models.settings import remat  # noqa: E402
from repro_torch.optim import adamw as t_adamw  # noqa: E402
from repro_torch.train.steps import batch_to, lm_grads  # noqa: E402
from repro_torch.train.steps import make_train_step as t_make_step  # noqa
from repro_torch.tree import leaves, unflatten_like  # noqa: E402


def j_step(cfg, batch, params, **kw):
    step = jax.jit(j_make_step(cfg, j_adamw.AdamWConfig(lr=LR), **kw))
    return step(params, j_adamw.init_opt_state(params), batch)


def t_step(c, **kw):
    step = t_make_step(c.tcfg, t_adamw.AdamWConfig(lr=LR), **kw)
    return step(c.tparams, t_adamw.init_opt_state(c.tparams), c.batch)


@pytest.mark.parametrize("arch,kw", [
    ("llama3-8b", {"n_micro": 2}),
    ("qwen3-4b", {"compress_grads": True}),
    ("llama3-8b", {"attn_impl": "blockwise"}),
    ("granite-moe-1b-a400m", {"n_micro": 2})],
    ids=["n_micro2", "compress", "blockwise", "moe_n_micro2"])
def test_step_options_match_reference(arch, kw):
    c = case(arch)
    jnew, _, jm = j_step(c.cfg, c.batch, c.params, **kw)
    tnew, _, tm = t_step(c, **kw)
    for k in ("loss", "aux_loss", "grad_norm"):
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-5,
                                             abs=1e-6), (k, kw)
    assert_step_close(tnew, jnew, False, kw)


def test_blockwise_attention_grads_match_reference():
    """The blockwise attention (under its no-save checkpoint) against
    JAX's blockwise grads, and against the port's naive attention."""
    from repro.models.settings import attn_impl as j_attn
    from repro_torch.models.settings import attn_impl as t_attn
    c = case("qwen3-4b")
    with j_attn("blockwise"):
        _, jg = jax.jit(jax.value_and_grad(
            lambda p, b: j_api.lm_loss(p, c.cfg, b), has_aux=True))(
                c.params, c.batch)
    with t_attn("blockwise"):
        _, tg = lm_grads(c.tparams, c.tcfg, batch_to(c.batch, "cpu"))
    assert_leaves_close(t_by_key(tg), j_grads_by_key(jg), REL_GRAD,
                        "blockwise")
    _, naive = lm_grads(c.tparams, c.tcfg, batch_to(c.batch, "cpu"))
    assert_leaves_close(t_by_key(tg), t_by_key(naive), REL_GRAD, "naive")


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "qwen2-moe-a2.7b"])
def test_moe_aux_loss_enters_the_total_and_the_router_grad(arch):
    """The summed MoE aux loss is nonzero, equal to JAX's, in the total
    at ``aux_coef``, and it moves the router's gradient."""
    c = case(arch)
    b = batch_to(c.batch, "cpu")
    with torch.no_grad():
        total, m = t_api.lm_loss(c.tparams, c.tcfg, b, aux_coef=0.01)
    assert float(m["aux_loss"]) > 0
    assert float(m["aux_loss"]) == pytest.approx(c.metrics["aux_loss"],
                                                 rel=REL_LOSS)
    assert float(total) == pytest.approx(
        float(m["loss"]) + 0.01 * float(m["aux_loss"]), rel=1e-6)
    _, g1 = lm_grads(c.tparams, c.tcfg, b, aux_coef=0.01)
    _, g0 = lm_grads(c.tparams, c.tcfg, b, aux_coef=0.0)
    router = ("moe", "router")
    r1, r0 = (g["blocks"][router[0]][router[1]] for g in (g1, g0))
    assert not torch.equal(r1, r0)


def port_case(arch, seq=32):
    """The port's own fp32 weights (seeded) and a batch, for reduced
    ``arch``."""
    cfg = t_registry.get_config(arch, reduced=True)
    params = t_api.init_params(cfg, torch.Generator().manual_seed(0),
                               dtype_policy=DTypePolicy.fp32(), device="cpu")
    return cfg, params, batch_to(batch_for(cfg, seq=seq), "cpu")


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "rwkv6-1.6b",
                                  "granite-moe-1b-a400m", "gemma3-12b",
                                  "internvl2-26b", "seamless-m4t-medium"])
def test_remat_modes_are_bitwise_none(arch):
    cfg, params, b = port_case(arch)
    out = {}
    for mode in ("none", "full", "dots"):
        with remat(mode):
            out[mode] = lm_grads(params, cfg, b)
    for mode in ("full", "dots"):
        assert torch.equal(out[mode][0]["loss"], out["none"][0]["loss"])
        for a, b_ in zip(leaves(out[mode][1]), leaves(out["none"][1])):
            assert torch.equal(a, b_), (arch, mode)


def test_remat_dots_keeps_the_matmuls_and_full_recomputes_them():
    """The backward runs as many ``aten.mm`` under ``dots`` as under
    ``none`` (the forward's matmul outputs are saved, not recomputed) and
    more under ``full`` (the forward's are recomputed)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.mm = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func in (torch.ops.aten.mm.default,
                        torch.ops.aten.addmm.default):
                self.mm += 1
            return func(*args, **(kwargs or {}))

    cfg, params, b = port_case("llama3-8b")
    counts = {}
    for mode in ("none", "full", "dots"):
        live = [t.detach().requires_grad_(True) for t in leaves(params)]
        with remat(mode):
            total, _ = t_api.lm_loss(unflatten_like(params, live), cfg, b)
        with Count() as cnt:
            torch.autograd.grad(total, live)
        counts[mode] = cnt.mm
    assert counts["none"] == counts["dots"] < counts["full"], counts


def test_remat_and_attn_settings_are_restored():
    from repro_torch.models import settings
    assert settings.get_remat() == "none"
    with remat("full"):
        assert settings.get_remat() == "full"
    assert settings.get_remat() == "none"
    with pytest.raises(ValueError, match="remat"):
        settings.set_remat("some")


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "qwen3-4b", "rwkv6-1.6b",
                                  "seamless-m4t-medium"])
def test_stacked_leaves_split_once_in_the_backward(arch):
    """A full-sequence pass splits each stacked leaf once (``unbind``):
    the backward stacks the layers' gradients with one op a leaf, and no
    layer's backward writes into a zero tensor the size of the whole
    stack (``select_backward``, what indexing layer by layer costs)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Selects(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.shapes = []     # (input sizes, dim) of each select_backward

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.overloadpacket.__name__ == "select_backward":
                self.shapes.append((tuple(args[1]), args[2]))
            return func(*args, **(kwargs or {}))

    cfg, params, b = port_case(arch, seq=8)
    live = [t.detach().requires_grad_(True) for t in leaves(params)]
    stacked = {tuple(t.shape) for t in live if t.dim() >= 1
               and t.shape[0] in (cfg.n_layers, cfg.enc_layers)
               and t.shape[0] > 1}
    assert stacked
    total, _ = t_api.lm_loss(unflatten_like(params, live), cfg, b)
    with Selects() as sel:
        torch.autograd.grad(total, live)
    assert not [s for s in sel.shapes if s[1] == 0 and s[0] in stacked], \
        sel.shapes
