"""Gradients through the port's conv ops and kernels' entry points,
against the JAX package's ``custom_vjp``s on the CPU (the plain versions
run there):

* ``ops.conv2d`` on every impl against ``jax.grad`` of ``repro``'s
  ``conv2d`` (the counterparts of ``tests/test_kernels.py:75, :94``), and
  grouped / depthwise through the reference conv's autograd;
* ``ops.conv2d_fused`` (bias / ReLU / pool, the residual shortcut, the BN
  scale and shift) against ``repro``'s fused op (``tests/
  test_fused_autotune.py:123, :393``);
* the compiled ResNet-18 and MobileNetV2 (kernel mode, ``jit=False``)
  against the per-layer reference walk (``tests/test_resnet.py:48``,
  ``tests/test_mobilenet.py:188``), and the walk against ``repro``'s;
* ``ops.conv1d_causal``: dx bitwise ``jax.vjp`` of ``repro``'s op (its
  backward's formula), dw within 1e-6 of max |dw|, fp32 and bf16;
* the entry points with no backward (``conv2d_folded``, the fold
  launchers, ``conv2d_int8``, ``flash_attention_folded``, the conv1d
  kernel's, the dense launch) raising under grad, never detaching; the
  dense head's own backward.

The ``cuda`` cases run the kernels' autograd paths on the card: dx
through the conv1d kernel bitwise the plain op's, its launches counted
in the backward, every fold impl's conv2d_fused grads against the
reference chain, and a captured forward refusing to train."""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.epilogue import Epilogue as TEpi  # noqa: E402
from repro_torch.kernels import ops as t_ops  # noqa: E402

t_conv1d = importlib.import_module("repro_torch.kernels.conv1d_causal")

REL = 1e-4        # port vs JAX, fp32 grads: sums in other orders


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread for the port's small CPU ops while a test runs:
    under ``-n 6`` every worker's default thread pool would oversubscribe
    the cores (the thread count is put back after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax():
    """The JAX package's side (JAX is imported here, not at module level,
    so the ``cuda`` cases run where JAX is not installed)."""
    jax = pytest.importorskip("jax")
    from repro.core.epilogue import Epilogue
    from repro.kernels import ops
    return jax, jax.numpy, ops, Epilogue


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _close(got, want, rel=REL, what=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max()
    assert err <= rel * max(np.abs(want).max(), 1e-30), (what, err)


def _t(*arrays):
    return [torch.from_numpy(a).requires_grad_(True) for a in arrays]


# --------------------------------------------------------------------------
# conv2d
# --------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["direct", "fold_ws", "fold_os",
                                  "fold_auto", "im2col", "torch"])
@pytest.mark.parametrize("stride,pad,hw", [(1, 1, 8), (2, 1, 9), (2, 0, 8),
                                           (1, 0, 7)])
def test_conv2d_grads_match_reference(impl, stride, pad, hw):
    jax, jnp, j_ops, JEpi = _jax()
    x, w = _rand((2, 3, hw, hw), 1), _rand((4, 3, 3, 3), 2)
    jg = jax.grad(lambda a, b: jnp.sum(j_ops.conv2d(
        a, b, stride, pad, impl="direct") ** 2), argnums=(0, 1))(x, w)
    tx, tw = _t(x, w)
    y = t_ops.conv2d(tx, tw, stride, pad, impl=impl)
    gx, gw = torch.autograd.grad((y ** 2).sum(), (tx, tw))
    _close(gx, jg[0], what=f"{impl} dx")
    _close(gw, jg[1], what=f"{impl} dw")


@pytest.mark.parametrize("impl", ["direct", "fold_ws", "fold_os"])
@pytest.mark.parametrize("c,nf,g", [(6, 12, 3), (8, 16, 4)])
def test_grouped_conv2d_grads_match_reference(impl, c, nf, g):
    jax, jnp, j_ops, JEpi = _jax()
    x, w = _rand((2, c, 9, 9), 3), _rand((nf, c // g, 3, 3), 4)
    jg = jax.grad(lambda a, b: jnp.sum(j_ops.conv2d(
        a, b, 2, 1, impl="direct", groups=g) ** 2), argnums=(0, 1))(x, w)
    tx, tw = _t(x, w)
    y = t_ops.conv2d(tx, tw, 2, 1, impl=impl, groups=g)
    gx, gw = torch.autograd.grad((y ** 2).sum(), (tx, tw))
    _close(gx, jg[0], what="dx")
    _close(gw, jg[1], what="dw")


def test_depthwise_fold_grads_match_reference():
    jax, jnp, j_ops, JEpi = _jax()
    x, w = _rand((2, 8, 9, 9), 5), _rand((8, 1, 3, 3), 6)
    jg = jax.grad(lambda a, b: jnp.sum(j_ops.conv2d(
        a, b, 1, 1, impl="direct", groups=8) ** 2), argnums=(0, 1))(x, w)
    tx, tw = _t(x, w)
    y = t_ops.conv2d(tx, tw, 1, 1, impl="fold_dw", groups=8)
    gx, gw = torch.autograd.grad((y ** 2).sum(), (tx, tw))
    _close(gx, jg[0], what="dx")
    _close(gw, jg[1], what="dw")


def test_conv2d_bf16_grads_keep_the_operand_types():
    x, w = _t(_rand((1, 4, 6, 6), 7), _rand((5, 4, 3, 3), 8))
    xb = x.detach().bfloat16().requires_grad_(True)
    wb = w.detach().bfloat16().requires_grad_(True)
    y = t_ops.conv2d(xb, wb, 1, 1, impl="fold_ws")
    gx, gw = torch.autograd.grad(y.float().sum(), (xb, wb))
    assert gx.dtype == gw.dtype == torch.bfloat16
    y32 = t_ops.conv2d(x, w, 1, 1, impl="direct")
    hx, hw = torch.autograd.grad(y32.sum(), (x, w))
    # bf16 operands: within a few bf16 steps of the fp32 grads
    _close(gx, hx.detach().numpy(), rel=2e-2)
    _close(gw, hw.detach().numpy(), rel=2e-2)


# --------------------------------------------------------------------------
# conv2d_fused
# --------------------------------------------------------------------------

FUSED = [
    ("bias_relu_pool", dict(bias=True, relu=True, pool="max2")),
    ("bias_relu_residual", dict(bias=True, relu=True, residual=True)),
    ("bn_relu6", dict(scale=True, relu6=True)),
    ("bn_residual", dict(scale=True, residual=True)),
]


@pytest.mark.parametrize("impl", ["direct", "fold_ws", "fold_os",
                                  "fold_auto"])
@pytest.mark.parametrize("name,epi", FUSED, ids=[f[0] for f in FUSED])
def test_conv2d_fused_grads_match_reference(impl, name, epi):
    jax, jnp, j_ops, JEpi = _jax()
    n, c, nf, hw = 1, 3, 4, 8
    x, w, b = _rand((n, c, hw, hw), 9), _rand((nf, c, 3, 3), 10), \
        _rand((nf,), 11)
    scale, shift = 1.0 + 0.2 * _rand((nf,), 12), _rand((nf,), 13, 0.2)
    res = _rand((n, nf, hw, hw), 14)
    names = ["x", "w"] + [k for k, on in (("b", epi.get("bias")),
                                          ("scale", epi.get("scale")),
                                          ("shift", epi.get("scale")),
                                          ("res", epi.get("residual")))
                          if on]
    vals = {"x": x, "w": w, "b": b, "scale": scale, "shift": shift,
            "res": res}
    args = [vals[k] for k in names]

    def call(ops, epi_cls, tensors, impl_):
        kw = dict(zip(names, tensors))
        return ops.conv2d_fused(
            kw["x"], kw["w"], kw.get("b"), stride=1, pad=1,
            epilogue=epi_cls(**epi), impl=impl_, residual=kw.get("res"),
            scale=kw.get("scale"), shift=kw.get("shift"))

    jg = jax.grad(lambda *a: jnp.sum(call(j_ops, JEpi, a, "direct") ** 2),
                  argnums=tuple(range(len(args))))(*args)
    tt = _t(*args)
    tg = torch.autograd.grad((call(t_ops, TEpi, tt, impl) ** 2).sum(), tt)
    for k, got, want in zip(names, tg, jg):
        _close(got, want, what=f"{impl} {name} d{k}")


def test_conv2d_fused_unused_operands_get_no_grad_slot():
    x, w = _t(_rand((1, 2, 5, 5), 15), _rand((3, 2, 3, 3), 16))
    b = torch.from_numpy(_rand((3,), 17))          # not trained
    y = t_ops.conv2d_fused(x, w, b, pad=1, epilogue=TEpi(bias=True,
                                                         relu=True),
                           impl="fold_ws")
    gx, gw = torch.autograd.grad(y.sum(), (x, w))
    assert gx.shape == x.shape and gw.shape == w.shape
    assert b.grad is None


# --------------------------------------------------------------------------
# the zoo networks: compiled (kernel mode) against the reference walk
# --------------------------------------------------------------------------

IMG, WIDTH, CLASSES = 32, 0.0625, 10


def _randomize_bn(params, seed=7):
    rng = np.random.default_rng(seed)
    for name, leaf in params.items():
        if name.endswith("_bn"):
            n = leaf["gamma"].shape[0]
            draws = {"gamma": 1.0 + 0.2 * rng.standard_normal(n),
                     "beta": 0.2 * rng.standard_normal(n),
                     "mean": 0.3 * rng.standard_normal(n),
                     "var": rng.uniform(0.5, 1.5, n)}
            for k, v in draws.items():
                leaf[k] = torch.as_tensor(v, dtype=torch.float32)
    return params


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def _grads(fn, params, x):
    names, leaves = zip(*_leaves(params))
    live = [t.detach().requires_grad_(True) for t in leaves]
    xl = x.detach().requires_grad_(True)
    tree = {}
    for name, t in zip(names, live):
        node = tree
        *path, last = name.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[last] = t
    out = fn(tree, xl)
    grads = torch.autograd.grad(out, [xl, *live])
    return grads[0], dict(zip(names, grads[1:]))


@pytest.mark.parametrize("model", ["resnet18", "mobilenetv2"])
def test_compiled_network_grads_match_the_reference_walk(model):
    """Grads of the compiled network in kernel mode (the fold impls' plain
    versions on the CPU, fused epilogues, the residual and BN folded into
    them) equal the per-layer reference walk's, for every parameter and
    the input, within 1e-5 of each array's scale (the JAX tests' bound)."""
    mod = importlib.import_module("repro_torch.models." + {
        "resnet18": "resnet", "mobilenetv2": "mobilenet"}[model])
    params = mod.init_params(torch.Generator().manual_seed(0),
                             width_mult=WIDTH, img=IMG, classes=CLASSES,
                             device="cpu")
    if model == "mobilenetv2":
        params = _randomize_bn(params)
    x = torch.from_numpy(_rand((2, 3, IMG, IMG), 1))
    net = mod.compile_forward(params, img=IMG, batch=2, policy="kernel",
                              jit=False, device="cpu")
    gx_f, gp_f = _grads(lambda p, xx: (net(p, xx) ** 2).mean(), params, x)
    gx_r, gp_r = _grads(lambda p, xx: (mod.forward(p, xx, impl="direct")
                                       ** 2).mean(), params, x)
    _close(gx_f, gx_r.numpy(), rel=1e-5, what="dL/dx")
    assert sorted(gp_f) == sorted(gp_r)
    for name in gp_r:
        _close(gp_f[name], gp_r[name].numpy(), rel=1e-5, what=name)
    assert any(float(g.abs().max()) > 0 for g in gp_f.values())


def test_resnet_walk_grads_match_reference():
    """The port's reference walk differentiated against ``repro``'s, on
    the JAX weights carried across."""
    jax, jnp, _, _ = _jax()
    from repro.models import resnet as j_resnet
    from repro_torch.models import resnet as t_resnet
    jp = j_resnet.init_params(jax.random.PRNGKey(0), width_mult=WIDTH,
                              img=IMG, classes=CLASSES)
    x = _rand((2, 3, IMG, IMG), 2)
    jgp, jgx = jax.jit(jax.grad(lambda p, xx: jnp.mean(j_resnet.forward(
        p, xx, impl="direct") ** 2), argnums=(0, 1)))(jp, x)
    tp = params_from_jax(jp, "cpu")
    gx, gp = _grads(lambda p, xx: (t_resnet.forward(p, xx, impl="direct")
                                   ** 2).mean(), tp,
                    torch.from_numpy(x))
    _close(gx, jgx, rel=1e-4, what="dL/dx")
    for name in ("stem/w", "s2b0_down/w", "s4b1_c2/b", "fc/w"):
        layer, leaf = name.split("/")
        _close(gp[name], jgp[layer][leaf], rel=1e-4, what=name)


# --------------------------------------------------------------------------
# conv1d_causal
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,t,d,k", [(2, 16, 13, 4), (2, 33, 8, 4),
                                     (1, 9, 21, 3), (2, 3, 5, 4)])
def test_conv1d_causal_grads_match_reference(dtype, b, t, d, k):
    jax, jnp, j_ops, JEpi = _jax()
    """dx bitwise the JAX backward (its fp32 sum over the taps, one
    rounding), dw within 1e-6 of max |dw|."""
    x, w, g = _rand((b, t, d), 1), _rand((k, d), 2), _rand((b, t, d), 3)
    jx, jw, jgo = (jnp.asarray(a).astype(dtype) for a in (x, w, g))
    _, vjp = jax.vjp(lambda a, c: j_ops.conv1d_causal(a, c), jx, jw)
    jdx, jdw = vjp(jgo)
    tdt = getattr(torch, dtype)
    tx, tw = (torch.from_numpy(a).to(tdt).requires_grad_(True)
              for a in (x, w))
    y = t_ops.conv1d_causal(tx, tw)
    dx, dw = torch.autograd.grad(y, (tx, tw), torch.from_numpy(g).to(tdt))
    assert dx.dtype == dw.dtype == tdt
    np.testing.assert_array_equal(dx.float().numpy(),
                                  np.asarray(jdx.astype("float32")))
    rel = 1e-6 if dtype == "float32" else 2.0 ** -8
    _close(dw, np.asarray(jdw.astype("float32")), rel=rel, what="dw")


def test_conv1d_dx_is_the_flipped_forward_conv():
    """dx is the causal conv of the time-reversed gradient, bit for bit
    (the identity the CUDA backward launches the forward kernel on)."""
    x, w, g = (torch.from_numpy(_rand(s, i)) for i, s in
               enumerate([(2, 11, 6), (4, 6), (2, 11, 6)]))
    xl = x.requires_grad_(True)
    (dx,) = torch.autograd.grad(t_ops.conv1d_causal(xl, w, impl="ref"),
                                (xl,), g)
    want = torch.flip(t_conv1d.conv1d_causal_plain(torch.flip(g, (1,)), w),
                      (1,))
    assert torch.equal(dx, want)


def test_mamba_block_grads_flow_to_every_parameter():
    """Through the Mamba2 mixer (the conv1d op in it) every parameter and
    the input get a nonzero gradient: nothing in front of the conv is
    cut off."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import ssm
    from repro_torch.models.common import DTypePolicy, TreeMaker
    cfg = get_config("zamba2-1.2b", reduced=True)
    tm = TreeMaker(torch.Generator().manual_seed(0), "cpu",
                   DTypePolicy.fp32())
    p = {k: v.requires_grad_(True) for k, v in
         ssm.mamba_params(tm, cfg).items()}
    x = torch.from_numpy(_rand((2, 16, cfg.d_model), 4)).requires_grad_(True)
    y, _, _ = ssm.mamba_block(p, cfg, x)
    grads = torch.autograd.grad(y.square().sum(), [x, *p.values()])
    for name, g in zip(["x", *p], grads):
        assert torch.isfinite(g).all() and g.abs().max() > 0, name


def test_ssd_grads_are_finite_where_the_decay_overflows():
    """Above a chunk's diagonal the SSD decay exponent cum_t - cum_s is
    positive and, at zamba2's full width, overflows exp; the port masks
    the exponent before the exp.  Its forward equals the JAX function's
    (which masks after the exp) and its gradients stay finite."""
    jax, jnp, _, _ = _jax()
    from repro.models import ssm as j_ssm
    from repro_torch.models import ssm as t_ssm
    b, t, h, hd, s = 2, 64, 4, 8, 16
    xh, bm, cm = _rand((b, t, h, hd), 1), _rand((b, t, 1, s), 2), \
        _rand((b, t, 1, s), 3)
    dt = np.abs(_rand((b, t, h), 4)) + 1.0
    a_log = (-20.0 * dt).astype(np.float32)        # cum reaches ~-2000
    h0 = np.zeros((b, h, s, hd), np.float32)
    jy, jh = j_ssm._ssd_chunked(*(jnp.asarray(a) for a in (
        xh, dt, a_log, bm, cm, h0)), 64)
    tt = _t(xh, dt, a_log, bm, cm)
    y, hf = t_ssm._ssd_chunked(*tt, torch.from_numpy(h0), 64)
    _close(y, jy, rel=1e-5, what="y")
    _close(hf, jh, rel=1e-5, what="h")
    grads = torch.autograd.grad((y ** 2).sum() + hf.sum(), tt)
    assert all(bool(torch.isfinite(g).all()) for g in grads)


# --------------------------------------------------------------------------
# the entry points with no backward raise under grad
# --------------------------------------------------------------------------

def _no_backward_calls():
    from repro_torch.kernels import attention_fold, conv2d_ws, dense
    x4 = torch.zeros(1, 2, 6, 6)
    w4 = torch.zeros(3, 2, 3, 3)
    q = torch.zeros(1, 4, 2, 16)
    x3, w2 = torch.zeros(1, 5, 8), torch.zeros(4, 8)
    xd, wd, bd = torch.zeros(2, 8), torch.zeros(8, 3), torch.zeros(3)
    return {
        "conv2d_folded": (lambda a: conv2d_ws.conv2d_folded(a, w4), x4),
        "launch_ws": (lambda a: conv2d_ws.launch_ws(None, a, w4, None,
                                                    None), x4),
        "launch_os": (lambda a: conv2d_ws.launch_os(None, a, w4, None,
                                                    None), x4),
        "launch_dw": (lambda a: conv2d_ws.launch_dw(None, a, w4, None,
                                                    None), x4),
        "launch_psum": (lambda a: conv2d_ws.launch_psum(None, a, w4), x4),
        "conv2d_int8": (lambda a: t_ops.conv2d_int8(a, w4, x_scale=0.1,
                                                    impl="direct"), x4),
        "flash_attention_folded": (
            lambda a: attention_fold.flash_attention_folded(a, q, q), q),
        "attention_launch": (lambda a: attention_fold.launch(
            a, q, q, causal=True, window=0), q),
        "conv1d_causal_folded": (
            lambda a: t_conv1d.conv1d_causal_folded(a, w2), x3),
        "conv1d_launch": (lambda a: t_conv1d.launch(a, w2), x3),
        "dense_launch": (lambda a: dense.launch(a, wd, bd), xd),
    }


@pytest.mark.parametrize("entry", sorted(_no_backward_calls()))
def test_entry_point_without_backward_raises_under_grad(entry):
    fn, arg = _no_backward_calls()[entry]
    live = arg.clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="has no backward"):
        fn(live)


@pytest.mark.parametrize("entry", ["conv2d_folded", "conv2d_int8",
                                   "flash_attention_folded",
                                   "conv1d_causal_folded"])
def test_entry_point_without_backward_runs_without_grad(entry):
    """The same calls under ``torch.no_grad()`` (or on tensors that need
    no grad) run their plain versions on the CPU."""
    fn, arg = _no_backward_calls()[entry]
    live = arg.clone().requires_grad_(True)
    with torch.no_grad():
        out = fn(live)
    assert not out.requires_grad
    assert fn(arg).shape == out.shape


def test_dense_head_has_a_backward():
    from repro_torch.kernels.dense import dense
    x, w, b = _t(_rand((3, 7), 1), _rand((7, 5), 2), _rand((5,), 3))
    y = dense(x, w, b)
    g = torch.from_numpy(_rand((3, 5), 4))
    got = torch.autograd.grad(y, (x, w, b), g)
    x2, w2, b2 = (t.detach().requires_grad_(True) for t in (x, w, b))
    want = torch.autograd.grad(x2 @ w2 + b2, (x2, w2, b2), g)
    for a, r in zip(got, want):
        _close(a, r.numpy(), rel=1e-6)


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels are CUDA-only")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,t,d,k", [(2, 64, 4224, 4), (2, 77, 300, 4),
                                     (1, 3, 13, 4)])
def test_cuda_conv1d_backward_runs_the_kernel(cuda_device, dtype, b, t, d,
                                              k):
    """On the card dx goes through the kernel (one more launch in the
    backward) and equals the plain op's bitwise; dw equals it too (the
    same torch reduction on the same operands)."""
    tdt = getattr(torch, dtype)
    x, w, g = (torch.from_numpy(_rand(s, i)).to(cuda_device, tdt)
               for i, s in enumerate([(b, t, d), (k, d), (b, t, d)]))
    grads = {}
    for impl in ("fold", "ref"):
        xl, wl = (a.clone().requires_grad_(True) for a in (x, w))
        before = t_conv1d.launch_counts()[t_conv1d.KERNEL]
        y = t_ops.conv1d_causal(xl, wl, impl=impl)
        grads[impl] = (y,) + torch.autograd.grad(y, (xl, wl), g)
        torch.cuda.synchronize()
        launched = t_conv1d.launch_counts()[t_conv1d.KERNEL] - before
        assert launched == (2 if impl == "fold" else 0), impl
    for a, r in zip(grads["fold"], grads["ref"]):
        assert torch.equal(a, r)


@pytest.mark.cuda
@pytest.mark.parametrize("impl,groups", [("fold_ws", 1), ("fold_os", 1),
                                         ("fold_dw", 16),
                                         ("fold_auto", 1)])
def test_cuda_conv2d_fused_grads_match_the_reference_chain(cuda_device, impl,
                                                           groups):
    c = nf = 16
    x, w, sc, sh, res = (torch.from_numpy(a).to(cuda_device) for a in (
        _rand((2, c, 12, 12), 1), _rand((nf, c // groups, 3, 3), 2),
        1.0 + 0.2 * _rand((nf,), 3), _rand((nf,), 4, 0.2),
        _rand((2, nf, 12, 12), 5)))
    epi = TEpi(scale=True, relu6=True, residual=True)
    got, want = [], []
    for impl_, out in ((impl, got), ("direct", want)):
        ops = [a.clone().requires_grad_(True) for a in (x, w, sc, sh, res)]
        y = t_ops.conv2d_fused(ops[0], ops[1], stride=1, pad=1,
                               epilogue=epi, impl=impl_, residual=ops[4],
                               scale=ops[2], shift=ops[3], groups=groups)
        out.extend(torch.autograd.grad((y ** 2).sum(), ops))
    for a, r in zip(got, want):
        err = (a - r).abs().max().item()
        assert err <= 1e-4 * max(r.abs().max().item(), 1e-30)


@pytest.mark.cuda
def test_cuda_captured_forward_refuses_to_train(cuda_device):
    from repro_torch.models import resnet
    params = resnet.init_params(torch.Generator(device=cuda_device)
                                .manual_seed(0), width_mult=WIDTH, img=IMG,
                                classes=CLASSES, device=cuda_device)
    net = resnet.compile_forward(params, img=IMG, batch=2)
    x = torch.randn(2, 3, IMG, IMG, device=cuda_device)
    net(params, x)
    live = {k: {n: t.requires_grad_(True) for n, t in v.items()}
            for k, v in params.items()}
    with pytest.raises(RuntimeError, match="has no backward"):
        net(live, x)
