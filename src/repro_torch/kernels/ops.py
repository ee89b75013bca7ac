"""Public conv entry points over the fold kernels (fp32 and bf16, and int8
through ``conv2d_int8``).

``impl`` selects the path:
  "fold_ws"      — weight-stationary fold kernel (the paper's dataflow)
  "fold_os"      — output-stationary fold kernel
  "fold_dw"      — the depthwise kernel (groups == C == N_F, no depth-fold
                   reduction)
  "fold_auto"    — fold kernel with the dataflow picked by the engine's
                   cost model (``core/engine.py``)
  "fold_ws_psum" — the weight-stationary formulation that stages every
                   depth fold's partial sums in device memory (the paper's
                   Fig. 5; kept as the comparison for the in-kernel
                   reduction)
  "direct"       — the plain-torch shifted-product reference (grouped via
                   ``groups``)
  "im2col"       — the GEMM baseline the paper argues against (dense only)
  "torch"        — one ``F.conv2d`` call with TF32 off: an oracle, never a
                   default

``default_conv_impl(x)`` is ``"fold_auto"`` for a CUDA tensor and
``"direct"`` for a CPU one (the JAX package's backend rule: the kernels on
the accelerator, the reference on the CPU).

``plan`` pins a pre-solved ``ConvBlockPlan`` (the engine's schedule cache
passes these in).  ``conv1d_causal(x, w, impl=None)`` is the Mamba2
mixer's causal depthwise conv1d (``kernels/conv1d_causal.py``): ``"fold"``
the CUDA kernel, ``"ref"`` the plain version.

Gradients, as in the JAX package's ``custom_vjp``s: ``conv2d``,
``conv2d_fused`` and ``conv1d_causal`` are ``torch.autograd.Function``s
under grad mode, so every impl is trainable and the fold impls still run
the kernels in the forward.  ``conv2d``'s backward is the dense
transposed-conv relations (dx one transposed conv, dw a per-tap
correlation, fp32 sums, TF32 off), or for a grouped conv the reference
conv's own autograd; ``conv2d_fused``'s recomputes the reference chain
(``ref.conv2d_direct`` and ``apply_epilogue``), since the kernel keeps no
pre-activation.  ``conv1d_causal``'s dx is the forward conv of the
time-reversed gradient, through the same impl (the kernel for ``"fold"``),
and its dw one fp32 reduction per tap.  ``conv2d_int8`` has no backward,
as in the JAX package: under grad mode an operand that requires grad
raises.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.epilogue import Epilogue, apply_epilogue
from repro_torch.distributed.dtensor import (is_dtensor, place_like,
                                             replicated_like, run_local)
from repro_torch.kernels import build
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.conv1d_causal import conv1d_causal_folded
from repro_torch.kernels.conv2d_ws import conv2d_folded

__all__ = ["conv2d", "conv2d_fused", "conv2d_int8", "conv1d_causal",
           "default_conv_impl", "FOLD_IMPLS", "IMPLS"]

FOLD_IMPLS = ("fold_ws", "fold_os", "fold_dw", "fold_auto", "fold_ws_psum")
IMPLS = FOLD_IMPLS + ("direct", "im2col", "torch")


def default_conv_impl(x: torch.Tensor) -> str:
    """The fold kernels (cost-model dataflow) for a CUDA tensor, the plain
    reference for a CPU one."""
    return "fold_auto" if x.device.type == "cuda" else "direct"


def _resolve_fold_dataflow(x, w, stride: int, pad: int, impl: str, plan,
                           groups: int = 1):
    """Map a fold impl string to (plan, dataflow) for the fold kernel."""
    if impl == "fold_ws_psum":
        return plan, "weight_stationary_psum"
    if impl == "fold_dw":
        return plan, "depthwise"
    if impl == "fold_auto":
        from repro_torch.core.engine import plan_and_dataflow, select_dataflow
        from repro_torch.core.loopnest import ConvLoopNest
        n, c, xh, xw = x.shape
        nf, _, r, s = w.shape
        cv = ConvLoopNest(n=n, nf=nf, c=c, r=r, s=s, x=xh, y=xw,
                          stride=stride, pad=pad, groups=groups)
        if plan is None:
            return plan_and_dataflow(cv)
        return plan, select_dataflow(cv, plan)
    return plan, ("weight_stationary" if impl == "fold_ws"
                  else "output_stationary")


def _check_impl(impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"unknown conv impl {impl!r} (want one of {IMPLS})")


def _plain(x, w, stride, pad, impl, groups):
    """The conv of a non-fold impl."""
    if impl == "direct":
        return _ref.conv2d_direct(x, w, stride, pad, groups)
    if impl == "torch":
        return _ref.conv2d_torch(x, w, stride, pad, groups)
    return _ref.conv2d_im2col(x, w, stride, pad)


def _folded(x, w, stride, pad, impl, plan, groups, **epilogue_operands):
    plan, dataflow = _resolve_fold_dataflow(x, w, stride, pad, impl, plan,
                                            groups)
    xp = F.pad(x, (pad, pad, pad, pad)) if pad else x
    return conv2d_folded(xp, w, stride=stride, dataflow=dataflow, plan=plan,
                         groups=groups, **epilogue_operands)


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def _conv2d_forward(x, w, stride, pad, impl, plan, groups):
    if impl not in FOLD_IMPLS:
        return _plain(x, w, stride, pad, impl, groups)
    return _folded(x, w, stride, pad, impl, plan, groups)


def _conv2d_grads(x, w, g, stride: int, pad: int, groups: int):
    """(dx, dw) of the conv at (x, w) for the output gradient ``g``: the
    JAX package's ``_conv2d_vjp_bwd``.  Dense: dx is the transposed conv
    of g (fp32, TF32 off), dw the correlation of the padded x with g, one
    fp32 einsum per tap.  Grouped: the reference conv's own autograd."""
    if groups > 1:
        with torch.enable_grad():
            xx = x.detach().requires_grad_(True)
            ww = w.detach().requires_grad_(True)
            y = _ref.conv2d_direct(xx, ww, stride, pad, groups)
            return torch.autograd.grad(y, (xx, ww), g)
    xh, xw_ = x.shape[2], x.shape[3]
    nf, c, r, s = w.shape
    g32 = g.float()
    with _ref.full_fp32():
        dx = F.conv_transpose2d(
            g32, w.float(), stride=stride, padding=pad,
            output_padding=((xh + 2 * pad - r) % stride,
                            (xw_ + 2 * pad - s) % stride))
        xp = F.pad(x.float(), (pad, pad, pad, pad)) if pad else x.float()
        p, q = g.shape[2], g.shape[3]
        dw = torch.empty((nf, c, r, s), dtype=torch.float32,
                         device=x.device)
        for ri in range(r):
            for si in range(s):
                win = xp[:, :, ri:ri + p * stride:stride,
                         si:si + q * stride:stride]
                dw[:, :, ri, si] = torch.einsum("nfpq,ncpq->fc", g32, win)
    return dx[:, :, :xh, :xw_].to(x.dtype), dw.to(w.dtype)


class _Conv2d(torch.autograd.Function):
    """``conv2d`` under autograd: the impl's forward, the transposed-conv
    backward (``_conv2d_grads``)."""

    @staticmethod
    def forward(ctx, x, w, stride, pad, impl, plan, groups):
        ctx.save_for_backward(x, w)
        ctx.args = (stride, pad, groups)
        return _conv2d_forward(x, w, stride, pad, impl, plan, groups)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx, dw = _conv2d_grads(x, w, g, *ctx.args)
        return dx, dw, None, None, None, None, None


def conv2d(x: torch.Tensor, w: torch.Tensor, stride: int = 1, pad: int = 0,
           impl: str = "fold_auto", plan=None,
           groups: int = 1) -> torch.Tensor:
    """Convolution through the fold framework.  x: NCHW, w: OIHW (the
    channel dim is per group, C/groups, when ``groups > 1``).
    Differentiable on every impl (``_Conv2d``)."""
    _check_impl(impl)
    if _needs_grad(x, w):
        return _Conv2d.apply(x, w, stride, pad, impl, plan, groups)
    return _conv2d_forward(x, w, stride, pad, impl, plan, groups)


def _conv2d_fused_forward(x, w, b, scale, shift, residual, stride, pad, epi,
                          impl, plan, groups):
    if impl not in FOLD_IMPLS:
        y = _plain(x, w, stride, pad, impl, groups)
        return apply_epilogue(y, b, epi, residual, scale, shift)
    return _folded(x, w, stride, pad, impl, plan, groups, bias=b,
                   epilogue=epi, residual=residual, scale=scale, shift=shift)


class _Conv2dFused(torch.autograd.Function):
    """``conv2d_fused`` under autograd: the impl's forward, and a backward
    that recomputes the reference chain (``ref.conv2d_direct`` then
    ``apply_epilogue``) and differentiates it, as the JAX package's
    ``_conv2d_fused_vjp_bwd`` does.  An operand passed as None gets no
    gradient."""

    @staticmethod
    def forward(ctx, x, w, b, scale, shift, residual, stride, pad, epi,
                impl, plan, groups):
        ctx.save_for_backward(x, w, b, scale, shift, residual)
        ctx.args = (stride, pad, epi, groups)
        return _conv2d_fused_forward(x, w, b, scale, shift, residual,
                                     stride, pad, epi, impl, plan, groups)

    @staticmethod
    def backward(ctx, g):
        stride, pad, epi, groups = ctx.args
        saved = ctx.saved_tensors
        need = [t is not None and n for t, n in
                zip(saved, ctx.needs_input_grad[:6])]
        with torch.enable_grad():
            ops = [t.detach().requires_grad_(n) if t is not None else None
                   for t, n in zip(saved, need)]
            x, w, b, scale, shift, res = ops
            y = apply_epilogue(_ref.conv2d_direct(x, w, stride, pad, groups),
                               b, epi, res, scale, shift)
            wanted = [t for t, n in zip(ops, need) if n]
            grads = iter(torch.autograd.grad(y, wanted, g))
        return (*(next(grads) if n else None for n in need),
                None, None, None, None, None, None)


def conv2d_fused(x: torch.Tensor, w: torch.Tensor,
                 b: Optional[torch.Tensor] = None, *, stride: int = 1,
                 pad: int = 0, epilogue: Optional[Epilogue] = None,
                 impl: str = "fold_auto", plan=None,
                 residual: Optional[torch.Tensor] = None,
                 scale: Optional[torch.Tensor] = None,
                 shift: Optional[torch.Tensor] = None,
                 groups: int = 1) -> torch.Tensor:
    """Convolution with the epilogue flushed in-kernel.  x: NCHW, w: OIHW
    (per-group channel dim when ``groups > 1``), b: (NF,) per-filter bias
    (required when ``epilogue.bias``), scale/shift: (NF,) folded-BN
    vectors (required when ``epilogue.scale``), residual: (N, NF, P, Q)
    shortcut (required when ``epilogue.residual``).

    On the fold impls the whole conv→bias/BN(→+shortcut)→ReLU[6](→pool)
    chain is one kernel launch and the pre-activation never reaches device
    memory.  Output is (N, NF, P, Q), or (N, NF, P//2, Q//2) when
    ``epilogue.pool`` fuses the 2x2 max-pool.  Differentiable on every
    impl (``_Conv2dFused``: the backward recomputes the reference chain).
    """
    _check_impl(impl)
    epi = epilogue if epilogue is not None else Epilogue(
        bias=b is not None, residual=residual is not None,
        scale=scale is not None)
    if epi.residual != (residual is not None):
        raise ValueError("epilogue.residual and the residual argument must "
                         "be supplied together")
    if epi.scale != (scale is not None and shift is not None):
        raise ValueError("epilogue.scale and the scale/shift arguments "
                         "must be supplied together")
    args = (x, w, b, scale, shift, residual, stride, pad, epi, impl, plan,
            groups)
    if _needs_grad(x, w, b, scale, shift, residual):
        return _Conv2dFused.apply(*args)
    return _conv2d_fused_forward(*args)


def conv2d_int8(x: torch.Tensor, w: torch.Tensor,
                b: Optional[torch.Tensor] = None, *, x_scale: float,
                stride: int = 1, pad: int = 0,
                epilogue: Optional[Epilogue] = None,
                impl: str = "fold_auto", plan=None,
                residual: Optional[torch.Tensor] = None,
                scale: Optional[torch.Tensor] = None,
                shift: Optional[torch.Tensor] = None,
                groups: int = 1) -> torch.Tensor:
    """Int8 convolution with the requantizing epilogue (inference only, as
    in the JAX package: no backward; under grad mode an operand that
    requires grad raises).

    ``x``/``w`` are the fp32 tensors; ``x_scale`` is the calibrated
    per-tensor activation scale (``core/quant.py:quantize_graph``).  The
    weights quantize per output channel from the params of this call, the
    activations with the static ``x_scale`` — before the spatial pad,
    since ``Q(0) == 0`` — and the dequant ``w_scale * x_scale`` folds with
    bias and batch-norm into the flush affine (``requant_affine``), so
    residual / ReLU[6] / pool run in fp32 after it.  The fold impls stream
    int8 blocks through one kernel launch per conv, accumulating in int32;
    every other impl takes the exact int32 reference conv and the same
    epilogue chain (as in the JAX package).  Output is fp32.
    """
    from repro_torch.core.quant import (quantize_act, quantize_weight,
                                        requant_affine, requant_epilogue,
                                        scalar)
    _check_impl(impl)
    build.refuse_grad("conv2d_int8", x, w, b, residual, scale, shift)
    epi = epilogue or Epilogue()
    if epi.bias and b is None:
        raise ValueError("epilogue.bias=True needs a bias vector")
    if epi.scale != (scale is not None and shift is not None):
        raise ValueError("epilogue.scale and the scale/shift arguments "
                         "must be supplied together")
    if epi.residual != (residual is not None):
        raise ValueError("epilogue.residual and the residual argument must "
                         "be supplied together")
    wq, w_scale = quantize_weight(w)
    xq = quantize_act(x, x_scale)
    comb_scale, comb_shift = requant_affine(
        w_scale * scalar(x_scale, x.device), epi, b, scale, shift)
    epi_q = requant_epilogue(epi)
    if impl not in FOLD_IMPLS:
        acc = _ref.conv2d_direct(xq, wq, stride, pad, groups)
        return apply_epilogue(acc.float(), None, epi_q, residual,
                              comb_scale, comb_shift)
    return _folded(xq, wq, stride, pad, impl, plan, groups,
                   epilogue=epi_q, residual=residual, scale=comb_scale,
                   shift=comb_shift)


def _conv1d_forward(x, w, impl: str):
    if impl == "ref":
        return _ref.conv1d_causal_ref(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"conv1d_causal(impl='fold') launches the CUDA "
                         f"kernel and needs a CUDA tensor, got {x.device}")
    return conv1d_causal_folded(x, w)


class _Conv1dCausal(torch.autograd.Function):
    """``conv1d_causal`` under autograd: the JAX package's
    ``_conv1d_vjp_bwd``.  With t' = T-1-t, ``dx[t] = sum_k w[k] g[t+K-1-k]``
    is the causal conv of the time-reversed g, so dx runs through the
    forward of the same impl on ``flip_T(g)`` (the kernel for ``"fold"``:
    its launch count ticks in the backward too), in the JAX backward's
    order and rounding (fp32 sum from 0 over k ascending, one rounding to
    g's type).  dw is one fp32 reduction over (B, T) per tap."""

    @staticmethod
    def forward(ctx, x, w, impl):
        ctx.save_for_backward(x, w)
        ctx.impl = impl
        return _conv1d_forward(x, w, impl)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.flip(_conv1d_forward(torch.flip(g, (1,)), w,
                                            ctx.impl), (1,)).to(x.dtype)
        if ctx.needs_input_grad[1]:
            k, t = w.shape[0], x.shape[1]
            g32 = g.float()
            xp = F.pad(x, (0, 0, k - 1, 0))
            dw = torch.stack([(g32 * xp[:, ki:ki + t].float()).sum((0, 1))
                              for ki in range(k)]).to(w.dtype)
        return dx, dw, None


def conv1d_causal(x: torch.Tensor, w: torch.Tensor,
                  impl: Optional[str] = None) -> torch.Tensor:
    """Depthwise causal conv1d (the Mamba2 mixer's).  x: (B, T, D), w: (K,
    D) -> (B, T, D) in x's type.

    ``impl="fold"`` launches the CUDA kernel (``kernels/conv1d_causal.py``)
    and raises on a tensor that is not on a CUDA device; ``"ref"`` runs the
    plain version (``kernels/ref.py:conv1d_causal_ref``); ``None`` means
    ``"fold"`` on a CUDA tensor and ``"ref"`` on a CPU or ``meta`` one.  On
    a ``DTensor`` (a sharded step's operand) every rank convolves its own
    rows and channels: its local shards go through this same dispatch.
    Differentiable (``_Conv1dCausal``): under ``"fold"`` the backward's dx
    launches the kernel once more."""
    if is_dtensor(x):
        x = place_like(x, x, {0: 0, 2: 2})
        w = place_like(replicated_like(w, x), x, {2: 1})
        return run_local(lambda a, b: conv1d_causal(a, b, impl), x, w,
                         out_placements=[x.placements])
    if impl is None:
        impl = "fold" if x.device.type == "cuda" else "ref"
    if impl not in ("fold", "ref"):
        raise ValueError(f"unknown conv1d impl {impl!r} (want 'fold', 'ref' "
                         "or None)")
    if _needs_grad(x, w):
        return _Conv1dCausal.apply(x, w, impl)
    return _conv1d_forward(x, w, impl)
