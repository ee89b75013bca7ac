"""Public conv entry points over the fold kernels (forward only; fp32 and
bf16, and int8 through ``conv2d_int8``).

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

``plan`` pins a pre-solved ``ConvBlockPlan`` (the engine's schedule cache
passes these in).  ``conv1d_causal(x, w, impl=None)`` is the Mamba2
mixer's causal depthwise conv1d (``kernels/conv1d_causal.py``): ``"fold"``
the CUDA kernel, ``"ref"`` the plain version.  The backward passes wait
for the training slice (ROADMAP queue A item 4d).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.epilogue import Epilogue, apply_epilogue
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.conv1d_causal import conv1d_causal_folded
from repro_torch.kernels.conv2d_ws import conv2d_folded

__all__ = ["conv2d", "conv2d_fused", "conv2d_int8", "conv1d_causal",
           "FOLD_IMPLS", "IMPLS"]

FOLD_IMPLS = ("fold_ws", "fold_os", "fold_dw", "fold_auto", "fold_ws_psum")
IMPLS = FOLD_IMPLS + ("direct",)


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


def _folded(x, w, stride, pad, impl, plan, groups, **epilogue_operands):
    plan, dataflow = _resolve_fold_dataflow(x, w, stride, pad, impl, plan,
                                            groups)
    xp = F.pad(x, (pad, pad, pad, pad)) if pad else x
    return conv2d_folded(xp, w, stride=stride, dataflow=dataflow, plan=plan,
                         groups=groups, **epilogue_operands)


def conv2d(x: torch.Tensor, w: torch.Tensor, stride: int = 1, pad: int = 0,
           impl: str = "fold_auto", plan=None,
           groups: int = 1) -> torch.Tensor:
    """Convolution through the fold framework.  x: NCHW, w: OIHW (the
    channel dim is per group, C/groups, when ``groups > 1``)."""
    _check_impl(impl)
    if impl == "direct":
        return _ref.conv2d_direct(x, w, stride, pad, groups)
    return _folded(x, w, stride, pad, impl, plan, groups)


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
    ``epilogue.pool`` fuses the 2x2 max-pool.
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
    if impl == "direct":
        y = _ref.conv2d_direct(x, w, stride, pad, groups)
        return apply_epilogue(y, b, epi, residual, scale, shift)
    return _folded(x, w, stride, pad, impl, plan, groups, bias=b,
                   epilogue=epi, residual=residual, scale=scale, shift=shift)


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
    in the JAX package: no autograd).

    ``x``/``w`` are the fp32 tensors; ``x_scale`` is the calibrated
    per-tensor activation scale (``core/quant.py:quantize_graph``).  The
    weights quantize per output channel from the params of this call, the
    activations with the static ``x_scale`` — before the spatial pad,
    since ``Q(0) == 0`` — and the dequant ``w_scale * x_scale`` folds with
    bias and batch-norm into the flush affine (``requant_affine``), so
    residual / ReLU[6] / pool run in fp32 after it.  The fold impls stream
    int8 blocks through one kernel launch per conv, accumulating in int32;
    ``"direct"`` takes the exact int32 reference conv and the same
    epilogue chain.  Output is fp32.
    """
    from repro_torch.core.quant import (quantize_act, quantize_weight,
                                        requant_affine, requant_epilogue,
                                        scalar)
    _check_impl(impl)
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
    if impl == "direct":
        acc = _ref.conv2d_direct(xq, wq, stride, pad, groups)
        return apply_epilogue(acc.float(), None, epi_q, residual,
                              comb_scale, comb_shift)
    return _folded(xq, wq, stride, pad, impl, plan, groups,
                   epilogue=epi_q, residual=residual, scale=comb_scale,
                   shift=comb_shift)


def conv1d_causal(x: torch.Tensor, w: torch.Tensor,
                  impl: Optional[str] = None) -> torch.Tensor:
    """Depthwise causal conv1d (the Mamba2 mixer's).  x: (B, T, D), w: (K,
    D) -> (B, T, D) in x's type.  Forward only.

    ``impl="fold"`` launches the CUDA kernel (``kernels/conv1d_causal.py``)
    and raises on a tensor that is not on a CUDA device; ``"ref"`` runs the
    plain version (``kernels/ref.py:conv1d_causal_ref``); ``None`` means
    ``"fold"`` on a CUDA tensor and ``"ref"`` on a CPU one."""
    if impl is None:
        impl = "fold" if x.device.type == "cuda" else "ref"
    if impl == "ref":
        return _ref.conv1d_causal_ref(x, w)
    if impl != "fold":
        raise ValueError(f"unknown conv1d impl {impl!r} (want 'fold', 'ref' "
                         "or None)")
    if x.device.type != "cuda":
        raise ValueError(f"conv1d_causal(impl='fold') launches the CUDA "
                         f"kernel and needs a CUDA tensor, got {x.device}")
    return conv1d_causal_folded(x, w)
