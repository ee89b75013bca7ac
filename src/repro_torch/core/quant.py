"""Int8 quantization scheme for fold streaming (the JAX package's
``core/quant.py``, in torch).

The paper's argument is that fold throughput is bounded by the bytes moved
per fold, so the biggest lever left is streaming the weight and
activation blocks at one byte per element instead of four.  This module
owns the scheme; the kernels (``kernels/conv2d_ws.py``), the engine
(``core/engine.py``) and its traffic model consume it:

* **Weights** — symmetric per-output-channel scales (axis 0 of OIHW):
  ``w[o] ~= w_q[o] * w_scale[o]`` with ``w_q`` int8 in [-127, 127].
* **Activations** — per-tensor scales from a calibration pass
  (``quantize_graph``): the fp32 reference forward runs over a small
  batch and each conv records the max |x| reaching it.  ``Q(0) == 0``, so
  convs quantize *before* spatial padding.
* **Accumulation** — int8 x int8 products accumulate in int32;
  ``int32_accumulator_bound`` gives the worst case ``127 * 127 * (C/G) *
  R * S``.
* **Requantization** — the dequant scale ``dq[o] = w_scale[o] *
  x_scale`` folds into the epilogue's scale/shift slot: with the fp32
  flush order ``(acc + bias) * bn_scale + bn_shift`` the int8 flush is
  the single affine ``acc * (dq * bn_scale) + (bias * bn_scale +
  bn_shift)`` (``requant_affine``), after which residual / ReLU / ReLU6 /
  pool run unchanged in fp32.

The arithmetic is the JAX package's, step for step: fp32 scales, round
half to even, clip to ±127.  Every division of an fp32 tensor by a scale
divides by a 0-dim fp32 tensor on the same device (``_div``): on a CUDA
tensor PyTorch turns a division by a python number into a multiplication
by its reciprocal, which can differ in the last bit.  The 0-dim tensor is
filled on the device (``scalar``), not copied from the host, so a forward
can be captured as a CUDA graph.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core.epilogue import Epilogue, apply_epilogue, maxpool2x2
from repro_torch.core.graph import (DEPTHWISE, GraphError, as_graph,
                                    bn_scale_shift)

__all__ = [
    "PRECISIONS",
    "INT8_QMAX",
    "INT32_ACC_MAX",
    "check_precision",
    "scalar",
    "quantize_int8",
    "dequantize_int8",
    "weight_scales",
    "quantize_weight",
    "act_scale",
    "quantize_act",
    "requant_epilogue",
    "requant_affine",
    "int32_accumulator_bound",
    "QuantRecipe",
    "quantize_graph",
    "default_calib_batch",
    "default_recipe",
]

PRECISIONS = ("fp32", "int8")
INT8_QMAX = 127.0
INT32_ACC_MAX = 2 ** 31 - 1


def check_precision(precision: str) -> str:
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r} "
                         f"(want one of {PRECISIONS})")
    return precision


def scalar(v: float, device) -> torch.Tensor:
    """``v`` rounded to fp32, as a 0-dim tensor filled on ``device``."""
    return torch.full((), v, dtype=torch.float32, device=device)


def _div(x: torch.Tensor, s) -> torch.Tensor:
    """``x / s`` in fp32 with a true division (``s`` a number or tensor)."""
    return x / (s if isinstance(s, torch.Tensor) else scalar(s, x.device))


def _to_int8(v: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(v), -INT8_QMAX, INT8_QMAX).to(torch.int8)


# --------------------------------------------------------------------------
# Scalar / tensor quantizers
# --------------------------------------------------------------------------

def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8: ``x ~= q * scale`` with q in [-127, 127].
    Returns ``(q, scale)``; the scale is a 0-dim fp32 tensor."""
    x32 = x.float()
    scale = _div(torch.max(torch.abs(x32)) + 1e-12, INT8_QMAX)
    return _to_int8(_div(x32, scale)), scale


def dequantize_int8(q: torch.Tensor, scale,
                    dtype=torch.float32) -> torch.Tensor:
    """Invert ``quantize_int8`` up to its rounding error (at most
    ``scale / 2`` elementwise)."""
    return (q.float() * scale).to(dtype)


def weight_scales(w: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Symmetric per-output-channel scales of an OIHW weight tensor: one
    fp32 scale per filter, ``amax / 127`` over the filter's own taps."""
    dims = tuple(i for i in range(w.ndim) if i != axis)
    amax = torch.amax(torch.abs(w.float()), dim=dims)
    return _div(amax, INT8_QMAX) + 1e-12


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8 weights: ``(w_q, w_scale)``, w_q
    int8 OIHW and w_scale an (NF,) fp32 vector."""
    scale = weight_scales(w)
    shape = (-1,) + (1,) * (w.ndim - 1)
    return _to_int8(w.float() / scale.reshape(shape)), scale


def act_scale(x: torch.Tensor) -> float:
    """Per-tensor activation scale of a calibration tensor (max |x| over
    the whole batch) as a python float: activation scales are constants
    baked into the lowered network."""
    return float(torch.max(torch.abs(x.float()))) / INT8_QMAX + 1e-12


def quantize_act(x: torch.Tensor, scale) -> torch.Tensor:
    """Quantize an activation tensor with a calibrated per-tensor scale;
    values outside the calibrated range saturate at ±127."""
    return _to_int8(_div(x.float(), scale))


# --------------------------------------------------------------------------
# Epilogue requantization
# --------------------------------------------------------------------------

def requant_epilogue(epi: Optional[Epilogue]) -> Epilogue:
    """The epilogue the int8 kernel flushes: dequant rides the scale/shift
    affine slot and the bias folds into it (``requant_affine``), so
    ``bias`` is always off and ``scale`` always on.  Residual / ReLU /
    ReLU6 / pool pass through unchanged."""
    epi = epi or Epilogue()
    return dataclasses.replace(epi, bias=False, scale=True)


def requant_affine(dq: torch.Tensor, epi: Optional[Epilogue],
                   bias: Optional[torch.Tensor],
                   bn_scale: Optional[torch.Tensor],
                   bn_shift: Optional[torch.Tensor]
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold dequant + bias + BN into one flush-time affine:
    ``acc * (dq * bn_scale) + (bias * bn_scale + bn_shift)``.  ``dq`` is
    the (NF,) combined dequant vector (``w_scale * x_scale``)."""
    epi = epi or Epilogue()
    dq = dq.float()
    scale = dq * bn_scale.float() if epi.scale else dq
    shift = torch.zeros_like(dq)
    if epi.bias:
        b32 = bias.float()
        shift = b32 * bn_scale.float() if epi.scale else b32
    if epi.scale:
        shift = shift + bn_shift.float()
    return scale, shift


def int32_accumulator_bound(cg: int, r: int, s: int) -> int:
    """Worst-case |int32 accumulator| of one output element: ``C/G * R * S``
    products of magnitude at most ``127 * 127``.  At VGG's deepest nest,
    512*3*3 * 16129 ~= 7.4e7, three decimal orders below 2^31."""
    return int(INT8_QMAX) * int(INT8_QMAX) * int(cg) * int(r) * int(s)


# --------------------------------------------------------------------------
# Graph calibration pass
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class QuantRecipe:
    """Per-conv-node scales produced by ``quantize_graph``.

    ``act_scales`` maps conv node name -> per-tensor input-activation
    scale (a python float, a constant of the lowered network).
    ``w_scales`` maps conv node name -> the (NF,) per-output-channel weight
    scales, kept for reporting; the lowering recomputes them from the live
    params."""
    act_scales: Dict[str, float]
    w_scales: Dict[str, Any]

    def scale_for(self, node_name: str) -> float:
        try:
            return self.act_scales[node_name]
        except KeyError:
            raise GraphError(
                f"{node_name}: no calibrated activation scale — the "
                "QuantRecipe was built for a different graph "
                "(re-run quantize_graph)") from None


def default_calib_batch(input_shape: Tuple[int, ...], batch: int = 4,
                        device: Any = "cuda") -> torch.Tensor:
    """A deterministic calibration batch: standard-normal images, at most
    ``batch`` of them, from ``torch.Generator().manual_seed(0)`` on the
    CPU, then moved to ``device``.  The JAX package draws from
    ``PRNGKey(0)``, which torch cannot reproduce: the two packages
    calibrate on different images unless the caller hands both the same
    batch or recipe."""
    n = max(1, min(int(input_shape[0]), batch))
    shape = (n,) + tuple(int(d) for d in input_shape[1:])
    gen = torch.Generator().manual_seed(0)
    return torch.randn(shape, generator=gen, dtype=torch.float32).to(device)


def default_recipe(graph, params: Dict[str, Any],
                   input_shape: Tuple[int, ...],
                   device: Any = "cuda") -> QuantRecipe:
    """The recipe ``compile_network(precision="int8")`` and
    ``BucketCompiler`` calibrate when the caller supplies none:
    ``quantize_graph`` on four ``default_calib_batch`` images of the
    input's (C, H, W), whatever the batch width, so a direct compile at
    batch 1 bakes in the scales a serving engine does."""
    return quantize_graph(graph, params, default_calib_batch(
        (4,) + tuple(input_shape[1:]), device=device))


def quantize_graph(graph, params: Dict[str, Any],
                   calib_batch: torch.Tensor) -> QuantRecipe:
    """Calibration pass over a ``StreamGraph``: run the fp32 reference
    forward on ``calib_batch`` and record, per conv node, the input
    activation's scale and the per-output-channel weight scales.

    Runs on the pre-fusion graph the models export (fusion keeps the conv
    node names, so the recipe's keys match the fused lowering), with the
    plain-torch ``conv2d_direct``: no kernel, no schedule cache."""
    from repro_torch.kernels.ref import conv2d_direct
    g = as_graph(graph)
    env: Dict[str, torch.Tensor] = {g.input: calib_batch}
    act_scales: Dict[str, float] = {}
    w_scales: Dict[str, Any] = {}
    with torch.inference_mode():
        for nd in g.nodes:
            srcs = [env[i] for i in nd.all_inputs()]
            x = srcs[0]
            if nd.op == "conv":
                w = params[nd.param]["w"]
                groups = x.shape[1] if nd.groups == DEPTHWISE else nd.groups
                act_scales[nd.name] = act_scale(x)
                w_scales[nd.name] = weight_scales(w)
                y = conv2d_direct(x, w, nd.stride, nd.pad, groups)
                if nd.epilogue is not None:
                    epi = nd.epilogue
                    if epi.pool and (y.shape[2] < 2 or y.shape[3] < 2):
                        epi = dataclasses.replace(epi, pool=None)
                    b = params[nd.param]["b"] if epi.bias else None
                    scale = shift = None
                    if epi.scale:
                        scale, shift = bn_scale_shift(params[nd.bn_param])
                    res = env[nd.residual] if epi.residual else None
                    y = apply_epilogue(y, b, epi, res, scale, shift)
                env[nd.name] = y
            elif nd.op == "bias":
                env[nd.name] = x + params[nd.param]["b"][None, :, None, None]
            elif nd.op == "batchnorm":
                scale, shift = bn_scale_shift(params[nd.param])
                env[nd.name] = (x * scale[None, :, None, None]
                                + shift[None, :, None, None])
            elif nd.op == "relu":
                env[nd.name] = torch.relu(x)
            elif nd.op == "relu6":
                env[nd.name] = torch.clamp(x, 0.0, 6.0)
            elif nd.op == "global_avgpool":
                env[nd.name] = x.mean(dim=(2, 3), keepdim=True)
            elif nd.op == "maxpool2":
                env[nd.name] = maxpool2x2(x)
            elif nd.op == "residual_add":
                env[nd.name] = srcs[0] + srcs[1]
            elif nd.op == "flatten":
                env[nd.name] = x.reshape(x.shape[0], -1)
            elif nd.op == "dense":
                # no scale is taken from a dense output: scales are read at
                # conv inputs, which are NCHW, and nothing turns a dense
                # layer's (N, K) output back into an image
                pd = params[nd.param]
                env[nd.name] = torch.matmul(x, pd["w"]) + pd["b"]
            else:  # pragma: no cover — StreamGraph construction validates ops
                raise GraphError(f"{nd.name}: cannot calibrate op {nd.op!r}")
    return QuantRecipe(act_scales=act_scales, w_scales=w_scales)
