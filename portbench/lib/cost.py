"""Operations, bytes and roofline bounds of the layers a reference lists,
and the chip's peaks.

The arithmetic is ``repro_torch/core/loopnest.py``'s (``macs``, ``flops``,
``tensor_sizes``) kept here, so that the yardstick does not move with the
program.  A bound is ``max(flops / peak, bytes / bandwidth)``, each input
byte read once and each output byte written once.
"""
from __future__ import annotations

from typing import Optional

# Published peaks of one card (NVIDIA's data sheet, SXM part), by the
# name ``torch.cuda.get_device_name`` gives, for the precisions that
# configurations state.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"fp32": 67e12, "bytes_per_s": 3.35e12},
}
ELEMENT_BYTES = {"fp32": 4}


def out_dim(size: int, k: int, stride: int, pad: int) -> int:
    return (size + 2 * pad - k) // stride + 1


def layer_flops(layer: dict) -> int:
    """2 x multiply-accumulates of one conv or dense layer."""
    if layer["kind"] == "dense":
        return 2 * layer["n"] * layer["k"] * layer["m"]
    p = out_dim(layer["h"], layer["r"], layer["stride"], layer["pad"])
    q = out_dim(layer["w"], layer["s"], layer["stride"], layer["pad"])
    return (2 * layer["n"] * layer["nf"] * (layer["c"] // layer["groups"])
            * layer["r"] * layer["s"] * p * q)


def layer_bytes(layer: dict, precision: str) -> int:
    """Input, weights, per-channel vectors, residual and output, each
    once; a fused 2x2 pool writes the pooled output."""
    e = ELEMENT_BYTES[precision]
    if layer["kind"] == "dense":
        n, k, m = layer["n"], layer["k"], layer["m"]
        return e * (n * k + k * m + m + n * m)
    n, c, nf = layer["n"], layer["c"], layer["nf"]
    p = out_dim(layer["h"], layer["r"], layer["stride"], layer["pad"])
    q = out_dim(layer["w"], layer["s"], layer["stride"], layer["pad"])
    out = n * nf * p * q
    if layer["pool"]:
        out = n * nf * (p // 2) * (q // 2)
    res = n * nf * p * q if layer["residual"] else 0
    weights = nf * (c // layer["groups"]) * layer["r"] * layer["s"]
    return (e * (n * c * layer["h"] * layer["w"] + weights + out + res)
            + 4 * nf * layer["vectors"])


def peak(kind: str, precision: str) -> Optional[float]:
    """FLOP/s of the card at ``precision``, or None for a card not in
    the table."""
    return PEAKS.get(kind, {}).get(precision)


def bound_s(layer: dict, precision: str, kind: str) -> Optional[float]:
    """The least time the card could take for the layer."""
    table = PEAKS.get(kind)
    if table is None or precision not in table:
        return None
    return max(layer_flops(layer) / table[precision],
               layer_bytes(layer, precision) / table["bytes_per_s"])


def flops_per_image(layers_b1: list) -> int:
    return sum(layer_flops(layer) for layer in layers_b1)
