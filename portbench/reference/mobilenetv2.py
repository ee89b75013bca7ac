"""MobileNetV2 (Sandler et al., arXiv:1801.04381), plain PyTorch.

A 3x3 stem, then inverted residual blocks from the (t, c, n, s) table: a
1x1 expand conv (left out where t is 1), a 3x3 depthwise conv with the
block's stride and a linear 1x1 project conv, each batch-normalized, ReLU6
after the first two; an identity skip where a block neither strides nor
changes width, and none elsewhere (the paper's Figure 4).  Then a
1x1 head conv with BN and ReLU6, the global average pool and one dense
layer ((in, out) weights, the port's layout).  Batch norm is inference
batch norm with the configuration's epsilon, folded here to a scale and a
shift.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference.common import fp32_math, operand

# the drawn batch-norm statistics, so that folding them is exercised
GAMMA = ("uniform", 0.5, 1.5)
BETA = ("normal", 0.1)
MEAN = ("normal", 0.1)
VAR = ("uniform", 0.5, 1.5)
BIAS_STD = 0.05


def blocks(cfg: dict):
    """(name, cin, cout, stride, t, hidden) for each inverted residual."""
    cin, i = cfg["stem"], 0
    for t, c, n, s in cfg["blocks"]:
        for j in range(n):
            yield f"b{i}", cin, c, (s if j == 0 else 1), t, cin * t
            cin, i = c, i + 1


def _convs(cfg: dict):
    """(name, cin, cout, k, stride, groups, act, residual) in order."""
    yield "stem", 3, cfg["stem"], 3, cfg["stem_stride"], 1, True, False
    for name, cin, cout, stride, t, hid in blocks(cfg):
        if t != 1:
            yield f"{name}_exp", cin, hid, 1, 1, 1, True, False
        yield f"{name}_dw", hid, hid, 3, stride, hid, True, False
        yield (f"{name}_proj", hid, cout, 1, 1, 1, False,
               stride == 1 and cin == cout)
    last = list(blocks(cfg))[-1][2]
    yield "head", last, cfg["head"], 1, 1, 1, True, False


def param_specs(cfg: dict) -> list:
    specs = []
    for name, cin, cout, k, _, groups, act, _ in _convs(cfg):
        fan_in = cin // groups * k * k
        specs.append((name, "w", (cout, cin // groups, k, k),
                      ("normal", math.sqrt((2.0 if act else 1.0) / fan_in))))
        for key, init in (("gamma", GAMMA), ("beta", BETA), ("mean", MEAN),
                          ("var", VAR)):
            specs.append((f"{name}_bn", key, (cout,), init))
    specs.append(("fc", "w", (cfg["head"], cfg["classes"]),
                  ("normal", math.sqrt(1.0 / cfg["head"]))))
    specs.append(("fc", "b", (cfg["classes"],), ("normal", BIAS_STD)))
    return specs


def layers(cfg: dict, batch: int) -> list:
    out, h = [], cfg["img"]
    for name, cin, cout, k, stride, groups, _, res in _convs(cfg):
        pad = 1 if k == 3 else 0
        out.append({"name": name, "kind": "conv", "n": batch, "c": cin,
                    "nf": cout, "r": k, "s": k, "h": h, "w": h,
                    "stride": stride, "pad": pad, "groups": groups,
                    "pool": False, "residual": res, "vectors": 2})
        h = (h + 2 * pad - k) // stride + 1
    out.append({"name": "fc", "kind": "dense", "n": batch,
                "k": cfg["head"], "m": cfg["classes"]})
    return out


def forward(params: dict, x: torch.Tensor, cfg: dict,
            round_tf32: bool = False,
            tf32_paths: bool = False) -> torch.Tensor:
    eps = cfg["bn_eps"]

    def conv_bn(name, x, k, stride, groups, act):
        bn = params[f"{name}_bn"]
        scale = bn["gamma"] / torch.sqrt(bn["var"] + eps)
        shift = bn["beta"] - bn["mean"] * scale
        y = F.conv2d(operand(x, round_tf32),
                     operand(params[name]["w"], round_tf32), stride=stride,
                     padding=1 if k == 3 else 0, groups=groups)
        y = y * scale[None, :, None, None] + shift[None, :, None, None]
        return torch.clamp(y, 0.0, 6.0) if act else y

    with fp32_math(tf32_paths):
        x = conv_bn("stem", x, 3, cfg["stem_stride"], 1, True)
        for name, cin, cout, stride, t, hid in blocks(cfg):
            h = conv_bn(f"{name}_exp", x, 1, 1, 1, True) if t != 1 else x
            h = conv_bn(f"{name}_dw", h, 3, stride, hid, True)
            h = conv_bn(f"{name}_proj", h, 1, 1, 1, False)
            x = x + h if stride == 1 and cin == cout else h
        x = conv_bn("head", x, 1, 1, 1, True)
        x = x.mean(dim=(2, 3))
        x = operand(x, round_tf32) @ operand(params["fc"]["w"], round_tf32) \
            + params["fc"]["b"]
    return x
