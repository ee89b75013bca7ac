"""VGG (Simonyan & Zisserman, arXiv:1409.1556), plain PyTorch.

The configuration lists the 3x3 convolutions (padding 1, each followed by
ReLU) and the 2x2 max pools ("M"), then the fully connected layers, each
but the last followed by ReLU.  Dense weights are (in, out), the port's
layout; the flatten is of NCHW.  Dropout is an identity at inference.
"""
from __future__ import annotations

import math
from typing import List

import torch
import torch.nn.functional as F

from portbench.reference.common import fp32_math, operand

BIAS_STD = 0.05       # biases drawn, not zero, so the bias epilogue counts


def _blocks(cfg: dict):
    """(entry, followed by a pool) for each conv entry of the config."""
    layers = cfg["layers"]
    for i, entry in enumerate(layers):
        if entry != "M":
            yield entry, i + 1 < len(layers) and layers[i + 1] == "M"


def _dense_dims(cfg: dict) -> List[int]:
    pools = sum(1 for e in cfg["layers"] if e == "M")
    last = [e for e in cfg["layers"] if e != "M"][-1][2]
    feat = cfg["img"] // 2 ** pools
    return [last * feat * feat, *cfg["fc"], cfg["classes"]]


def param_specs(cfg: dict) -> list:
    """(name, key, shape, init): He-normal weights for the layers that
    ReLU follows, 1/fan-in variance for the last, normal biases."""
    specs = []
    for (name, cin, cout), _ in _blocks(cfg):
        specs.append((name, "w", (cout, cin, 3, 3),
                      ("normal", math.sqrt(2.0 / (cin * 9)))))
        specs.append((name, "b", (cout,), ("normal", BIAS_STD)))
    dims = _dense_dims(cfg)
    for i in range(len(dims) - 1):
        gain = 2.0 if i + 2 < len(dims) else 1.0
        specs.append((f"fc{i + 1}", "w", (dims[i], dims[i + 1]),
                      ("normal", math.sqrt(gain / dims[i]))))
        specs.append((f"fc{i + 1}", "b", (dims[i + 1],),
                      ("normal", BIAS_STD)))
    return specs


def layers(cfg: dict, batch: int) -> list:
    """Each conv and dense layer's geometry at ``batch`` rows."""
    out, h = [], cfg["img"]
    for (name, cin, cout), pool in _blocks(cfg):
        out.append({"name": name, "kind": "conv", "n": batch, "c": cin,
                    "nf": cout, "r": 3, "s": 3, "h": h, "w": h,
                    "stride": 1, "pad": 1, "groups": 1, "pool": pool,
                    "residual": False, "vectors": 1})
        if pool:
            h //= 2
    dims = _dense_dims(cfg)
    for i in range(len(dims) - 1):
        out.append({"name": f"fc{i + 1}", "kind": "dense", "n": batch,
                    "k": dims[i], "m": dims[i + 1]})
    return out


def forward(params: dict, x: torch.Tensor, cfg: dict,
            round_tf32: bool = False,
            tf32_paths: bool = False) -> torch.Tensor:
    """(N, 3, img, img) -> (N, classes) logits in fp32.  The control:
    ``round_tf32`` rounds every conv and matmul operand to TF32,
    ``tf32_paths`` runs cuDNN and cuBLAS on their TF32 paths."""
    with fp32_math(tf32_paths):
        for entry in cfg["layers"]:
            if entry == "M":
                x = F.max_pool2d(x, 2)
                continue
            p = params[entry[0]]
            x = F.relu(F.conv2d(operand(x, round_tf32),
                                operand(p["w"], round_tf32), p["b"],
                                padding=1))
        x = x.reshape(x.shape[0], -1)
        n_fc = len(cfg["fc"]) + 1
        for i in range(n_fc):
            p = params[f"fc{i + 1}"]
            x = operand(x, round_tf32) @ operand(p["w"], round_tf32) + p["b"]
            if i + 1 < n_fc:
                x = F.relu(x)
    return x
