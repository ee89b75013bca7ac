"""ResNet-18 — the second conv model through the streaming-graph IR.

Where VGG-16 is the paper's evaluation model, ResNet-18 is the shape the
engine must generalize to: residual skip edges, stride-2 convs and 1x1
downsample projections exercise ``ScheduleKey`` beyond the 3x3/stride-1
geometry, and every residual block's ``relu(conv(x) + b + shortcut)``
tail fuses into the conv's single kernel launch via
``Epilogue(residual=True)``.

The default is CIFAR-scale: a 3x3 stride-1 stem (no 7x7/pool), four
stages of two basic blocks at widths 64/128/256/512 x ``width_mult``,
stages 2-4 opening with a stride-2 block whose shortcut is a 1x1 stride-2
projection, and a flatten + single fc classifier.  Blocks are conv+bias
(no batch-norm), as in the JAX package.

``to_graph`` exports the ``StreamGraph``; ``forward`` is the graph-free
per-layer reference used as the test oracle.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from repro_torch.core.engine import BucketCompiler, CompiledNetwork
from repro_torch.core.graph import StreamGraph
from repro_torch.core.loopnest import conv_output_dim
from repro_torch.kernels.ops import conv2d
from repro_torch.models.common import cast, normal, width, zeros

__all__ = ["RESNET18_STAGES", "block_specs", "n_convs", "init_params",
           "forward", "to_graph", "compile_forward", "bucket_compiler",
           "n_classes"]

# (basic blocks, base width, first-block stride) per stage — ResNet-18 is
# (2, 2, 2, 2) basic blocks; stages 2-4 downsample by 2.
RESNET18_STAGES: Tuple[Tuple[int, int, int], ...] = (
    (2, 64, 1), (2, 128, 2), (2, 256, 2), (2, 512, 2))
n_classes = 10          # CIFAR-scale default


def block_specs(width_mult: float = 1.0
                ) -> List[Tuple[str, int, int, int, bool]]:
    """The basic-block list: (name, cin, cout, stride, has_downsample).

    A block downsamples when it strides or changes width — its shortcut
    is then a 1x1 projection conv with the same stride.  The structure is
    width-independent; only the channel counts scale with ``width_mult``.
    """
    specs = []
    cin = width(64, width_mult)                # stem output
    for si, (blocks, base, stride0) in enumerate(RESNET18_STAGES, start=1):
        cout = width(base, width_mult)
        for bi in range(blocks):
            stride = stride0 if bi == 0 else 1
            down = stride != 1 or cin != cout
            specs.append((f"s{si}b{bi}", cin, cout, stride, down))
            cin = cout
    return specs


def n_convs() -> int:
    """Conv count (kernel launches when fused): stem + 2 per block + 1 per
    downsample projection — 20 for ResNet-18."""
    return 1 + sum(2 + down for _, _, _, _, down in block_specs())


def _final_hw(img: int) -> int:
    h = img                                    # stem is stride 1
    for _, _, _, stride, _ in block_specs():
        h = conv_output_dim(h, 3, stride, 1)   # c1 carries the stride
    return h


def init_params(generator: torch.Generator, *, width_mult: float = 1.0,
                img: int = 32, classes: int = n_classes,
                device: Any = "cuda",
                dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """Random ResNet-18 parameters drawn with ``generator`` (on the
    generator's device), placed on ``device``.  Biases are zeros."""
    def conv_entry(cout: int, cin: int, k: int) -> Dict[str, Any]:
        return {"w": normal(generator, (cout, cin, k, k), device),
                "b": zeros(cout, device)}

    p: Dict[str, Any] = {"stem": conv_entry(width(64, width_mult), 3, 3)}
    for name, cin, cout, _, down in block_specs(width_mult):
        p[f"{name}_c1"] = conv_entry(cout, cin, 3)
        p[f"{name}_c2"] = conv_entry(cout, cout, 3)
        if down:
            p[f"{name}_down"] = conv_entry(cout, cin, 1)
    feat = _final_hw(img)
    last = block_specs(width_mult)[-1][2]
    p["fc"] = {"w": normal(generator, (last * feat * feat, classes), device),
               "b": zeros(classes, device)}
    return cast(p, dtype)


def to_graph() -> StreamGraph:
    """Export ResNet-18 as a streaming graph.  Skip edges are explicit
    ``residual_add`` inputs; after ``fuse_graph`` each block is exactly
    two fused convs (c1: bias+relu; c2: bias+residual+relu) plus, on
    downsample blocks, the fused 1x1 projection (bias)."""
    g = StreamGraph(name="resnet18")
    g.conv("stem", param="stem")
    g.bias()
    g.relu()
    prev = g.output
    for name, _, _, stride, down in block_specs():
        g.conv(f"{name}_c1", src=prev, stride=stride, pad=1)
        g.bias()
        g.relu()
        g.conv(f"{name}_c2", pad=1)
        g.bias()
        main = g.output
        if down:
            g.conv(f"{name}_down", src=prev, stride=stride, pad=0)
            g.bias()
            skip = g.output
        else:
            skip = prev
        g.residual_add(f"{name}_add", main, skip)
        g.relu(f"{name}_out")
        prev = g.output
    g.flatten()
    g.dense("fc")
    return g


def forward(params: Dict[str, Any], x: torch.Tensor,
            impl: str = "direct") -> torch.Tensor:
    """Graph-free per-layer reference walk (the test oracle): x is
    (N, 3, H, W) NCHW -> (N, classes) logits.  ``impl`` selects the conv
    implementation exactly as in ``kernels/ops.conv2d``."""

    def conv_bias(name, x, stride, pad, relu):
        y = conv2d(x, params[name]["w"], stride=stride, pad=pad, impl=impl)
        y = y + params[name]["b"][None, :, None, None]
        return torch.relu(y) if relu else y

    x = conv_bias("stem", x, 1, 1, True)
    for name, _, _, stride, down in block_specs():
        h = conv_bias(f"{name}_c1", x, stride, 1, True)
        h = conv_bias(f"{name}_c2", h, 1, 1, False)
        sc = conv_bias(f"{name}_down", x, stride, 0, False) if down else x
        x = torch.relu(h + sc)
    x = x.reshape(x.shape[0], -1)
    return x @ params["fc"]["w"] + params["fc"]["b"]


def compile_forward(params: Dict[str, Any], *, img: int,
                    **compile_kw) -> CompiledNetwork:
    """Compile the whole ResNet-18 trunk+head into a static fold schedule
    through the shared graph lowering (``models/zoo.py:compile_forward``)
    — 20 convs collapse to 11 filter-fold geometries at any uniform
    width."""
    from repro_torch.models import zoo
    return zoo.compile_forward("resnet18", params, img=img, **compile_kw)


def bucket_compiler(params: Dict[str, Any], *, img: int,
                    **compile_kw) -> BucketCompiler:
    """Serving compile surface: one memoized compiled forward per batch
    bucket over one shared ``ScheduleCache``."""
    from repro_torch.models import zoo
    return zoo.bucket_compiler("resnet18", params, img=img, **compile_kw)
