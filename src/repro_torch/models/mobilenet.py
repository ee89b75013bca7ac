"""MobileNetV2 — the grouped/depthwise stress test for the fold engine.

Every inverted residual block is a 1x1 **expand** conv, a 3x3
**depthwise** conv (the groups == C fold geometry with no depth reduction
at all), and a 1x1 linear **project** conv, all batch-normalized,
activations ReLU6, with a residual skip when the block neither strides
nor changes width.  After ``fuse_graph`` each block is exactly three
fused kernel launches (two when the expand ratio is 1): expand =
conv+BN+ReLU6 and project = conv+BN(+residual) on the WS / OS kernels,
depthwise = dw-conv+BN+ReLU6 on the depthwise kernel.  Batch-norm folds
to the epilogue's scale/shift (``core/graph.py:bn_scale_shift``), so no
standalone BN, ReLU6 or add op survives in the fused forward.

The default is CIFAR-scale, as in the JAX package: 3x3 stride-1 stem, the
standard (t, c, n, s) table with the first two downsamples removed (32px
in, 4px at the head), global average pool and a single fc classifier.
``forward`` is the graph-free reference walk used as the test oracle;
``to_graph`` exports the ``StreamGraph`` the engine lowers.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from repro_torch.core.engine import BucketCompiler, CompiledNetwork
from repro_torch.core.graph import StreamGraph, bn_scale_shift
from repro_torch.kernels.ops import conv2d
from repro_torch.models.common import cast, normal, ones, width, zeros

__all__ = ["INVERTED_RESIDUAL_CFG", "block_specs", "n_convs",
           "n_residual_adds", "init_params", "forward", "to_graph",
           "compile_forward", "bucket_compiler", "n_classes"]

# (expand ratio t, output channels c, repeats n, first-block stride s) —
# the MobileNetV2 table with the stem and stage-2 strides dropped to 1
# (CIFAR inputs are 32px; three downsamples remain: 32 -> 16 -> 8 -> 4).
INVERTED_RESIDUAL_CFG: Tuple[Tuple[int, int, int, int], ...] = (
    (1, 16, 1, 1), (6, 24, 2, 1), (6, 32, 3, 2), (6, 64, 4, 2),
    (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1))
STEM_CH, HEAD_CH = 32, 1280
n_classes = 10          # CIFAR-scale default


def block_specs(width_mult: float = 1.0
                ) -> List[Tuple[str, int, int, int, int, int]]:
    """The inverted-residual block list:
    (name, cin, cout, stride, expand_t, hidden).

    ``hidden = cin * t`` is the expanded width the depthwise conv runs at
    (its group count).  A block carries a residual skip iff it neither
    strides nor changes width — the structure is width-independent."""
    specs = []
    cin = width(STEM_CH, width_mult)
    bi = 0
    for t, c, n, s in INVERTED_RESIDUAL_CFG:
        cout = width(c, width_mult)
        for i in range(n):
            stride = s if i == 0 else 1
            specs.append((f"b{bi}", cin, cout, stride, t, cin * t))
            cin = cout
            bi += 1
    return specs


def n_convs() -> int:
    """Conv count (= fused kernel launches): stem + head + 3 per block (2
    when t == 1) — 52 for the default table."""
    return 2 + sum(2 + (t != 1) for _, _, _, _, t, _ in block_specs())


def n_residual_adds() -> int:
    """Blocks with an identity skip (stride 1, cin == cout) — their adds
    all flush inside the project conv's kernel when fused."""
    return sum(1 for _, cin, cout, stride, _, _ in block_specs()
               if stride == 1 and cin == cout)


def init_params(generator: torch.Generator, *, width_mult: float = 1.0,
                img: int = 32, classes: int = n_classes,
                device: Any = "cuda",
                dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """Random MobileNetV2 parameters drawn with ``generator`` (on the
    generator's device), placed on ``device``.  Convs carry no bias
    (batch-norm's shift is the additive term); batch-norm entries hold
    identity statistics {gamma, beta, mean, var}, as at init in the JAX
    package."""
    def conv_entry(cout: int, cin: int, k: int) -> Dict[str, Any]:
        return {"w": normal(generator, (cout, cin, k, k), device)}

    def bn_entry(cout: int) -> Dict[str, Any]:
        return {"gamma": ones(cout, device), "beta": zeros(cout, device),
                "mean": zeros(cout, device), "var": ones(cout, device)}

    stem = width(STEM_CH, width_mult)
    p: Dict[str, Any] = {"stem": conv_entry(stem, 3, 3),
                         "stem_bn": bn_entry(stem)}
    for name, cin, cout, _, t, hidden in block_specs(width_mult):
        if t != 1:
            p[f"{name}_exp"] = conv_entry(hidden, cin, 1)
            p[f"{name}_exp_bn"] = bn_entry(hidden)
        p[f"{name}_dw"] = conv_entry(hidden, 1, 3)       # (C, 1, R, S)
        p[f"{name}_dw_bn"] = bn_entry(hidden)
        p[f"{name}_proj"] = conv_entry(cout, hidden, 1)
        p[f"{name}_proj_bn"] = bn_entry(cout)
    head = max(width(HEAD_CH, width_mult), 8)
    last = block_specs(width_mult)[-1][2]
    p["head"] = conv_entry(head, last, 1)
    p["head_bn"] = bn_entry(head)
    # global average pool feeds the classifier, so fc is width-only
    p["fc"] = {"w": normal(generator, (head, classes), device),
               "b": zeros(classes, device)}
    return cast(p, dtype)


def to_graph(*, include_head: bool = True) -> StreamGraph:
    """Export MobileNetV2 as a streaming graph.  Every conv is followed by
    a ``batchnorm`` node (own parameter entry) and — except the linear
    projection — ``relu6``; the fusion pass folds each chain into the
    conv's epilogue, and the identity-skip ``residual_add`` into the
    project conv (``Epilogue(scale=True, residual=True)``).  Without
    ``include_head`` the graph ends at the head conv's ReLU6: the conv
    trunk, before the pooling and the classifier."""
    g = StreamGraph(name="mobilenetv2")

    def conv_bn(name: str, src=None, *, stride=1, pad=0, dw=False,
                act=True) -> str:
        if dw:
            g.depthwise_conv(name, src, stride=stride, pad=1)
        else:
            g.conv(name, src, stride=stride, pad=pad)
        g.batchnorm(param=f"{name}_bn")
        if act:
            g.relu6()
        return g.output

    prev = conv_bn("stem", stride=1, pad=1)
    for name, cin, cout, stride, t, _ in block_specs():
        h = prev
        if t != 1:
            h = conv_bn(f"{name}_exp", h)
        h = conv_bn(f"{name}_dw", h, stride=stride, dw=True)
        h = conv_bn(f"{name}_proj", h, act=False)        # linear bottleneck
        if stride == 1 and cin == cout:
            prev = g.residual_add(f"{name}_add", h, prev)
        else:
            prev = h
    conv_bn("head", prev)
    if include_head:
        g.global_avgpool()
        g.flatten()
        g.dense("fc")
    return g


def forward(params: Dict[str, Any], x: torch.Tensor,
            impl: str = "direct") -> torch.Tensor:
    """Graph-free per-layer reference walk (the test oracle): x is
    (N, 3, H, W) NCHW -> (N, classes) logits.  ``impl`` selects the conv
    implementation as in ``kernels/ops.conv2d``; the depthwise layers run
    on ``fold_dw`` whenever ``impl`` names a fold kernel."""

    def conv_bn(name, x, stride, pad, dw=False, act=True):
        w = params[name]["w"]
        # depthwise weights are (C, 1, R, S): the group count is the
        # actual (width-scaled) channel count, read off the tensor
        y = conv2d(x, w, stride=stride, pad=pad,
                   impl="fold_dw" if dw and impl != "direct" else impl,
                   groups=int(w.shape[0]) if dw else 1)
        scale, shift = bn_scale_shift(params[f"{name}_bn"])
        y = y * scale[None, :, None, None] + shift[None, :, None, None]
        return torch.clamp(y, 0.0, 6.0) if act else y

    x = conv_bn("stem", x, 1, 1)
    for name, cin, cout, stride, t, _ in block_specs():
        h = x
        if t != 1:
            h = conv_bn(f"{name}_exp", h, 1, 0)
        h = conv_bn(f"{name}_dw", h, stride, 1, dw=True)
        h = conv_bn(f"{name}_proj", h, 1, 0, act=False)
        x = x + h if (stride == 1 and cin == cout) else h
    x = conv_bn("head", x, 1, 0)
    x = x.mean(dim=(2, 3))                   # global average pool
    return x @ params["fc"]["w"] + params["fc"]["b"]


def compile_forward(params: Dict[str, Any], *, img: int,
                    **compile_kw) -> CompiledNetwork:
    """Compile MobileNetV2 into a static fold schedule through the shared
    graph lowering (``models/zoo.py:compile_forward``) — the depthwise
    layers run the ``fold_dw`` kernel; ``net.fold_reuse()`` reports the
    per-model fold-reuse metric."""
    from repro_torch.models import zoo
    return zoo.compile_forward("mobilenetv2", params, img=img, **compile_kw)


def bucket_compiler(params: Dict[str, Any], *, img: int,
                    **compile_kw) -> BucketCompiler:
    """Serving compile surface: one memoized compiled forward per batch
    bucket over one shared ``ScheduleCache``."""
    from repro_torch.models import zoo
    return zoo.bucket_compiler("mobilenetv2", params, img=img, **compile_kw)
