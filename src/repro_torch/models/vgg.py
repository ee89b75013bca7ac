"""VGG-16 — the paper's end-to-end evaluation model (Table 2B), exported
as a streaming graph and lowered through the fold-schedule engine.

Parameters are a plain dict shaped like the JAX package's pytree
(``params[name]["w"]`` OIHW for convs, (in, out) for the dense layers,
``params[name]["b"]``), so ``convert.params_from_jax`` maps one onto the
other entry by entry.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.core.engine import BucketCompiler, CompiledNetwork
from repro_torch.core.graph import StreamGraph
from repro_torch.models.common import cast, normal, zeros

__all__ = ["VGG_LAYERS", "init_params", "vgg_head", "to_graph",
           "compile_forward", "bucket_compiler", "n_classes"]

# (name, in_ch, out_ch) conv3x3 blocks; "M" = 2x2 maxpool (paper Table 2B)
VGG_LAYERS: Tuple = (
    ("conv1_1", 3, 64), ("conv1_2", 64, 64), "M",
    ("conv2_1", 64, 128), ("conv2_2", 128, 128), "M",
    ("conv3_1", 128, 256), ("conv3_2", 256, 256), ("conv3_3", 256, 256), "M",
    ("conv4_1", 256, 512), ("conv4_2", 512, 512), ("conv4_3", 512, 512), "M",
    ("conv5_1", 512, 512), ("conv5_2", 512, 512), ("conv5_3", 512, 512), "M",
)
n_classes = 1000


def init_params(generator: torch.Generator, *, width_mult: float = 1.0,
                img: int = 224, classes: int = n_classes,
                device: Any = "cuda",
                dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """Random VGG-16 parameters drawn with ``generator`` (on the
    generator's device), placed on ``device``.  Biases are zeros."""
    p: Dict[str, Any] = {}
    pools = 0
    for entry in VGG_LAYERS:
        if entry == "M":
            pools += 1
            continue
        name, cin, cout = entry
        cin = max(int(cin * width_mult), 1) if cin != 3 else 3
        cout = max(int(cout * width_mult), 1)
        p[name] = {"w": normal(generator, (cout, cin, 3, 3), device),
                   "b": zeros(cout, device)}
    feat = img // (2 ** pools)
    last = max(int(512 * width_mult), 1)
    fc_dim = max(int(4096 * width_mult), 8)
    p["fc1"] = {"w": normal(generator, (last * feat * feat, fc_dim), device),
                "b": zeros(fc_dim, device)}
    p["fc2"] = {"w": normal(generator, (fc_dim, fc_dim), device),
                "b": zeros(fc_dim, device)}
    p["fc3"] = {"w": normal(generator, (fc_dim, classes), device),
                "b": zeros(classes, device)}
    return cast(p, dtype)


def vgg_head(params: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    """Flatten + the 3-layer fc classifier head (the callable form of the
    flatten/dense tail ``to_graph`` expresses as graph nodes), through the
    head kernel as the graph's dense nodes run it."""
    from repro_torch.kernels.dense import dense
    x = x.reshape(x.shape[0], -1)
    x = torch.relu(dense(x, params["fc1"]["w"], params["fc1"]["b"]))
    x = torch.relu(dense(x, params["fc2"]["w"], params["fc2"]["b"]))
    return dense(x, params["fc3"]["w"], params["fc3"]["b"])


def to_graph(*, include_head: bool = True) -> StreamGraph:
    """Export VGG-16 as a streaming graph: the 13 conv/bias/relu blocks
    with their 5 pool stages, plus — with ``include_head`` — the flatten +
    3-layer fc classifier as graph nodes."""
    g = StreamGraph.from_conv_spec(VGG_LAYERS, name="vgg16")
    if include_head:
        g.flatten()
        g.dense("fc1")
        g.relu()
        g.dense("fc2")
        g.relu()
        g.dense("fc3")
    return g


def compile_forward(params: Dict[str, Any], *, img: int,
                    **compile_kw) -> CompiledNetwork:
    """Compile the whole VGG trunk+head into a static fold schedule.  Call
    the result as ``net(params, x)``; ``net.fold_reuse()`` and
    ``net.describe()`` report the schedule table."""
    from repro_torch.models import zoo
    return zoo.compile_forward("vgg16", params, img=img, **compile_kw)


def bucket_compiler(params: Dict[str, Any], *, img: int,
                    **compile_kw) -> BucketCompiler:
    """The serving compile surface: one memoized ``compile_forward`` per
    batch-bucket width over one shared ``ScheduleCache``."""
    from repro_torch.models import zoo
    return zoo.bucket_compiler("vgg16", params, img=img, **compile_kw)
