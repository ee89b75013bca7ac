"""Registry of conv models that lower through the streaming-graph IR.

The serving engine and the launcher look models up here by name, so none
of them hard-codes a network: ``vgg16``, ``resnet18`` and ``mobilenetv2``
are registered.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

__all__ = ["ConvModelSpec", "register_conv_model", "get_conv_model",
           "conv_model_names", "compile_forward", "bucket_compiler"]


@dataclasses.dataclass(frozen=True)
class ConvModelSpec:
    """One registered conv model: ``init_params(generator, *, width_mult,
    img, classes, device)`` and ``to_graph()``."""
    name: str
    init_params: Callable
    to_graph: Callable

    def graph(self):
        return self.to_graph()


_REGISTRY: Dict[str, ConvModelSpec] = {}


def register_conv_model(name: str, init_params: Callable,
                        to_graph: Callable) -> ConvModelSpec:
    spec = ConvModelSpec(name=name, init_params=init_params,
                         to_graph=to_graph)
    _REGISTRY[name] = spec
    return spec


def conv_model_names():
    """Registered model names, sorted (the launcher's --model choices)."""
    _ensure_builtin()
    return sorted(_REGISTRY)


def get_conv_model(name: str) -> ConvModelSpec:
    _ensure_builtin()
    spec = _REGISTRY.get(name)
    if spec is None:
        raise KeyError(f"unknown conv model {name!r} "
                       f"(registered: {', '.join(sorted(_REGISTRY))})")
    return spec


def compile_forward(model, params, *, img: int, batch: int = 1,
                    chan: int = 3, **compile_kw):
    """Compile a registered model's graph (``core/engine.py:
    compile_network``; ``compile_kw`` carries policy, cache, jit,
    device...)."""
    from repro_torch.core.engine import compile_network
    spec = model if isinstance(model, ConvModelSpec) else \
        get_conv_model(model)
    return compile_network(params, spec.to_graph(),
                           (batch, chan, img, img), **compile_kw)


def bucket_compiler(model, params, *, img: int, chan: int = 3,
                    **compile_kw):
    """One memoized compiled forward per batch-bucket width
    (``core/engine.py:BucketCompiler``; ``compile_kw`` as above)."""
    from repro_torch.core.engine import BucketCompiler
    spec = model if isinstance(model, ConvModelSpec) else \
        get_conv_model(model)
    return BucketCompiler(params, spec.to_graph(), img, chan=chan,
                          **compile_kw)


def _ensure_builtin() -> None:
    if "vgg16" not in _REGISTRY:
        from repro_torch.models import vgg
        register_conv_model("vgg16", vgg.init_params, vgg.to_graph)
    if "resnet18" not in _REGISTRY:
        from repro_torch.models import resnet
        register_conv_model("resnet18", resnet.init_params, resnet.to_graph)
    if "mobilenetv2" not in _REGISTRY:
        from repro_torch.models import mobilenet
        register_conv_model("mobilenetv2", mobilenet.init_params,
                            mobilenet.to_graph)
