"""Input stand-ins for every (arch x shape) cell (the JAX package's
``launch/specs.py``): ``meta`` tensors of the batch's shapes and types,
nothing allocated, and the logical axes of each.  The [vlm] and [audio]
archs get their stub frontend embeddings (bf16) here."""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec

__all__ = ["train_batch_specs", "train_batch_axes", "decode_input_specs",
           "prefill_batch_specs", "prefill_batch_axes", "src_len_for"]


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def src_len_for(cfg: ArchConfig, shape: ShapeSpec) -> int:
    """Encoder source length for enc-dec archs (stub frames = seq_len)."""
    return shape.seq_len if cfg.is_encdec else 0


def train_batch_specs(cfg: ArchConfig, shape: ShapeSpec) -> Dict[str, Any]:
    b, s = shape.global_batch, shape.seq_len
    batch = {"tokens": _meta((b, s), torch.int32),
             "labels": _meta((b, s), torch.int32)}
    if cfg.frontend == "vlm":
        batch["patches"] = _meta((b, cfg.frontend_len, cfg.d_model),
                                 torch.bfloat16)
    if cfg.is_encdec:
        batch["src_embeds"] = _meta((b, src_len_for(cfg, shape),
                                     cfg.d_model), torch.bfloat16)
    return batch


def train_batch_axes(cfg: ArchConfig) -> Dict[str, Any]:
    axes = {"tokens": ("batch", None), "labels": ("batch", None)}
    if cfg.frontend == "vlm":
        axes["patches"] = ("batch", None, None)
    if cfg.is_encdec:
        axes["src_embeds"] = ("batch", None, None)
    return axes


def prefill_batch_specs(cfg: ArchConfig, shape: ShapeSpec
                        ) -> Dict[str, Any]:
    """The training batch's stand-ins without the labels."""
    b = dict(train_batch_specs(cfg, shape))
    b.pop("labels")
    return b


def prefill_batch_axes(cfg: ArchConfig) -> Dict[str, Any]:
    a = dict(train_batch_axes(cfg))
    a.pop("labels")
    return a


def decode_input_specs(cfg: ArchConfig, shape: ShapeSpec
                       ) -> Tuple[Any, Any]:
    """(token, pos) stand-ins; the cache comes from
    ``api.init_cache(abstract=True)``."""
    return (_meta((shape.global_batch,), torch.int32),
            _meta((), torch.int32))
