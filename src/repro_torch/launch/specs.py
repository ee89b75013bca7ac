"""Input stand-ins for every (arch x shape) cell (the JAX package's
``launch/specs.py``): ``meta`` tensors of the batch's shapes and types,
nothing allocated, and the logical axes of each.  The [vlm] and [audio]
archs get their stub frontend embeddings (bf16) here.

``step_layout`` is the one table of the sharded steps' layouts: for the
train, prefill and decode steps on a mesh, the sharding rules and the
``NamedSharding`` of every argument, with the donated ones (the JAX
dry-run's ``in_shardings`` and ``donate_argnums``).  The dry-run, the
mesh ``Trainer`` and the mesh ``BatchEngine`` all read it."""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec

__all__ = ["train_batch_specs", "train_batch_axes", "decode_input_specs",
           "prefill_batch_specs", "prefill_batch_axes", "src_len_for",
           "StepLayout", "step_rules", "step_shardings", "step_layout"]


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


# ---------------------------------------------------------------------------
# the sharded steps' layouts
# ---------------------------------------------------------------------------

STEP_KINDS = ("train", "prefill", "decode")


@dataclasses.dataclass(frozen=True)
class StepLayout:
    """A step's layout on a mesh: the rules, the ``NamedSharding`` tree
    of each argument in the step's order (train: params, optimizer state,
    batch; prefill: params, batch, cache; decode: params, token, cache,
    pos) and the indices of the donated ones."""
    rules: Any
    shardings: Tuple[Any, ...]
    donate: Tuple[int, ...]
    seq_shard_kv: bool
    shard_batch: bool


def step_rules(cfg: ArchConfig, kind: str, mesh, batch: int,
               seq_shard_kv: Optional[bool] = None):
    """(rules, seq_shard_kv, shard_batch) of a ``kind`` step over
    ``batch`` rows: the batch split over the data axes where it divides
    by them; a decode step whose batch does not splits its cache's
    sequence there instead (``seq_shard_kv``)."""
    from repro_torch.distributed.sharding import make_rules
    if kind not in STEP_KINDS:
        raise ValueError(f"step kind {kind!r} is not one of {STEP_KINDS}")
    dp = math.prod(int(mesh.shape.get(a, 1)) for a in ("pod", "data"))
    shard_batch = batch % dp == 0
    if seq_shard_kv is None:
        seq_shard_kv = kind == "decode" and not shard_batch
    return (make_rules(cfg, mesh, seq_shard_kv=seq_shard_kv,
                       shard_batch=shard_batch),
            bool(seq_shard_kv), shard_batch)


def step_shardings(cfg: ArchConfig, kind: str, mesh, rules
                   ) -> Tuple[Tuple[Any, ...], Tuple[int, ...]]:
    """(the ``NamedSharding`` tree of every argument, the donated
    indices) of a ``kind`` step under ``rules``: the parameters by their
    axes; the AdamW state in the ZeRO-1 layout, its step replicated; the
    batch and the token over the batch axis; the cache by its axes; the
    position replicated."""
    from repro_torch.core.mapping import PartitionSpec
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import api
    axes = api.param_axes(cfg)
    p_sh = shd.tree_shardings(axes, rules, mesh)
    repl = shd.NamedSharding(mesh, PartitionSpec())
    if kind == "train":
        z1 = shd.zero1_shardings(axes, api.init_params(cfg, abstract=True),
                                 rules, mesh)
        o_sh = {"step": repl, "mu": z1, "nu": z1, "master": z1}
        b_sh = shd.tree_shardings(train_batch_axes(cfg), rules, mesh)
        return (p_sh, o_sh, b_sh), (0, 1)
    c_sh = shd.tree_shardings(api.cache_axes(cfg), rules, mesh)
    if kind == "prefill":
        b_sh = shd.tree_shardings(prefill_batch_axes(cfg), rules, mesh)
        return (p_sh, b_sh, c_sh), (2,)
    tok_sh = shd.NamedSharding(mesh, shd.spec_for(("batch",), rules))
    return (p_sh, tok_sh, c_sh, repl), (2,)


def step_layout(cfg: ArchConfig, kind: str, mesh, batch: int, *,
                seq_shard_kv: Optional[bool] = None) -> StepLayout:
    """The layout of a ``kind`` step ("train", "prefill" or "decode")
    over ``batch`` rows on ``mesh``: ``step_rules`` and
    ``step_shardings`` together."""
    rules, seq_kv, shard_batch = step_rules(cfg, kind, mesh, batch,
                                            seq_shard_kv)
    shardings, donate = step_shardings(cfg, kind, mesh, rules)
    return StepLayout(rules, shardings, donate, seq_kv, shard_batch)
