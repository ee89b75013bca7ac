"""Logical-axis sharding rules: the paper's Spatial-Map directives bound to
mesh axes (the JAX package's ``distributed/sharding.py``).

Every model parameter and activation declares *logical* axis names
(``models/common.Axes``); this module maps them onto the mesh:

  Spatial Map(batch  -> pod, data)     — DP (the image-fold streaming axis)
  Spatial Map(heads/mlp/vocab/experts -> model) — TP/EP (the filter-fold
                                          stationary axis: weights never move)
  Temporal Map(seq)                    — streamed in time, unsharded

A sharding is ``NamedSharding(mesh, PartitionSpec)``: it gives the DTensor
placements (``Shard(d)`` / ``Replicate()``) per mesh dim and each rank's
local shape and slice.  The vision binding (``vision_shardings``) is what
``serve/vision.py`` runs on a mesh: each model rank holds its N_F slice
of every conv whose filter count divides the model axis
(``FilterShard``), and ``core/engine.py`` runs the fold kernel on that
slice and gathers the output channels.

``distribute_tree`` lays a tree out on a mesh with ranks: each leaf
becomes a ``DTensor`` whose local tensor is the rank's shard
(``NamedSharding.local_slice``), or a ``meta`` tensor of the shard's shape
for a ``meta`` leaf.  The dry-run (``launch/dryrun.py``) traces the
sharded step on such trees over a fake process group; on real tensors
over gloo the same step gives the one-rank loss.

``constrain`` reads the (mesh, rules) context a launcher installs: without
one it returns ``x`` itself; under a one-rank mesh it checks the spec
against ``x``'s shape and returns ``x`` unchanged.  On a ``DTensor`` it
returns ``x`` redistributed to the spec's placements, as
``with_sharding_constraint`` does in JAX's SPMD program.  On a plain
tensor under a mesh of more ranks it raises: the model would run
replicated on every rank, and doing that silently would hide it.  The
entry points that lay the trees out for such a mesh are
``Trainer(mesh=)`` and ``BatchEngine(mesh=)``, from
``launch/specs.step_layout``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, FrozenSet, Optional, Sequence, Tuple

import torch

from repro_torch.core.mapping import PartitionSpec
from repro_torch.distributed.dtensor import in_local_region, is_dtensor
from repro_torch.models.common import Axes, map_axes

__all__ = ["ShardingRules", "make_rules", "spec_for", "tree_shardings",
           "NamedSharding", "distribute_tree", "set_context", "clear_context",
           "context_mesh", "constrain",
           "zero1_shardings", "vision_shardings", "vision_batch_sharding",
           "FilterShard", "filter_shard"]


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """logical axis name -> mesh axis (or tuple of axes, or None)."""
    table: Dict[str, Any]
    seq_shard_kv: bool = False   # long-context decode: shard cache seq on dp

    def get(self, name: Optional[str]):
        if name is None:
            return None
        return self.table.get(name)


def _dp_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def make_rules(cfg, mesh, *, seq_shard_kv: bool = False,
               shard_batch: bool = True) -> ShardingRules:
    """The rule table from the config's divisibilities and the mesh."""
    model = mesh.shape.get("model", 1)
    dp = _dp_axes(mesh)
    # head params are padded to head_pad_multiple for even TP; divisibility
    # is checked on the PADDED count
    heads_ok = cfg.padded_heads % model == 0
    kv_ok = cfg.kv_heads % model == 0
    d_in = cfg.ssm_expand * cfg.d_model
    table = {
        Axes.BATCH: dp if shard_batch else None,
        Axes.VOCAB: "model",
        Axes.HEADS: "model" if heads_ok else None,
        Axes.KV_HEADS: "model" if kv_ok else None,   # else replicated (GQA)
        Axes.MLP: "model",
        Axes.EXPERTS: "model",
        Axes.EXPERT_MLP: None,
        Axes.EMBED: None,
        Axes.SSM_INNER: "model" if d_in % model == 0 else None,
        Axes.STATE: None,
        Axes.CONV_K: None,
        Axes.HEAD_DIM: None,
        Axes.LAYERS: None,
        Axes.SEQ: None,
        "seq_kv": dp if seq_shard_kv else None,
        "cache_kv": "model" if cfg.cache_kv_heads % model == 0 else None,
    }
    return ShardingRules(table=table, seq_shard_kv=seq_shard_kv)


def spec_for(axes: Sequence[Optional[str]], rules: ShardingRules
             ) -> PartitionSpec:
    return PartitionSpec(*[rules.get(a) for a in axes])


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A tensor's layout on a mesh: ``spec[d]`` names the mesh axes its
    dim ``d`` is split over (the first the major), None: replicated."""
    mesh: Any
    spec: PartitionSpec

    def __post_init__(self):
        used = [a for entry in self.spec for a in _entry_axes(entry)]
        dup = sorted({a for a in used if used.count(a) > 1})
        if dup:
            raise ValueError(f"{self.spec} maps mesh axes {dup} to more "
                             "than one dim")
        unknown = sorted(set(used) - set(self.mesh.axis_names))
        if unknown:
            raise ValueError(f"{self.spec} names axes {unknown} that the "
                             f"mesh {self.mesh.shape} lacks")

    def placements(self):
        """The DTensor placements, one per device-mesh dim: ``Shard(d)``
        where the dim is split over that mesh axis (or over every axis of
        a joined dim, in its order), ``Replicate()`` else."""
        from torch.distributed.tensor import Replicate, Shard
        by_axis = {a: d for d, entry in enumerate(self.spec)
                   for a in _entry_axes(entry)}
        out = []
        for group in getattr(self.mesh, "dm_axes",
                             tuple((a,) for a in self.mesh.axis_names)):
            dims = {by_axis.get(a) for a in group}
            if dims == {None}:
                out.append(Replicate())
                continue
            d = dims.pop()
            if dims or d is None or tuple(
                    a for a in _entry_axes(self.spec[d]) if a in group) \
                    != group:
                raise ValueError(f"{self.spec} splits the joined mesh axes "
                                 f"{group} apart")
            out.append(Shard(d))
        return tuple(out)

    def _parts(self, d: int) -> int:
        if d >= len(self.spec):
            return 1
        return math.prod(self.mesh.shape[a]
                         for a in _entry_axes(self.spec[d]))

    def local_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        """A rank's shard shape of a tensor of ``shape``."""
        if len(self.spec) > len(shape):
            raise ValueError(f"spec {self.spec} has more dims than the "
                             f"shape {tuple(shape)}")
        out = []
        for d, n in enumerate(shape):
            parts = self._parts(d)
            if n % parts:
                raise ValueError(f"dim {d} of {tuple(shape)} does not "
                                 f"split {parts} ways ({self.spec})")
            out.append(n // parts)
        return tuple(out)

    def local_slice(self, shape: Sequence[int],
                    coords: Optional[Dict[str, int]] = None
                    ) -> Tuple[slice, ...]:
        """The slice of a tensor of ``shape`` that the rank at mesh
        ``coords`` (this rank's, by default) holds."""
        local = self.local_shape(shape)
        out = []
        for d, n in enumerate(local):
            idx = 0
            for a in (_entry_axes(self.spec[d]) if d < len(self.spec)
                      else ()):
                c = (coords[a] if coords is not None
                     else self.mesh.axis_index(a))
                idx = idx * self.mesh.shape[a] + c
            out.append(slice(idx * n, (idx + 1) * n))
        return tuple(out)

    def local(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's shard of ``t``, a tensor of its own (``t`` itself
        where nothing is split)."""
        if tuple(self.local_shape(t.shape)) == tuple(t.shape):
            return t
        return t[self.local_slice(t.shape)].clone()

    def distribute(self, t: torch.Tensor):
        """``t`` as a ``DTensor`` on the mesh's ranks: this rank's shard
        as its local tensor (a ``meta`` tensor of the shard's shape for a
        ``meta`` ``t``), ``t``'s shape and contiguous strides as the
        global ones."""
        from torch.distributed.tensor import DTensor
        self.mesh._need_ranks()
        if t.device.type == "meta":
            local = torch.empty(self.local_shape(t.shape), dtype=t.dtype,
                                device="meta")
        else:
            local = self.local(t).contiguous()
        return DTensor.from_local(
            local, self.mesh.device_mesh, self.placements(), run_check=False,
            shape=t.shape, stride=torch.empty(t.shape, device="meta").stride())


def distribute_tree(tree, shardings):
    """Each leaf of ``tree`` (tensors, ``meta`` or real) as a ``DTensor``
    under the matching ``NamedSharding`` of ``shardings``."""
    return map_axes(lambda t, sh: sh.distribute(t), tree, shardings)



def tree_shardings(axes_tree, rules: ShardingRules, mesh):
    """Map an axes tree (tuples of logical names) to ``NamedSharding``s."""
    return map_axes(lambda a: NamedSharding(mesh, spec_for(a, rules)),
                    axes_tree)


# ---------------------------------------------------------------------------
# Vision serving: the conv-trunk binding of the paper's Spatial Maps
# ---------------------------------------------------------------------------

def vision_batch_sharding(mesh, plan) -> NamedSharding:
    """The NCHW activation batch under a serving ``MappingPlan``
    (``core/mapping.py:serving_conv_plan``): the batch — the image-fold
    streaming axis — splits across the plan's data axis."""
    return NamedSharding(mesh, plan.partition_spec(("N", None, None, None)))


def _is_conv(leaf, model: int) -> bool:
    return (isinstance(leaf, dict) and "w" in leaf
            and getattr(leaf["w"], "ndim", 0) == 4
            and leaf["w"].shape[0] % model == 0)


def vision_shardings(params, mesh, plan):
    """``NamedSharding``s for a conv-trunk param tree under a serving
    plan: conv layers (4-D ``w`` OIHW and the entry's other leaves, its
    bias) split on the N_F filter-fold axis — the stationary axis: each
    model rank holds its slice of every filter fold and the weights never
    move.  A layer whose filter count does not divide the model axis is
    replicated, as is everything that is not a conv layer (the head, the
    batch-norm entries)."""
    by_dim = {d.dim: d.axis for d in plan.spatial()}
    model_axis = by_dim.get("N_F")
    model = mesh.shape.get(model_axis, 1) if model_axis else 1
    w_spec = plan.partition_spec(("N_F", None, None, None))
    b_spec = plan.partition_spec(("N_F",))
    replicate = NamedSharding(mesh, PartitionSpec())

    def rep(leaf):
        if isinstance(leaf, dict):
            return {k: rep(v) for k, v in leaf.items()}
        return replicate

    out = {}
    for name, leaf in params.items():
        if _is_conv(leaf, model):
            out[name] = {k: NamedSharding(mesh, w_spec) if k == "w"
                         else NamedSharding(mesh, b_spec) for k in leaf}
        else:
            out[name] = rep(leaf)
    return out


@dataclasses.dataclass(frozen=True)
class FilterShard:
    """A conv trunk's model-axis split for ``core/engine.compile_network``:
    the convs in ``names`` hold this rank's ``index``-th of ``size``
    slices of their filters; the forward runs each such conv on its
    slice (its bias with it, its batch-norm scale / shift and residual
    sliced alike) and gathers the output channels over ``group``."""
    group: Any
    size: int
    index: int
    names: FrozenSet[str]

    def sharded(self, name: str) -> bool:
        return self.size > 1 and name in self.names

    def channels(self, nf_local: int) -> slice:
        """This rank's channel range of a split conv's full output."""
        return slice(self.index * nf_local, (self.index + 1) * nf_local)

    def gather(self, y: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """Every rank's channel slices, concatenated in rank order."""
        from repro_torch.distributed.comm import all_gather_cat
        return all_gather_cat(y, self.group, dim)


def filter_shard(params, mesh, plan, graph, model_axis: str = "model"
                 ) -> Optional[FilterShard]:
    """The ``FilterShard`` of ``vision_shardings`` on this rank (None when
    the model axis has one rank: nothing splits).  The port splits a
    grouped conv by whole groups and keeps a depthwise slice depthwise,
    so a grouped conv splits only when every rank keeps two groups or
    more; with fewer (a two-channel depthwise conv over two ranks) it is
    replicated, where the JAX package's spec splits it."""
    from repro_torch.core.graph import DEPTHWISE, as_graph
    size = mesh.shape.get(model_axis, 1)
    if size == 1:
        return None
    sh = vision_shardings(params, mesh, plan)
    groups = {nd.param: (params[nd.param]["w"].shape[0]
                         if nd.groups == DEPTHWISE else nd.groups)
              for nd in as_graph(graph).nodes if nd.op == "conv"}
    names = frozenset(n for n, s in sh.items()
                      if isinstance(s, dict) and "w" in s
                      and s["w"].spec and s["w"].spec[0] is not None
                      and (groups.get(n, 1) == 1
                           or groups[n] // size >= 2))
    return FilterShard(group=mesh.group(model_axis), size=size,
                       index=mesh.axis_index(model_axis), names=names)


# ---------------------------------------------------------------------------
# ZeRO-1: optimizer-state sharding over the data axes
# ---------------------------------------------------------------------------

def zero1_shardings(axes_tree, shapes_tree, rules: ShardingRules, mesh):
    """Optimizer moments / master: the parameter's sharding plus the DP
    axes folded onto the first dimension that is unsharded and divisible
    (classic ZeRO-1)."""
    dp = _dp_axes(mesh)
    dp_size = math.prod(mesh.shape[a] for a in dp) if dp else 1

    def one(axes, leaf):
        shape = tuple(leaf.shape)
        spec = list(spec_for(axes, rules))
        if dp and dp_size > 1:
            for i, (s, dim) in enumerate(zip(spec, shape)):
                if s is None and dim % dp_size == 0 and dim > 0:
                    spec[i] = dp
                    break
        return NamedSharding(mesh, PartitionSpec(*spec))

    return map_axes(one, axes_tree, shapes_tree)


# ---------------------------------------------------------------------------
# activation-constraint context (installed by launchers)
# ---------------------------------------------------------------------------

_CTX: Optional[Tuple[Any, ShardingRules]] = None


def set_context(mesh, rules: ShardingRules) -> None:
    global _CTX
    _CTX = (mesh, rules)


def clear_context() -> None:
    global _CTX
    _CTX = None


def context_mesh():
    """The installed context's mesh; without a context, an error."""
    if _CTX is None:
        raise ValueError("no sharding context is set (set_context)")
    return _CTX[0]


def constrain(x, logical_names: Sequence[Optional[str]]):
    """The activation's sharding constraint: ``x`` itself without a
    context; a ``DTensor`` redistributed to the spec's placements; under
    a one-rank mesh, a plain ``x`` after its spec is checked against its
    shape; a plain tensor under more ranks, an error (ROADMAP 4f.3).
    Inside ``run_local`` (a rank's own shards) it is ``x`` itself."""
    if _CTX is None or in_local_region():
        return x
    mesh, rules = _CTX
    spec = spec_for(logical_names, rules)
    if len(spec) != x.ndim:
        raise ValueError(f"constraint {spec} for a tensor of shape "
                         f"{tuple(x.shape)}")
    sharding = NamedSharding(mesh, spec)
    sharding.local_shape(x.shape)                     # raises if uneven
    if is_dtensor(x):
        return x.redistribute(mesh.device_mesh, sharding.placements())
    if mesh.size > 1:
        raise NotImplementedError(
            f"a plain tensor under a mesh of {mesh.size} ranks "
            f"({mesh.shape}): the multi-rank LM step runs on DTensors "
            "(ROADMAP 4f.3); lay its trees out through Trainer(mesh=), "
            "BatchEngine(mesh=) or distribute_tree over "
            "launch/specs.step_layout's shardings, or run it under a "
            "one-rank mesh or none")
    return x
