"""Parameter initializers shared by the port's models: the conv models'
``normal``/``zeros``/``ones``/``width``, and for the LM side the
mixed-precision ``DTypePolicy``, the logical axis names ``Axes`` and the
``TreeMaker`` (the JAX package's ``models/common.py``).

Every LM parameter is declared once, through ``TreeMaker.param`` with its
shape and its logical axes, and the same declaration runs in three modes:
``init`` draws the tensor, ``abstract`` makes a ``meta`` tensor of its
shape and type (no storage: a full config's tree costs nothing), and
``axes`` gives the tuple of logical axis names, which
``distributed/sharding.py`` binds to mesh axes.  One definition, so the
sharding rules cannot drift from the model code."""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Sequence

import torch

__all__ = ["normal", "zeros", "ones", "width", "cast", "DTypePolicy",
           "TreeMaker", "Axes", "stack_abstract", "stack_axes", "map_axes"]


class Axes:
    """Logical axis names (bound to mesh axes by
    ``distributed/sharding.py``)."""
    LAYERS = "layers"        # the stacking axis, never sharded
    BATCH = "batch"
    SEQ = "seq"
    EMBED = "embed"
    VOCAB = "vocab"
    HEADS = "heads"
    KV_HEADS = "kv_heads"
    HEAD_DIM = "head_dim"
    MLP = "mlp"              # ffn hidden
    EXPERTS = "experts"
    EXPERT_MLP = "expert_mlp"
    SSM_INNER = "ssm_inner"  # mamba/rwkv expanded inner dim
    STATE = "state"          # ssm state dim
    CONV_K = "conv_k"
    NONE = None


def _trunc_normal(gen: torch.Generator, shape) -> torch.Tensor:
    """Standard normal truncated to [-2, 2], fp32, on the generator's
    device."""
    t = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t


def normal(gen: torch.Generator, shape, device: Any) -> torch.Tensor:
    """Truncated normal on [-2, 2] scaled by 1/sqrt(shape[0]) — the JAX
    package's ``TreeMaker.param`` init (other random bits, same law).  On
    the ``meta`` device only the shape is made."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, device="meta")
    return (_trunc_normal(gen, shape) * (1.0 / math.sqrt(shape[0]))).to(device)


def zeros(n: int, device: Any) -> torch.Tensor:
    return torch.zeros((n,), dtype=torch.float32, device=device)


def ones(n: int, device: Any) -> torch.Tensor:
    return torch.ones((n,), dtype=torch.float32, device=device)


def cast(tree: Any, dtype: torch.dtype) -> Any:
    """A nested dict of tensors with every tensor in ``dtype`` (the conv
    models' ``init_params(dtype=)``: drawn in fp32, then rounded once)."""
    if isinstance(tree, dict):
        return {k: cast(v, dtype) for k, v in tree.items()}
    return tree.to(dtype)


def width(c: int, mult: float) -> int:
    """A channel count scaled by ``width_mult`` (at least 1)."""
    return max(int(c * mult), 1)


@dataclasses.dataclass(frozen=True)
class DTypePolicy:
    """Mixed-precision policy, the JAX package's: bf16 parameters and
    compute, fp32 reductions (norms, softmax, the loss, the SSD sums) and
    fp32 optimizer master copy and moments (``optim/adamw.py``, fp32 as
    in the JAX package).  Activations follow the parameters."""
    param: torch.dtype = torch.bfloat16
    compute: torch.dtype = torch.bfloat16
    accum: torch.dtype = torch.float32
    master: torch.dtype = torch.float32

    @classmethod
    def fp32(cls) -> "DTypePolicy":
        return cls(param=torch.float32, compute=torch.float32)


class TreeMaker:
    """Declare-once parameter trees.

    mode="init":     each ``param`` call draws one leaf from ``gen`` (on
                     the generator's device) and puts it on ``device`` in
                     the policy's parameter type;
    mode="abstract": leaves are ``meta`` tensors of the shape and type
                     (nothing allocated, nothing drawn);
    mode="axes":     leaves are tuples of logical axis names.
    """

    def __init__(self, gen: Optional[torch.Generator] = None,
                 device: Any = "cuda",
                 dtype_policy: Optional[DTypePolicy] = None,
                 mode: str = "init"):
        if mode not in ("init", "abstract", "axes"):
            raise ValueError(f"unknown TreeMaker mode {mode!r}")
        self.mode = mode
        self.gen = gen
        self.device = torch.device("meta" if mode == "abstract" else device)
        self.dp = dtype_policy or DTypePolicy()

    def _uniform(self, shape, lo: float, hi: float) -> torch.Tensor:
        t = torch.empty(shape, dtype=torch.float32, device=self.gen.device)
        return t.uniform_(lo, hi, generator=self.gen)

    def param(self, shape: Sequence[int], axes: Sequence[Optional[str]],
              init: str = "normal", scale: Optional[float] = None,
              dtype: Optional[torch.dtype] = None) -> Any:
        """Declare one parameter with one logical axis name (or None) per
        dim.

        init: "normal" (trunc-normal, fan-in scaled unless ``scale``),
              "zeros", "ones", "ssm_a" (mamba A_log), "ssm_dt" (dt bias).
        """
        shape = tuple(int(s) for s in shape)
        if len(shape) != len(axes):
            raise ValueError(f"shape {shape} and axes {tuple(axes)} differ "
                             "in rank")
        if self.mode == "axes":
            return tuple(axes)
        dtype = dtype or self.dp.param
        if self.mode == "abstract":
            return torch.empty(shape, dtype=dtype, device="meta")
        if init == "zeros":
            return torch.zeros(shape, dtype=dtype, device=self.device)
        if init == "ones":
            return torch.ones(shape, dtype=dtype, device=self.device)
        if init == "ssm_a":    # A_log ~ log(uniform[1, 16]) (mamba2 default)
            x = torch.log(self._uniform(shape, 1.0, 16.0))
        elif init == "ssm_dt":  # dt bias = softplus^-1(uniform[1e-3, 1e-1])
            x = torch.log(torch.expm1(self._uniform(shape, 1e-3, 1e-1)))
        elif init == "normal":
            if scale is None:
                fan_in = shape[0] if len(shape) >= 2 else max(shape[-1], 1)
                scale = 1.0 / math.sqrt(fan_in)
            x = _trunc_normal(self.gen, shape) * scale
        else:
            raise ValueError(f"unknown init {init!r}")
        return x.to(device=self.device, dtype=dtype)


def map_axes(fn, tree, *rest):
    """``fn`` over the leaves of a nested dict whose leaves are tensors
    or tuples of axis names (a tuple is a leaf here, not a sequence), and
    the matching leaves of the trees in ``rest``."""
    if isinstance(tree, dict):
        return {k: map_axes(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def stack_abstract(tree: Any, n: int) -> Any:
    """A tree of ``meta`` tensors with a new leading axis of ``n`` (the
    abstract form of stacking ``n`` copies)."""
    return map_axes(lambda t: torch.empty((n,) + tuple(t.shape),
                                          dtype=t.dtype, device="meta"),
                    tree)


def stack_axes(tree: Any) -> Any:
    """Prepend the (unsharded) layers axis to every leaf of an axes
    tree."""
    return map_axes(lambda a: (Axes.LAYERS,) + tuple(a), tree)
