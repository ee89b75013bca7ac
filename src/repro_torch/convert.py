"""The weight bridge from the JAX package's parameter trees.

Both packages lay parameters out the same way: conv ``w`` is OIHW, the
dense ``w`` is (in, out) and is applied as ``x @ w``, biases are vectors.
So the bridge copies every leaf and transposes nothing.  A JAX
``QuantRecipe`` crosses as the port's own (``recipe_from_jax``).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

__all__ = ["params_from_jax", "recipe_from_jax"]


def params_from_jax(tree: Dict[str, Any], device: Any = "cuda"
                    ) -> Dict[str, Any]:
    """Turn a (nested dict) parameter tree of arrays — numpy arrays, or
    anything ``np.asarray`` reads — into the port's dict of tensors on
    ``device``, leaf for leaf.  A bfloat16 leaf (numpy reads a JAX bf16
    array as the ``bfloat16`` extension type, which torch cannot take)
    crosses by way of float32, which holds every bf16 value exactly, and
    lands as ``torch.bfloat16``."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    arr = np.asarray(tree)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def recipe_from_jax(recipe: Any, device: Any = "cuda"):
    """Turn the JAX package's ``QuantRecipe`` (read duck-typed: its
    ``act_scales`` dict of floats and ``w_scales`` dict of arrays) into the
    port's ``core/quant.QuantRecipe``, by way of numpy, with the weight
    scales on ``device``."""
    from repro_torch.core.quant import QuantRecipe
    return QuantRecipe(
        act_scales={k: float(v) for k, v in recipe.act_scales.items()},
        w_scales={k: params_from_jax(v, device)
                  for k, v in recipe.w_scales.items()})
