"""The check that a run loaded neither JAX nor the JAX package: modules
are compared by their whole top-level name, so ``repro_torch`` (the port)
is not ``repro`` (the JAX package)."""
from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(names: Iterable[str] = None,
                      forbidden: Iterable[str] = FORBIDDEN) -> List[str]:
    """The loaded modules (``sys.modules`` by default) whose top-level
    name is one of ``forbidden``."""
    bad = set(forbidden)
    names = list(sys.modules) if names is None else names
    return sorted(n for n in names if n.split(".", 1)[0] in bad)
