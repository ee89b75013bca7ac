"""Nested parameter trees (dicts, lists and tuples of tensors), walked in
the order ``jax.tree_util`` walks them: a dict's keys sorted, a
sequence's items in order.  The optimizer, the train step and the
checkpoint format read this order (the JAX package's leaf order, and its
``tree_flatten_with_path`` key paths)."""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

__all__ = ["leaves", "leaves_with_path", "tree_map", "unflatten_like"]


def _children(tree):
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return list(enumerate(tree))
    return None


def leaves_with_path(tree: Any, prefix: Tuple = ()) -> List[Tuple[Tuple,
                                                                   Any]]:
    """(key path, leaf) of every leaf; a None is an empty subtree, as in
    JAX."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for k, v in kids:
        out.extend(leaves_with_path(v, prefix + (k,)))
    return out


def leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in leaves_with_path(tree)]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of the
    trees in ``rest`` (the same structure), in a tree of ``tree``'s
    structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def unflatten_like(tree: Any, values: List[Any]) -> Any:
    """A tree of ``tree``'s structure whose leaves, in ``leaves`` order,
    are ``values``."""
    paths = [p for p, _ in leaves_with_path(tree)]
    if len(paths) != len(values):
        raise ValueError(f"{len(values)} values for a tree of "
                         f"{len(paths)} leaves")
    by_path = dict(zip(paths, values))

    def build(t, prefix):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: build(v, prefix + (k,)) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v, prefix + (i,)) for i, v in enumerate(t))
        return by_path[prefix]
    return build(tree, ())
