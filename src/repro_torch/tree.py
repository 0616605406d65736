"""Nested-dict trees of tensors: the port's stand-in for the reference's
``jax.tree`` calls over its params, gradients and optimizer states.

A tree is a dict whose values are trees or leaves.  Leaves are visited in
sorted-key order at every level, the order ``jax.tree.flatten`` gives a
dict, so a flattened tree lines up leaf for leaf with the reference's and
a key path joins its keys as the reference's checkpoints do.
"""
from __future__ import annotations

from typing import Any, Callable

__all__ = ["tree_map", "tree_leaves", "tree_items", "tree_from_items"]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` applied leaf by leaf to ``tree`` and the trees of the same
    structure in ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def tree_items(tree: Any, prefix: tuple = ()) -> list[tuple[tuple, Any]]:
    """``[(key path, leaf), ...]`` in sorted-key order."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in tree_items(tree[k], prefix + (k,))]
    return [(prefix, tree)]


def tree_leaves(tree: Any) -> list:
    """The leaves in sorted-key order (``jax.tree.leaves`` of a dict)."""
    return [leaf for _, leaf in tree_items(tree)]


def tree_from_items(items) -> dict:
    """The nested dict that ``tree_items`` flattened."""
    out: dict = {}
    for path, leaf in items:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out
