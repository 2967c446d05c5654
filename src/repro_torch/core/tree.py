"""Nested dict/list/tuple trees of tensors: flatten and unflatten.

The port's parameters, optimizer state and checkpoints are plain nested
containers. Leaves are ordered as ``jax.tree_util`` orders them — dict keys
sorted, lists and tuples in order — so a flattened tree lines up leaf for
leaf with the reference's (the checkpoint format and the optimizer's
global-norm sum depend on it).
"""

from __future__ import annotations

from typing import Any, List, Tuple

__all__ = ["tree_flatten", "tree_unflatten", "tree_leaves"]


def tree_flatten(tree) -> Tuple[List[Any], Any]:
    """``(leaves, treedef)``; ``treedef`` rebuilds the containers."""
    leaves: List[Any] = []

    def walk(t):
        if isinstance(t, dict):
            keys = sorted(t)
            return ("dict", keys, [walk(t[k]) for k in keys])
        if isinstance(t, (list, tuple)):
            return (type(t).__name__, None, [walk(v) for v in t])
        leaves.append(t)
        return None

    return leaves, walk(tree)


def tree_unflatten(treedef, leaves):
    it = iter(leaves)

    def build(d):
        if d is None:
            return next(it)
        kind, keys, kids = d
        if kind == "dict":
            return {k: build(c) for k, c in zip(keys, kids)}
        vals = [build(c) for c in kids]
        return tuple(vals) if kind == "tuple" else vals

    out = build(treedef)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_leaves(tree) -> List[Any]:
    return tree_flatten(tree)[0]

