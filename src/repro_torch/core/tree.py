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


def _flatten(t, leaves: List[Any]):
    if isinstance(t, dict):
        keys = sorted(t)
        return ("dict", keys, [_flatten(t[k], leaves) for k in keys])
    if isinstance(t, (list, tuple)):
        return (type(t).__name__, None, [_flatten(v, leaves) for v in t])
    leaves.append(t)
    return None


def tree_flatten(tree) -> Tuple[List[Any], Any]:
    """``(leaves, treedef)``; ``treedef`` rebuilds the containers. The
    walks are module functions, not closures: a recursive closure is a
    reference cycle, which would keep every leaf it saw (a step's
    gradients) alive until the garbage collector runs."""
    leaves: List[Any] = []
    return leaves, _flatten(tree, leaves)


def _build(d, it):
    if d is None:
        return next(it)
    kind, keys, kids = d
    if kind == "dict":
        return {k: _build(c, it) for k, c in zip(keys, kids)}
    vals = [_build(c, it) for c in kids]
    return tuple(vals) if kind == "tuple" else vals


def tree_unflatten(treedef, leaves):
    it = iter(leaves)
    out = _build(treedef, it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_leaves(tree) -> List[Any]:
    return tree_flatten(tree)[0]

