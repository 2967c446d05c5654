"""Sharding rules: tree path → per-dimension spec, and its DTensor placement.

Counterpart of ``repro/distributed/sharding.py``, rule for rule. TP follows
the Megatron column/row pattern over the ``model`` axis (QKV/up projections
column-split, O/down row-split, vocab embedding + head vocab-split); EP
shards the expert axis of MoE weights over ``model``; DP shards the batch
over (``pod``, ``data``); float weights are also sharded over the DP axes
on their other matrix dimension (FSDP). Dimensions that don't divide
evenly fall back to replication.

A spec is a tuple with one entry per tensor dimension: ``None``, a mesh
axis name, or a tuple of names (the reference's ``PartitionSpec``). It is
computed from axis sizes alone, so a "mesh" here is anything that gives
them: a ``DeviceMesh`` (its ``mesh_dim_names`` and ``shape``), an object
with a ``.shape`` mapping (``launch/mesh.py``'s abstract production
meshes) or a plain dict of sizes. :func:`to_placements` turns a spec into
DTensor placements on a ``DeviceMesh`` — ``Shard(d)`` on every mesh
dimension that names tensor dimension ``d``, ``Replicate()`` on the rest —
the counterpart of a ``NamedSharding``; :func:`distribute_tree` places a
tree by them (``device_put``).

Paths are the reference's: dict keys and list indices joined by ``/``
(``groups/0/attn/wq/w``, ``opt/m/embed``); the rules read the last two
parts and whether ``moe`` is among them.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch

__all__ = ["dp_axes_of", "mesh_sizes", "param_pspec", "cache_pspec",
           "batch_pspec", "tree_pspecs", "tree_shardings", "to_placements",
           "from_placements", "distribute_tree", "tree_paths",
           "spec_shards", "local_slices", "local_shape", "map_paths",
           "sharding_leaves", "place_tree"]

Spec = Tuple[Any, ...]


def mesh_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` in the mesh's axis order."""
    if isinstance(mesh, dict):
        return dict(mesh)
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:                        # a DeviceMesh
        return dict(zip(names, tuple(mesh.shape)))
    return dict(mesh.shape)


def dp_axes_of(mesh) -> Tuple[str, ...]:
    return tuple(a for a in mesh_sizes(mesh) if a in ("pod", "data"))


def _fits(mesh, ax, dim: int) -> bool:
    if ax is None or dim <= 0:
        return False
    sizes = mesh_sizes(mesh)
    axes = ax if isinstance(ax, tuple) else (ax,)
    size = 1
    for a in axes:
        size *= sizes[a]
    return dim % size == 0


def _maybe(mesh, ax, dim: int):
    return ax if _fits(mesh, ax, dim) else None


def _dp_entry(mesh):
    dp = dp_axes_of(mesh)
    return dp if len(dp) > 1 else dp[0]


# Paths look like: groups/0/attn/wq/w, groups/1/moe/w_up/w_packed, embed, ...
_COL = ("wq", "wk", "wv", "w_up", "w_gate", "in_proj", "w_dkv", "w_uk",
        "w_uv", "shared_up", "shared_gate")
_ROW = ("wo", "w_down", "out_proj", "shared_down")


def _w_spec(shape, mesh, col: bool, expert: bool) -> Spec:
    """Float weight (…, K, N): 2-D "FSDP + TP" sharding — ``model`` shards
    N of a column-parallel layer or K of a row-parallel one; the other
    matrix dimension is sharded over the DP axes (FSDP). An expert weight
    (L?, E, K, N) shards E over ``model`` (EP) and K over the DP axes."""
    nd = len(shape)
    spec = [None] * nd
    dp = dp_axes_of(mesh)
    if expert and nd >= 3:
        e_dim = nd - 3
        spec[e_dim] = _maybe(mesh, "model", shape[e_dim])
        if _fits(mesh, dp, shape[nd - 2]):
            spec[nd - 2] = _dp_entry(mesh)
        return tuple(spec)
    tp_dim = nd - 1 if col else nd - 2
    fsdp_dim = nd - 2 if col else nd - 1
    spec[tp_dim] = _maybe(mesh, "model", shape[tp_dim])
    if _fits(mesh, dp, shape[fsdp_dim]):
        spec[fsdp_dim] = _dp_entry(mesh)
    return tuple(spec)


def _packed_spec(shape, mesh, col: bool, expert: bool) -> Spec:
    """Packed weight (…, bits, K/32, N)."""
    nd = len(shape)
    spec = [None] * nd
    if expert and nd >= 4:
        e_dim = nd - 4
        spec[e_dim] = _maybe(mesh, "model", shape[e_dim])
        return tuple(spec)
    tgt = nd - 1 if col else nd - 2
    spec[tgt] = _maybe(mesh, "model", shape[tgt])
    return tuple(spec)


def param_pspec(path: str, shape: Tuple[int, ...], mesh) -> Spec:
    """The spec of one parameter leaf (or of its AdamW moments)."""
    parts = path.split("/")
    leaf = parts[-1]
    parent = parts[-2] if len(parts) > 1 else ""
    expert = ("moe" in parts and parent in ("w_up", "w_gate", "w_down"))
    col = parent in _COL
    row = parent in _ROW
    if path == "embed" or leaf == "embed":
        d_ax = _dp_entry(mesh) if _fits(mesh, dp_axes_of(mesh),
                                        shape[1]) else None
        return (_maybe(mesh, "model", shape[0]), d_ax)
    if parent == "head":
        if leaf == "w":
            d_ax = _dp_entry(mesh) if _fits(mesh, dp_axes_of(mesh),
                                            shape[0]) else None
            return (d_ax, _maybe(mesh, "model", shape[-1]))
        return (None,) * len(shape)
    if leaf == "w_packed":
        return _packed_spec(shape, mesh, col, expert)
    if leaf == "w" and (col or row):
        return _w_spec(shape, mesh, col, expert)
    if leaf in ("b", "alpha_w", "scale") and col:
        spec = [None] * len(shape)
        spec[-1] = _maybe(mesh, "model", shape[-1])
        return tuple(spec)
    if leaf == "router":
        return (None,) * len(shape)
    if parent == "ssm" or leaf in ("conv_w", "conv_b", "A_log", "D",
                                   "dt_bias"):
        # per-channel / per-head vectors follow the d_inner TP split
        spec = [None] * len(shape)
        if len(shape) >= 1 and leaf in ("conv_b", "norm", "conv_w", "A_log",
                                        "D", "dt_bias"):
            spec[-1] = _maybe(mesh, "model", shape[-1])
        return tuple(spec)
    # norms, scalars, everything else: replicated
    return (None,) * len(shape)


def batch_pspec(shape: Tuple[int, ...], mesh) -> Spec:
    """A data batch: the leading (batch) dim over all DP axes."""
    spec = [None] * len(shape)
    if shape and _fits(mesh, dp_axes_of(mesh), shape[0]):
        spec[0] = _dp_entry(mesh)
    return tuple(spec)


def cache_pspec(path: str, shape: Tuple[int, ...], mesh) -> Spec:
    """Decode-cache leaves. Layout (L, B, S, H, D) for KV, (L, B, S, lora)
    for MLA latents, (L, B, H, N, P) for SSM state."""
    leaf = path.split("/")[-1]
    dp = dp_axes_of(mesh)
    nd = len(shape)
    spec = [None] * nd
    if nd >= 2:
        spec[1] = dp if _fits(mesh, dp, shape[1]) else None
        if isinstance(spec[1], tuple) and len(spec[1]) == 1:
            spec[1] = spec[1][0]
    if leaf in ("k", "v", "k_q", "v_q") and nd == 5:
        # TP over kv heads when they divide, else the sequence axis over
        # model (flash-decoding style): a GQA cache replicated across TP
        # would not fit for the 8-kv-head 100B archs
        if _fits(mesh, "model", shape[3]):
            spec[3] = "model"
        else:
            spec[2] = _maybe(mesh, "model", shape[2])
    elif leaf in ("k_s", "v_s") and nd == 4:
        if _fits(mesh, "model", shape[3]):
            spec[3] = "model"
        else:
            spec[2] = _maybe(mesh, "model", shape[2])
    elif leaf == "c" and nd == 4:
        spec[3] = _maybe(mesh, "model", shape[3])      # latent dim
        if spec[3] is None:
            spec[2] = _maybe(mesh, "model", shape[2])
    elif leaf == "k_rope" and nd == 4:
        spec[2] = _maybe(mesh, "model", shape[2])      # rope dim is tiny
    elif leaf == "h" and nd == 5:
        spec[2] = _maybe(mesh, "model", shape[2])      # ssm heads
    elif leaf == "conv" and nd == 4:
        spec[3] = _maybe(mesh, "model", shape[3])      # channels
    return tuple(spec)


def tree_paths(tree, prefix: str = ""):
    """``[(path, leaf)]`` in the tree's flatten order (dict keys sorted,
    lists in order: :mod:`repro_torch.core.tree`'s)."""
    out = []
    if isinstance(tree, dict):
        for k in sorted(tree):
            out += tree_paths(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out += tree_paths(v, f"{prefix}{i}/")
    else:
        out.append((prefix[:-1], tree))
    return out


def map_paths(fn, tree, prefix: str = ""):
    """``tree`` with every leaf replaced by ``fn(path, leaf)``."""
    if isinstance(tree, dict):
        return {k: map_paths(fn, v, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        vals = [map_paths(fn, v, f"{prefix}{i}/") for i, v in enumerate(tree)]
        return tuple(vals) if isinstance(tree, tuple) else vals
    return fn(prefix[:-1], tree)


def tree_pspecs(tree, mesh, kind: str = "param"):
    """The specs of a whole tree (of tensors, meta tensors or anything with
    a ``shape``; a leaf without one, a cache's ``len``, gets ``()``)."""
    fn = param_pspec if kind == "param" else cache_pspec
    return map_paths(
        lambda path, leaf: fn(path, tuple(getattr(leaf, "shape", ())), mesh),
        tree)


def to_placements(spec: Spec, device_mesh) -> tuple:
    """DTensor placements of ``spec`` on ``device_mesh``: ``Shard(d)`` on
    each mesh dimension that spec entry ``d`` names (a tuple such as
    ``("pod", "data")`` names two: the tensor dimension is split over both,
    the first-named major, as mesh order has it), ``Replicate()`` on every
    other."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(device_mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, ax in enumerate(spec):
        if ax is None:
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axes} out of the mesh's "
                             f"order {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def from_placements(placements: Sequence, device_mesh, ndim: int) -> Spec:
    """The spec that :func:`to_placements` maps to ``placements``."""
    names = tuple(device_mesh.mesh_dim_names)
    spec = [[] for _ in range(ndim)]
    for name, pl in zip(names, placements):
        if pl.is_shard():
            spec[pl.dim % ndim].append(name)
        elif not pl.is_replicate():
            raise ValueError(f"{pl} on {name}: a spec has no partial sum")
    return tuple(None if not a else a[0] if len(a) == 1 else tuple(a)
                 for a in spec)


def tree_shardings(tree, device_mesh, kind: str = "param"):
    """``(device_mesh, placements)`` for every leaf: the counterpart of a
    tree of ``NamedSharding``."""
    fn = param_pspec if kind == "param" else cache_pspec
    return map_paths(
        lambda path, leaf: (device_mesh, to_placements(
            fn(path, tuple(getattr(leaf, "shape", ())), device_mesh),
            device_mesh)),
        tree)


def _is_sharding(x) -> bool:
    return isinstance(x, tuple) and len(x) == 2 and hasattr(
        x[0], "mesh_dim_names")


def sharding_leaves(shardings) -> list:
    """The ``(device_mesh, placements)`` of a :func:`tree_shardings` tree
    in flatten order (dict keys sorted, lists in order), None where a
    leaf has none."""
    if _is_sharding(shardings) or shardings is None:
        return [shardings]
    if isinstance(shardings, dict):
        return [s for k in sorted(shardings)
                for s in sharding_leaves(shardings[k])]
    return [s for v in shardings for s in sharding_leaves(v)]


def distribute_tree(tree, shardings):
    """Every tensor leaf of ``tree`` as a DTensor placed by the matching
    ``(device_mesh, placements)`` of ``shardings``. The leaf must be the
    same full tensor on every rank: each rank keeps its own shard, and
    nothing is sent."""
    from torch.distributed.tensor import distribute_tensor

    def one(leaf, sh):
        mesh, placements = sh
        return distribute_tensor(leaf, mesh, placements, src_data_rank=None)

    return _zip_map(one, tree, shardings)


def place_tree(tree, device_mesh, kind: str = "param"):
    """``tree`` (whole tensors, the same on every rank: float or packed
    params, or caches) placed on ``device_mesh`` by ``param_pspec``
    (``kind="cache"``: ``cache_pspec``); each rank keeps its shard of each
    leaf. Packed planes are split as ``_packed_spec`` says: a column-
    parallel projection's N, a row-parallel one's K words."""
    return distribute_tree(tree, tree_shardings(tree, device_mesh, kind))


def _zip_map(fn, tree, other):
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, other[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not _is_sharding(other):
        vals = [_zip_map(fn, v, o) for v, o in zip(tree, other)]
        return tuple(vals) if isinstance(tree, tuple) else vals
    return fn(tree, other) if torch.is_tensor(tree) else tree


def spec_shards(spec: Spec, mesh) -> int:
    """How many ways ``spec`` splits its tensor: the product of the sizes
    of every axis it names (a leaf's bytes per device are its bytes over
    this)."""
    sizes = mesh_sizes(mesh)
    n = 1
    for ax in spec:
        if ax is None:
            continue
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            n *= sizes[a]
    return n


def local_shape(spec: Spec, shape: Tuple[int, ...],
                device_mesh) -> Tuple[int, ...]:
    """The shape of this rank's shard of a tensor of ``shape`` placed by
    ``spec`` (each split dimension over the product of its axes)."""
    sizes = dict(zip(device_mesh.mesh_dim_names, tuple(device_mesh.shape)))
    out = []
    for d, ax in enumerate(spec):
        n = 1
        for a in (() if ax is None else ax if isinstance(ax, tuple)
                  else (ax,)):
            n *= sizes[a]
        out.append(shape[d] // n)
    return tuple(out)


def local_slices(spec: Spec, shape: Tuple[int, ...], device_mesh,
                 coords: Optional[Sequence[int]] = None) -> tuple:
    """The index of this rank's shard of a tensor of ``shape`` placed by
    ``spec``: one ``slice`` per dimension (the even split
    :func:`to_placements` makes; a spec only names dims its axes divide).
    ``coords`` is the rank's place on the mesh (default: its own)."""
    names = tuple(device_mesh.mesh_dim_names)
    sizes = dict(zip(names, tuple(device_mesh.shape)))
    if coords is None:
        coords = device_mesh.get_coordinate()
    at = dict(zip(names, coords))
    out = []
    for d, ax in enumerate(spec):
        if ax is None:
            out.append(slice(None))
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        n, i = 1, 0
        for a in axes:                         # first-named major
            i = i * sizes[a] + at[a]
            n *= sizes[a]
        step = shape[d] // n
        out.append(slice(None) if n == 1 else
                   slice(i * step, (i + 1) * step))
    return tuple(out)
