"""Model code on placed tensors: the operations DTensor has no sharding
strategy for, run on each rank's shard.

The counterpart of what GSPMD does by itself inside the reference's
jitted step. Three operations of the models need it:

* :func:`embedding` — a lookup in a vocab-sharded table (the ``embed``
  rule of :func:`~repro_torch.distributed.sharding.param_pspec` splits the
  vocabulary over ``model``) by batch-sharded tokens: each rank looks up
  the tokens that fall in its rows, zeroes the rest, and the ranks' rows
  are summed (a vocab-parallel gather);
* the MoE's dispatch (``models/moe.py``): routing, capacity ranks and the
  scatter into the expert buffer run on local tensors, then each rank runs
  its experts;
* attention (:func:`per_head`): each rank attends its own rows and heads
  (DTensor's einsum flattens a split head dimension into a batched
  matmul, which it cannot do without a redistribution).

Both leave autograd whole: a local tensor comes from
:func:`local_of`, which states the placement its gradient has (a shard of
a batch-sharded input's gradient, a partial sum where the forward
replicated a tensor that the ranks then used on different rows), and
results go back through ``DTensor.from_local``. Everything here is for
DTensors; the models call it only when a parameter is one.
"""

from __future__ import annotations

import contextlib
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

__all__ = ["is_placed", "local_of", "mesh_offset", "local_rows", "embedding",
           "whole_dim", "per_head", "split_heads", "elementwise", "replicas",
           "sum_over_mesh", "like", "plain", "mesh_context",
           "contiguous_stride"]


def is_placed(t) -> bool:
    """Whether ``t`` is a DTensor (checked without importing DTensor for
    a plain tensor's sake on every call)."""
    return type(t) is not torch.Tensor and type(t).__name__ == "DTensor"


def local_of(t, grad_partial: Sequence[int] = ()):
    """``t``'s local shard as a plain tensor whose gradient comes back at
    ``t``'s placements, but a partial sum on the mesh dimensions in
    ``grad_partial`` (where the ranks of a dimension use the same shard on
    different data, each gradient is a part of the whole)."""
    from torch.distributed.tensor import Partial
    pls = [Partial() if i in grad_partial else p
           for i, p in enumerate(t.placements)]
    return t.to_local(grad_placements=pls)


def mesh_offset(mesh, placements, dim: int, size: int) -> Tuple[int, int]:
    """``(start, length)`` of this rank's slice of dimension ``dim`` (of
    global ``size``) under ``placements``, every ``Shard(dim)`` split even
    and in mesh order."""
    coord = mesh.get_coordinate()
    n, i = 1, 0
    for k, p in enumerate(placements):
        if p.is_shard(dim):
            i = i * mesh.size(k) + coord[k]
            n *= mesh.size(k)
    if size % n:
        raise ValueError(f"dimension {dim} of {size} over {n} ranks")
    step = size // n
    return i * step, step


def local_rows(t, mesh, rows_on: Sequence[int]) -> torch.Tensor:
    """This rank's rows of the placed ``t`` (B, ...) with the rows split
    over the mesh dimensions ``rows_on`` (as a placed batch's are) and
    whole over the others: ``t`` redistributed so (no collective when it
    lies so already), its local shard returned. Reads nothing on the
    host, so a captured step may call it."""
    from torch.distributed.tensor import Replicate, Shard
    pls = [Shard(0) if i in rows_on else Replicate() for i in range(mesh.ndim)]
    if list(t.placements) != pls:
        t = t.redistribute(mesh, pls)
    return t.to_local()


def embedding(table, tokens):
    """``F.embedding(tokens, table)`` for a placed ``table`` (V, D) whose
    rows may be split over some mesh dimensions (its D over others, which
    is gathered first) and ``tokens`` placed on the batch (or plain, whole
    on every rank). Returns a DTensor (..., D): the tokens' placements on
    their dimensions, every other mesh dimension whole."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = table.device_mesh
    rows_on = [k for k, p in enumerate(table.placements)
               if p.is_shard(0) and mesh.size(k) > 1]
    table = table.redistribute(
        mesh, [Shard(0) if k in rows_on else Replicate()
               for k in range(mesh.ndim)])
    if is_placed(tokens):
        tok_pls = list(tokens.placements)
        if any(tok_pls[k].is_shard() for k in rows_on):
            raise ValueError("tokens split over the mesh dimensions that "
                             "split the vocabulary")
        tok = tokens.to_local()
    else:
        tok_pls = [Replicate()] * mesh.ndim
        tok = tokens
    # the table's gradient from this rank's tokens is a part of the whole
    # wherever the tokens are split
    data_on = [k for k, p in enumerate(tok_pls) if p.is_shard()]
    local = local_of(table, grad_partial=data_on)
    lo, n = mesh_offset(mesh, table.placements, 0, table.shape[0])
    if not rows_on:
        out = F.embedding(tok, local)
    else:
        rel = tok - lo
        inside = (rel >= 0) & (rel < n)
        out = F.embedding(torch.where(inside, rel, torch.zeros_like(rel)),
                          local) * inside[..., None].to(local.dtype)
    pls = [Partial() if k in rows_on else tok_pls[k]
           for k in range(mesh.ndim)]
    shape = tuple(tokens.shape) + (table.shape[1],)
    out = DTensor.from_local(out, mesh, pls, shape=torch.Size(shape),
                             stride=contiguous_stride(shape))
    return out.redistribute(mesh, [Replicate() if p.is_partial() else p
                                   for p in pls])


def per_head(fn, q, k, v, **kw):
    """``fn(q, k, v, **kw)`` (attention: q (B, Sq, H, D), k and v (B, Sk,
    Hkv, D*), out (B, Sq, H, Dv)) on each rank's rows and heads: the batch
    stays split where ``q``'s is, the heads where ``q``'s are and the kv
    heads divide too (a q head's group then lies on its rank), every other
    mesh dimension whole; the result is placed alike."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = q.device_mesh
    pls = []
    for i, p in enumerate(q.placements):
        n = mesh.size(i)
        if p.is_shard(0) and q.shape[0] % n == 0:
            pls.append(Shard(0))
        elif p.is_shard(2) and k.shape[2] % n == 0:
            pls.append(Shard(2))
        else:
            pls.append(Replicate())
    ql, kl, vl = (t.redistribute(mesh, pls).to_local() for t in (q, k, v))
    out = fn(ql, kl, vl, **kw).contiguous()
    shape = tuple(q.shape[:3]) + (v.shape[-1],)
    return DTensor.from_local(out, mesh, pls, shape=torch.Size(shape),
                              stride=contiguous_stride(shape))


def whole_dim(t, dim: int):
    """``t`` redistributed so that dimension ``dim`` is whole on every
    rank and no partial sum is pending (its other splits kept): the
    vocabulary of the logits before the loss's ``logsumexp`` and gather,
    which DTensor cannot run on a split vocabulary."""
    from torch.distributed.tensor import Replicate
    dim = dim % t.ndim
    pls = [Replicate() if p.is_partial() or p.is_shard(dim) else p
           for p in t.placements]
    return t if pls == list(t.placements) else t.redistribute(
        t.device_mesh, pls)


def split_heads(t, n_heads: int, head_dim: int):
    """``t`` (..., n_heads·head_dim) reshaped to (..., n_heads, head_dim).
    A placed ``t`` whose last dimension is split over more ranks than
    ``n_heads`` divides (8 kv heads over a 16-way ``model`` axis) is made
    whole on those mesh dimensions first, which DTensor cannot do inside
    the view."""
    if is_placed(t):
        from torch.distributed.tensor import Replicate
        last = t.ndim - 1
        n = 1
        for k, p in enumerate(t.placements):
            if p.is_shard(last):
                n *= t.device_mesh.size(k)
        if n_heads % n:
            t = t.redistribute(t.device_mesh, [
                Replicate() if p.is_shard(last) else p
                for p in t.placements])
    return t.reshape(tuple(t.shape[:-1]) + (n_heads, head_dim))


def elementwise(fn, t):
    """``fn(t)`` for an elementwise ``fn``; on a placed ``t``, on each
    rank's shard (a pending partial sum reduced first), for an op DTensor
    has no strategy for (``softplus``'s backward)."""
    if not is_placed(t):
        return fn(t)
    from torch.distributed.tensor import DTensor, Replicate
    if any(p.is_partial() for p in t.placements):
        t = t.redistribute(t.device_mesh, [
            Replicate() if p.is_partial() else p for p in t.placements])
    return DTensor.from_local(fn(t.to_local()), t.device_mesh, t.placements,
                              shape=t.shape, stride=t.stride())


def replicas(t) -> int:
    """How many ranks hold each element of ``t`` (the product of the mesh
    sizes ``t`` is whole over); a pending partial sum raises."""
    n = 1
    for i, p in enumerate(t.placements):
        if p.is_partial():
            raise ValueError(f"{t.placements}: a partial sum is pending")
        if p.is_replicate():
            n *= t.device_mesh.size(i)
    return n


def sum_over_mesh(x: torch.Tensor, mesh) -> torch.Tensor:
    """A plain tensor summed over every rank of ``mesh`` (an all-reduce
    per mesh dimension), returned plain."""
    from torch.distributed.tensor import DTensor, Partial
    return DTensor.from_local(x, mesh, [Partial()] * mesh.ndim).full_tensor()


def like(local: torch.Tensor, ref):
    """``local`` (a shard of ``ref``'s shape) as a DTensor placed as
    ``ref``."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local, ref.device_mesh, ref.placements,
                              shape=ref.shape, stride=ref.stride())


def plain(t):
    """A plain tensor: a placed one gathered whole (a collective: every
    rank calls it), anything else as it is."""
    return t.full_tensor() if is_placed(t) else t


@contextlib.contextmanager
def mesh_context(mesh):
    """The context a placed step runs in: the logical axes bound as the
    reference's ``Trainer`` binds them (``dp`` the DP axes, ``tp``
    ``model``), and plain tensors made inside the model (rotary tables,
    masks, constants) taken as whole on every rank."""
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.distributed.context import bind_axes
    from repro_torch.distributed.sharding import dp_axes_of
    with implicit_replication(), bind_axes(dp=dp_axes_of(mesh), tp="model",
                                           mesh=mesh):
        yield


def contiguous_stride(shape) -> Tuple[int, ...]:
    """The strides of a contiguous tensor of ``shape`` (a DTensor's
    global strides for ``from_local``)."""
    stride, acc = [], 1
    for s in reversed(shape):
        stride.append(acc)
        acc *= s
    return tuple(reversed(stride))
