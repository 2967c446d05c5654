"""AdamW + schedules on nested dict/list trees of tensors.

Counterpart of ``repro/optim/optimizer.py``, expression for expression and
in its order: bias corrections with a float32 ``step``, ``delta = mhat /
(sqrt(vhat) + eps)``, decoupled weight decay ``+ wd * p`` on leaves with
``ndim >= 2`` only, ``p - lr * delta`` in float32 cast back to ``p``'s
dtype, and an int32 ``step`` counter. ``torch.optim.AdamW`` is another
function: it decays before the moment update and decays every leaf.

An update is out of place, the caller's trees not written, unless it is
asked to write in place (``inplace``: the counterpart of a donated state),
where each leaf's new params and moments are computed a slab at a time and
copied into the old ones, so one state is alive, not two. The clipped
gradient is formed leaf by leaf in either case; the arithmetic is the
same, element for element. Scalars
that divide are float32 tensors on the leaves' device, because torch's
``scalar / tensor`` multiplies by the reciprocal and CUDA's ``tensor /
host scalar`` does too, where the reference divides. They are made once
per value and device (``device_scalar``): a fresh host-to-device copy
would make the host wait for the queued step.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch

from repro_torch.core.tree import tree_flatten, tree_leaves, tree_unflatten
from repro_torch.distributed import placed
from repro_torch.models.layers import device_scalar

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cosine_lr",
           "global_norm", "clip_by_global_norm", "reduce_gradients"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def cosine_lr(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup to ``lr``, then a cosine decay to ``min_lr_frac *
    lr`` at ``total_steps``; a float32 0-d tensor on ``step``'s device."""
    step = torch.as_tensor(step).to(torch.float32)
    dev = step.device
    warmup = float(max(cfg.warmup_steps, 1))
    warm = torch.clamp_max(step / device_scalar(warmup, dev), 1.0)
    span = float(max(cfg.total_steps - cfg.warmup_steps, 1))
    prog = torch.clamp((step - cfg.warmup_steps) / device_scalar(span, dev),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def _zeros(p) -> torch.Tensor:
    """float32 zeros of ``p``'s shape on its device (placed as ``p`` is)."""
    if placed.is_placed(p):
        return torch.zeros_like(p, dtype=torch.float32)
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def adamw_init(params) -> Dict[str, Any]:
    leaves, treedef = tree_flatten(params)
    zeros = lambda: tree_unflatten(treedef, [_zeros(p) for p in leaves])
    dev = leaves[0].device if leaves else None
    return {"m": zeros(), "v": zeros(),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's sum of squares (float32), summed
    leaf by leaf in the reference's leaf order. On placed leaves
    (DTensors, no partial sums) each rank sums its shards' squares, a
    shard held whole by r ranks counted 1/r on each, and one all-reduce
    over the mesh adds the ranks' sums: a plain 0-d tensor, the same on
    every rank."""
    total = 0
    mesh = None
    for g in tree_leaves(tree):
        if placed.is_placed(g):
            mesh = g.device_mesh
            s = torch.sum(torch.square(g.to_local().to(torch.float32)))
            reps = placed.replicas(g)
            total = total + (s / reps if reps > 1 else s)
        else:
            total = total + torch.sum(torch.square(g.to(torch.float32)))
    if mesh is not None:
        total = placed.sum_over_mesh(total, mesh)
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def _clip_scale(grads, max_norm: float):
    """``(min(1, max_norm / (norm + 1e-9)), norm)``, 0-d float32."""
    gn = global_norm(grads)
    return torch.clamp_max(device_scalar(float(max_norm), gn.device)
                           / (gn + 1e-9), 1.0), gn


def clip_by_global_norm(grads, max_norm: float):
    """``(grads * min(1, max_norm / (norm + 1e-9)), norm)``, the grads in
    float32."""
    scale, gn = _clip_scale(grads, max_norm)
    leaves, treedef = tree_flatten(grads)
    return tree_unflatten(treedef, [g.to(torch.float32) * scale
                                    for g in leaves]), gn


#: the elements an in-place update computes at a time (its temporaries)
SLAB_ELEMS = 1 << 26


def reduce_gradients(grads, params):
    """Each placed gradient brought to its parameter's placements: a
    partial sum over the DP axes (a replicated leaf's gradient from each
    rank's rows) is the data-parallel all-reduce; the loss is already the
    mean over the whole batch. Plain gradients pass as they are."""
    g_l, treedef = tree_flatten(grads)
    p_l = tree_flatten(params)[0]
    return tree_unflatten(treedef, [
        g.redistribute(p.device_mesh, p.placements)
        if placed.is_placed(g) and tuple(g.placements) != tuple(p.placements)
        else g for g, p in zip(g_l, p_l)])


def adamw_update(params, grads, opt_state, cfg: AdamWConfig, *,
                 inplace: bool = False):
    """One AdamW step; returns ``(params, opt_state, metrics)`` with
    metrics ``lr`` and ``grad_norm`` (0-d float32 tensors). ``inplace``
    writes the new params and moments into ``params`` and ``opt_state``'s
    tensors (contiguous, as drawn, restored or updated here), a slab of
    :data:`SLAB_ELEMS` elements at a time, and returns them; the step
    counter is a new tensor either way.

    Placed params (DTensors) take their gradients reduced first
    (:func:`reduce_gradients`); the norm is global, and the update, which
    is elementwise, runs on each rank's local shards (the slabs too) with
    the same arithmetic. The step counter comes back a plain tensor."""
    grads = reduce_gradients(grads, params)
    step = opt_state["step"]
    if placed.is_placed(step):
        step = step.to_local()
    step = step + 1
    lr = cosine_lr(cfg, step)
    scale, gn = _clip_scale(grads, cfg.grad_clip)
    stepf = step.to(torch.float32)
    dev = stepf.device
    one = device_scalar(1.0, dev)
    c1 = one - device_scalar(cfg.b1, dev) ** stepf
    c2 = one - device_scalar(cfg.b2, dev) ** stepf

    def update(p, g, m, v, decay: bool):
        g = g.to(torch.float32) * scale      # the clipped gradient
        m2 = cfg.b1 * m + (1 - cfg.b1) * g
        v2 = cfg.b2 * v + (1 - cfg.b2) * g * g
        mhat = m2 / c1
        vhat = v2 / c2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        # decoupled weight decay on matrices only (ndim >= 2)
        if decay:
            delta = delta + cfg.weight_decay * p.to(torch.float32)
        return (p.to(torch.float32) - lr * delta).to(p.dtype), m2, v2

    p_l, treedef = tree_flatten(params)
    g_l = tree_flatten(grads)[0]
    m_l = tree_flatten(opt_state["m"])[0]
    v_l = tree_flatten(opt_state["v"])[0]
    new_p, new_m, new_v = [], [], []
    for p, g, m, v in zip(p_l, g_l, m_l, v_l):
        decay = p.dim() >= 2
        whole = p
        if placed.is_placed(p):
            p, g, m, v = (t.to_local() for t in (p, g, m, v))
        if inplace:
            flat = [t.view(-1) for t in (p, m, v)]
            gf = g.reshape(-1)
            for i in range(0, p.numel(), SLAB_ELEMS):
                sl = slice(i, i + SLAB_ELEMS)
                for dst, src in zip(flat, update(flat[0][sl], gf[sl],
                                                 flat[1][sl], flat[2][sl],
                                                 decay)):
                    dst[sl].copy_(src)
            p2, m2, v2 = p, m, v
        else:
            p2, m2, v2 = update(p, g, m, v, decay)
        if whole is not p:
            p2, m2, v2 = (placed.like(t, whole) for t in (p2, m2, v2))
        new_p.append(p2)
        new_m.append(m2)
        new_v.append(v2)
    return (tree_unflatten(treedef, new_p),
            {"m": tree_unflatten(treedef, new_m),
             "v": tree_unflatten(treedef, new_v), "step": step},
            {"lr": lr, "grad_norm": gn})
