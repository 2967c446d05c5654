"""Gradient compression for the data-parallel axes: int8 quantized
reduce-scatter/all-gather with error feedback — the paper's quantizer/
serializer applied to the *gradient* channel.

Counterpart of ``repro/distributed/compression.py``, expression for
expression: a per-device scale ``max|x| / 127 + 1e-12``, codes
``clip(round(x / scale), -127, 127)`` (round half to even) as int8, the
flat gradient padded to a multiple of the group's size. A ring all-reduce
of fp32 moves ``2·N·4`` bytes per device; this exchange moves ``2·N·1``
(int8 codes; the fp32 scales are one per device) — a 4x cut in
collective bytes. Error feedback (Karimireddy et al. 2019) keeps SGD
unbiased in the long run: the quantization residual is added back before
the next step's compression.

The reference runs inside ``shard_map`` over a named axis; here a call
runs on every rank of a ``torch.distributed`` process group (``group``,
default the whole world) with the collectives ``all_to_all_single`` and ``all_gather``. Like the reference's, it is a library: no
trainer uses it.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

from repro_torch.core.tree import tree_flatten, tree_unflatten
from repro_torch.models.layers import device_scalar

__all__ = ["compressed_allreduce_mean", "compress_tree", "init_error_state"]


def _quant(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 codes of ``x`` and its float32 0-d scale."""
    dev = x.device
    scale = (torch.max(torch.abs(x)) / device_scalar(127.0, dev)
             + device_scalar(1e-12, dev))
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """(n, *x.shape): every rank's ``x``, in rank order."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.stack(parts)


def compressed_allreduce_mean(g: torch.Tensor, group=None) -> torch.Tensor:
    """The mean of ``g`` over the ranks of ``group``, exchanging int8
    codes.

    Reduce-scatter phase: each rank quantizes its flat gradient (split
    into n chunks) with one scale and all-to-alls the codes, so rank d
    holds chunk d of every rank; it sums them dequantized in float32 and
    divides by n. All-gather phase: the reduced chunk is requantized and
    the codes (and the n scales) are all-gathered. Every rank returns the
    same tensor, of ``g``'s shape and dtype."""
    n = dist.get_world_size(group)
    flat = g.reshape(-1)
    pad = (-flat.numel()) % n
    flat = torch.nn.functional.pad(flat, (0, pad))
    chunks = flat.reshape(n, -1)
    q, scale = _quant(chunks)
    recv = torch.empty_like(q)
    # rank d receives chunk d from every peer (int8 on the wire)
    dist.all_to_all_single(recv, q, group=group)
    scales = _all_gather(scale.reshape(()), group)         # (n,) fp32
    local_sum = torch.sum(recv.to(torch.float32) * scales[:, None], dim=0) \
        / device_scalar(float(n), g.device)
    # second phase: requantize the reduced chunk, all-gather the codes
    q2, s2 = _quant(local_sum)
    gathered = _all_gather(q2, group)                      # (n, chunk) int8
    s2g = _all_gather(s2.reshape(()), group)
    out = (gathered.to(torch.float32) * s2g[:, None]).reshape(-1)
    return out[:g.numel()].reshape(g.shape).to(g.dtype)


def init_error_state(grads):
    """Zero residuals, one per gradient leaf."""
    leaves, treedef = tree_flatten(grads)
    return tree_unflatten(treedef, [torch.zeros_like(l) for l in leaves])


def compress_tree(grads, err, group=None):
    """Error-feedback compressed mean-reduce of a gradient tree over the
    ranks of ``group``. Returns ``(reduced_grads, new_err)``: each leaf's
    mean of (gradient + residual), and the residual of this rank's own
    quantization (what its int8 codes did not carry)."""
    g_l, treedef = tree_flatten(grads)
    e_l = tree_flatten(err)[0]
    reduced, new_err = [], []
    for g, e in zip(g_l, e_l):
        corrected = g.to(torch.float32) + e
        reduced.append(compressed_allreduce_mean(corrected, group).to(
            g.dtype))
        q, s = _quant(corrected.reshape(-1))
        recon = (q.to(torch.float32) * s).reshape(g.shape)
        new_err.append(corrected - recon)
    return tree_unflatten(treedef, reduced), tree_unflatten(treedef, new_err)
