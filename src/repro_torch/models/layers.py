"""Quantization-aware building blocks shared by the port's models.

Counterpart of ``repro/models/layers.py``. Every matmul-bearing layer goes
through :func:`qdense`, which dispatches on its parameters:

* float params (``{"w"[, "b"]}``, mode ``none``) — a plain matmul in the
  input's dtype (the LM head, the first and last layers);
* packed params (``{"w_packed", "scale", "alpha_a"[, "b"]}``, from
  :func:`pack_qdense`) — the deployment path: runtime activation
  quantization → bit-serial matmul over bit-transposed packed weights →
  the fused scaler/bias epilogue. With ``QuantPolicy.pack_acts`` the
  activations are quantized and packed by K1 and multiplied by K3; without
  it they are quantized to int32 codes and multiplied by K4.
  :func:`qdense_shared` runs the projections of one activation with one K1
  launch for all of them. On placed params (DTensors over a mesh, a
  sharded server) each rank runs the kernels on its own planes: see
  :func:`_placed_qdense`.

* float params in mode ``qat`` (``{"w", "alpha_w", "alpha_a"}``) — LSQ
  fake-quant of the weights and the input, then the matmul: the reference's
  quant-aware training path, differentiable through LSQ's straight-through
  estimator (MLA's prefill runs its forward on the unpacked
  ``w_uk``/``w_uv``).

Parameters are plain dicts; layer stacks carry a leading ``(L, ...)`` axis
on every leaf.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import bitops
from repro_torch.core.bitserial import SerialSpec, plan_spec
from repro_torch.core.quant import (QuantSpec, init_alpha, lsq_fake_quant,
                                    quantize_int, qrange)
from repro_torch.distributed import placed
from repro_torch.kernels import ops
from repro_torch.kernels.epilogue import epilogue

__all__ = ["QuantPolicy", "DEFAULT_POLICY", "qdense_init", "qdense",
           "qdense_shared", "pack_qdense", "pack_weight_codes", "rms_norm",
           "layer_norm", "rotary", "apply_rotary", "device_scalar"]


@dataclasses.dataclass(frozen=True)
class QuantPolicy:
    """Per-layer-class precision policy (the per-MVU CSR precision
    settings). ``mode``: 'none' | 'qat' | 'serial'. ``radix_bits`` selects
    the faithful bit-serial (1) or digit-serial (7/8) plan of the plain
    path; the integer result does not depend on it.

    ``pack_acts`` carries activations bit-packed into the matmul (K1 + K3)
    instead of as int32 codes (K4). ``plain`` runs the kernels' plain
    versions whatever the device — the yardstick the card's kernels are
    held against, never a fallback."""

    mode: str = "none"
    w_bits: int = 4
    a_bits: int = 8
    w_signed: bool = True
    a_signed: bool = True
    radix_bits: int = 7
    pack_acts: bool = False
    plain: bool = False

    def spec(self) -> SerialSpec:
        return SerialSpec(self.a_bits, self.w_bits, self.a_signed,
                          self.w_signed, self.radix_bits)


DEFAULT_POLICY = QuantPolicy()


def qdense_init(gen: torch.Generator, k: int, n: int, policy: QuantPolicy, *,
                bias: bool = False, scale: Optional[float] = None,
                lead: tuple = ()) -> dict:
    """Float parameters of a quant-aware dense layer, drawn on
    ``gen.device``; ``lead`` prepends stacking axes to every leaf (the
    reference's ``vmap`` over a layer stack). Mode ``qat`` adds the LSQ
    step sizes at their initial values, as the reference does."""
    std = scale if scale is not None else 1.0 / np.sqrt(k)
    dev = gen.device
    # scaled in place: a (152064, 8192) head is 5 GB in float32
    p = {"w": torch.randn(lead + (k, n), generator=gen, device=dev).mul_(std)}
    if bias:
        p["b"] = torch.zeros(lead + (n,), device=dev)
    if policy.mode == "qat":
        _, qpw = qrange(policy.w_bits, policy.w_signed)
        _, qpa = qrange(policy.a_bits, policy.a_signed)
        p["alpha_w"] = torch.full(lead + (1, n),
                                  2.0 * std / np.sqrt(max(qpw, 1)), device=dev)
        p["alpha_a"] = torch.full(lead, 2.0 / np.sqrt(max(qpa, 1)),
                                  device=dev)
    return p


def qdense(p: dict, x: torch.Tensor, policy: QuantPolicy, *,
           raw_acc: bool = False) -> torch.Tensor:
    """Apply a quant-aware dense layer over (..., K); dispatches on the
    parameters. The output has ``x``'s dtype: the kernels emit float32 and
    it is cast once after them, as the reference's kernel does. With
    ``raw_acc`` (packed params) the kernel runs in accumulator mode and
    the raw int32 (..., N) accumulator comes back: no scale, bias or cast
    (a row-parallel rank's part of the sum, :func:`_placed_qdense`)."""
    if "w_packed" in p and placed.is_placed(p["w_packed"]):
        return _placed_qdense([p], x, policy)[0]
    if "w_packed" in p:
        aspec = QuantSpec(policy.a_bits, policy.a_signed)
        if policy.pack_acts:
            # K1 reads x in its own dtype and divides in float32
            xp = ops.quantize_pack_activations(x, p["alpha_a"], aspec,
                                               plain=policy.plain)
            return _packed_matmul(p, xp, x, policy, raw_acc)
        # the reference divides bf16 by a float32 step in float32
        codes = quantize_int(x.to(torch.float32), p["alpha_a"], aspec)
        out = ops.serial_matmul_op(codes, p["w_packed"],
                                   *_epilogue_args(p, raw_acc),
                                   spec=plan_spec(policy.spec()),
                                   k=x.shape[-1], plain=policy.plain,
                                   raw_acc=raw_acc)
        return out if raw_acc else out.to(x.dtype)
    w = p["w"]
    if policy.mode == "qat" and "alpha_w" in p:
        # the forward of LSQ fake-quant, as the reference's qdense
        wspec = QuantSpec(policy.w_bits, policy.w_signed, per_channel=True)
        aspec = QuantSpec(policy.a_bits, policy.a_signed)
        w = lsq_fake_quant(w, p["alpha_w"].to(w.dtype), wspec)
        x = lsq_fake_quant(x, p["alpha_a"].to(x.dtype), aspec)
    out = torch.matmul(x, w.to(x.dtype))
    if "b" in p:
        out = out + p["b"].to(x.dtype)
    return out


def _epilogue_args(p: dict, raw_acc: bool = False) -> tuple:
    """The fused epilogue's ``(scale, bias)`` of packed params: the weight
    scale times the activation step, in float32; none in accumulator
    mode."""
    if raw_acc:
        return None, None
    return (p["scale"] * p["alpha_a"]).to(torch.float32), p.get("b")


def _packed_matmul(p: dict, xp: torch.Tensor, x: torch.Tensor,
                   policy: QuantPolicy, raw_acc: bool = False
                   ) -> torch.Tensor:
    """The packed half of :func:`qdense`: K3 on ``xp``, the planes K1 made
    of ``x`` with ``p``'s step, cast to ``x``'s dtype (with ``raw_acc``
    the int32 accumulator)."""
    out = ops.serial_matmul_packed_op(
        xp, p["w_packed"], *_epilogue_args(p, raw_acc),
        spec=plan_spec(policy.spec()), k=x.shape[-1], plain=policy.plain,
        raw_acc=raw_acc)
    return out if raw_acc else out.to(x.dtype)


def qdense_shared(ps: Sequence[dict], x: torch.Tensor,
                  policy: QuantPolicy, *,
                  raw_acc: bool = False) -> List[torch.Tensor]:
    """Returns exactly ``[qdense(p, x, policy, raw_acc=raw_acc) for p in
    ps]``: the projections of one activation (q/k/v, gate/up).

    On packed params with ``pack_acts`` one K1 launch quantize-packs ``x``
    for every member's step size (at most four), then one K3 runs per
    member; otherwise (float params, the K4 path) :func:`qdense` runs per
    member. The same function, launched fewer times; the reference has no
    counterpart."""
    if all("w_packed" in p and placed.is_placed(p["w_packed"]) for p in ps):
        return _placed_qdense(ps, x, policy)
    if policy.pack_acts and all("w_packed" in p for p in ps):
        aspec = QuantSpec(policy.a_bits, policy.a_signed)
        xp = ops.quantize_pack_activations_multi(
            x, [p["alpha_a"] for p in ps], aspec, plain=policy.plain)
        return [_packed_matmul(p, xp[g], x, policy, raw_acc)
                for g, p in enumerate(ps)]
    return [qdense(p, x, policy, raw_acc=raw_acc) for p in ps]


def _placed_qdense(ps: Sequence[dict], x, policy: QuantPolicy) -> list:
    """:func:`qdense_shared` on placed packed params (a sharded server):
    each rank runs :func:`qdense_shared` on its local activation and its
    local planes, ``scale``, ``b`` and step (one K1 launch for all of
    ``ps``, then K3 or K4).

    The planes (…, bits, ceil(K/32), N) are split as ``param_pspec``
    places them. A split of N (column-parallel: q/k/v, gate/up) takes the
    whole K on each rank and leaves the output split the same way, with
    the rank's ``scale`` and ``b``. A split of the K words (row-parallel:
    o, down) takes the rank's K range, 32 lanes a word; every rank then
    runs its kernel in accumulator mode (``raw_acc``: int32, no
    epilogue), the accumulators are summed over those mesh dimensions in
    int32 (a ``Partial`` → ``Replicate`` redistribution: an all-reduce),
    and the plain epilogue (one FMA) runs once on the sum. That is the
    reference's arithmetic, whose partitioned dot reduces the int32
    accumulator before the scale, so the result equals the unsharded
    kernel's bit for bit. The local activation is taken as it lies when
    its split matches the planes' words; otherwise (a split that does not
    line up with the words, or a dimension the planes left whole because
    it did not divide) it is gathered first and sliced, never packed from
    a slice that straddles a word. Returns DTensors: the activation's row
    splits kept, N split where the planes split it."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    w0 = ps[0]["w_packed"]
    mesh = w0.device_mesh
    rows_on = _words_split(w0)
    if len(ps) > 1 and any(_words_split(p["w_packed"]) != rows_on
                           for p in ps):
        return [_placed_qdense([p], x, policy)[0] for p in ps]
    if not placed.is_placed(x):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim)
    last = x.ndim - 1
    k = x.shape[-1]
    k_lo, k_hi = 0, k
    if rows_on:
        kw = w0.shape[-2]
        w_lo, w_n = placed.mesh_offset(mesh, w0.placements, w0.ndim - 2, kw)
        k_lo, k_hi = 32 * w_lo, min(k, 32 * (w_lo + w_n))
    x_loc = _local_range(x, rows_on, k, k_lo, k_hi)
    xpl = [p if p.is_shard() and p.dim % x.ndim != last else Replicate()
           for p in x.placements]
    local = [{n: placed.local_of(t) for n, t in p.items()} for p in ps]
    accs = qdense_shared(local, x_loc, policy, raw_acc=bool(rows_on))
    outs = []
    for p, lp, acc in zip(ps, local, accs):
        w = p["w_packed"]
        n_pl = []
        for i, pw in enumerate(w.placements):
            if pw.is_shard() and xpl[i].is_shard():
                raise ValueError(f"mesh dimension {i} splits both the "
                                 "activation's rows and the planes")
            n_pl.append(xpl[i] if xpl[i].is_shard() else
                        Partial() if i in rows_on else
                        Shard(last) if pw.is_shard(w.ndim - 1) else
                        Replicate())
        shape = torch.Size(tuple(x.shape[:-1]) + (w.shape[-1],))
        stride = placed.contiguous_stride(shape)
        if rows_on:
            # the int32 accumulators summed over the ranks of the K split,
            # then the epilogue once, with the bias added once
            summed = DTensor.from_local(
                acc, mesh, n_pl, shape=shape, stride=stride).redistribute(
                    mesh, [Replicate() if q.is_partial() else q
                           for q in n_pl])
            acc = epilogue(summed.to_local(), *_epilogue_args(lp),
                           relu=False, requant=None).to(x.dtype)
            n_pl = list(summed.placements)
        outs.append(DTensor.from_local(acc, mesh, n_pl, shape=shape,
                                       stride=stride))
    return outs


def _words_split(w) -> list:
    """The mesh dimensions that split a placed packed weight's K words."""
    return [i for i, p in enumerate(w.placements) if p.is_shard(w.ndim - 2)]


def _local_range(x, rows_on: list, k: int, k_lo: int, k_hi: int):
    """This rank's local activation holding K columns ``[k_lo, k_hi)`` of
    its rows: ``x``'s own shard when its K split over ``rows_on`` is
    exactly that range, else ``x`` made whole in K (a pending partial sum
    reduced) and sliced."""
    from torch.distributed.tensor import Replicate
    last = x.ndim - 1
    split = [i for i, p in enumerate(x.placements) if p.is_shard(last)]
    if rows_on and split == rows_on and not any(
            p.is_partial() for p in x.placements):
        try:
            lo, n = placed.mesh_offset(x.device_mesh, x.placements, last, k)
        except ValueError:            # an uneven split
            lo, n = -1, 0
        if (lo, lo + n) == (k_lo, k_hi):
            return placed.local_of(x)
    whole = [Replicate() if p.is_partial() or p.is_shard(last) else p
             for p in x.placements]
    if whole != list(x.placements):
        x = x.redistribute(x.device_mesh, whole)
    loc = placed.local_of(x)
    return loc if (k_lo, k_hi) == (0, k) else loc[..., k_lo:k_hi]


#: columns of one matrix packed at a time at most ``PACK_ELEMS // K``: the
#: packing's temporaries (int64 bit planes, 16 B a weight) stay near 1 GB
#: at any width
PACK_ELEMS = 1 << 24


def pack_weight_codes(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """(K, N) integer weight codes → (bits, ceil(K/32), N) int32 words,
    ``PACK_ELEMS // K`` columns at a time."""
    k, n = codes.shape
    out = torch.empty((bits, -(-k // 32), n), dtype=torch.int32,
                      device=codes.device)
    cols = max(1, PACK_ELEMS // k)
    for c in range(0, n, cols):
        planes = bitops.pad_to(
            bitops.to_bitplanes(codes[:, c:c + cols], bits), 32, axis=-2)
        out[..., c:c + cols] = bitops.pack_bitplanes(planes, axis=-2)
    return out


def pack_qdense(p: dict, policy: QuantPolicy) -> dict:
    """Export float params → deployment params: packed bit-transposed
    weight codes (..., w_bits, ceil(K/32), N) and the per-output-channel
    ``scale``. Works on single (K, N) and stacked (L, K, N) weights; a
    stack is packed one matrix at a time, which bounds the temporaries."""
    w = p["w"]
    n = w.shape[-1]
    wspec = QuantSpec(policy.w_bits, policy.w_signed, per_channel=True)
    alpha_w = p.get("alpha_w")
    if alpha_w is None:
        alpha_w = init_alpha(w, wspec, axis=-2)
    alpha_w = torch.clamp_min(torch.abs(alpha_w), 1e-8)
    alpha_w = alpha_w.expand(tuple(w.shape[:-2]) + (1, n))
    lead = tuple(w.shape[:-2])
    flat_w = w.reshape((-1,) + tuple(w.shape[-2:]))
    flat_a = alpha_w.reshape((-1, 1, n))
    packed = torch.stack([
        pack_weight_codes(quantize_int(flat_w[i], flat_a[i], wspec),
                          wspec.bits)
        for i in range(flat_w.shape[0])])
    out = {
        "w_packed": packed.reshape(lead + tuple(packed.shape[1:])),
        "scale": alpha_w[..., 0, :].to(torch.float32).contiguous(),
        "alpha_a": torch.as_tensor(p.get("alpha_a", 0.05),
                                   dtype=torch.float32, device=w.device),
    }
    if "b" in p:
        out["b"] = p["b"]
    return out


# ---------------------------------------------------------------- norms/rope

@functools.lru_cache(maxsize=None)
def device_scalar(value: float, device: torch.device) -> torch.Tensor:
    """``value`` as a 0-d float32 tensor on ``device``, made once per
    (value, device) and shared: callers must not write to it. A step
    captured as a CUDA graph may copy nothing from the host, and torch's
    CUDA divide by a host scalar multiplies by its reciprocal instead of
    dividing; a device tensor made here divides exactly and copies once.
    It is made outside inference mode, so that training may save it for
    backward after a server made it under ``torch.inference_mode``."""
    with torch.inference_mode(False):
        return torch.tensor(value, dtype=torch.float32, device=device)


def rms_norm(x: torch.Tensor, w: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * w.to(torch.float32)).to(dt)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * w.to(torch.float32) + b.to(torch.float32)).to(dt)


def rotary(positions: torch.Tensor, dim: int, theta: float = 10000.0,
           dtype: torch.dtype = torch.float32):
    """Rotary cos/sin tables for ``positions`` (any shape) over ``dim``."""
    dev = positions.device
    expo = torch.arange(0, dim, 2, dtype=torch.float32, device=dev) / dim
    inv = 1.0 / (device_scalar(float(theta), dev) ** expo)
    ang = positions.to(torch.float32)[..., None] * inv
    return torch.cos(ang).to(dtype), torch.sin(ang).to(dtype)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                 rotary_dim: Optional[int] = None) -> torch.Tensor:
    """Apply rotary embedding to (..., S, H, Dh) over interleaved pairs;
    supports partial rotary (the first ``rotary_dim`` channels)."""
    d = x.shape[-1]
    rd = rotary_dim or d
    xr, xp = x[..., :rd], x[..., rd:]
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    c = cos[..., None, :]   # (..., S, rd/2) -> broadcast over heads
    s = sin[..., None, :]
    o1 = x1 * c - x2 * s
    o2 = x2 * c + x1 * s
    out = torch.stack([o1, o2], dim=-1).reshape(xr.shape)
    if rd < d:
        out = torch.cat([out, xp.to(out.dtype)], dim=-1)
    return out.to(x.dtype)
