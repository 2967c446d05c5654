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
  launch for all of them.

LSQ fake-quant (mode ``qat`` on float params) waits for the LSQ
straight-through estimator and raises. Parameters are plain dicts; layer
stacks carry a leading ``(L, ...)`` axis on every leaf.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import bitops
from repro_torch.core.bitserial import SerialSpec, plan_spec
from repro_torch.core.quant import QuantSpec, init_alpha, quantize_int, qrange
from repro_torch.kernels import ops

__all__ = ["QuantPolicy", "qdense_init", "qdense", "qdense_shared",
           "pack_qdense", "rms_norm",
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


def qdense_init(gen: torch.Generator, k: int, n: int, policy: QuantPolicy, *,
                bias: bool = False, scale: Optional[float] = None,
                lead: tuple = ()) -> dict:
    """Float parameters of a quant-aware dense layer, drawn on
    ``gen.device``; ``lead`` prepends stacking axes to every leaf (the
    reference's ``vmap`` over a layer stack). Mode ``qat`` adds the LSQ
    step sizes at their initial values, as the reference does."""
    std = scale if scale is not None else 1.0 / np.sqrt(k)
    dev = gen.device
    p = {"w": torch.randn(lead + (k, n), generator=gen, device=dev) * std}
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


def qdense(p: dict, x: torch.Tensor, policy: QuantPolicy) -> torch.Tensor:
    """Apply a quant-aware dense layer over (..., K); dispatches on the
    parameters. The output has ``x``'s dtype: the kernels emit float32 and
    it is cast once after them, as the reference's kernel does."""
    if "w_packed" in p:
        aspec = QuantSpec(policy.a_bits, policy.a_signed)
        if policy.pack_acts:
            # K1 reads x in its own dtype and divides in float32
            xp = ops.quantize_pack_activations(x, p["alpha_a"], aspec,
                                               plain=policy.plain)
            return _packed_matmul(p, xp, x, policy)
        # the reference divides bf16 by a float32 step in float32
        codes = quantize_int(x.to(torch.float32), p["alpha_a"], aspec)
        scale = (p["scale"] * p["alpha_a"]).to(torch.float32)
        out = ops.serial_matmul_op(codes, p["w_packed"], scale, p.get("b"),
                                   spec=plan_spec(policy.spec()),
                                   k=x.shape[-1], plain=policy.plain)
        return out.to(x.dtype)
    if policy.mode == "qat" and "alpha_w" in p:
        raise NotImplementedError(
            "LSQ fake-quant (mode 'qat' on float params) waits for the LSQ "
            "straight-through estimator; serve packed params instead")
    out = torch.matmul(x, p["w"].to(x.dtype))
    if "b" in p:
        out = out + p["b"].to(x.dtype)
    return out


def _packed_matmul(p: dict, xp: torch.Tensor, x: torch.Tensor,
                   policy: QuantPolicy) -> torch.Tensor:
    """The packed half of :func:`qdense`: K3 on ``xp``, the planes K1 made
    of ``x`` with ``p``'s step, cast to ``x``'s dtype."""
    scale = (p["scale"] * p["alpha_a"]).to(torch.float32)
    out = ops.serial_matmul_packed_op(
        xp, p["w_packed"], scale, p.get("b"), spec=plan_spec(policy.spec()),
        k=x.shape[-1], plain=policy.plain)
    return out.to(x.dtype)


def qdense_shared(ps: Sequence[dict], x: torch.Tensor,
                  policy: QuantPolicy) -> List[torch.Tensor]:
    """Returns exactly ``[qdense(p, x, policy) for p in ps]``: the
    projections of one activation (q/k/v, gate/up).

    On packed params with ``pack_acts`` one K1 launch quantize-packs ``x``
    for every member's step size (at most four), then one K3 runs per
    member; otherwise (float params, the K4 path) :func:`qdense` runs per
    member. The same function, launched fewer times; the reference has no
    counterpart."""
    if policy.pack_acts and all("w_packed" in p for p in ps):
        aspec = QuantSpec(policy.a_bits, policy.a_signed)
        xp = ops.quantize_pack_activations_multi(
            x, [p["alpha_a"] for p in ps], aspec, plain=policy.plain)
        return [_packed_matmul(p, xp[g], x, policy) for g, p in enumerate(ps)]
    return [qdense(p, x, policy) for p in ps]


def _pack_matrix(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """(K, N) integer codes → (bits, ceil(K/32), N) int32 words."""
    planes = bitops.pad_to(bitops.to_bitplanes(codes, bits), 32, axis=-2)
    return bitops.pack_bitplanes(planes, axis=-2)


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
        _pack_matrix(quantize_int(flat_w[i], flat_a[i], wspec), wspec.bits)
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
    dividing; a device tensor made here divides exactly and copies once."""
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
