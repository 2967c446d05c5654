"""Quantization: LSQ (Learned Step Size Quantization, Esser et al. 2020)
quantization-aware training, PTQ calibration and the integer/packed
deployment path.

Counterpart of ``repro/core/quant.py``: :func:`lsq_fake_quant` is LSQ's
fake quantization with its straight-through estimator and gradient-scaled
step-size learning (the reference's ``_lsq`` custom VJP as a
``torch.autograd.Function``); :func:`calibrate` is the PTQ step from a
percentile. ``quantize_int`` is the serve-path quantizer: IEEE division,
round half to even, clip — the same expression as the reference and as the
CUDA kernels (``rintf(__fdiv_rn(x, alpha))``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import bitops

__all__ = [
    "QuantSpec",
    "qrange",
    "lsq_fake_quant",
    "init_alpha",
    "quantize_int",
    "dequantize",
    "calibrate",
    "pack_weights",
    "QuantizedWeight",
    "pack_conv_weights",
    "QuantizedConvWeight",
]


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """Precision of one tensor channel of the pipeline (weights or acts)."""

    bits: int = 8
    signed: bool = True
    per_channel: bool = False  # weights: scale per output channel

    def __post_init__(self):
        if not 1 <= self.bits <= 16:
            raise ValueError("bits must be in 1..16 (MVU operand range)")


def qrange(bits: int, signed: bool) -> tuple[int, int]:
    if signed:
        return -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    return 0, (1 << bits) - 1


def _unbroadcast(x: torch.Tensor, shape: tuple) -> torch.Tensor:
    """Sum ``x`` down to ``shape`` (inverse of numpy broadcasting)."""
    if shape == ():
        return torch.sum(x)
    extra = x.dim() - len(shape)
    if extra:
        x = torch.sum(x, dim=tuple(range(extra)))
    axes = tuple(i for i, s in enumerate(shape) if s == 1 and x.shape[i] != 1)
    if axes:
        x = torch.sum(x, dim=axes, keepdim=True)
    return x


class _LSQ(torch.autograd.Function):
    """``clip(round(x / alpha), qn, qp) * alpha`` with LSQ's gradients
    (the reference's ``_lsq_fwd``/``_lsq_bwd``): ``dx`` passes ``g``
    inside the clip range; ``dalpha`` is ``round(q) - q`` inside, ``qn``/
    ``qp`` at the clips, times ``g``, summed down to alpha's shape and
    scaled by ``gscale``. The residual is ``q = x / alpha``."""

    @staticmethod
    def forward(ctx, x, alpha, qn: float, qp: float, gscale: float):
        q = x / alpha
        ctx.save_for_backward(q, alpha)
        ctx.bounds = (qn, qp, gscale)
        return torch.clamp(torch.round(q), qn, qp) * alpha

    @staticmethod
    def backward(ctx, g):
        q, alpha = ctx.saved_tensors
        qn, qp, gscale = ctx.bounds
        lower = q <= qn
        upper = q >= qp
        mid = torch.logical_not(torch.logical_or(lower, upper))
        dx = torch.where(mid, g, 0.0)
        # the clip values as 0-d tensors of g's dtype (Python scalars would
        # make the result float32, where the reference keeps g's dtype)
        bound = lambda v: torch.full((), v, dtype=g.dtype, device=g.device)
        edge = torch.where(lower, bound(qn), bound(qp))
        dalpha_elem = torch.where(mid, torch.round(q) - q, edge) * g
        dalpha = _unbroadcast(dalpha_elem, tuple(alpha.shape)) * gscale
        return dx, dalpha.to(alpha.dtype), None, None, None


def lsq_fake_quant(x: torch.Tensor, alpha: torch.Tensor,
                   spec: QuantSpec, numel: Optional[int] = None
                   ) -> torch.Tensor:
    """LSQ fake quantization, differentiable wrt both ``x`` and ``alpha``:
    ``clip(round(x / a), Qn, Qp) * a`` with ``a = max(|alpha|, 1e-8)``
    cast to ``x``'s dtype, as the reference computes it. ``alpha`` is a
    scalar (per-tensor) or broadcastable (per-channel) step size; the LSQ
    gradient scale ``1/sqrt(N * Qp)`` stabilizes step-size learning
    (Esser et al., §2.2). The clamp and the sign stay outside the
    estimator, so autograd carries them as the reference's does.
    ``numel`` is the count N is taken from (default ``x.numel()``): a rank
    that quantizes its part of a tensor passes the whole one's."""
    qn, qp = qrange(spec.bits, spec.signed)
    n = (x.numel() if numel is None else numel) / max(1, alpha.numel())
    gscale = 1.0 / np.sqrt(max(1.0, n * max(qp, 1)))
    a = torch.clamp_min(torch.abs(alpha), 1e-8).to(x.dtype)
    return _LSQ.apply(x, a, float(qn), float(qp), float(gscale))


def init_alpha(x: torch.Tensor, spec: QuantSpec, axis=None) -> torch.Tensor:
    """LSQ init: 2 * mean|x| / sqrt(Qp). The mean sums in torch's order,
    so the result may sit a few ulps from the reference's.

    The divisor is a float32 tensor on ``x``'s device: torch's CUDA divide
    by a host scalar multiplies by its reciprocal instead of dividing."""
    _, qp = qrange(spec.bits, spec.signed)
    if axis is None:
        m = torch.mean(torch.abs(x))
    else:
        m = torch.mean(torch.abs(x), dim=axis, keepdim=True)
    root = torch.tensor(np.sqrt(max(qp, 1)), dtype=torch.float32,
                        device=x.device)
    return 2.0 * m / root + 1e-8


def quantize_int(x: torch.Tensor, alpha: torch.Tensor,
                 spec: QuantSpec) -> torch.Tensor:
    """Integer quantization: int32 codes ``clip(round(x / alpha), Qn, Qp)``."""
    qn, qp = qrange(spec.bits, spec.signed)
    return torch.clamp(torch.round(x / alpha), qn, qp).to(torch.int32)


def dequantize(q: torch.Tensor, alpha: torch.Tensor,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return q.to(dtype) * alpha.to(dtype)


def calibrate(x: torch.Tensor, spec: QuantSpec, percentile: float = 99.9,
              axis=None) -> torch.Tensor:
    """PTQ step-size calibration from a sample batch (percentile absmax,
    interpolated linearly between order statistics as ``jnp.percentile``
    does; ``axis`` reduces those axes, kept as size 1)."""
    _, qp = qrange(spec.bits, spec.signed)
    a = torch.abs(x)
    axes = (tuple(range(a.dim())) if axis is None else
            tuple(d % a.dim() for d in
                  ((axis,) if isinstance(axis, int) else axis)))
    keep = [d for d in range(a.dim()) if d not in axes]
    flat = a.permute(keep + list(axes)).reshape(
        [a.shape[d] for d in keep] + [-1])
    srt = torch.sort(flat, dim=-1).values
    # the position and weights in float32, as jnp.percentile computes them
    pos = np.float32(percentile) / np.float32(100)
    pos = pos * np.float32(srt.shape[-1] - 1)
    lo = int(np.floor(pos))
    hi_i = min(int(np.ceil(pos)), srt.shape[-1] - 1)
    w = pos - np.float32(lo)
    hi = srt[..., lo] * float(np.float32(1) - w) + srt[..., hi_i] * float(w)
    if axis is not None:
        for d in sorted(axes):
            hi = hi.unsqueeze(d)
    return torch.clamp_min(hi, 1e-8) / max(qp, 1)


@dataclasses.dataclass
class QuantizedWeight:
    """Deployment weight: ``packed`` (w_bits, ceil(K/32), N) int32 words and
    the per-output-channel (or scalar) ``scale``."""

    packed: torch.Tensor
    scale: torch.Tensor
    bits: int
    signed: bool
    k: int  # logical reduction length

    @property
    def out_features(self) -> int:
        return self.packed.shape[-1]


@dataclasses.dataclass
class QuantizedConvWeight:
    """Deployment conv weight: ``packed`` (w_bits, FH, FW, ceil(Ci/32), Co)
    int32 words — the layout the packed conv kernel walks — and ``scale``."""

    packed: torch.Tensor
    scale: torch.Tensor
    bits: int
    signed: bool
    ci: int  # logical input-channel count

    @property
    def out_channels(self) -> int:
        return self.packed.shape[-1]

    @property
    def fh(self) -> int:
        return self.packed.shape[1]

    @property
    def fw(self) -> int:
        return self.packed.shape[2]


def pack_conv_weights(w: torch.Tensor, spec: QuantSpec,
                      alpha: Optional[torch.Tensor] = None
                      ) -> QuantizedConvWeight:
    """Quantize + bit-transpose an HWIO filter ``(FH, FW, Ci, Co)``."""
    ci = w.shape[2]
    if alpha is None:
        alpha = (init_alpha(w, spec, axis=(0, 1, 2)) if spec.per_channel
                 else init_alpha(w, spec))
    q = quantize_int(w, alpha, spec)                      # (FH, FW, Ci, Co)
    planes = bitops.to_bitplanes(q, spec.bits)            # (bits, FH, FW, Ci, Co)
    planes = bitops.pad_to(planes, 32, axis=3)
    packed = bitops.pack_bitplanes(planes, axis=3)        # (bits, FH, FW, Kw, Co)
    return QuantizedConvWeight(packed, torch.squeeze(alpha), spec.bits,
                               spec.signed, ci)


def pack_weights(w: torch.Tensor, spec: QuantSpec,
                 alpha: Optional[torch.Tensor] = None) -> QuantizedWeight:
    """Quantize + bit-transpose a float weight matrix ``(K, N)``."""
    if alpha is None:
        alpha = (init_alpha(w, spec, axis=0) if spec.per_channel
                 else init_alpha(w, spec))
    q = quantize_int(w, alpha, spec)
    planes = bitops.pad_to(bitops.to_bitplanes(q, spec.bits), 32, axis=1)
    packed = bitops.pack_bitplanes(planes, axis=1)  # (bits, ceil(K/32), N)
    return QuantizedWeight(packed, torch.squeeze(alpha), spec.bits,
                           spec.signed, w.shape[0])
