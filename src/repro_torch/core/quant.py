"""Quantization: step-size init, the LSQ fake-quant forward and the
integer/packed deployment path.

Counterpart of ``repro/core/quant.py`` without LSQ training:
:func:`lsq_fake_quant` is the forward only (a later slice ports the
straight-through estimator with training). ``quantize_int`` is the
serve-path quantizer: IEEE division, round half to even, clip — the same
expression as the reference and as the CUDA kernels
(``rintf(__fdiv_rn(x, alpha))``).
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


def lsq_fake_quant(x: torch.Tensor, alpha: torch.Tensor,
                   spec: QuantSpec) -> torch.Tensor:
    """LSQ fake quantization, forward only: ``clip(round(x / a), Qn, Qp) *
    a`` with ``a = max(|alpha|, 1e-8)`` cast to ``x``'s dtype, as the
    reference computes it (``repro/core/quant.py`` ``lsq_fake_quant`` and
    ``_lsq``). The straight-through gradient (``_lsq_bwd``) belongs to
    training and is not ported yet: this is for inference under
    ``torch.inference_mode``/``no_grad``."""
    qn, qp = qrange(spec.bits, spec.signed)
    a = torch.clamp_min(torch.abs(alpha), 1e-8).to(x.dtype)
    return torch.clamp(torch.round(x / a), qn, qp) * a


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


@dataclasses.dataclass
class QuantizedWeight:
    """Deployment weight: ``packed`` (w_bits, ceil(K/32), N) int32 words and
    the per-output-channel (or scalar) ``scale``."""

    packed: torch.Tensor
    scale: torch.Tensor
    bits: int
    signed: bool
    k: int  # logical reduction length


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
