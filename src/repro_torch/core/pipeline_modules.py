"""MVU post-MVP pipeline modules (paper §3.1.4) as torch functions.

Counterpart of ``repro/core/pipeline_modules.py``: the float scaler/bias
stage, the ReLU comparator and the combined MaxPool/ReLU comparator, plus
the one float expression whose rounding the integer path depends on; and
the fixed-point datapath (:func:`scaler_bias_fixed`, the scaler's
multiply, shift and 32-bit bias add, and :func:`quantize_serialize`, the
quantizer/serializer's bit select with saturation), bit for bit as the
reference computes them: in 32-bit words that wrap, each product taken
exactly in int64 and reduced modulo 2^32 (:func:`~repro_torch.core.bitops.
wrap_int32`).

The scaler/bias stage is a fused multiply-add. The reference computes
``acc.astype(f32) * scale + bias`` under ``jax.jit``, and XLA contracts it
into one FMA with a single rounding; a separate multiply and add round
twice and disagree with it in about a third of random cases, which flips a
requantized code whenever the result sits at a rounding boundary. So the
port computes that step as an FMA everywhere: ``fmaf`` in the CUDA kernel
and :func:`fma_f32` here.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.bitops import wrap_int32
from repro_torch.core.quant import qrange

__all__ = ["fma_f32", "scaler_bias", "relu", "maxpool_relu", "host_conv2d",
           "disable_tf32", "ScalerConfig", "scaler_bias_fixed",
           "QuantSerConfig", "quantize_serialize"]


@dataclasses.dataclass(frozen=True)
class ScalerConfig:
    """CSR-style config of the scaler/bias stage."""

    scale_bits: int = 16      # FPGA: 27x16 DSP multiplier
    bias_bits: int = 32
    shift: int = 0            # right-shift applied after the fixed multiply


@dataclasses.dataclass(frozen=True)
class QuantSerConfig:
    """Quantizer/serializer CSRs: output bit depth + MSB position selector."""

    out_bits: int = 8
    out_signed: bool = True
    msb_pos: int = 15  # which bit of the 32-bit word becomes the output MSB


def fma_f32(a: torch.Tensor, b: torch.Tensor,
            c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, bit-identical to C's ``fmaf`` on
    any device.

    Emulated in float64: the product of two float32 values is exact there;
    the sum is rounded to float64 and its error recovered exactly (TwoSum);
    the float64 sum is then rounded to odd, which makes the final rounding
    to float32 the correct rounding of the exact ``a * b + c``
    (53 >= 24 + 2 bits, Boldo & Melquiond).
    """
    a64, b64, c64 = a.to(torch.float64), b.to(torch.float64), c.to(torch.float64)
    p = a64 * b64
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)
    even = torch.bitwise_and(s.view(torch.int64), 1) == 0
    toward = torch.where(err > 0, math.inf, -math.inf).to(torch.float64)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


def scaler_bias(acc: torch.Tensor, scale: torch.Tensor,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Float scaler + bias over an integer accumulator: one FMA per element
    (a plain product without a bias, as the reference)."""
    a = acc.to(torch.float32)
    s = torch.broadcast_to(scale.to(torch.float32), a.shape)
    if bias is None:
        return a * s
    return fma_f32(a, s, torch.broadcast_to(bias.to(torch.float32), a.shape))


def scaler_bias_fixed(acc: torch.Tensor, scale_q: torch.Tensor,
                      bias_q: torch.Tensor,
                      cfg: ScalerConfig = ScalerConfig()) -> torch.Tensor:
    """Fixed-point scaler: the int32 accumulator times the scale clipped to
    ``scale_bits`` (int16), arithmetic-shifted right by ``shift``, plus the
    int32 bias. The reference asks for an int64 product, which JAX's
    default (no 64-bit types) computes in int32: the product wraps modulo
    2^32 before the shift, and so it does here."""
    lo, hi = qrange(cfg.scale_bits, True)
    s = torch.clamp(scale_q.to(torch.int64), lo, hi)
    prod = wrap_int32(acc.to(torch.int64) * s) >> cfg.shift
    return wrap_int32(prod.to(torch.int64) + bias_q.to(torch.int64))


def quantize_serialize(acc: torch.Tensor, cfg: QuantSerConfig) -> torch.Tensor:
    """Bit-exact quantizer/serializer: ``out_bits`` selected from the
    32-bit word at ``msb_pos`` with saturation, ``clip(acc >> (msb_pos + 1
    - out_bits))`` (a left shift, wrapping in int32, when that is
    negative). Returns int32 codes; :func:`repro_torch.core.bitops.
    bit_transpose` packs them (the serializer writes bit planes back)."""
    shift = cfg.msb_pos + 1 - cfg.out_bits
    v = acc.to(torch.int64)
    v = v >> shift if shift >= 0 else wrap_int32(v << -shift).to(torch.int64)
    lo, hi = qrange(cfg.out_bits, cfg.out_signed)
    return torch.clamp(v, lo, hi).to(torch.int32)


def relu(x: torch.Tensor) -> torch.Tensor:
    """The comparator against a register initialized to 0."""
    return torch.clamp_min(x, 0)


def maxpool_relu(x: torch.Tensor, window: int = 2,
                 stride: Optional[int] = None,
                 with_relu: bool = True) -> torch.Tensor:
    """Combined MaxPool/ReLU comparator over NHWC maps (VALID windows).

    Pools any dtype, integer codes included, with a window view and
    ``amax`` (``F.max_pool2d`` has no integer kernel on every backend)."""
    stride = stride or window
    win = x.unfold(1, window, stride).unfold(2, window, stride)
    out = win.amax(dim=(-2, -1))
    return relu(out) if with_relu else out


def host_conv2d(x: torch.Tensor, w: torch.Tensor, stride: int,
                padding: int) -> torch.Tensor:
    """Float conv on the host path (first layer, paper §4.1): NHWC input,
    HWIO filter, NHWC (contiguous) output."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.to(x.dtype).permute(3, 2, 0, 1),
                 stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1).contiguous()


def disable_tf32() -> None:
    """Run float32 matmuls and cuDNN convolutions in full float32 on the
    card. The host conv0 feeds the first activation quantizer, where TF32's
    10-bit mantissa would move codes; entry points call this once."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
