"""Dispatch wrappers around the packed kernels.

Counterpart of ``repro/kernels/ops.py``. Where the reference selects a
backend by name (``"xla"`` oracle or ``"pallas_v2"`` kernel), the port
selects by device: every function here runs the CUDA kernel for a tensor
on the card and the kernel's plain version for a tensor on the CPU. A CUDA
tensor never reaches a plain version through these functions; a kernel
that does not build or launch raises.

* :func:`pack_activations` — (..., K) integer codes → (a_bits, ...,
  ceil(K/32)) words (K1's codes entry);
* :func:`quantize_pack_activations` — (..., K) floats and a step size →
  the same planes (K1);
* :func:`serial_conv2d_packed_op` — the fused packed conv (K2). The
  plain epilogue is :func:`repro_torch.kernels.bitserial_conv.epilogue`,
  one FMA where the reference's jitted ``_epilogue_xla`` contracts to one.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.bitserial import SerialSpec
from repro_torch.core.quant import QuantSpec
from repro_torch.kernels import bitserial_conv, quantize_pack

__all__ = ["pack_activations", "quantize_pack_activations", "over_rows",
           "serial_conv2d_packed_op", "serial_matmul_packed_op"]


def over_rows(fn, x: torch.Tensor, bits: int) -> torch.Tensor:
    """Run a row packer ``fn`` ((R, K) → (bits, R, W)) over (..., K) and
    restore the leading dims: (bits, ..., W)."""
    lead = tuple(x.shape[:-1])
    out = fn(x.reshape(-1, x.shape[-1]).contiguous())
    return out.reshape((bits,) + lead + (out.shape[-1],))


def pack_activations(codes: torch.Tensor, a_bits: int) -> torch.Tensor:
    """Bit-transpose-pack integer codes: (..., K) → (a_bits, ...,
    ceil(K/32)) int32 words."""
    return over_rows(lambda r: quantize_pack.pack_codes(r, a_bits),
                     codes.to(torch.int32), a_bits)


def quantize_pack_activations(x: torch.Tensor, alpha: torch.Tensor,
                              spec: QuantSpec) -> torch.Tensor:
    """Quantize (..., K) floats with step ``alpha`` and pack the codes:
    (spec.bits, ..., ceil(K/32)) int32 words."""
    return over_rows(lambda r: quantize_pack.quantize_pack(r, alpha, spec),
                     x, spec.bits)


def serial_conv2d_packed_op(x_packed: torch.Tensor, w_packed: torch.Tensor,
                            scale: torch.Tensor,
                            bias: Optional[torch.Tensor] = None, *,
                            spec: SerialSpec, ci: int, stride: int = 1,
                            padding: int = 1, relu: bool = False,
                            requant: Optional[QuantSpec] = None,
                            requant_scale=None,
                            emit_packed: bool = False) -> torch.Tensor:
    """Fused implicit-GEMM serial conv2d over bit-packed activations
    (see :mod:`repro_torch.kernels.bitserial_conv` for the formats)."""
    return bitserial_conv.bitserial_conv2d(
        x_packed, w_packed, scale, bias, spec=spec, ci=ci, stride=stride,
        padding=padding, relu=relu, requant=requant,
        requant_scale=requant_scale, emit_packed=emit_packed)


def serial_matmul_packed_op(*args, **kwargs):
    """The packed GEMM needs K3 (``bitserial_matmul_v2_pallas``), which is
    not ported yet; there is no plain stand-in."""
    raise NotImplementedError(
        "packed GEMM (gemm_packed steps, LM qdense) needs kernel K3 "
        "bitserial_matmul_v2_pallas, which is not yet ported")
