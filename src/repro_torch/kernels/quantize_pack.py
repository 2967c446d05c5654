"""K1: fused quantize → clip → bit-transpose pack (the QuantSer unit).

Counterpart of ``repro/kernels/quantize_pack.py``. The CUDA kernel
(``csrc/quantize_pack.cu``) replaces ``quantize_pack_pallas``; beside it are
its plain versions:

* :func:`quantize_pack_ref` — ``(R, L)`` float → ``(bits, R, ceil(L/32))``
  packed planes, for the ``quantize_pack`` step;
* :func:`pack_codes_ref` — the codes-input variant, ``(R, L)`` int32 codes
  → the same planes, for the ``pack_codes`` step.

:func:`quantize_pack` and :func:`pack_codes` dispatch on the tensor's
device: the plain version for a CPU tensor, the kernel for a CUDA tensor.
"""

from __future__ import annotations

import torch

from repro_torch.core import bitops
from repro_torch.core.quant import QuantSpec, qrange, quantize_int
from repro_torch.kernels._build import I, Kernel, P

__all__ = ["KERNEL", "quantize_pack", "pack_codes", "quantize_pack_ref",
           "pack_codes_ref", "quantize_pack_cuda", "pack_codes_cuda"]

KERNEL = Kernel("quantize_pack", {
    "quantize_pack_f32": (P, P, P, I, I, I, I, I, P),
    "pack_codes_i32": (P, P, I, I, I, P),
})


def pack_codes_ref(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """Plain version: (R, L) integer codes → (bits, R, ceil(L/32)) int32
    words (the reference's ``pack_activations``)."""
    planes = bitops.pad_to(bitops.to_bitplanes(codes, bits), 32, axis=-1)
    return bitops.pack_bitplanes(planes, axis=-1)


def quantize_pack_ref(x: torch.Tensor, scale: torch.Tensor,
                      spec: QuantSpec) -> torch.Tensor:
    """Plain version: (R, L) float, scalar step → (bits, R, ceil(L/32))."""
    return pack_codes_ref(quantize_int(x, scale, spec), spec.bits)


def _check_rows(name: str, x: torch.Tensor, dtype: torch.dtype) -> None:
    if not x.is_cuda:
        raise ValueError(f"{name}: tensor must be on the card, got {x.device}")
    if x.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {x.dtype}")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous (R, L) tensor, got "
                         f"shape {tuple(x.shape)}")


def _check_bits(bits: int) -> None:
    if not 1 <= bits <= 16:
        raise ValueError(f"bits must be in 1..16, got {bits}")


def quantize_pack_cuda(x: torch.Tensor, scale: torch.Tensor,
                       spec: QuantSpec) -> torch.Tensor:
    """Launch K1 on a CUDA ``(R, L)`` float32 tensor; ``scale`` is a
    one-element float32 tensor on the same card, read by the kernel."""
    _check_rows("quantize_pack", x, torch.float32)
    _check_bits(spec.bits)
    if (not scale.is_cuda or scale.device != x.device
            or scale.dtype != torch.float32 or scale.numel() != 1):
        raise ValueError("quantize_pack: scale must be one float32 element "
                         "on the input's card")
    r, l = x.shape
    out = torch.empty((spec.bits, r, -(-l // 32)), dtype=torch.int32,
                      device=x.device)
    qn, qp = qrange(spec.bits, spec.signed)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    KERNEL.launch("quantize_pack_f32", x.data_ptr(), scale.data_ptr(),
                  out.data_ptr(), r, l, spec.bits, qn, qp, stream)
    return out


def pack_codes_cuda(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """Launch K1's codes-input entry on a CUDA ``(R, L)`` int32 tensor."""
    _check_rows("pack_codes", codes, torch.int32)
    _check_bits(bits)
    r, l = codes.shape
    out = torch.empty((bits, r, -(-l // 32)), dtype=torch.int32,
                      device=codes.device)
    stream = torch.cuda.current_stream(codes.device).cuda_stream
    KERNEL.launch("pack_codes_i32", codes.data_ptr(), out.data_ptr(), r, l,
                  bits, stream)
    return out


def quantize_pack(x: torch.Tensor, scale: torch.Tensor,
                  spec: QuantSpec) -> torch.Tensor:
    """K1 on a CUDA tensor, its plain version on a CPU tensor."""
    if x.is_cuda:
        return quantize_pack_cuda(x, scale, spec)
    return quantize_pack_ref(x, scale, spec)


def pack_codes(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """K1's codes entry on a CUDA tensor, its plain version on a CPU one."""
    if codes.is_cuda:
        return pack_codes_cuda(codes, bits)
    return pack_codes_ref(codes, bits)
