"""K1: fused quantize → clip → bit-transpose pack (the QuantSer unit).

Counterpart of ``repro/kernels/quantize_pack.py``. The CUDA kernel
(``csrc/quantize_pack.cu``) replaces ``quantize_pack_pallas``; beside it are
its plain versions:

* :func:`quantize_pack_ref` — ``(R, L)`` float32 or bf16 → ``(bits, R,
  ceil(L/32))`` packed planes, for the ``quantize_pack`` step;
* :func:`quantize_pack_multi_ref` — the same activation for G step sizes
  at once → ``(G, bits, R, ceil(L/32))``, one launch of the kernel for the
  LM's projections that share an input;
* :func:`pack_codes_ref` — the codes-input variant, ``(R, L)`` int32 codes
  → the same planes, for the ``pack_codes`` step.

:func:`quantize_pack`, :func:`quantize_pack_multi` and :func:`pack_codes`
dispatch on the tensor's device: the plain version for a CPU tensor, the
kernel for a CUDA tensor, and for a ``meta`` tensor the kernel wrapper's
checks and its output's shape, with no launch (its fake implementation).
Under an active :class:`~repro_torch.launch.hlo_analysis.CostMode` each
call counts as one op, whichever runs.
"""

from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.core import bitops
from repro_torch.core.quant import QuantSpec, qrange, quantize_int
from repro_torch.kernels._build import I, Kernel, P
from repro_torch.launch import hlo_analysis as cost

__all__ = ["KERNEL", "MAX_GROUPS", "quantize_pack", "quantize_pack_multi",
           "pack_codes", "quantize_pack_ref", "quantize_pack_multi_ref",
           "pack_codes_ref", "quantize_pack_cuda", "quantize_pack_multi_cuda",
           "pack_codes_cuda"]

KERNEL = Kernel("quantize_pack", {
    "quantize_pack_float": (P, I, P, P, P, P, I, P, I, I, I, I, I, P),
    "pack_codes_i32": (P, P, I, I, I, P),
})

MAX_GROUPS = 4   # step sizes one launch quantizes for
# the kernel's input types (its ``bf16`` flag)
_FLOAT_INPUTS = {torch.float32: 0, torch.bfloat16: 1}


def pack_codes_ref(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """Plain version: (R, L) integer codes → (bits, R, ceil(L/32)) int32
    words (the reference's ``pack_activations``)."""
    planes = bitops.pad_to(bitops.to_bitplanes(codes, bits), 32, axis=-1)
    return bitops.pack_bitplanes(planes, axis=-1)


def quantize_pack_ref(x: torch.Tensor, scale: torch.Tensor,
                      spec: QuantSpec) -> torch.Tensor:
    """Plain version: (R, L) float, scalar step → (bits, R, ceil(L/32)).
    A bf16 ``x`` is widened to float32 first (exact), as the kernel and the
    reference do."""
    return pack_codes_ref(quantize_int(x.float(), scale, spec), spec.bits)


def quantize_pack_multi_ref(x: torch.Tensor, scales: Sequence[torch.Tensor],
                            spec: QuantSpec) -> torch.Tensor:
    """Plain version of the grouped launch: (R, L) float and G step sizes →
    (G, bits, R, ceil(L/32)), slice g packed with ``scales[g]``."""
    return torch.stack([quantize_pack_ref(x, s, spec) for s in scales])


def _check_rows(name: str, x: torch.Tensor, dtypes) -> None:
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"{name}: tensor must be on the card, got {x.device}")
    if x.dtype not in dtypes:
        raise TypeError(f"{name}: expected one of {list(dtypes)}, got "
                        f"{x.dtype}")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous (R, L) tensor, got "
                         f"shape {tuple(x.shape)}")


def _check_bits(bits: int) -> None:
    if not 1 <= bits <= 16:
        raise ValueError(f"bits must be in 1..16, got {bits}")


def quantize_pack_multi_cuda(x: torch.Tensor, scales: Sequence[torch.Tensor],
                             spec: QuantSpec) -> torch.Tensor:
    """Launch K1 once on a CUDA ``(R, L)`` float32 or bf16 tensor for G =
    ``len(scales)`` (1..4) step sizes, each a one-element float32 tensor on
    the same card, read by the kernel. Returns (G, bits, R, ceil(L/32))."""
    scales = list(scales)
    _check_rows("quantize_pack", x, _FLOAT_INPUTS)
    _check_bits(spec.bits)
    if not 1 <= len(scales) <= MAX_GROUPS:
        raise ValueError(f"quantize_pack: 1..{MAX_GROUPS} step sizes, got "
                         f"{len(scales)}")
    for s in scales:
        if (s.device != x.device
                or s.dtype != torch.float32 or s.numel() != 1):
            raise ValueError("quantize_pack: each step size must be one "
                             "float32 element on the input's card")
    r, l = x.shape
    out = torch.empty((len(scales), spec.bits, r, -(-l // 32)),
                      dtype=torch.int32, device=x.device)
    if x.is_meta:
        return out
    ptrs = [s.data_ptr() for s in scales] + [None] * (MAX_GROUPS - len(scales))
    qn, qp = qrange(spec.bits, spec.signed)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    KERNEL.launch("quantize_pack_float", x.data_ptr(), _FLOAT_INPUTS[x.dtype],
                  *ptrs, len(scales), out.data_ptr(), r, l, spec.bits, qn, qp,
                  stream)
    return out


def quantize_pack_cuda(x: torch.Tensor, scale: torch.Tensor,
                       spec: QuantSpec) -> torch.Tensor:
    """Launch K1 on a CUDA ``(R, L)`` float32 or bf16 tensor for one step
    size: (bits, R, ceil(L/32))."""
    return quantize_pack_multi_cuda(x, [scale], spec)[0]


def pack_codes_cuda(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """Launch K1's codes-input entry on a CUDA ``(R, L)`` int32 tensor."""
    _check_rows("pack_codes", codes, (torch.int32,))
    _check_bits(bits)
    r, l = codes.shape
    out = torch.empty((bits, r, -(-l // 32)), dtype=torch.int32,
                      device=codes.device)
    if codes.is_meta:
        return out
    stream = torch.cuda.current_stream(codes.device).cuda_stream
    KERNEL.launch("pack_codes_i32", codes.data_ptr(), out.data_ptr(), r, l,
                  bits, stream)
    return out


def quantize_pack(x: torch.Tensor, scale: torch.Tensor,
                  spec: QuantSpec) -> torch.Tensor:
    """K1 on a CUDA tensor, its plain version on a CPU tensor."""
    return quantize_pack_multi(x, [scale], spec)[0]


def quantize_pack_multi(x: torch.Tensor, scales: Sequence[torch.Tensor],
                        spec: QuantSpec) -> torch.Tensor:
    """The grouped K1 on a CUDA tensor (its output's shape on ``meta``),
    its plain version on a CPU tensor; one op of an active
    :class:`~repro_torch.launch.hlo_analysis.CostMode`."""
    if cost.ACTIVE.mode is not None:
        return cost.ACTIVE.mode.kernel("K1", quantize_pack_multi,
                                       (x, list(scales), spec), {})
    if x.is_cuda or x.is_meta:
        return quantize_pack_multi_cuda(x, scales, spec)
    return quantize_pack_multi_ref(x, scales, spec)


def pack_codes(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """K1's codes entry on a CUDA tensor (its output's shape on ``meta``),
    its plain version on a CPU one; one op of an active ``CostMode``."""
    if cost.ACTIVE.mode is not None:
        return cost.ACTIVE.mode.kernel("K1", pack_codes, (codes, bits), {})
    if codes.is_cuda or codes.is_meta:
        return pack_codes_cuda(codes, bits)
    return pack_codes_ref(codes, bits)
