"""Bit-transposed data structures (BARVINN §3.1.2) in PyTorch.

Counterpart of ``repro/core/bitops.py``. A ``b``-bit integer tensor is stored
as ``b`` bit planes, LSB first; planes are packed along the lane (reduction)
axis into 32-bit words, lane ``t`` of a 32-lane group in bit ``t``.

Packed words are ``int32`` tensors holding the bits of the reference's
``uint32`` words: torch has no ``uint32`` shifts on the CPU, and
``(w >> t) & 1`` on an ``int32`` word is still the right bit (the arithmetic
shift only fills the bits above ``t``).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "to_bitplanes",
    "from_bitplanes",
    "plane_coeffs",
    "pack_bitplanes",
    "unpack_bitplanes",
    "to_digits",
    "digit_coeffs",
    "from_digits",
    "num_digits",
    "kernel_digits",
    "pad_to",
    "wrap_int32",
    "bit_transpose",
    "bit_untranspose",
    "BitTransposed",
    "packed_nbytes",
]

_TWO32 = 1 << 32


def _mask(bits: int) -> int:
    return (1 << bits) - 1


def wrap_int32(v: torch.Tensor) -> torch.Tensor:
    """Reduce an int64 tensor modulo 2^32 into int32's range — the wrap of
    the reference's int32 arithmetic, spelt out so no backend's cast rule
    decides it."""
    v = torch.remainder(v.to(torch.int64) + (1 << 31), _TWO32) - (1 << 31)
    return v.to(torch.int32)


def to_bitplanes(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Decompose integers into ``bits`` {0,1} planes, LSB first, in
    ``bits``-wide two's complement. Returns int8 ``(bits, *x.shape)``."""
    u = torch.bitwise_and(x.to(torch.int32), _mask(bits))
    shifts = torch.arange(bits, dtype=torch.int32, device=x.device).reshape(
        (bits,) + (1,) * x.dim())
    return torch.bitwise_and(u[None] >> shifts, 1).to(torch.int8)


def plane_coeffs(bits: int, signed: bool) -> np.ndarray:
    """Per-plane magnitudes 2^i, the MSB plane negated for signed operands
    (Algorithm 1's sign handling)."""
    c = np.asarray([1 << i for i in range(bits)], dtype=np.int64)
    if signed:
        c[-1] = -c[-1]
    return c


def from_bitplanes(planes: torch.Tensor, signed: bool) -> torch.Tensor:
    """Inverse of :func:`to_bitplanes`; ``planes`` is ``(bits, ...)``."""
    bits = planes.shape[0]
    c = torch.as_tensor(plane_coeffs(bits, signed), dtype=torch.int32,
                        device=planes.device)
    c = c.reshape((bits,) + (1,) * (planes.dim() - 1))
    return torch.sum(planes.to(torch.int32) * c, dim=0, dtype=torch.int32)


def pack_bitplanes(planes: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Pack {0,1} planes into 32-bit words (int32 bits) along ``axis``,
    whose length must be a multiple of 32 (use :func:`pad_to` upstream)."""
    axis = axis % planes.dim()
    n = planes.shape[axis]
    if n % 32:
        raise ValueError(f"pack axis length {n} not a multiple of 32")
    x = torch.movedim(planes, axis, -1).to(torch.int64)
    x = x.reshape(x.shape[:-1] + (n // 32, 32))
    weights = torch.ones(32, dtype=torch.int64, device=planes.device) << \
        torch.arange(32, dtype=torch.int64, device=planes.device)
    packed = wrap_int32(torch.sum(x * weights, dim=-1))
    return torch.movedim(packed, -1, axis).contiguous()


def unpack_bitplanes(packed: torch.Tensor, n: int,
                     axis: int = -1) -> torch.Tensor:
    """Inverse of :func:`pack_bitplanes`; returns int8 {0,1} of length
    ``n`` along ``axis``."""
    axis = axis % packed.dim()
    x = torch.movedim(packed.to(torch.int32), axis, -1)
    shifts = torch.arange(32, dtype=torch.int32, device=packed.device)
    bits = torch.bitwise_and(x[..., None] >> shifts, 1).to(torch.int8)
    bits = bits.reshape(bits.shape[:-2] + (x.shape[-1] * 32,))[..., :n]
    return torch.movedim(bits, -1, axis)


def num_digits(bits: int, radix_bits: int, signed: bool) -> int:
    """Number of radix-2^s digit planes for a ``bits``-wide operand
    (unsigned: ``radix_bits <= 7``; radix 8 only for signed ``bits <= 8``,
    where the whole operand is one signed digit)."""
    if radix_bits < 1:
        raise ValueError("radix_bits must be >= 1")
    if radix_bits == 8:
        if not (signed and bits <= 8):
            raise ValueError("radix_bits=8 requires signed operands with bits<=8")
        return 1
    if radix_bits > 8:
        raise ValueError("radix_bits must be <= 8")
    return max(1, -(-bits // radix_bits))


def kernel_digits(bits: int, signed: bool) -> int:
    """Number of int8 digit planes the tensor-core kernels (K2, K3, K4;
    ``kernels/csrc/digits.cuh``) split a ``bits``-wide operand into: one
    signed digit for a signed operand of at most 8 bits, else radix-7
    digits with the top one signed. Chosen from ``(bits, signed)`` alone,
    not from a spec's ``radix_bits``: the integer result does not depend on
    it."""
    return num_digits(bits, 8 if signed and bits <= 8 else 7, signed)


def to_digits(x: torch.Tensor, bits: int, radix_bits: int,
              signed: bool) -> torch.Tensor:
    """Decompose integers into int8 digit planes, LSB digit first: low
    digits in ``[0, 2^s)``, the top digit arithmetic-shifted so it carries
    the sign. Returns int8 ``(num_digits, *x.shape)``."""
    n = num_digits(bits, radix_bits, signed)
    u = torch.bitwise_and(x.to(torch.int32), _mask(bits))
    if signed:
        x = u - ((u >> (bits - 1)) & 1) * (1 << bits)
    else:
        x = u
    digits = []
    for j in range(n):
        d = x >> (j * radix_bits)      # arithmetic shift on int32
        if j < n - 1:
            d = torch.bitwise_and(d, _mask(radix_bits))
        digits.append(d)
    return torch.stack(digits).to(torch.int8)


def digit_coeffs(bits: int, radix_bits: int, signed: bool) -> np.ndarray:
    """Each digit plane's weight, 2^(j·radix_bits), LSB digit first."""
    n = num_digits(bits, radix_bits, signed)
    return np.asarray([1 << (j * radix_bits) for j in range(n)],
                      dtype=np.int64)


def from_digits(digits: torch.Tensor, bits: int, radix_bits: int,
                signed: bool) -> torch.Tensor:
    """Inverse of :func:`to_digits`: the int32 values of ``(num_digits,
    ...)`` digit planes."""
    c = torch.as_tensor(digit_coeffs(bits, radix_bits, signed),
                        dtype=torch.int32, device=digits.device)
    c = c.reshape((digits.shape[0],) + (1,) * (digits.dim() - 1))
    return torch.sum(digits.to(torch.int32) * c, dim=0, dtype=torch.int32)


def pad_to(x: torch.Tensor, multiple: int, axis: int = -1) -> torch.Tensor:
    """Zero-pad ``axis`` up to a multiple of ``multiple``."""
    axis = axis % x.dim()
    pad = (-x.shape[axis]) % multiple
    if pad == 0:
        return x
    widths = [0, 0] * (x.dim() - 1 - axis) + [0, pad]
    return F.pad(x, widths)


@dataclasses.dataclass
class BitTransposed:
    """A tensor in BARVINN's bit-transposed packed format: ``packed``
    (bits, *leading, ceil(K/32)) int32 words (the bits of the reference's
    uint32 words), K the lane (reduction) axis; ``shape`` the logical
    integer tensor's shape, lane axis last. Torch has no pytree to
    register it with: it is a plain dataclass."""

    packed: torch.Tensor
    bits: int
    signed: bool
    shape: tuple

    @property
    def nbytes(self) -> int:
        return self.packed.numel() * 4

    def unpack(self) -> torch.Tensor:
        planes = unpack_bitplanes(self.packed, self.shape[-1], axis=-1)
        return from_bitplanes(planes, self.signed)

    def digits(self, radix_bits: int) -> torch.Tensor:
        """The int8 digit planes of the packed values (what the kernels
        assemble in registers)."""
        return to_digits(self.unpack(), self.bits, radix_bits, self.signed)


def bit_transpose(x: torch.Tensor, bits: int, signed: bool) -> BitTransposed:
    """The host-side transposer (paper §3.1.2): an integer tensor packed
    into bit-transposed words, lane axis last, padded to 32 lanes."""
    planes = pad_to(to_bitplanes(x, bits), 32, axis=-1)
    return BitTransposed(pack_bitplanes(planes, axis=-1), bits, signed,
                         tuple(x.shape))


def bit_untranspose(bt: BitTransposed) -> torch.Tensor:
    return bt.unpack()


def packed_nbytes(shape: Sequence[int], bits: int) -> int:
    """Bytes of the packed form of a logical ``shape`` (lane axis last)."""
    lead = int(np.prod(shape[:-1])) if len(shape) > 1 else 1
    return bits * lead * (-(-shape[-1] // 32)) * 4
