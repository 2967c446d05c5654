"""Serial arbitrary-precision matmul/conv — BARVINN Algorithm 1, in torch.

Counterpart of ``repro/core/bitserial.py``: the plain (oracle) integer
path. ``radix_bits=1`` is the paper-faithful bit-serial scheme;
``radix_bits=s>1`` groups bits into int8 digits. Both return the exact
integer result modulo 2^32, as the reference's int32 arithmetic does.

torch has no integer matmul on the CPU, so each digit-plane product is
taken in float64: the operands are small integers, every product and every
partial sum below 2^53 is exact, whatever order the sum runs in. The
products are then reduced modulo 2^32 into int32, the wrap of the
reference's int32 accumulator, and combined Horner-style.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import bitops

__all__ = ["SerialSpec", "plan_spec", "serial_matmul", "serial_matmul_packed",
           "serial_matmul_packed_acts", "serial_conv2d",
           "serial_conv2d_packed_acts", "conv_out_hw", "digits_from_planes"]


@dataclasses.dataclass(frozen=True)
class SerialSpec:
    """Operand precision configuration — the per-MVU CSR settings."""

    a_bits: int = 8
    w_bits: int = 4
    a_signed: bool = True
    w_signed: bool = True
    radix_bits: int = 1  # 1 = faithful bit-serial; 7/8 = digit-serial

    def __post_init__(self):
        for b in (self.a_bits, self.w_bits):
            if not 1 <= b <= 16:
                raise ValueError(f"bit depth {b} outside the MVU's 1..16 range")

    @property
    def cycles_per_tile(self) -> int:
        """MVU cycles per 64x64 tile (paper §3.1.1): b_w * b_a."""
        return self.a_bits * self.w_bits

    @property
    def num_plane_products(self) -> int:
        na = bitops.num_digits(self.a_bits, self.radix_bits, self.a_signed)
        nw = bitops.num_digits(self.w_bits, self.radix_bits, self.w_signed)
        return na * nw


def plan_spec(spec: SerialSpec) -> SerialSpec:
    """Pick the radix (7 or 8) with the fewest digit-plane products; the
    integer result does not depend on it. Radix 1 is never rewritten."""
    if spec.radix_bits <= 1:
        return spec
    best, best_cost = spec, spec.num_plane_products
    for r in (7, 8):
        try:
            na = bitops.num_digits(spec.a_bits, r, spec.a_signed)
            nw = bitops.num_digits(spec.w_bits, r, spec.w_signed)
        except ValueError:
            continue
        if na * nw < best_cost:
            best = dataclasses.replace(spec, radix_bits=r)
            best_cost = na * nw
    return best


def _plane_dot(xp: torch.Tensor, wp: torch.Tensor) -> torch.Tensor:
    """One partial-product matmul (..., K) x (K, N), exact in float64,
    returned as int32 modulo 2^32."""
    p = torch.matmul(xp.to(torch.float64), wp.to(torch.float64))
    return bitops.wrap_int32(p.to(torch.int64))


def _horner(partials, shift: int) -> torch.Tensor:
    """acc = partials[-1]; acc = (acc << shift) + partials[m] downwards,
    wrapping to int32 after every step like the reference."""
    acc = partials[-1]
    for m in range(len(partials) - 2, -1, -1):
        acc = bitops.wrap_int32((acc.to(torch.int64) << shift)
                                + partials[m].to(torch.int64))
    return acc


def _digit_combine(xd: torch.Tensor, wd: torch.Tensor,
                   radix_bits: int) -> torch.Tensor:
    """Horner-combine digit plane products: sum 2^{s(J+K)} (x_J . w_K)."""
    na, nw = xd.shape[0], wd.shape[0]
    partials = [None] * (na + nw - 1)
    for j in range(na):
        for k in range(nw):
            p = _plane_dot(xd[j], wd[k])
            m = j + k
            partials[m] = p if partials[m] is None else bitops.wrap_int32(
                partials[m].to(torch.int64) + p)
    return _horner(partials, radix_bits)


def serial_matmul(x: torch.Tensor, w: torch.Tensor,
                  spec: SerialSpec) -> torch.Tensor:
    """Exact integer matmul via serial plane products. ``x``: (..., K)
    integer-valued; ``w``: (K, N). Out-of-range bits are truncated."""
    s = spec.radix_bits
    if s == 1:
        xb = bitops.to_bitplanes(x, spec.a_bits)
        wb = bitops.to_bitplanes(w, spec.w_bits)
        sa = np.sign(bitops.plane_coeffs(spec.a_bits, spec.a_signed))
        sw = np.sign(bitops.plane_coeffs(spec.w_bits, spec.w_signed))
        partials = [None] * (spec.a_bits + spec.w_bits - 1)
        for j in range(spec.a_bits):
            for k in range(spec.w_bits):
                p = _plane_dot(xb[j], wb[k]).to(torch.int64)
                if sa[j] * sw[k] < 0:
                    p = -p
                m = j + k
                partials[m] = p if partials[m] is None else partials[m] + p
        return _horner([bitops.wrap_int32(p) for p in partials], 1)
    xd = bitops.to_digits(x, spec.a_bits, s, spec.a_signed)
    wd = bitops.to_digits(w, spec.w_bits, s, spec.w_signed)
    return _digit_combine(xd, wd, s)


def digits_from_planes(planes: torch.Tensor, bits: int, radix_bits: int,
                       signed: bool) -> torch.Tensor:
    """Assemble int8 digit planes directly from {0,1} bit planes
    ``(bits, ...)``: the digit values of :func:`bitops.to_digits`, with the
    MSB plane of a signed operand weighing ``-2^{bits-1-lo}``."""
    s = radix_bits
    n = bitops.num_digits(bits, s, signed)
    out = []
    for j in range(n):
        lo = j * s
        hi = min(lo + s, bits)
        d = torch.zeros(planes.shape[1:], dtype=torch.int32,
                        device=planes.device)
        for t in range(lo, hi):
            c = 1 << (t - lo)
            if signed and j == n - 1 and t == bits - 1:
                c = -c
            d = d + planes[t].to(torch.int32) * c
        out.append(d.to(torch.int8))
    return torch.stack(out)


def serial_matmul_packed(x_int: torch.Tensor, w_packed: torch.Tensor, *,
                         spec: SerialSpec, k: int) -> torch.Tensor:
    """Serial matmul of integer activations ``x_int`` (..., K) against
    bit-transposed packed weights ``w_packed`` (w_bits, ceil(K/32), N) —
    the integer core of the plain version of K4. Activation codes are
    masked to ``a_bits`` (and sign-extended when signed), as the
    reference's plane/digit decomposition does. Returns int32 (..., N)."""
    planes = bitops.unpack_bitplanes(w_packed, k, axis=1)  # (bw, K, N)
    if spec.radix_bits == 1:
        return serial_matmul(x_int, bitops.from_bitplanes(planes,
                                                          spec.w_signed),
                             spec)
    s = spec.radix_bits
    wd = digits_from_planes(planes, spec.w_bits, s, spec.w_signed)
    xd = bitops.to_digits(x_int, spec.a_bits, s, spec.a_signed)
    return _digit_combine(xd, wd, s)


def serial_matmul_packed_acts(x_packed: torch.Tensor, w_packed: torch.Tensor,
                              *, spec: SerialSpec, k: int) -> torch.Tensor:
    """Serial matmul with both operands bit-packed — the integer core of
    the plain version of K3. ``x_packed``: (a_bits, M, ceil(K/32)) words;
    ``w_packed``: (w_bits, ceil(K/32), N). Returns int32 (M, N)."""
    a_planes = bitops.unpack_bitplanes(x_packed, k, axis=-1)  # (ba, M, K)
    w_planes = bitops.unpack_bitplanes(w_packed, k, axis=1)   # (bw, K, N)
    s = spec.radix_bits
    xd = digits_from_planes(a_planes, spec.a_bits, s, spec.a_signed)
    wd = digits_from_planes(w_planes, spec.w_bits, s, spec.w_signed)
    return _digit_combine(xd, wd, s)


def conv_out_hw(h: int, w: int, fh: int, fw: int, stride: int,
                padding: int) -> tuple:
    """Output spatial extent of a VALID conv over padded input."""
    ho = (h + 2 * padding - fh) // stride + 1
    wo = (w + 2 * padding - fw) // stride + 1
    return ho, wo


def _tap(x: torch.Tensor, i_fh: int, i_fw: int, stride: int, ho: int,
         wo: int) -> torch.Tensor:
    """The (..., Ho, Wo, C) input window of filter tap (i_fh, i_fw) of a
    padded (..., H, W, C) map — strided slicing, no patch tensor."""
    return x[..., i_fh:i_fh + (ho - 1) * stride + 1:stride,
             i_fw:i_fw + (wo - 1) * stride + 1:stride, :]


def serial_conv2d(x: torch.Tensor, w: torch.Tensor, spec: SerialSpec, *,
                  stride: int = 1, padding: int = 1) -> torch.Tensor:
    """Quantized 2D convolution (NHWC / HWIO) via integer im2col + the
    serial matmul — the calibration replay's exact-integer conv."""
    n, h, wdt, ci = x.shape
    fh, fw, _, co = w.shape
    x = F.pad(x.to(torch.int32), (0, 0, padding, padding, padding, padding))
    ho, wo = conv_out_hw(h, wdt, fh, fw, stride, padding)
    patches = torch.cat([_tap(x, a, b, stride, ho, wo)
                         for a in range(fh) for b in range(fw)], dim=-1)
    wmat = w.reshape(fh * fw * ci, co)
    out = serial_matmul(patches.reshape(n * ho * wo, fh * fw * ci), wmat, spec)
    return out.reshape(n, ho, wo, co)


def serial_conv2d_packed_acts(x_packed: torch.Tensor, w_packed: torch.Tensor,
                              *, spec: SerialSpec, ci: int, stride: int = 1,
                              padding: int = 1) -> torch.Tensor:
    """Implicit-GEMM serial conv with both operands bit-packed — the plain
    version of the packed conv kernel's integer part.

    ``x_packed``: (a_bits, N, H, W, ceil(Ci/32)) words (NHWC, channel axis
    packed); ``w_packed``: (w_bits, FH, FW, ceil(Ci/32), Co). Returns the
    int32 conv accumulator (N, Ho, Wo, Co). The reduction is walked one
    filter row at a time, the FW taps of a row merged into one digit-plane
    GEMM of width FW*Ci, as the reference does.
    """
    _, n, h, wdt, _ = x_packed.shape
    _, fh, fw, _, co = w_packed.shape
    s = spec.radix_bits
    a_planes = bitops.unpack_bitplanes(x_packed, ci, axis=-1)
    w_planes = bitops.unpack_bitplanes(w_packed, ci, axis=3)
    xd = digits_from_planes(a_planes, spec.a_bits, s, spec.a_signed)
    wd = digits_from_planes(w_planes, spec.w_bits, s, spec.w_signed)
    # spatial zero padding on digit planes: value 0 has all-zero digits
    xd = F.pad(xd, (0, 0, padding, padding, padding, padding))
    ho, wo = conv_out_hw(h, wdt, fh, fw, stride, padding)
    nd_w = wd.shape[0]
    out = None
    for i_fh in range(fh):
        xrow = torch.cat([_tap(xd, i_fh, i_fw, stride, ho, wo)
                          for i_fw in range(fw)], dim=-1)  # (nd_a,N,Ho,Wo,FW*Ci)
        wrow = wd[:, i_fh].reshape(nd_w, fw * ci, co)
        p = _digit_combine(xrow, wrow, s)
        out = p if out is None else bitops.wrap_int32(
            out.to(torch.int64) + p)
    return out
