"""K2: implicit-GEMM bit-serial conv2d over packed NHWC activations and
packed HWIO weights, with the fused scaler → bias → ReLU → requant (→ pack)
epilogue.

Counterpart of ``repro/kernels/bitserial_conv.py``. The CUDA kernel
(``csrc/bitserial_conv.cu``) replaces ``bitserial_conv2d_v2_pallas``; its
plain version :func:`bitserial_conv2d_ref` is the port of the reference's
XLA oracle (``serial_conv2d_packed_acts`` followed by ``_epilogue_xla``).
:func:`bitserial_conv2d` dispatches on the tensor's device.

Output modes: float32 ``(N, Ho, Wo, Co)``; requantized codes ``(N, Ho, Wo,
Co)`` (int8 for ``requant.bits <= 8``, else int32); or, with
``emit_packed``, ``(requant.bits, N, Ho, Wo, ceil(Co/32))`` int32 words —
the next conv's input format.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.bitserial import (SerialSpec, conv_out_hw,
                                        serial_conv2d_packed_acts)
from repro_torch.core.pipeline_modules import relu as _relu, scaler_bias
from repro_torch.core.quant import QuantSpec, qrange, quantize_int
from repro_torch.kernels._build import I, Kernel, P
from repro_torch.kernels.quantize_pack import pack_codes_ref

__all__ = ["KERNEL", "bitserial_conv2d", "bitserial_conv2d_ref",
           "bitserial_conv2d_cuda", "epilogue"]

KERNEL = Kernel("bitserial_conv", {
    "bitserial_conv2d": (P,) * 6 + (I,) * 20 + (P,),
})

_FLOAT, _CODES8, _CODES32, _PACKED = 0, 1, 2, 3


def _codes_dtype(requant: QuantSpec) -> torch.dtype:
    return torch.int8 if requant.bits <= 8 else torch.int32


def _requant_scale(requant_scale, device) -> torch.Tensor:
    # a tensor on the output's device: torch's CUDA divide by a host scalar
    # multiplies by the reciprocal, which is not the IEEE quotient
    if requant_scale is None:
        return torch.ones((), dtype=torch.float32, device=device)
    return torch.as_tensor(requant_scale, dtype=torch.float32, device=device)


def epilogue(acc: torch.Tensor, scale: torch.Tensor,
             bias: Optional[torch.Tensor], *, relu: bool,
             requant: Optional[QuantSpec], requant_scale=None,
             emit_packed: bool = False) -> torch.Tensor:
    """Plain version of the fused epilogue over an (M, Co) int32
    accumulator: ``fma(acc, scale, bias)`` → ReLU → float, or codes
    ``clip(round(out / rs))``, or their packed planes (bits, M, ceil(Co/32))."""
    out = scaler_bias(acc, scale, bias)
    if relu:
        out = _relu(out)
    if requant is None:
        return out
    codes = quantize_int(out, _requant_scale(requant_scale, out.device),
                         requant)
    if emit_packed:
        return pack_codes_ref(codes, requant.bits)
    return codes.to(_codes_dtype(requant))


def bitserial_conv2d_ref(x_packed: torch.Tensor, w_packed: torch.Tensor,
                         scale: torch.Tensor,
                         bias: Optional[torch.Tensor] = None, *,
                         spec: SerialSpec, ci: int, stride: int = 1,
                         padding: int = 1, relu: bool = False,
                         requant: Optional[QuantSpec] = None,
                         requant_scale=None,
                         emit_packed: bool = False) -> torch.Tensor:
    """Plain version of K2, on any device."""
    if emit_packed and requant is None:
        raise ValueError("emit_packed requires requant")
    acc = serial_conv2d_packed_acts(x_packed, w_packed, spec=spec, ci=ci,
                                    stride=stride, padding=padding)
    n, ho, wo, co = acc.shape
    out = epilogue(acc.reshape(n * ho * wo, co), scale, bias, relu=relu,
                   requant=requant, requant_scale=requant_scale,
                   emit_packed=emit_packed)
    if emit_packed:
        return out.reshape(requant.bits, n, ho, wo, out.shape[-1])
    return out.reshape(n, ho, wo, co)


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, dim: int,
           device: torch.device) -> None:
    if not t.is_cuda or t.device != device:
        raise ValueError(f"bitserial_conv2d: {name} must be on {device}, "
                         f"got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"bitserial_conv2d: {name} must be {dtype}, got "
                        f"{t.dtype}")
    if t.dim() != dim or not t.is_contiguous():
        raise ValueError(f"bitserial_conv2d: {name} must be a contiguous "
                         f"{dim}-d tensor, got shape {tuple(t.shape)}")


def _per_channel(name: str, v: torch.Tensor, co: int,
                 device: torch.device) -> torch.Tensor:
    if v.dtype != torch.float32 or v.device != device or v.numel() not in (1, co):
        raise ValueError(f"bitserial_conv2d: {name} must be float32 with 1 "
                         f"or {co} elements on {device}")
    return v.reshape(-1).expand(co).contiguous()


def bitserial_conv2d_cuda(x_packed: torch.Tensor, w_packed: torch.Tensor,
                          scale: torch.Tensor,
                          bias: Optional[torch.Tensor] = None, *,
                          spec: SerialSpec, ci: int, stride: int = 1,
                          padding: int = 1, relu: bool = False,
                          requant: Optional[QuantSpec] = None,
                          requant_scale=None,
                          emit_packed: bool = False) -> torch.Tensor:
    """Launch K2 on CUDA tensors (same contract as the plain version)."""
    if emit_packed and requant is None:
        raise ValueError("emit_packed requires requant")
    dev = x_packed.device
    _check("x_packed", x_packed, torch.int32, 5, dev)
    _check("w_packed", w_packed, torch.int32, 5, dev)
    ba, n, h, w_in, ciw = x_packed.shape
    bw, fh, fw, ciw_w, co = w_packed.shape
    if ba != spec.a_bits or bw != spec.w_bits:
        raise ValueError(f"bitserial_conv2d: planes (x {ba}, w {bw}) do not "
                         f"match spec a_bits={spec.a_bits} w_bits={spec.w_bits}")
    if not (ciw == ciw_w == -(-ci // 32)):
        raise ValueError(f"bitserial_conv2d: channel-word mismatch: x {ciw}, "
                         f"w {ciw_w}, ceil(ci/32)={-(-ci // 32)}")
    if requant is not None and not 1 <= requant.bits <= 16:
        raise ValueError("bitserial_conv2d: requant bits must be in 1..16")
    scale = _per_channel("scale", scale, co, dev)
    bias = None if bias is None else _per_channel("bias", bias, co, dev)
    ho, wo = conv_out_hw(h, w_in, fh, fw, stride, padding)
    if ho <= 0 or wo <= 0:
        raise ValueError(f"bitserial_conv2d: empty output map {ho}x{wo}")
    qn = qp = 0
    rs = None
    if requant is None:
        mode, rq_bits = _FLOAT, 0
        out = torch.empty((n, ho, wo, co), dtype=torch.float32, device=dev)
    else:
        rq_bits = requant.bits
        qn, qp = qrange(requant.bits, requant.signed)
        rs = _requant_scale(requant_scale, dev)
        if rs.numel() != 1:
            raise ValueError("bitserial_conv2d: requant_scale must be scalar")
        if emit_packed:
            mode = _PACKED
            out = torch.empty((rq_bits, n, ho, wo, -(-co // 32)),
                              dtype=torch.int32, device=dev)
        else:
            dt = _codes_dtype(requant)
            mode = _CODES8 if dt == torch.int8 else _CODES32
            out = torch.empty((n, ho, wo, co), dtype=dt, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    KERNEL.launch(
        "bitserial_conv2d", x_packed.data_ptr(), w_packed.data_ptr(),
        scale.data_ptr(), None if bias is None else bias.data_ptr(),
        None if rs is None else rs.data_ptr(), out.data_ptr(),
        n, h, w_in, ci, co, fh, fw, stride, padding, ho, wo,
        spec.a_bits, spec.w_bits, int(spec.a_signed), int(spec.w_signed),
        int(relu), mode, rq_bits, qn, qp, stream)
    return out


def bitserial_conv2d(x_packed: torch.Tensor, w_packed: torch.Tensor,
                     scale: torch.Tensor, bias: Optional[torch.Tensor] = None,
                     **kw) -> torch.Tensor:
    """K2 on CUDA tensors, its plain version on CPU tensors."""
    if x_packed.is_cuda:
        return bitserial_conv2d_cuda(x_packed, w_packed, scale, bias, **kw)
    return bitserial_conv2d_ref(x_packed, w_packed, scale, bias, **kw)
