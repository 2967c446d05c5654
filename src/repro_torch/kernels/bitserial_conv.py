"""K2: implicit-GEMM bit-serial conv2d over packed NHWC activations and
packed HWIO weights, with the fused scaler → bias → ReLU → requant (→ pack)
epilogue.

Counterpart of ``repro/kernels/bitserial_conv.py``. The CUDA kernel
(``csrc/bitserial_conv.cu``) replaces ``bitserial_conv2d_v2_pallas``; its
plain version :func:`bitserial_conv2d_ref` is the port of the reference's
XLA oracle (``serial_conv2d_packed_acts`` followed by ``_epilogue_xla``).
:func:`bitserial_conv2d` dispatches on the tensor's device (a ``meta``
tensor gets the kernel wrapper's checks and output shape, no launch) and
counts as one op of an active
:class:`~repro_torch.launch.hlo_analysis.CostMode`.

``tile=`` (output pixels per block and K-split warps,
:mod:`repro_torch.kernels.tuning`) sets the kernel's launch shape; None is
its own heuristic. The result does not depend on it.

Output modes: float32 ``(N, Ho, Wo, Co)``; requantized codes ``(N, Ho, Wo,
Co)`` (int8 for ``requant.bits <= 8``, else int32); or, with
``emit_packed``, ``(requant.bits, N, Ho, Wo, ceil(Co/32))`` int32 words —
the next conv's input format.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import bitops
from repro_torch.core.bitserial import (SerialSpec, conv_out_hw,
                                        serial_conv2d_packed_acts)
from repro_torch.core.quant import QuantSpec, qrange
from repro_torch.kernels._build import I, Kernel, P
from repro_torch.kernels.tuning import launch_args
from repro_torch.launch import hlo_analysis as cost
from repro_torch.kernels.epilogue import (CODES8, CODES32, FLOAT, PACKED,
                                          check_operand, codes_dtype,
                                          epilogue, per_channel,
                                          requant_scale_tensor)

__all__ = ["KERNEL", "bitserial_conv2d", "bitserial_conv2d_ref",
           "bitserial_conv2d_cuda", "epilogue"]

KERNEL = Kernel("bitserial_conv", {
    "bitserial_conv2d": (P,) * 6 + (I,) * 24 + (P,),
})


def bitserial_conv2d_ref(x_packed: torch.Tensor, w_packed: torch.Tensor,
                         scale: torch.Tensor,
                         bias: Optional[torch.Tensor] = None, *,
                         spec: SerialSpec, ci: int, stride: int = 1,
                         padding: int = 1, relu: bool = False,
                         requant: Optional[QuantSpec] = None,
                         requant_scale=None,
                         emit_packed: bool = False,
                         tile=None) -> torch.Tensor:
    """Plain version of K2, on any device; ``tile`` is ignored (the result
    does not depend on it)."""
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


def bitserial_conv2d_cuda(x_packed: torch.Tensor, w_packed: torch.Tensor,
                          scale: torch.Tensor,
                          bias: Optional[torch.Tensor] = None, *,
                          spec: SerialSpec, ci: int, stride: int = 1,
                          padding: int = 1, relu: bool = False,
                          requant: Optional[QuantSpec] = None,
                          requant_scale=None,
                          emit_packed: bool = False,
                          tile=None) -> torch.Tensor:
    """Launch K2 on CUDA tensors (same contract as the plain version).

    ``tile``: a :class:`~repro_torch.kernels.tuning.ConvTileConfig`
    (output pixels per block and K-split warps), or None for the kernel's
    own heuristic; a tile the instantiation does not take raises at
    launch."""
    if emit_packed and requant is None:
        raise ValueError("emit_packed requires requant")
    dev = x_packed.device
    check_operand("bitserial_conv2d", "x_packed", x_packed, torch.int32, 5,
                  dev)
    check_operand("bitserial_conv2d", "w_packed", w_packed, torch.int32, 5,
                  dev)
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
    scale = per_channel("bitserial_conv2d", "scale", scale, co, dev)
    bias = (None if bias is None
            else per_channel("bitserial_conv2d", "bias", bias, co, dev))
    ho, wo = conv_out_hw(h, w_in, fh, fw, stride, padding)
    if ho <= 0 or wo <= 0:
        raise ValueError(f"bitserial_conv2d: empty output map {ho}x{wo}")
    qn = qp = 0
    rs = None
    if requant is None:
        mode, rq_bits = FLOAT, 0
        out = torch.empty((n, ho, wo, co), dtype=torch.float32, device=dev)
    else:
        rq_bits = requant.bits
        qn, qp = qrange(requant.bits, requant.signed)
        rs = requant_scale_tensor(requant_scale, dev)
        if rs.numel() != 1:
            raise ValueError("bitserial_conv2d: requant_scale must be scalar")
        if emit_packed:
            mode = PACKED
            out = torch.empty((rq_bits, n, ho, wo, -(-co // 32)),
                              dtype=torch.int32, device=dev)
        else:
            dt = codes_dtype(requant)
            mode = CODES8 if dt == torch.int8 else CODES32
            out = torch.empty((n, ho, wo, co), dtype=dt, device=dev)
    if dev.type == "meta":
        return out
    stream = torch.cuda.current_stream(dev).cuda_stream
    KERNEL.launch(
        "bitserial_conv2d", x_packed.data_ptr(), w_packed.data_ptr(),
        scale.data_ptr(), None if bias is None else bias.data_ptr(),
        None if rs is None else rs.data_ptr(), out.data_ptr(),
        n, h, w_in, ci, co, fh, fw, stride, padding, ho, wo,
        spec.a_bits, spec.w_bits, int(spec.a_signed), int(spec.w_signed),
        bitops.kernel_digits(spec.a_bits, spec.a_signed),
        bitops.kernel_digits(spec.w_bits, spec.w_signed),
        int(relu), mode, rq_bits, qn, qp, *launch_args(tile), stream)
    return out


def bitserial_conv2d(x_packed: torch.Tensor, w_packed: torch.Tensor,
                     scale: torch.Tensor, bias: Optional[torch.Tensor] = None,
                     **kw) -> torch.Tensor:
    """K2 on CUDA tensors (its output's shape on ``meta``), its plain
    version on CPU tensors; one op of an active
    :class:`~repro_torch.launch.hlo_analysis.CostMode`."""
    if cost.ACTIVE.mode is not None:
        spec = kw["spec"]
        _, n, h, w_in, _ = x_packed.shape
        _, fh, fw, _, co = w_packed.shape
        ho, wo = conv_out_hw(h, w_in, fh, fw, kw.get("stride", 1),
                             kw.get("padding", 1))
        return cost.ACTIVE.mode.kernel(
            "K2", bitserial_conv2d, (x_packed, w_packed, scale, bias), kw,
            *cost.gemm_flops(n * ho * wo, co, fh * fw * kw["ci"],
                             bitops.kernel_digits(spec.a_bits, spec.a_signed),
                             bitops.kernel_digits(spec.w_bits,
                                                  spec.w_signed)))
    if x_packed.is_cuda or x_packed.is_meta:
        return bitserial_conv2d_cuda(x_packed, w_packed, scale, bias, **kw)
    return bitserial_conv2d_ref(x_packed, w_packed, scale, bias, **kw)
