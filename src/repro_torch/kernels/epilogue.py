"""The fused MVU epilogue shared by K2, K3 and K4: scaler + bias as one
FMA → ReLU → float, or requantized codes, or their packed planes.

Plain side of ``csrc/epilogue.cuh``. The reference computes
``acc.astype(f32) * scale + bias`` under ``jax.jit`` (and in its Pallas
kernels, interpreted or not), where it is one fused multiply-add; the
plain version is :func:`repro_torch.core.pipeline_modules.scaler_bias`
(a product without a bias). Requant is ``clip(round(out / rs))`` with an
IEEE divide by a tensor on the output's device; K4's requant has no divide
(its ``scale`` folds the step), which is ``rs = None``.

Also here: the output-mode numbers the CUDA entries take and the argument
checks the three wrappers share. :data:`ACC` is no epilogue at all: the
raw int32 accumulator, which a row-parallel projection on a mesh sums over
its ranks before it runs the epilogue once (``models/layers.py``).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.pipeline_modules import relu as _relu, scaler_bias
from repro_torch.core.quant import QuantSpec, quantize_int, qrange
from repro_torch.kernels.quantize_pack import pack_codes_ref

__all__ = ["epilogue", "codes_dtype", "requant_scale_tensor", "check_operand",
           "per_channel", "check_raw_acc", "FLOAT", "CODES8", "CODES32",
           "PACKED", "ACC"]

#: output modes of ``csrc/epilogue.cuh``
FLOAT, CODES8, CODES32, PACKED, ACC = 0, 1, 2, 3, 4


def codes_dtype(requant: QuantSpec) -> torch.dtype:
    return torch.int8 if requant.bits <= 8 else torch.int32


def requant_scale_tensor(requant_scale, device) -> torch.Tensor:
    """The requant step as a float32 tensor on ``device`` (1.0 when None):
    torch's CUDA divide by a host scalar multiplies by the reciprocal,
    which is not the IEEE quotient."""
    if requant_scale is None:
        return torch.ones((), dtype=torch.float32, device=device)
    return torch.as_tensor(requant_scale, dtype=torch.float32, device=device)


def epilogue(acc: torch.Tensor, scale: torch.Tensor,
             bias: Optional[torch.Tensor], *, relu: bool,
             requant: Optional[QuantSpec], requant_scale=None,
             divide: bool = True, emit_packed: bool = False) -> torch.Tensor:
    """Plain version of the fused epilogue over an (M, N) int32
    accumulator: ``fma(acc, scale, bias)`` → ReLU → float32, or codes
    ``clip(round(out / rs))`` (``divide=False``: ``clip(round(out))``),
    int8 for ``requant.bits <= 8`` else int32, or their packed planes
    (bits, M, ceil(N/32))."""
    out = scaler_bias(acc, scale, bias)
    if relu:
        out = _relu(out)
    if requant is None:
        return out
    if divide:
        codes = quantize_int(out, requant_scale_tensor(requant_scale,
                                                       out.device), requant)
    else:
        qn, qp = qrange(requant.bits, requant.signed)
        codes = torch.clamp(torch.round(out), qn, qp).to(torch.int32)
    if emit_packed:
        return pack_codes_ref(codes, requant.bits)
    return codes.to(codes_dtype(requant))


def check_raw_acc(fn: str, scale, bias, relu: bool, requant,
                  emit_packed: bool = False) -> None:
    """Raise unless a ``raw_acc`` call asks for no epilogue: no scale, no
    bias, no ReLU, no requant."""
    if (scale is not None or bias is not None or relu
            or requant is not None or emit_packed):
        raise ValueError(f"{fn}: raw_acc returns the int32 accumulator and "
                         "takes no scale, bias, relu or requant")


def check_operand(fn: str, name: str, t: torch.Tensor, dtype: torch.dtype,
                  dim: int, device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous ``dim``-d ``dtype`` tensor on
    ``device`` (a CUDA device, or ``meta`` for the output's shape)."""
    if t.device.type not in ("cuda", "meta") or t.device != device:
        raise ValueError(f"{fn}: {name} must be on {device}, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{fn}: {name} must be {dtype}, got {t.dtype}")
    if t.dim() != dim or not t.is_contiguous():
        raise ValueError(f"{fn}: {name} must be a contiguous {dim}-d "
                         f"tensor, got shape {tuple(t.shape)}")


def per_channel(fn: str, name: str, v: torch.Tensor, n: int,
                device: torch.device) -> torch.Tensor:
    """A float32 scale or bias of 1 or ``n`` elements on ``device`` as a
    contiguous (n,) tensor."""
    if v.dtype != torch.float32 or v.device != device or v.numel() not in (1, n):
        raise ValueError(f"{fn}: {name} must be float32 with 1 or {n} "
                         f"elements on {device}")
    return v.reshape(-1).expand(n).contiguous()
