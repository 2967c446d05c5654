"""Quantization policy shared by the port's models.

Counterpart of ``repro/models/layers.py``; this slice needs only
:class:`QuantPolicy` (the quantized dense layer ``qdense`` waits for the
packed GEMM kernel K3).
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.bitserial import SerialSpec

__all__ = ["QuantPolicy"]


@dataclasses.dataclass(frozen=True)
class QuantPolicy:
    """Per-layer-class precision policy (the per-MVU CSR precision
    settings). ``mode``: 'none' | 'serial'. ``radix_bits`` selects the
    faithful bit-serial (1) or digit-serial (7/8) plan of the oracle path;
    the integer result does not depend on it."""

    mode: str = "none"
    w_bits: int = 4
    a_bits: int = 8
    w_signed: bool = True
    a_signed: bool = True
    radix_bits: int = 7

    def spec(self) -> SerialSpec:
        return SerialSpec(self.a_bits, self.w_bits, self.a_signed,
                          self.w_signed, self.radix_bits)
