"""The static verifier's error type.

The port's part of ``repro/analysis/verify_ir.py``: :class:`VerifyError`,
which :class:`~repro_torch.analysis.verify_stream.StreamError` extends. The
reference's ``verify_graph`` and ``verify_program`` are not ported yet; the
latter's tile check is a TPU VMEM budget, which the CUDA kernels have no
counterpart of.
"""

from __future__ import annotations

from typing import Optional

__all__ = ["VerifyError"]


class VerifyError(ValueError):
    """A static-verification failure.

    ``check`` names the violated invariant (stable identifier, e.g.
    ``"hazard-order"``); ``blame`` names the pass / step / site responsible.
    """

    def __init__(self, check: str, detail: str, *,
                 blame: Optional[str] = None):
        self.check = check
        self.blame = blame
        where = f" [blame: {blame}]" if blame else ""
        super().__init__(f"{check}: {detail}{where}")
