"""Static verification: the command-stream hazard analyzer and the
``REPRO_VERIFY`` switch that gates it.

The port's copy of ``repro/analysis/__init__.py``, with what the port has:

* :mod:`repro_torch.analysis.verify_stream` — hazard/resource checks over a
  :class:`~repro_torch.core.codegen.CommandStream` (dependency ordering,
  tag uniqueness, illegal-job lint) plus reconciliation of the per-hart
  cycle accounting against :meth:`BarrelController.simulate`'s report;
* :mod:`repro_torch.analysis.verify_ir` — :class:`VerifyError` only. The
  reference's graph/Program verifier, its pass sandwich and its lint are
  not ported yet.

**Gating.** Serving-path verification runs only when the ``REPRO_VERIFY``
env var is set (non-empty, not ``"0"``); the pytest conftest defaults it
on. Each call site bumps a named counter (:func:`counters`), so with
``REPRO_VERIFY`` unset every gated site reads 0. The port's gated sites are
``to_command_stream`` (:meth:`Program.to_command_stream`) and
``stream_admission`` (:meth:`SlotScheduler.stream_for`).
"""

from __future__ import annotations

import os
from typing import Dict

__all__ = ["verify_enabled", "count", "counters", "reset_counters",
           "GATED_SITES", "VerifyError", "verify_stream", "StreamError"]

#: call sites that must stay silent (count 0) when REPRO_VERIFY is unset.
GATED_SITES = ("to_command_stream", "stream_admission")

_COUNTERS: Dict[str, int] = {s: 0 for s in GATED_SITES}


def verify_enabled() -> bool:
    """The one gate: is serving-path verification on?"""
    return os.environ.get("REPRO_VERIFY", "") not in ("", "0")


def count(site: str) -> None:
    """Record one verifier invocation at ``site`` (see :data:`GATED_SITES`)."""
    _COUNTERS[site] = _COUNTERS.get(site, 0) + 1


def counters() -> Dict[str, int]:
    """Snapshot of per-site verifier invocation counts."""
    return dict(_COUNTERS)


def reset_counters() -> None:
    for k in _COUNTERS:
        _COUNTERS[k] = 0


def __getattr__(name):
    # lazy re-exports: keep `import repro_torch.analysis` free of the
    # verifier's imports so the gate check costs nothing on the serving path
    if name == "VerifyError":
        from repro_torch.analysis import verify_ir
        return verify_ir.VerifyError
    if name in ("StreamError", "verify_stream"):
        import repro_torch.analysis.verify_stream as vs
        return getattr(vs, name)
    raise AttributeError(name)
