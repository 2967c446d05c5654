"""Static verification suite: IR/Program verifier, command-stream
hazard analyzer, and an AST-based concurrency/convention lint.

The port's copy of ``repro/analysis/__init__.py``. Three layers, one gate:

* :mod:`repro_torch.analysis.verify_ir` — well-formedness of the typed
  graph IR (run as a pass sandwich inside
  :func:`repro_torch.compiler.passes.run_pipeline` so a corrupting pass is
  blamed by name) and of the lowered
  :class:`~repro_torch.compiler.lower.Program` (step I/O chaining,
  format-planner consistency, the per-layer precision plan);
* :mod:`repro_torch.analysis.verify_stream` — hazard/resource checks over a
  :class:`~repro_torch.core.codegen.CommandStream` (dependency ordering,
  tag uniqueness, illegal-job lint) plus reconciliation of the per-hart
  cycle accounting against :meth:`BarrelController.simulate`'s report;
* :mod:`repro_torch.analysis.lint` — source conventions: shared-state
  writes outside their ``# guarded-by:`` lock, bare ``assert`` in library
  code, ``time.time()`` on timing paths, mutable default args. CLI:
  ``python -m repro_torch.analysis src/repro_torch`` (exit 0 clean / 1
  findings / 2 error).

**Gating.** Compile/serving-path verification runs only when the
``REPRO_VERIFY`` env var is set (non-empty, not ``"0"``); the pytest
conftest defaults it on. Each call site bumps a named counter
(:func:`counters`), so with ``REPRO_VERIFY`` unset every gated site reads
0. Artifact loading (:func:`repro_torch.compiler.artifact.load_program`)
verifies unconditionally — a deserialized Program crossed a trust
boundary — under its own ``artifact_load`` counter, outside the gated set.
"""

from __future__ import annotations

import os
from typing import Dict

__all__ = ["verify_enabled", "count", "counters", "reset_counters",
           "GATED_SITES", "UNGATED_SITES", "VerifyError", "verify_graph",
           "verify_program", "verify_stream", "StreamError", "run_lint",
           "Finding"]

#: call sites that must stay silent (count 0) when REPRO_VERIFY is unset.
GATED_SITES = ("pass_sandwich", "post_lowering", "to_command_stream",
               "stream_admission")
#: always-on sites (trust-boundary checks, not gated by the env flag).
UNGATED_SITES = ("artifact_load",)

_COUNTERS: Dict[str, int] = {s: 0 for s in GATED_SITES + UNGATED_SITES}


def verify_enabled() -> bool:
    """The one gate: is compile/serving-path verification on?"""
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
    if name in ("VerifyError", "verify_graph", "verify_program"):
        from repro_torch.analysis import verify_ir
        return getattr(verify_ir, name)
    if name in ("StreamError", "verify_stream"):
        import repro_torch.analysis.verify_stream as vs
        return getattr(vs, name)
    if name in ("run_lint", "Finding"):
        from repro_torch.analysis import lint
        return getattr(lint, name)
    raise AttributeError(name)
