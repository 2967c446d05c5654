"""Failure types and a deterministic failure schedule.

The port's copy of the serving half of ``repro/runtime/fault_tolerance.py``:
:class:`WorkerFailure`, :class:`BankFailure` and :class:`FailureInjector`.
:class:`~repro_torch.serving.service.InferenceService` requeues the
requests of a micro-batch that raised a :class:`WorkerFailure` (bounded by
``max_retries``). The reference's ``TrainSupervisor`` (checkpoint/restart
supervision of training) waits for ``runtime/checkpoint``, which the port
has not got yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["BankFailure", "FailureInjector", "WorkerFailure"]


class WorkerFailure(RuntimeError):
    """A (simulated) node loss / preemption / hardware fault."""


class BankFailure(WorkerFailure):
    """One MVU bank (device) failed mid-batch on the *serving* path.

    :class:`~repro_torch.serving.service.InferenceService` treats this as
    transient: the affected micro-batch's requests are **requeued** through
    the batcher (bounded by ``max_retries``, counted by the
    ``service_requeues_total`` metric) so a flaky bank costs latency, not
    errors."""

    def __init__(self, msg: str, bank: Optional[int] = None):
        super().__init__(msg)
        self.bank = bank


@dataclasses.dataclass
class FailureInjector:
    """Deterministic failure schedule for tests & chaos drills."""

    fail_at_steps: tuple = ()
    fail_once: bool = True
    _fired: set = dataclasses.field(default_factory=set)

    def check(self, step: int) -> None:
        if step in self.fail_at_steps and step not in self._fired:
            self._fired.add(step)
            raise WorkerFailure(f"injected failure at step {step}")
