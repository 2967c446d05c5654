"""Fault tolerance: supervised training with checkpoint/restart, failure
injection, and the serving path's failure types.

The port's copy of ``repro/runtime/fault_tolerance.py``:
:class:`WorkerFailure`, :class:`BankFailure`, :class:`FailureInjector` and
:class:`TrainSupervisor`. The run loop treats worker failure as a normal
event: detect (here: injected or raised), restore the latest atomic
checkpoint and continue; a resumed run equals an uninterrupted one bit for
bit (``tests/test_torch_train.py``).
:class:`~repro_torch.serving.service.InferenceService` requeues the
requests of a micro-batch that raised a :class:`WorkerFailure` (bounded by
``max_retries``).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Callable, Optional

from repro_torch.runtime.checkpoint import CheckpointManager

log = logging.getLogger("repro_torch.ft")

__all__ = ["BankFailure", "FailureInjector", "TrainSupervisor",
           "WorkerFailure"]


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


class TrainSupervisor:
    """Runs ``step_fn`` under checkpoint/restart supervision.

    ``build_state(ckpt_step) -> state``: (re)builds the state, restored
    from ``ckpt_step`` when it is not None; called on start and after
    every failure. ``step_fn(state, step) -> state, metrics``. A
    checkpoint is saved every ``save_every`` steps and at the last one.
    """

    def __init__(self, ckpt: CheckpointManager, *,
                 save_every: int = 50, max_restarts: int = 10):
        self.ckpt = ckpt
        self.save_every = save_every
        self.max_restarts = max_restarts
        self.restarts = 0

    def run(self, build_state: Callable[[Optional[int]], Any],
            step_fn: Callable, n_steps: int,
            injector: Optional[FailureInjector] = None,
            on_metrics: Optional[Callable] = None) -> Any:
        start = self.ckpt.latest_step()
        state = build_state(start)
        step = (start or 0)
        while step < n_steps:
            try:
                if injector is not None:
                    injector.check(step)
                state, metrics = step_fn(state, step)
                step += 1
                if on_metrics is not None:
                    on_metrics(step, metrics)
                if step % self.save_every == 0 or step == n_steps:
                    self.ckpt.save(step, state)
            except WorkerFailure as e:
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    raise RuntimeError("restart budget exhausted") from e
                log.warning("worker failure at step %d (%s); restarting "
                            "from checkpoint", step, e)
                self.ckpt.wait()
                restore_step = self.ckpt.latest_step()
                state = build_state(restore_step)
                step = restore_step or 0
        self.ckpt.wait()
        return state
