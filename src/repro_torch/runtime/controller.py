"""Pito analogue: a barrel-scheduled command-stream virtual machine.

The FPGA controller is an 8-hart barrel RV32I CPU; hart *i* programs MVU *i*
through CSR writes, triggers the job, and sleeps until the completion
interrupt. We keep exactly those semantics as a software scheduler:

* :class:`BarrelController.simulate` — discrete-event cycle simulation
  (per-hart issue overhead = ``instrs_per_issue * harts`` cycles, since each
  hart executes one instruction every 8 clock cycles in the barrel). Feeds
  the cost model and EXPERIMENTS latency numbers.
* :class:`BarrelController.execute` — *real* execution: each job's op is
  dispatched to a registered executor in dependency order, producing
  actual tensors.

The port's copy of ``repro/runtime/controller.py``, over the port's
:mod:`repro_torch.core.codegen` streams and :mod:`repro_torch.core.mvu`
jobs (it runs no tensor op). The serving scheduler books every batch
through :meth:`BarrelController.simulate`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

from repro_torch.core.codegen import CommandStream
from repro_torch.core.mvu import OpKind, MVU_COUNT
from repro_torch.obs.hpm import HPMCounters, precision_key

__all__ = ["BarrelController", "SimReport"]


@dataclasses.dataclass
class SimReport:
    makespan_cycles: int
    per_job_start: List[int]
    per_job_end: List[int]
    per_mvu_busy: List[int]
    # busy-until cycle of each hart after this stream: feed back into the
    # next ``simulate`` call so consecutive streams share the fabric (the
    # serving scheduler's admission clock)
    hart_free: List[int] = dataclasses.field(default_factory=list)
    # HPM counter deltas for this call: per-hart busy/xfer/issue/stall plus
    # per-tag and per-precision attribution. Per-call (not cumulative) so
    # the scheduler can simulate tentatively on every bank and merge only
    # the committed report into its counter file.
    hpm: Optional[HPMCounters] = None

    @property
    def utilization(self) -> float:
        if self.makespan_cycles == 0:
            return 0.0
        busy = [b for b in self.per_mvu_busy if b > 0]
        if not busy:
            return 0.0
        return sum(busy) / (len(busy) * self.makespan_cycles)


class BarrelController:
    """8 communicating harts, one per MVU (paper §3.2)."""

    def __init__(self, harts: int = MVU_COUNT, instrs_per_issue: int = 8,
                 freq_hz: float = 250e6):
        self.harts = harts
        # every hart turn comes up once per `harts` cycles; programming a job
        # costs a handful of CSR-write instructions
        self.issue_overhead = instrs_per_issue * harts
        self.freq_hz = freq_hz
        self._executors: Dict[OpKind, Callable] = {}

    # ------------------------------------------------------------------ sim
    def simulate(self, stream: CommandStream,
                 xfer_cycles_per_job: int = 64, *,
                 hart_free: Optional[List[int]] = None,
                 cycle_scale: int = 1) -> SimReport:
        """Discrete-event simulation of one stream.

        ``hart_free`` seeds each hart's busy-until cycle (default: an idle
        fabric) — pass the previous report's ``hart_free`` to co-schedule
        consecutive streams on the shared MVUs, which is how the serving
        scheduler admits mixed-precision batches. ``cycle_scale``
        multiplies every job duration (a command stream costs one input;
        MVU work scales linearly with batch size).
        """
        jobs = stream.jobs
        n = len(jobs)
        start = [0] * n
        end = [0] * n
        hart_free = ([0] * self.harts if hart_free is None
                     else list(hart_free))
        if len(hart_free) != self.harts:
            raise ValueError(f"hart_free must have {self.harts} entries")
        busy = [0] * self.harts
        hpm = HPMCounters.empty(self.harts)
        for i, job in enumerate(jobs):
            dep_ready = max((end[d] for d in job.depends_on), default=0)
            op = job.op.value
            hpm.jobs[op] = hpm.jobs.get(op, 0) + 1
            if job.op == OpKind.HOST:
                start[i] = dep_ready
                end[i] = dep_ready  # host work is off the accelerator clock
                continue
            h = job.mvu % self.harts
            # stall: the hart was free but its input hadn't arrived yet —
            # dependency wait, as distinct from the hart simply being busy
            if dep_ready > hart_free[h]:
                hpm.stall[h] += dep_ready - hart_free[h]
            hpm.issue[h] += self.issue_overhead
            t0 = max(dep_ready, hart_free[h]) + self.issue_overhead
            dur = (job.cycles if job.op != OpKind.XFER
                   else xfer_cycles_per_job) * cycle_scale
            start[i] = t0
            end[i] = t0 + dur
            hart_free[h] = end[i]
            busy[h] += dur
            if job.op == OpKind.XFER:
                hpm.xfer[h] += dur
            else:
                hpm.busy[h] += dur
                pk = precision_key(job.a_bits, job.w_bits)
                hpm.per_precision[pk] = hpm.per_precision.get(pk, 0) + dur
            if job.tag:
                hpm.per_tag[job.tag] = hpm.per_tag.get(job.tag, 0) + dur
        return SimReport(makespan_cycles=max(end, default=0),
                         per_job_start=start, per_job_end=end,
                         per_mvu_busy=busy, hart_free=hart_free, hpm=hpm)

    # ------------------------------------------------------------- real exec
    def register(self, op: OpKind, fn: Callable) -> None:
        """``fn(job, env) -> None`` mutates the tensor environment."""
        self._executors[op] = fn

    def execute(self, stream: CommandStream, env: Dict[str, object], *,
                hpm=None) -> Dict:
        """Run every job in dependency order against real tensors.

        ``env`` maps tensor names to arrays; executors read/write it. The
        per-job ``tag`` identifies which layer/tensors a job touches.
        Pass an :class:`~repro_torch.obs.hpm.HPMCounterFile` as ``hpm`` to count
        dispatched jobs (and their modelled cycles) on the real path.
        """
        done = set()
        for i, job in enumerate(stream.jobs):
            missing = [d for d in job.depends_on if d not in done]
            if missing:
                raise RuntimeError(
                    f"job {i} ({job.tag}) scheduled before deps {missing}")
            fn = self._executors.get(job.op)
            if fn is not None:
                fn(job, env)
            if hpm is not None:
                hpm.record_executed_job(job)
            done.add(i)  # completion interrupt
        return env
