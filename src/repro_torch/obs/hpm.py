"""HPM-style per-hart performance counter file (RISC-V mcycle/minstret
analogue for the barrel controller).

The port's copy of ``repro/obs/hpm.py`` (pure Python, no torch).

RISC-V's answer to "what is the core doing" is the hardware performance
monitor CSR file: per-hart cycle/instret/event counters, readable at any
time, attributable to whatever the hart was running. The
:class:`~repro_torch.runtime.controller.BarrelController` is our 8-hart barrel —
this module gives it the same counter file in software:

* **per-hart cycle counters** — ``busy`` (compute-job cycles), ``xfer``
  (interconnect-send cycles), ``issue`` (CSR-programming overhead: the
  ``instrs_per_issue * harts`` barrel tax per job), and ``stall``
  (dependency wait: cycles a free hart sat idle because a predecessor job
  hadn't completed). The invariant the tests pin:
  ``busy[h] + xfer[h] == SimReport.per_mvu_busy[h]`` exactly;
* **per-layer-tag attribution** — cycles by ``MVUJob.tag`` (FINN-R-style
  per-layer cost attribution: which layer owns the fabric);
* **per-precision attribution** — cycles by ``W{w_bits}A{a_bits}`` (the
  SPEED-style utilization split across co-scheduled precisions);
* **per-job counts** — jobs issued per :class:`~repro_torch.core.mvu.OpKind`.

:meth:`HPMCounterFile.record` consumes one
:class:`~repro_torch.runtime.controller.SimReport` together with its stream, so
accumulation happens only where a schedule is *committed* (the
:class:`~repro_torch.serving.scheduler.SlotScheduler` simulates tentatively on
every bank and records on the winner only). ``BarrelController.simulate``
also returns a per-call :class:`HPMCounters` on the report itself.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

__all__ = ["HPMCounters", "HPMCounterFile", "precision_key"]


def precision_key(a_bits: int, w_bits: int) -> str:
    return f"W{w_bits}A{a_bits}"


@dataclasses.dataclass
class HPMCounters:
    """One simulation call's counter deltas (attached to ``SimReport``)."""

    harts: int
    busy: List[int]                  # compute cycles per hart
    xfer: List[int]                  # interconnect-send cycles per hart
    issue: List[int]                 # job-programming overhead per hart
    stall: List[int]                 # dependency-wait idle cycles per hart
    per_tag: Dict[str, int]          # layer tag -> cycles (busy + xfer)
    per_precision: Dict[str, int]    # "W{w}A{a}" -> compute cycles
    jobs: Dict[str, int]             # OpKind.value -> jobs issued

    @classmethod
    def empty(cls, harts: int) -> "HPMCounters":
        return cls(harts=harts, busy=[0] * harts, xfer=[0] * harts,
                   issue=[0] * harts, stall=[0] * harts, per_tag={},
                   per_precision={}, jobs={})

    @property
    def total(self) -> List[int]:
        """busy + xfer per hart — equals ``SimReport.per_mvu_busy``."""
        return [b + x for b, x in zip(self.busy, self.xfer)]

    def snapshot(self) -> Dict:
        return {
            "busy": list(self.busy),
            "xfer": list(self.xfer),
            "issue": list(self.issue),
            "stall": list(self.stall),
            "per_tag": dict(self.per_tag),
            "per_precision": dict(self.per_precision),
            "jobs": dict(self.jobs),
        }


class HPMCounterFile:
    """Cumulative counter file: merge per-call :class:`HPMCounters` (or
    raw execute-path events) across a component's lifetime.

    Optionally mirrors totals into a :class:`~repro_torch.obs.metrics
    .MetricsRegistry` (``metrics=``) so the Prometheus exposition carries
    the same numbers, labelled by ``bank`` and hart/tag/precision.
    """

    def __init__(self, harts: int, *, metrics=None, bank: int = 0):
        self.harts = harts
        self.bank = bank
        self.counters = HPMCounters.empty(harts)
        self.records = 0
        self._metrics = metrics
        if metrics is not None:
            self._c_cycles = metrics.counter(
                "hpm_hart_cycles_total",
                "per-hart cycles by class (busy/xfer/issue/stall)")
            self._c_tag = metrics.counter(
                "hpm_tag_cycles_total", "cycles attributed per layer tag")
            self._c_prec = metrics.counter(
                "hpm_precision_cycles_total",
                "compute cycles per (a_bits x w_bits) precision")

    # ------------------------------------------------------------ recording
    def merge(self, delta: HPMCounters) -> None:
        c = self.counters
        for h in range(self.harts):
            c.busy[h] += delta.busy[h]
            c.xfer[h] += delta.xfer[h]
            c.issue[h] += delta.issue[h]
            c.stall[h] += delta.stall[h]
        for d, s in ((c.per_tag, delta.per_tag),
                     (c.per_precision, delta.per_precision),
                     (c.jobs, delta.jobs)):
            for k, v in s.items():
                d[k] = d.get(k, 0) + v
        self.records += 1
        if self._metrics is not None:
            bank = str(self.bank)
            for h in range(self.harts):
                hh = str(h)
                if delta.busy[h]:
                    self._c_cycles.inc(delta.busy[h], bank=bank, hart=hh,
                                       cls="busy")
                if delta.xfer[h]:
                    self._c_cycles.inc(delta.xfer[h], bank=bank, hart=hh,
                                       cls="xfer")
                if delta.issue[h]:
                    self._c_cycles.inc(delta.issue[h], bank=bank, hart=hh,
                                       cls="issue")
                if delta.stall[h]:
                    self._c_cycles.inc(delta.stall[h], bank=bank, hart=hh,
                                       cls="stall")
            for t, v in delta.per_tag.items():
                self._c_tag.inc(v, bank=bank, tag=t)
            for p, v in delta.per_precision.items():
                self._c_prec.inc(v, bank=bank, precision=p)

    def record(self, report, stream) -> None:
        """Merge one committed simulation (report must carry ``hpm``)."""
        hpm = getattr(report, "hpm", None)
        if hpm is None:
            raise ValueError("SimReport has no hpm counters to record")
        self.merge(hpm)

    def record_executed_job(self, job, *, cycles: Optional[int] = None
                            ) -> None:
        """Execute-path event: one job dispatched on the real executor.

        ``execute`` runs tensors, not a clock, so only job counts (and the
        job's modelled cycles) are attributable here — the wall-clock view
        belongs to the tracer's spans.
        """
        c = self.counters
        op = getattr(job.op, "value", str(job.op))
        c.jobs[op] = c.jobs.get(op, 0) + 1
        dur = job.cycles if cycles is None else cycles
        if job.mvu >= 0 and dur:
            h = job.mvu % self.harts
            key = precision_key(job.a_bits, job.w_bits)
            if op == "xfer":
                c.xfer[h] += dur
            else:
                c.busy[h] += dur
                c.per_precision[key] = c.per_precision.get(key, 0) + dur
            if job.tag:
                c.per_tag[job.tag] = c.per_tag.get(job.tag, 0) + dur
        self.records += 1

    # -------------------------------------------------------------- reading
    def snapshot(self) -> Dict:
        out = self.counters.snapshot()
        out["records"] = self.records
        out["bank"] = self.bank
        return out

    def top_tags(self, k: int = 8) -> List:
        """The k most expensive layer tags — the per-layer cost oracle."""
        return sorted(self.counters.per_tag.items(),
                      key=lambda kv: -kv[1])[:k]
