"""MVU-slot scheduler: admission of micro-batches onto virtual PE slots.

The paper's fabric has 8 MVUs, each CSR-programmable to its own precision
(§3.1.1), and two mapping modes (§3.1.6). When several models — or the
same model at several precisions — share the fabric, the runtime must
decide *when* each batch's command stream may start. This scheduler keeps
that decision in the cycle domain:

* each variant's compiled Program lowers once to a
  :class:`~repro_torch.core.codegen.CommandStream` (cached per key);
* admission runs :meth:`BarrelController.simulate` seeded with the current
  per-slot busy-until clock (``hart_free``) and ``cycle_scale=batch``, so
  a W2A2 batch books 4x fewer cycles than the same model's W4A8 batch —
  exactly the paper's precision/throughput trade-off — and the stream's
  job→MVU placement (pipelined or distributed) is honoured, not just an
  aggregate cost;
* the returned :class:`Admission` carries the virtual start/finish cycles
  and estimated seconds; :meth:`complete` feeds back measured wall time so
  metrics expose both the modelled and the observed picture;
* :meth:`set_calibration` attaches a fitted ns-per-cycle model
  (:mod:`repro_torch.obs.calibrate`) so ``est_seconds`` and the predicted
  finish switch from the nominal controller clock to measured wall time —
  the SLO-booking currency.

**Bank scaling** (``n_banks > 1``): the slot pool generalizes from the
single fabric's 8 slots to ``n_banks x 8`` — one 8-MVU bank per
device, the paper's "bigger FPGA carries more banks" axis. Admission then
has a placement decision:

* ``placement="banked"`` — simulate the stream against *every* bank's
  clock and book the one that finishes earliest, so mixed W2A2/W4A8
  traffic load-balances across banks (a W4A8 batch books ~8x the cycles
  of a W2A2 batch — a*w = 32 vs 4 bit-cycles; least-finish placement
  keeps the banks even);
* ``placement="sharded"`` — the batch is split evenly over all banks
  (data-parallel :class:`~repro_torch.distributed.program_parallel
  .ShardedProgram` execution); every bank books the same stream at
  ``cycle_scale = batch / n_banks``.

Utilization is per-slot busy cycles over the virtual makespan — the same
definition as :class:`~repro_torch.runtime.controller.SimReport.utilization`,
extended across every admitted batch and every bank.

The port's copy of ``repro/serving/scheduler.py`` (pure Python). Its banks
are cycle-domain clocks, so ``n_banks > 1`` books more virtual slots and
needs no second card; the service runs each booked bank's batch on that
bank's stream.
``set_calibration`` takes a :class:`~repro_torch.obs.calibrate.Calibration`
(or any object with ``predict_wall_seconds`` and ``ns_for``).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Tuple

from repro_torch.obs.hpm import HPMCounterFile
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.runtime.controller import BarrelController
from repro_torch.serving.registry import ModelKey

__all__ = ["Admission", "SlotScheduler"]


@dataclasses.dataclass
class Admission:
    key: ModelKey
    batch: int
    start_cycle: int          # earliest cycle any of its jobs issues
    finish_cycle: int         # virtual completion cycle
    est_cycles: int           # finish - start (this batch's span)
    est_seconds: float        # est_cycles at the controller clock
    banks: Tuple[int, ...] = (0,)   # banks this batch was booked on

    @property
    def bank(self) -> int:
        """The placed bank (banked placement books exactly one)."""
        return self.banks[0]


class SlotScheduler:
    def __init__(self, *, controller: Optional[BarrelController] = None,
                 mode: str = "pipelined", n_banks: int = 1,
                 placement: str = "banked",
                 metrics: Optional[MetricsRegistry] = None,
                 tracer=None):
        if n_banks < 1:
            raise ValueError(f"n_banks must be >= 1, got {n_banks}")
        if placement not in ("banked", "sharded"):
            raise ValueError(f"unknown placement {placement!r} — "
                             "'banked' or 'sharded'")
        self.controller = controller or BarrelController()
        self.n_banks = n_banks
        self.placement = placement
        self.slots = self.controller.harts * n_banks
        self.mode = mode
        self._lock = threading.Lock()
        h = self.controller.harts
        self._hart_free: List[List[int]] = [
            [0] * h for _ in range(n_banks)]        # guarded-by: _lock
        self._busy: List[List[int]] = [
            [0] * h for _ in range(n_banks)]        # guarded-by: _lock
        self._streams: Dict[ModelKey, object] = {}  # guarded-by: _lock
        # registry-backed counters: every mutation below happens under
        # self._lock, so the totals stay exact despite the registry's
        # lock-free write path (see obs/metrics.py)
        self.metrics_registry = (metrics if metrics is not None
                                 else MetricsRegistry())
        m = self.metrics_registry
        self._c_admitted = m.counter(
            "scheduler_admitted_batches_total", "micro-batches booked")
        self._c_requests = m.counter(
            "scheduler_admitted_requests_total", "requests booked")
        self._c_unscheduled = m.counter(
            "scheduler_unscheduled_batches_total",
            "batches served without a cost model")
        self._c_wall = m.counter(
            "scheduler_wall_seconds_total", "measured batch wall time")
        self._c_done_cycles = m.counter(
            "scheduler_completed_cycles_total",
            "booked est_cycles of completed batches (observed ns/cycle "
            "denominator)")
        self._c_bank_batches = m.counter(
            "scheduler_bank_batches_total", "batches committed per bank")
        self._c_bank_requests = m.counter(
            "scheduler_bank_requests_total", "requests committed per bank")
        self._g_cycles = m.gauge(
            "scheduler_virtual_cycles", "busiest slot's busy-until cycle")
        # the HPM counter file: one per bank, merged only on _commit (the
        # tentative per-bank simulations in admit() never accumulate)
        self.hpm_files = [HPMCounterFile(h, metrics=m, bank=b)
                          for b in range(n_banks)]
        self.tracer = tracer
        # optional fitted wall-time model (see set_calibration)
        self._calibration = None                    # guarded-by: _lock

    # ---------------------------------------------------------- calibration
    def set_calibration(self, calibration) -> None:
        """Attach a fitted ns-per-cycle model (anything with the
        reference ``Calibration``'s ``predict_wall_seconds`` and ``ns_for``
        contract), or ``None`` to revert to the nominal controller clock.
        Later admissions book wall-time estimates at the fitted rate."""
        with self._lock:
            self._calibration = calibration

    def _est_seconds(self, est_cycles: int) -> float:
        if self._calibration is not None:
            return self._calibration.predict_wall_seconds(est_cycles)
        return est_cycles / self.controller.freq_hz

    # --------------------------------------------------------------- stream
    def stream_for(self, key: ModelKey, program=None, stream=None):
        """The variant's CommandStream (lowered once, then cached).

        With ``REPRO_VERIFY`` set, a stream entering the admission cache is
        first hazard-checked and cycle-reconciled against this scheduler's
        own controller (:mod:`repro_torch.analysis.verify_stream`) — admission
        books per-hart cycles from ``simulate``, so a stream whose
        accounting does not reconcile would corrupt the booking clock."""
        from repro_torch import analysis
        with self._lock:
            cs = self._streams.get(key)
            if cs is None:
                if stream is not None:
                    cs = stream
                elif program is not None:
                    cs = program.to_command_stream(mode=self.mode)
                else:
                    return None
                if analysis.verify_enabled():
                    analysis.count("stream_admission")
                    from repro_torch.analysis.verify_stream import verify_stream
                    verify_stream(cs, controller=self.controller,
                                  blame=f"admission of {key}")
                self._streams[key] = cs
            return cs

    # ------------------------------------------------------------ admission
    def _simulate_on(self, bank: int, cs, batch: int):
        """One bank's tentative schedule for this stream (not committed)."""
        return self.controller.simulate(
            cs, hart_free=self._hart_free[bank],
            cycle_scale=max(1, batch))

    def _commit(self, bank: int, rep, cs, batch: int,
                label: str = "") -> Tuple[int, int]:  # requires: _lock
        started = [s for s, j in zip(rep.per_job_start, cs.jobs)
                   if j.mvu >= 0]
        start = min(started, default=rep.makespan_cycles)
        self._hart_free[bank] = rep.hart_free
        for h in range(self.controller.harts):
            self._busy[bank][h] += rep.per_mvu_busy[h]
        self._c_bank_batches.inc(bank=str(bank))
        self._c_bank_requests.inc(batch, bank=str(bank))
        if rep.hpm is not None:
            self.hpm_files[bank].merge(rep.hpm)
        if self.tracer is not None and self.tracer.enabled:
            # cycle-domain occupancy rows: one span per hart this batch
            # actually ran on (track "bankB/hartH" in the Perfetto export)
            h_lo: Dict[int, int] = {}
            h_hi: Dict[int, int] = {}
            for s, e, j in zip(rep.per_job_start, rep.per_job_end,
                               cs.jobs):
                if j.mvu < 0 or e <= s:
                    continue
                h = j.mvu % self.controller.harts
                h_lo[h] = min(h_lo.get(h, s), s)
                h_hi[h] = max(h_hi.get(h, e), e)
            for h in h_lo:
                self.tracer.cycle_span(
                    label or "batch", h_lo[h], h_hi[h],
                    track=f"bank{bank}/hart{h}", batch=batch)
        return start, rep.makespan_cycles

    def admit(self, key: ModelKey, batch: int, *, program=None,
              stream=None) -> Optional[Admission]:
        """Book ``batch`` inputs of ``key`` onto the virtual slots.

        Returns ``None`` (and serves unscheduled) when the variant has no
        command stream — opaque engines without a cost model.
        """
        cs = self.stream_for(key, program=program, stream=stream)
        if cs is None:
            with self._lock:
                self._c_unscheduled.inc()
                self._c_requests.inc(batch)
            return None
        label = str(key)
        with self._lock:
            if self.placement == "sharded" and self.n_banks > 1:
                # data-parallel: every bank runs the stream on its shard.
                # Split exactly (first banks take the remainder) so
                # sum(bank_requests) == admitted requests; banks with an
                # empty shard are not booked at all.
                base, rem = divmod(batch, self.n_banks)
                shards = [base + (1 if b < rem else 0)
                          for b in range(self.n_banks)]
                start = finish = None
                booked = []
                for b, shard in enumerate(shards):
                    if shard == 0:
                        continue
                    rep = self._simulate_on(b, cs, shard)
                    s, f = self._commit(b, rep, cs, shard, label)
                    start = s if start is None else min(start, s)
                    finish = f if finish is None else max(finish, f)
                    booked.append(b)
                banks = tuple(booked)
            else:
                # least-finish placement: the load-balancing decision
                reports = [(self._simulate_on(b, cs, batch), b)
                           for b in range(self.n_banks)]
                rep, bank = min(reports,
                                key=lambda rb: (rb[0].makespan_cycles,
                                                rb[1]))
                start, finish = self._commit(bank, rep, cs, batch, label)
                banks = (bank,)
            self._c_admitted.inc()
            self._c_requests.inc(batch)
            self._g_cycles.set(self.virtual_cycles)
            est = finish - start
            return Admission(
                key=key, batch=batch, start_cycle=start,
                finish_cycle=finish, est_cycles=est,
                est_seconds=self._est_seconds(est), banks=banks)

    def complete(self, admission: Optional[Admission],
                 wall_seconds: float) -> None:
        """Measured wall time feedback for one served batch. With the
        admission handed back, its booked cycles accumulate too, so
        metrics expose the *observed* ns/cycle next to any fitted one."""
        with self._lock:
            self._c_wall.inc(wall_seconds)
            if admission is not None:
                self._c_done_cycles.inc(admission.est_cycles)

    # -------------------------------------------------------------- metrics
    # legacy attribute surface, now registry-backed (same names/semantics
    # as the former plain counters, read by tests and the service)
    @property
    def admitted(self) -> int:
        return int(self._c_admitted.value())

    @property
    def admitted_requests(self) -> int:
        return int(self._c_requests.value())

    @property
    def unscheduled(self) -> int:
        return int(self._c_unscheduled.value())

    @property
    def wall_seconds(self) -> float:
        return self._c_wall.value()

    @property
    def bank_batches(self) -> List[int]:
        return [int(self._c_bank_batches.value(bank=str(b)))
                for b in range(self.n_banks)]

    @property
    def bank_requests(self) -> List[int]:
        return [int(self._c_bank_requests.value(bank=str(b)))
                for b in range(self.n_banks)]

    def hpm(self) -> List[Dict]:
        """Per-bank HPM counter-file snapshots (committed streams only)."""
        with self._lock:
            return [f.snapshot() for f in self.hpm_files]

    @property
    def virtual_cycles(self) -> int:
        """The virtual clock: cycle at which the busiest slot frees."""
        return max((c for bank in self._hart_free for c in bank), default=0)

    def utilization(self) -> List[float]:
        """Per-slot busy fraction of the virtual makespan so far
        (flattened bank-major: slot ``b * 8 + h`` is hart h of bank b)."""
        span = self.virtual_cycles
        flat = [c for bank in self._busy for c in bank]
        if span == 0:
            return [0.0] * self.slots
        return [b / span for b in flat]

    def bank_utilization(self) -> List[float]:
        """Mean busy fraction per bank (the soak test's per-bank signal)."""
        span = self.virtual_cycles
        if span == 0:
            return [0.0] * self.n_banks
        h = self.controller.harts
        return [sum(bank) / (h * span) for bank in self._busy]

    def metrics(self) -> Dict:
        with self._lock:
            span = self.virtual_cycles
            util = self.utilization()
            bank_util = self.bank_utilization()
            busy = [c for bank in self._busy for c in bank if c > 0]
            return {
                "mode": self.mode,
                "placement": self.placement,
                "n_banks": self.n_banks,
                "admitted_batches": self.admitted,
                "admitted_requests": self.admitted_requests,
                "unscheduled_batches": self.unscheduled,
                "virtual_cycles": span,
                "virtual_seconds": span / self.controller.freq_hz,
                "slot_utilization": [round(u, 4) for u in util],
                "bank_utilization": [round(u, 4) for u in bank_util],
                "bank_batches": list(self.bank_batches),
                "bank_requests": list(self.bank_requests),
                "mean_busy_utilization": (
                    round(sum(busy) / (len(busy) * span), 4)
                    if busy and span else 0.0),
                "wall_seconds": round(self.wall_seconds, 6),
                "hpm": [f.snapshot() for f in self.hpm_files],
                "calibration": self._calibration_metrics(span),
            }

    def _calibration_metrics(self, span: int) -> Dict:
        """The wall-time view of the virtual clock: fitted ns/cycle (when
        calibrated), the observed rate from completions, and the busiest
        slot's predicted wall-clock finish."""
        cal = self._calibration
        done_cycles = self._c_done_cycles.value()
        observed = (self._c_wall.value() * 1e9 / done_cycles
                    if done_cycles > 0 else None)
        fitted = cal.ns_for() if cal is not None else None
        return {
            "source": "fitted" if cal is not None else "nominal",
            "ns_per_cycle": (round(fitted, 4) if fitted is not None
                             else round(1e9 / self.controller.freq_hz, 4)),
            "observed_ns_per_cycle": (round(observed, 4)
                                      if observed is not None else None),
            "predicted_finish_seconds": round(
                cal.predict_wall_seconds(span) if cal is not None
                else span / self.controller.freq_hz, 6),
        }
