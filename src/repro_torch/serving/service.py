"""Thread-driven serving front end: ``submit`` / ``submit_many`` / ``drain``.

Counterpart of ``repro/serving/service.py``. One worker thread pulls
micro-batches from the :class:`~repro_torch.serving.batcher.DynamicBatcher`,
resolves the variant in the :class:`~repro_torch.serving.registry.
ModelRegistry`, books it on the :class:`~repro_torch.serving.scheduler.
SlotScheduler` (the barrel controller's cycle domain), and executes:

* **Program variants** run through the executor's bucketed runner
  (:func:`repro_torch.compiler.executor.make_bucketed_runner`) — one runner
  per (model, precision), one CUDA graph per padding bucket on the card,
  so the whole service's capture set is the closed set {variant} x
  {bucket} and steady-state traffic never captures again
  (``metrics()["bucket_caches"]`` exposes the counters);
* **callable variants** (e.g. the continuous LM engine) receive the raw
  request list and return one result per request.

**Bank scaling** (``n_banks > 1``): every bank is one 8-slot MVU bank
(:mod:`repro_torch.distributed.program_parallel`) — a device and, on a
card, a CUDA stream of its own; four banks on one H100 are four streams.
Two placements:

* ``placement="banked"`` — the :class:`SlotScheduler` books each
  micro-batch on the bank whose cycle clock frees earliest, and the batch
  replays that bank's graph on that bank's stream, so mixed-precision
  traffic load-balances across banks;
* ``placement="sharded"`` — each micro-batch is split evenly over all
  banks (buckets are multiples of the bank count; the batcher rounds
  takes to it).

In both, packed weight planes are placed once per device through a
service-wide :class:`~repro_torch.distributed.program_parallel.
ReplicaCache` (on one card: no copy at all), and batch completion moves to
a small finalize pool, so the worker can keep dispatching to idle banks
while earlier batches still run on the card (a runner call only enqueues
work; the host copy of the answers waits). Program variants run the
kernels' plain versions when the registry says ``plain``
(``InferenceService(plain=)`` overrides it).

Per-batch wall latency feeds the
:class:`~repro_torch.runtime.straggler.StragglerDetector`, so anomalous
batches show up in the metrics snapshot. A batch that raises
:class:`~repro_torch.runtime.fault_tolerance.WorkerFailure` has its requests
requeued (at most ``max_retries`` times each). Results arrive through
``concurrent.futures.Future``s; ``drain()`` blocks until every accepted
request has resolved.
"""

from __future__ import annotations

import collections
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np

from repro_torch.compiler import executor
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.tracing import Tracer, now_ns
from repro_torch.runtime.fault_tolerance import WorkerFailure
from repro_torch.runtime.straggler import StragglerDetector
from repro_torch.serving.batcher import (DynamicBatcher, MicroBatch,
                                         QueueFull, Request)
from repro_torch.serving.registry import ModelKey, ModelRegistry
from repro_torch.serving.scheduler import SlotScheduler

__all__ = ["InferenceService"]


class InferenceService:
    """See module docstring. Use as a context manager, or ``start()`` /
    ``stop()`` explicitly; ``submit`` before ``start`` raises."""

    def __init__(self, registry: ModelRegistry, *,
                 batcher: Optional[DynamicBatcher] = None,
                 scheduler: Optional[SlotScheduler] = None,
                 straggler: Optional[StragglerDetector] = None,
                 max_batch: int = 32, max_wait_s: float = 0.002,
                 max_queue: int = 256,
                 plain: Optional[bool] = None,
                 n_banks: Optional[int] = None,
                 placement: str = "banked",
                 mesh=None,
                 metrics: Optional[MetricsRegistry] = None,
                 tracer: Optional[Tracer] = None,
                 trace_sample_every: int = 1,
                 max_retries: int = 0):
        self.registry = registry
        self.n_banks = 1 if n_banks is None else n_banks
        if self.n_banks < 1:
            raise ValueError(f"n_banks must be >= 1, got {n_banks}")
        if placement not in ("banked", "sharded"):
            # validate unconditionally: a typo must not silently degrade
            # to single-device serving just because n_banks was defaulted
            raise ValueError(f"unknown placement {placement!r} — "
                             "'banked' or 'sharded'")
        self._mesh = None
        self._banks = None
        self._replicas = None
        round_to = 1
        if self.n_banks > 1 or mesh is not None:
            from repro_torch.distributed import program_parallel as pp
            self.placement = placement
            self._replicas = pp.ReplicaCache()
            home = pp.home_devices(registry.device)
            if placement == "sharded":
                self._mesh = mesh if mesh is not None else pp.bank_mesh(
                    self.n_banks, devices=home)
                self.n_banks = int(self._mesh.shape[pp.BANK_AXIS])
                round_to = self.n_banks
            else:
                # the raw n_banks (None = every bank of the given mesh),
                # NOT self.n_banks: its None->1 default would silently
                # shrink an explicit mesh to a single bank
                self._banks = pp.bank_devices(
                    n_banks, list(mesh) if mesh is not None else home)
                self.n_banks = len(self._banks)
        else:
            self.placement = "single"
        # the spine-wide observability pair: one metrics registry + one
        # tracer, propagated into every component the service constructs
        self.metrics_registry = (metrics if metrics is not None
                                 else MetricsRegistry())
        self.tracer = tracer if tracer is not None else Tracer(
            sample_every=trace_sample_every)
        self.batcher = batcher or DynamicBatcher(
            max_batch=max_batch, max_wait_s=max_wait_s, max_queue=max_queue,
            round_to=round_to, metrics=self.metrics_registry)
        self.scheduler = scheduler or SlotScheduler(
            n_banks=self.n_banks,
            placement=("sharded" if self.placement == "sharded"
                       else "banked"),
            metrics=self.metrics_registry, tracer=self.tracer)
        self.straggler = straggler or StragglerDetector(window=64)
        self.plain = plain
        self._runners: Dict[ModelKey, executor.BucketedRunner] = {}  # guarded-by: _mlock
        self._thread: Optional[threading.Thread] = None
        self._pool: Optional[ThreadPoolExecutor] = None
        self._stop = threading.Event()
        self._pend_lock = threading.Condition()
        self._pending = 0    # guarded-by: _pend_lock
        self._batch_seq = 0  # guarded-by: _mlock
        # guards everything metrics() reads while the worker writes it
        self._mlock = threading.Lock()
        self._latencies = collections.deque(maxlen=4096)  # guarded-by: _mlock
        self.max_retries = max_retries
        m = self.metrics_registry
        self._c_completed = m.counter("service_completed_total",
                                      "requests resolved successfully")
        self._c_failed = m.counter("service_failed_total",
                                   "requests resolved with an error")
        self._c_requeues = m.counter(
            "service_requeues_total",
            "requests requeued after a transient bank failure")
        self._h_latency = m.histogram(
            "service_request_latency_seconds",
            "submit-to-result wall latency")

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "InferenceService":
        if self._thread is not None:
            return self
        self._stop.clear()
        self.batcher.reopen()
        if self.n_banks > 1:
            self._pool = ThreadPoolExecutor(
                max_workers=self.n_banks,
                thread_name_prefix="serving-finalize")
        self._thread = threading.Thread(target=self._loop,
                                        name="serving-worker", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._thread is None:
            return
        # closing the batcher first makes shutdown race-free: submits that
        # already passed the started check (or are blocked on a full queue)
        # now fail inside put() and roll their pending count back
        self.batcher.close()
        self._stop.set()
        self._thread.join(timeout=30)
        self._thread = None
        if self._pool is not None:
            # every dispatched batch still in flight resolves its futures
            self._pool.shutdown(wait=True)
            self._pool = None
        n = self.batcher.flush_pending(
            RuntimeError("service stopped with requests still queued"))
        with self._pend_lock:
            self._pending -= n
            self._pend_lock.notify_all()

    def __enter__(self) -> "InferenceService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ------------------------------------------------------------ submission
    def submit(self, key: ModelKey, payload, *, block: bool = True,
               timeout: Optional[float] = None) -> Future:
        """Queue one request; returns its Future.

        ``payload``: one example (no batch axis) for Program variants; any
        engine-defined object for callable variants. With ``block=False``
        a full queue raises :class:`~repro_torch.serving.batcher.QueueFull`
        instead of waiting (the backpressure boundary).
        """
        if self._thread is None:
            raise RuntimeError("service is not started — use "
                               "`with service:` or call start()")
        self.registry.entry(key)  # fail fast on unknown variants
        req = Request(key, payload, trace=self.tracer.start_trace())
        with self._pend_lock:
            self._pending += 1
        try:
            self.batcher.put(req, block=block, timeout=timeout)
        except BaseException:
            with self._pend_lock:
                self._pending -= 1
                self._pend_lock.notify_all()
            raise
        return req.future

    def submit_many(self, key: ModelKey, payloads) -> List[Future]:
        return [self.submit(key, p) for p in payloads]

    def drain(self, timeout: Optional[float] = None) -> None:
        """Block until every accepted request has resolved."""
        deadline = None if timeout is None else time.perf_counter() + timeout
        with self._pend_lock:
            while self._pending > 0:
                wait = None if deadline is None else (
                    deadline - time.perf_counter())
                if wait is not None and wait <= 0:
                    raise TimeoutError(
                        f"{self._pending} requests still pending")
                self._pend_lock.wait(wait)

    # ------------------------------------------------------------ execution
    def _runner_for(self, key: ModelKey) -> executor.BucketedRunner:
        r = self._runners.get(key)
        resident = self.registry.resident_program(key)
        if r is not None and r.program is resident:
            return r
        # first use, or the registry evicted/recompiled this variant's
        # Program: (re)build the runner so the service never pins an
        # evicted Program (nor the graphs captured over its parameters),
        # and drop the runners of variants evicted so far — this compile
        # included
        prog = self.registry.program(key)  # touches LRU / lazy-compiles
        r = executor.make_bucketed_runner(
            prog, max_batch=self.batcher.max_batch,
            plain=self.registry.plain if self.plain is None else self.plain,
            mesh=self._mesh, banks=self._banks, replica_cache=self._replicas)
        with self._mlock:
            for k in [k for k in self._runners
                      if self.registry.resident_program(k) is None]:
                del self._runners[k]
            self._runners[key] = r
        return r

    _PROGRAM_KINDS = ("graph", "program", "artifact")

    def warmup(self, key: Optional[ModelKey] = None) -> int:
        """Capture every padding bucket of one (or every) Program variant;
        returns the number of captures (compiles) triggered. Call it
        before traffic: the captures then happen on the caller's thread."""
        keys = [key] if key is not None else [
            k for k in self.registry.keys()
            if self.registry.entry(k).kind in self._PROGRAM_KINDS]
        n = 0
        for k in keys:
            if self.registry.entry(k).kind in self._PROGRAM_KINDS:
                n += self._runner_for(k).warmup()
        return n

    def warm_boot(self) -> Dict:
        """Cold-start killer: restore every variant from the registry's
        artifact store (zero ``compile_graph`` with a populated store),
        then capture every variant's padding buckets over the loaded
        tensors (:meth:`warmup`; ``bucket_compiles`` in the report)."""
        report = self.registry.warm_boot()
        report["bucket_compiles"] = self.warmup()
        return report

    def set_calibration(self, calibration) -> None:
        """Attach a fitted ns-per-cycle model to the scheduler, turning
        cycle-domain admissions into wall-time finish estimates; surfaced
        via ``metrics()["scheduler"]["calibration"]``."""
        self.scheduler.set_calibration(calibration)

    def _max_batch_for(self, key: ModelKey) -> Optional[int]:
        return self.registry.entry(key).max_batch

    def _loop(self) -> None:
        while not self._stop.is_set():
            mb = self.batcher.next_batch(timeout=0.05,
                                         max_batch_for=self._max_batch_for)
            if mb is None:
                continue
            self._run_batch(mb)

    def _run_batch(self, mb: MicroBatch) -> None:
        t0 = time.perf_counter()
        marks = {"batch": now_ns()}
        try:
            pending, admission = self._dispatch(mb, marks)
        except WorkerFailure as e:
            # transient bank loss on the serving path: requeue the batch's
            # requests (bounded per request by max_retries) rather than
            # failing them — a flaky bank costs latency, not errors
            self._requeue_or_fail(mb, e)
            return
        except BaseException as e:  # noqa: BLE001 — worker must survive
            self._fail_batch(mb, e)
            return
        if self._pool is None:
            self._finalize(mb, pending, admission, t0, marks)
        else:
            # multi-bank: the batch's card work is in flight; the host copy
            # and the futures move off the worker so the next micro-batch
            # can start on another bank at once
            self._pool.submit(self._finalize, mb, pending, admission, t0,
                              marks)

    def _fail_batch(self, mb: MicroBatch, e: BaseException) -> None:
        for r in mb.requests:
            r.future.set_exception(e)
        self._c_failed.inc(len(mb.requests))
        self._mark_done(len(mb.requests))

    def _requeue_or_fail(self, mb: MicroBatch, e: WorkerFailure) -> None:
        for r in mb.requests:
            if r.retries >= self.max_retries:
                r.future.set_exception(e)
                self._c_failed.inc()
                self._mark_done(1)
                continue
            r.retries += 1
            try:
                # non-blocking: the worker must not deadlock against its
                # own full queue; an unlucky request fails like any other
                self.batcher.put(r, block=False)
                self._c_requeues.inc()
            except (QueueFull, RuntimeError) as qe:
                r.future.set_exception(qe)
                self._c_failed.inc()
                self._mark_done(1)

    def _mark_done(self, n: int) -> None:
        with self._pend_lock:
            self._pending -= n
            self._pend_lock.notify_all()

    def _call_engine(self, fn, mb: MicroBatch) -> List:
        results = fn([r.payload for r in mb.requests])
        if len(results) != mb.size:
            raise RuntimeError(f"engine {mb.key} returned {len(results)} "
                               f"results for {mb.size} requests")
        return results

    def _dispatch(self, mb: MicroBatch, marks: Dict):
        """Book the batch and launch its work (no host copy).

        ``marks`` collects the phase boundary timestamps (ns) that
        :meth:`_emit_spans` turns into queue/schedule/execute spans."""
        entry = self.registry.entry(mb.key)
        if entry.kind == "callable":
            if getattr(entry.fn, "books_own_cycles", False):
                # continuous engines book the scheduler themselves, per
                # decode step (token granularity) — a per-batch admission
                # here would double-count their cycles
                if getattr(entry.fn, "_scheduler", None) is not self.scheduler:
                    entry.fn.bind_runtime(self.scheduler, mb.key,
                                          tracer=self.tracer)
                marks["exec"] = now_ns()
                return ("list", self._call_engine(entry.fn, mb)), None
            marks["sched"] = now_ns()
            admission = self.scheduler.admit(mb.key, mb.size,
                                             stream=entry.stream)
            marks["exec"] = now_ns()
            return ("list", self._call_engine(entry.fn, mb)), admission
        runner = self._runner_for(mb.key)
        marks["sched"] = now_ns()
        admission = self.scheduler.admit(mb.key, mb.size,
                                         program=runner.program)
        marks["exec"] = now_ns()
        x = np.stack([np.asarray(r.payload) for r in mb.requests])
        bank = (admission.bank
                if admission is not None and runner.placement == "banked"
                else None)
        return ("tensor", runner(x, bank=bank)), admission

    def _finalize(self, mb: MicroBatch, pending, admission,
                  t0: float, marks: Dict) -> None:
        """Bring the batch's results to the host, resolve its futures and
        record its latency and spans."""
        try:
            kind, val = pending
            results = val if kind == "list" else list(val.cpu().numpy())
        except WorkerFailure as e:
            self._requeue_or_fail(mb, e)
            return
        except BaseException as e:  # noqa: BLE001 — pool must survive
            self._fail_batch(mb, e)
            return
        t_exec_done = now_ns()
        dt = time.perf_counter() - t0
        self.scheduler.complete(admission, dt)
        done = time.perf_counter()
        with self._mlock:
            self._batch_seq += 1
            self.straggler.observe(self._batch_seq, dt)
            for r in mb.requests:
                lat = done - r.t_submit
                self._latencies.append(lat)
                self._h_latency.observe(lat)
        for r, y in zip(mb.requests, results):
            r.future.set_result(y)
        self._c_completed.inc(len(mb.requests))
        self._emit_spans(mb, admission, marks, t_exec_done, now_ns())
        self._mark_done(len(mb.requests))

    def _emit_spans(self, mb: MicroBatch, admission, marks: Dict,
                    t_exec_done: int, t_fin_done: int) -> None:
        """Turn one batch's phase boundaries into per-request spans.

        Every request in the batch shares the batch's phase timestamps
        (they rode the same dispatch); the queue span is per-request
        (submit time differs)."""
        tr = self.tracer
        if not tr.enabled:
            return
        worker = threading.current_thread().name
        t_batch = marks["batch"]
        t_sched = marks.get("sched")
        t_exec = marks.get("exec", t_batch)
        cyc0 = admission.start_cycle if admission is not None else None
        cyc1 = admission.finish_cycle if admission is not None else None
        key_s = str(mb.key)
        banks = list(admission.banks) if admission is not None else None
        for r in mb.requests:
            ctx = r.trace
            if ctx is None or not ctx.sampled:
                continue
            tr.span(ctx, "queue", ctx.t_submit_ns, t_batch, track=worker,
                    key=key_s, batch=mb.size)
            if t_sched is not None:
                tr.span(ctx, "schedule", t_sched, t_exec, track=worker,
                        cycle_start=cyc0, cycle_end=cyc1, bank=banks)
            tr.span(ctx, "execute", t_exec, t_exec_done, track=worker,
                    cycle_start=cyc0, cycle_end=cyc1)
            tr.span(ctx, "finalize", t_exec_done, t_fin_done, track=worker)

    @property
    def completed(self) -> int:
        return int(self._c_completed.value())

    @property
    def failed(self) -> int:
        return int(self._c_failed.value())

    @property
    def requeues(self) -> int:
        return int(self._c_requeues.value())

    # -------------------------------------------------------------- metrics
    def metrics(self) -> Dict:
        with self._mlock:     # consistent snapshot vs the live worker
            lats = sorted(self._latencies)
            buckets = {str(k): r.stats() for k, r in self._runners.items()}
            straggler = self.straggler.snapshot()

        def pct(p):
            if not lats:
                return 0.0
            return lats[min(len(lats) - 1, int(p / 100 * len(lats)))]

        # continuous LM engines (kind="callable" with engine_metrics):
        # tokens/s, slot occupancy and the capture counters, per key
        engines = {}
        for k in self.registry.keys():
            fn = getattr(self.registry.entry(k), "fn", None)
            if fn is not None and hasattr(fn, "engine_metrics"):
                engines[str(k)] = fn.engine_metrics()

        return {
            "completed": self.completed,
            "failed": self.failed,
            "requeues": self.requeues,
            "queue_depth": self.batcher.depth,
            "peak_queue_depth": self.batcher.peak_depth,
            "batches": self.batcher.batches,
            "latency_p50_ms": round(pct(50) * 1e3, 3),
            "latency_p99_ms": round(pct(99) * 1e3, 3),
            "tokens_per_s": (round(sum(
                e["tokens_per_s"] for e in engines.values()), 1)
                if engines else None),
            "slot_occupancy": (round(sum(
                e["slot_occupancy"] for e in engines.values())
                / len(engines), 4) if engines else None),
            "engines": engines or None,
            "bucket_caches": buckets,
            "banks": {
                "n_banks": self.n_banks,
                "placement": self.placement,
                "replica_cache": (self._replicas.stats()
                                  if self._replicas is not None else None),
            },
            "scheduler": self.scheduler.metrics(),
            "straggler": straggler,
            "registry": self.registry.stats(),
            "artifact_store": (self.registry.store.stats()
                               if self.registry.store is not None else None),
        }

    def registries(self) -> List[MetricsRegistry]:
        """Every metrics registry this service can see, deduped — the
        exporter set for ``/metrics``."""
        regs = [self.metrics_registry]
        for obj in (self.batcher, self.scheduler, self.registry):
            r = getattr(obj, "metrics_registry", None)
            if r is not None and all(r is not x for x in regs):
                regs.append(r)
        for k in self.registry.keys():
            fn = getattr(self.registry.entry(k), "fn", None)
            r = getattr(fn, "metrics_registry", None)
            if r is not None and all(r is not x for x in regs):
                regs.append(r)
        with self._mlock:
            runners = list(self._runners.values())
        for rn in runners:
            r = getattr(rn, "metrics_registry", None)
            if r is not None and all(r is not x for x in regs):
                regs.append(r)
        return regs
