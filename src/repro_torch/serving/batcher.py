"""Request queue + dynamic micro-batcher.

Requests arrive one example at a time (``submit``) and leave as
micro-batches grouped by :class:`~repro_torch.serving.registry.ModelKey`. The
batcher holds a per-variant FIFO and a global depth bound:

* **grouping** — ``next_batch`` picks the variant whose head request has
  waited longest (oldest-first across variants, FIFO within one), so no
  precision starves under a mixed load;
* **batching window** — if the chosen variant has fewer than ``max_batch``
  requests queued and its head is younger than ``max_wait_s``, the batcher
  waits out the remainder of the window for stragglers to coalesce;
* **backpressure** — beyond ``max_queue`` outstanding requests, ``put``
  blocks (or raises :class:`QueueFull` with ``block=False``), bounding
  memory under overload.

Padding to power-of-two buckets happens downstream (the executor's
bucketed runner, :func:`repro_torch.compiler.executor.make_bucketed_runner`) —
the batcher only bounds batch sizes; it never pads.

The port's copy of ``repro/serving/batcher.py`` (pure Python).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import Future
from typing import Deque, Dict, List, Optional

import collections

from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.serving.registry import ModelKey

__all__ = ["Request", "MicroBatch", "DynamicBatcher", "QueueFull"]


class QueueFull(RuntimeError):
    """Raised by non-blocking ``put`` when the queue is at ``max_queue``."""


@dataclasses.dataclass
class Request:
    """One queued inference request.

    ``payload``: a single example (no batch axis) for Program variants, or
    an arbitrary engine-specific object for callable variants.
    ``trace`` carries the request's
    :class:`~repro_torch.obs.tracing.TraceContext` through the spine; ``retries``
    counts bank-failure requeues (see ``InferenceService._run_batch``).
    """

    key: ModelKey
    payload: object
    future: Future = dataclasses.field(default_factory=Future)
    t_submit: float = dataclasses.field(default_factory=time.perf_counter)
    trace: object = None
    retries: int = 0


@dataclasses.dataclass
class MicroBatch:
    key: ModelKey
    requests: List[Request]

    @property
    def size(self) -> int:
        return len(self.requests)


class DynamicBatcher:
    """See module docstring.

    ``round_to``: device-count awareness for the bank-mesh serving path —
    when draining a partially-filled queue (coalescing window expired)
    with more than ``round_to`` requests waiting, the take is rounded
    *down* to a multiple of it, so batches split evenly across ``n_banks``
    devices with minimal zero-padding. Heads left behind are already past
    their window and ship in the very next micro-batch. ``round_to=1``
    (default) is the exact pre-mesh behavior.
    """

    def __init__(self, *, max_batch: int = 32, max_wait_s: float = 0.002,
                 max_queue: int = 256, round_to: int = 1,
                 metrics: Optional[MetricsRegistry] = None):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if round_to < 1:
            raise ValueError("round_to must be >= 1")
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self.max_queue = max_queue
        self.round_to = round_to
        self._queues: Dict[ModelKey, Deque[Request]] = {}  # guarded-by: _cv
        self._cv = threading.Condition()
        self._depth = 0                                    # guarded-by: _cv
        self._closed = False                               # guarded-by: _cv
        # registry-backed counters (every write happens under self._cv, so
        # the totals stay exact despite the registry's lock-free writes)
        self.metrics_registry = (metrics if metrics is not None
                                 else MetricsRegistry())
        m = self.metrics_registry
        self._c_enqueued = m.counter("batcher_enqueued_total",
                                     "requests accepted into the queue")
        self._c_batches = m.counter("batcher_batches_total",
                                    "micro-batches formed")
        self._g_peak = m.gauge("batcher_peak_depth",
                               "queue depth high-water mark")
        self._g_depth = m.gauge("batcher_depth", "current queue depth")

    @property
    def depth(self) -> int:
        """Requests currently queued (not yet handed to a worker)."""
        return self._depth

    # legacy attribute surface, now registry-backed
    @property
    def enqueued(self) -> int:
        return int(self._c_enqueued.value())

    @property
    def batches(self) -> int:
        return int(self._c_batches.value())

    @property
    def peak_depth(self) -> int:
        return int(self._g_peak.value())

    # ------------------------------------------------------------- producer
    def put(self, req: Request, *, block: bool = True,
            timeout: Optional[float] = None) -> None:
        with self._cv:
            if self._closed:
                raise RuntimeError("batcher is closed")
            if self._depth >= self.max_queue:
                if not block:
                    raise QueueFull(
                        f"queue at max_queue={self.max_queue}")
                deadline = None if timeout is None else (
                    time.perf_counter() + timeout)
                while self._depth >= self.max_queue:
                    remaining = None if deadline is None else (
                        deadline - time.perf_counter())
                    if remaining is not None and remaining <= 0:
                        raise QueueFull(
                            f"queue still full after {timeout}s")
                    self._cv.wait(remaining)
                    if self._closed:  # closed while we waited for space
                        raise RuntimeError("batcher is closed")
            self._queues.setdefault(req.key, collections.deque()).append(req)
            self._depth += 1
            self._c_enqueued.inc()
            self._g_peak.set_max(self._depth)
            self._g_depth.set(self._depth)
            self._cv.notify_all()

    # ------------------------------------------------------------- consumer
    def _oldest_key(self, *, max_batch_for) -> Optional[ModelKey]:
        live = [(q[0].t_submit, k) for k, q in self._queues.items() if q]
        if not live:
            return None
        return min(live)[1]

    def next_batch(self, *, timeout: Optional[float] = None,
                   max_batch_for=None) -> Optional[MicroBatch]:
        """Dequeue one micro-batch, or ``None`` on timeout.

        ``max_batch_for``: optional ``key -> int`` override of the global
        ``max_batch`` (per-variant caps, e.g. an LM engine's slot count).
        """
        deadline = None if timeout is None else time.perf_counter() + timeout
        with self._cv:
            while True:
                key = self._oldest_key(max_batch_for=max_batch_for)
                if key is not None:
                    q = self._queues[key]
                    cap = self.max_batch
                    if max_batch_for is not None:
                        cap = min(cap, max_batch_for(key) or cap)
                    window_end = q[0].t_submit + self.max_wait_s
                    now = time.perf_counter()
                    if len(q) >= cap or now >= window_end:
                        take = min(len(q), cap)
                        if take > self.round_to:
                            take -= take % self.round_to
                        reqs = [q.popleft() for _ in range(take)]
                        self._depth -= take
                        self._c_batches.inc()
                        self._g_depth.set(self._depth)
                        self._cv.notify_all()
                        return MicroBatch(key, reqs)
                    wait = window_end - now
                    if deadline is not None:  # caller's timeout still binds
                        wait = min(wait, deadline - now)
                        if wait <= 0:
                            return None
                else:
                    if deadline is None:
                        wait = None
                    else:
                        wait = deadline - time.perf_counter()
                        if wait <= 0:
                            return None
                self._cv.wait(wait)

    def close(self) -> None:
        """Reject further ``put``s (raises RuntimeError, including for
        producers currently blocked on a full queue) — call before
        ``flush_pending`` so shutdown cannot race a late enqueue."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    def reopen(self) -> None:
        with self._cv:
            self._closed = False

    def flush_pending(self, exc: BaseException) -> int:
        """Fail every queued request (service shutdown); returns count."""
        n = 0
        with self._cv:
            for q in self._queues.values():
                while q:
                    q.popleft().future.set_exception(exc)
                    n += 1
            self._depth = 0
            self._g_depth.set(0)
            self._cv.notify_all()
        return n
