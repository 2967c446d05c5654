"""Request-scoped tracing: spans through the serving spine in two clock
domains.

The port's copy of ``repro/obs/tracing.py`` (pure Python, no torch).

A *trace* is one request's life: ``submit`` → queue wait in the
``DynamicBatcher`` → ``SlotScheduler`` booking → ``BucketedRunner`` /
``ContinuousLMEngine`` execute → finalize. Each phase is one
:class:`Span`. Spans carry **two clock domains**:

* **wall** — ``time.perf_counter_ns()`` stamps, the thread-level truth of
  where time went in the Python serving stack;
* **virtual cycles** — the barrel controller's simulated MVU clock, taken
  from the scheduler booking (``cycle_start``/``cycle_end`` on the bank's
  virtual timeline). Wall and cycle domains are *not* mutually convertible
  (the simulator's clock advances only when work is booked), so the
  exporter renders them as separate process tracks.

Span storage is a bounded ring (``collections.deque(maxlen=...)``): a soak
can run for hours without the tracer becoming the memory leak it is meant
to find. Sampling is decided once per trace at ``start_trace`` time
(deterministic every-Nth, so a sampled request keeps *all* of its spans —
per-phase sampling would tear traces apart); unsampled traces cost one
counter increment and no allocations.

The hot-loop discipline: callers capture raw timestamps inline (an
attribute read + ``perf_counter_ns``) and emit finished spans with explicit
``t0``/``t1`` via :meth:`Tracer.span` — no context managers or callbacks on
the decode step's critical path.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Dict, List, Optional

__all__ = ["Span", "TraceContext", "Tracer"]

now_ns = time.perf_counter_ns


class Span:
    """One finished phase of one trace. Plain attributes, no dataclass —
    these are allocated per phase per sampled request."""

    __slots__ = ("trace_id", "name", "t0_ns", "t1_ns", "cycle_start",
                 "cycle_end", "track", "args")

    def __init__(self, trace_id: int, name: str, t0_ns: int, t1_ns: int, *,
                 cycle_start: Optional[int] = None,
                 cycle_end: Optional[int] = None,
                 track: Optional[str] = None,
                 args: Optional[Dict] = None):
        self.trace_id = trace_id
        self.name = name
        self.t0_ns = t0_ns
        self.t1_ns = t1_ns
        self.cycle_start = cycle_start
        self.cycle_end = cycle_end
        self.track = track            # e.g. "bank0" for cycle-domain rows
        self.args = args or {}

    @property
    def wall_us(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1000.0

    @property
    def cycles(self) -> Optional[int]:
        if self.cycle_start is None or self.cycle_end is None:
            return None
        return self.cycle_end - self.cycle_start

    def to_dict(self) -> Dict:
        d = {"trace_id": self.trace_id, "name": self.name,
             "t0_ns": self.t0_ns, "t1_ns": self.t1_ns}
        if self.cycle_start is not None:
            d["cycle_start"] = self.cycle_start
            d["cycle_end"] = self.cycle_end
        if self.track:
            d["track"] = self.track
        if self.args:
            d["args"] = self.args
        return d


class TraceContext:
    """Per-request handle threaded through the spine (rides on
    ``Request.trace``). Carries the id, the sampling decision, and the
    submit timestamp so later phases can compute queue wait without a
    side-channel."""

    __slots__ = ("trace_id", "sampled", "t_submit_ns", "tracer")

    def __init__(self, trace_id: int, sampled: bool, t_submit_ns: int,
                 tracer: "Tracer"):
        self.trace_id = trace_id
        self.sampled = sampled
        self.t_submit_ns = t_submit_ns
        self.tracer = tracer


class Tracer:
    """Bounded, sampled span sink.

    * ``sample_every=1`` traces everything (tests, short demos);
      ``sample_every=N`` keeps every Nth request, whole;
    * ``capacity`` bounds the ring — old spans fall off, traces degrade
      gracefully rather than the process growing without bound;
    * ``enabled=False`` makes ``start_trace`` return the shared NULL
      context and every emit a single early return.
    """

    def __init__(self, *, capacity: int = 65536, sample_every: int = 1,
                 enabled: bool = True):
        if sample_every < 1:
            raise ValueError("sample_every must be >= 1")
        self.enabled = enabled
        self.sample_every = sample_every
        self._spans: deque = deque(maxlen=capacity)
        self._ids = itertools.count(1)
        self._lock = threading.Lock()
        self.started = 0          # traces begun (sampled or not)
        self.sampled = 0          # traces actually recorded
        self.dropped_spans = 0    # emits on unsampled/disabled traces
        # NULL context: shared, unsampled, id 0 — handed out when disabled
        self._null = TraceContext(0, False, 0, self)

    # ----------------------------------------------------------- lifecycle
    def start_trace(self, *, t_ns: Optional[int] = None) -> TraceContext:
        if not self.enabled:
            return self._null
        n = next(self._ids)
        self.started += 1
        sampled = (n % self.sample_every) == 0 if self.sample_every > 1 \
            else True
        if sampled:
            self.sampled += 1
        return TraceContext(n, sampled, t_ns if t_ns is not None
                            else now_ns(), self)

    def span(self, ctx: Optional[TraceContext], name: str, t0_ns: int,
             t1_ns: int, *, cycle_start: Optional[int] = None,
             cycle_end: Optional[int] = None, track: Optional[str] = None,
             **args) -> None:
        """Emit one finished span with explicitly captured timestamps."""
        if ctx is None or not (self.enabled and ctx.sampled):
            self.dropped_spans += 1
            return
        self._spans.append(Span(ctx.trace_id, name, t0_ns, t1_ns,
                                cycle_start=cycle_start,
                                cycle_end=cycle_end, track=track,
                                args=args or None))

    def cycle_span(self, name: str, cycle_start: int, cycle_end: int, *,
                   track: str, trace_id: int = 0, **args) -> None:
        """Cycle-domain-only span (hart/bank occupancy rows). Wall stamps
        are recorded as the emit instant so the span still sorts stably."""
        if not self.enabled:
            self.dropped_spans += 1
            return
        t = now_ns()
        self._spans.append(Span(trace_id, name, t, t,
                                cycle_start=cycle_start,
                                cycle_end=cycle_end, track=track,
                                args=args or None))

    # ------------------------------------------------------------- reading
    def spans(self, trace_id: Optional[int] = None) -> List[Span]:
        with self._lock:
            out = list(self._spans)
        if trace_id is not None:
            out = [s for s in out if s.trace_id == trace_id]
        return out

    def traces(self) -> Dict[int, List[Span]]:
        """{trace_id: [spans]} for request-scoped traces (id > 0)."""
        out: Dict[int, List[Span]] = {}
        for s in self.spans():
            if s.trace_id > 0:
                out.setdefault(s.trace_id, []).append(s)
        return out

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()

    def stats(self) -> Dict:
        return {"started": self.started, "sampled": self.sampled,
                "dropped_spans": self.dropped_spans,
                "buffered": len(self._spans),
                "capacity": self._spans.maxlen,
                "sample_every": self.sample_every,
                "enabled": self.enabled}
