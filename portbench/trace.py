"""The device trace of a bounded slice of a run: what ran on the card,
when, and for how long, read from ``torch.profiler``'s CUDA activity
(CUPTI), kernels inside replayed CUDA graphs included.

Only device activity is recorded, and the events are read straight from
the profiler's results without building its per-op tables. A run ends
the recording inside its window and reads the events after it: a slice
of a million kernels (a few hundred replays of a 2,600-kernel decode
step) takes a minute or more to read.
"""

from __future__ import annotations

import re
import time
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["DeviceTrace", "Slice", "union_seconds"]


def union_seconds(intervals: Sequence[Tuple[int, int]]) -> float:
    """Seconds covered by the union of ``(start_ns, end_ns)`` intervals."""
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e9


class Slice:
    """The device events of one traced slice: ``events`` as ``(name,
    start_ns, duration_ns)`` sorted by start, ``window_s`` the slice's
    length on the host clock, and whatever the system noted about the
    work inside it (``work``)."""

    def __init__(self, events: List[Tuple[str, int, int]], window_s: float,
                 work: Optional[Dict] = None):
        self.events = sorted(events, key=lambda e: e[1])
        self.window_s = window_s
        self.work = dict(work or {})
        #: False where the slice holds fewer launches of a kernel than its
        #: work implies (the profiler dropped records); None if unchecked
        self.complete: Optional[bool] = None

    def check_launches(self, want: Dict[str, int]) -> str:
        """Set :attr:`complete` from the launches the work implies,
        ``{name pattern: count}``; returns a line that says so."""
        got = {p: self.kernels(p)[0] for p in want}
        self.complete = got == want
        return ("traced slice " + ("complete" if self.complete
                                   else "incomplete") + ": "
                + ", ".join(f"{p} {got[p]} of {n}" for p, n in want.items()))

    @property
    def busy_s(self) -> float:
        return union_seconds([(s, s + d) for _, s, d in self.events])

    def kernels(self, pattern: str) -> Tuple[int, float]:
        """(count, seconds) of the events whose name matches ``pattern``."""
        rx = re.compile(pattern)
        hits = [d for n, _, d in self.events if rx.search(n)]
        return len(hits), sum(hits) / 1e9

    def breakdown(self, top: int = 10) -> Dict:
        """The device operations that took most time, and the longest
        idle gaps between device operations, each named by the
        operations on either side."""
        by_name: Dict[str, float] = {}
        for n, _, d in self.events:
            by_name[n] = by_name.get(n, 0.0) + d / 1e9
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = []
        end, prev = None, None
        for n, s, d in self.events:
            if end is not None and s > end:
                gaps.append((s - end, prev, n))
            if end is None or s + d > end:
                end, prev = s + d, n
        gaps.sort(key=lambda g: -g[0])
        return {"device_ops": [[_short(n), v] for n, v in ops],
                "idle_gaps": [[f"after {_short(a, 60)} before "
                               f"{_short(b, 60)}", g / 1e9]
                              for g, a, b in gaps[:top]]}


def _short(name: str, n: int = 120) -> str:
    return name if len(name) <= n else name[:n - 3] + "..."


class DeviceTrace:
    """Start and stop the profiler around a slice; on a host with no card
    it records nothing and :meth:`slice` returns None.

    :meth:`stop` only ends the recording, so a run can call it inside its
    window; :meth:`slice` reads the events, which for a slice of a million
    kernels takes a minute, and belongs after the window."""

    def __init__(self, device):
        import torch
        self._torch = torch
        self.enabled = device.type == "cuda"
        self._prof = None
        self._t0 = None
        self._stopped = None

    def prepare(self) -> None:
        """Start and stop the profiler once, in set-up: its first start
        loads CUPTI and takes seconds, which the window must not pay."""
        self.start()
        self.stop()
        self.slice()

    def start(self) -> None:
        if not self.enabled:
            return
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.start()
        self._t0 = time.perf_counter()

    @property
    def recording(self) -> bool:
        return self._prof is not None

    def stop(self, work: Optional[Dict] = None) -> None:
        """End the recording: the slice's length is from :meth:`start` to
        now, once the card has finished what was queued."""
        if self._prof is None:
            return
        import torch.autograd.profiler as autograd_profiler
        self._torch.cuda.synchronize()
        window = time.perf_counter() - self._t0
        self._stopped = (autograd_profiler._disable_profiler(), window,
                         work)
        self._prof = None

    def slice(self) -> Optional[Slice]:
        """The events of the slice :meth:`stop` ended (None if none)."""
        if self._stopped is None:
            return None
        results, window, work = self._stopped
        self._stopped = None
        cuda = self._torch.autograd.DeviceType.CUDA
        events = [(e.name(), int(e.start_ns()), int(e.duration_ns()))
                  for e in results.events() if e.device_type() == cuda]
        return Slice(events, window, work)
