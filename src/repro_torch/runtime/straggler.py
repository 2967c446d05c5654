"""Straggler detection & mitigation.

A slow host stalls every synchronous collective, so the framework keeps a
per-step wall-time ring buffer, flags steps beyond ``k`` MADs of the rolling
median, and drives mitigation hooks:

* ``rebalance`` — shrink the flagged host's microbatch share (the paper's
  Distributed-mode analogue: re-split a layer's regions unevenly),
* ``checkpoint_and_exclude`` — at persistent degradation, snapshot and
  restart without the sick host (elastic restart path).

The port's copy of ``repro/runtime/straggler.py``: the continuous LM
engine (:mod:`repro_torch.serving.lm_engine`) observes every arena decode
step with it.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Deque, List, Optional

import numpy as np

__all__ = ["StragglerDetector", "StepTimer"]


@dataclasses.dataclass
class StragglerEvent:
    step: int
    duration: float
    median: float
    severity: float  # duration / median


class StragglerDetector:
    def __init__(self, window: int = 50, mad_threshold: float = 3.0,
                 persistent_n: int = 5):
        self.window = window
        self.mad_threshold = mad_threshold
        self.persistent_n = persistent_n
        self.times: Deque[float] = collections.deque(maxlen=window)
        self.events: List[StragglerEvent] = []
        self.observed = 0          # total samples fed (window is bounded)
        self._consecutive = 0
        self.on_rebalance: Optional[Callable[[StragglerEvent], None]] = None
        self.on_exclude: Optional[Callable[[StragglerEvent], None]] = None

    def observe(self, step: int, duration: float) -> Optional[StragglerEvent]:
        """Feed one step duration; returns an event if flagged."""
        self.observed += 1
        if len(self.times) >= 8:
            arr = np.asarray(self.times)
            med = float(np.median(arr))
            mad = float(np.median(np.abs(arr - med))) + 1e-9
            if duration > med + self.mad_threshold * 1.4826 * mad \
                    and duration > 1.05 * med:
                ev = StragglerEvent(step, duration, med, duration / med)
                self.events.append(ev)
                self._consecutive += 1
                if self._consecutive >= self.persistent_n:
                    if self.on_exclude is not None:
                        self.on_exclude(ev)
                    self._consecutive = 0
                elif self.on_rebalance is not None:
                    self.on_rebalance(ev)
                # NOTE: flagged samples stay out of the baseline window
                return ev
        self._consecutive = 0
        self.times.append(duration)
        return None

    def snapshot(self) -> dict:
        """Metrics view of the detector (serving/training dashboards):
        baseline window state + the flagged-anomaly history."""
        med = float(np.median(np.asarray(self.times))) if self.times else 0.0
        last = self.events[-1] if self.events else None
        return {
            "observed": self.observed,
            "median_s": round(med, 6),
            "events": len(self.events),
            "consecutive": self._consecutive,
            "last_event": None if last is None else {
                "step": last.step,
                "duration_s": round(last.duration, 6),
                "severity": round(last.severity, 3),
            },
        }


class StepTimer:
    """Context-manager step timer feeding the detector."""

    def __init__(self, detector: StragglerDetector, step: int):
        self.detector = detector
        self.step = step

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.detector.observe(self.step, time.perf_counter() - self.t0)
        return False
