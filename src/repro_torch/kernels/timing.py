"""Device time of one kernel call on the card, from CUDA events.

Used by ``chip_smoke.py``; needs a CUDA device.
"""

from __future__ import annotations

import statistics
import time

import torch

__all__ = ["Timer"]


class Timer:
    """Median device time of one call from CUDA events around each launch,
    with L2 flushed (a 256 MB write) before every launch, outside the events.

    All repetitions are enqueued behind a ``torch.cuda._sleep`` long enough
    for the host to run ahead of the device, so the events never count the
    device waiting for the host to enqueue the next call (which, for calls
    of a few µs, a slow host otherwise adds)."""

    CYCLES_PER_S = 2.0e9   # at least the H100's SM clock (1.98 GHz boost)

    def __init__(self, device):
        self.flush = torch.empty(64 * 1024 * 1024, dtype=torch.int32,
                                 device=device)

    def __call__(self, fn, reps):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        self.flush.zero_()
        fn()
        host_s = time.perf_counter() - t0   # the host's enqueue of one rep
        torch.cuda.synchronize()
        sleep_s = min(1.0, 2 * reps * host_s + 1e-3)
        torch.cuda._sleep(int(sleep_s * self.CYCLES_PER_S))
        events = []
        for _ in range(reps):
            self.flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            events.append((s, e))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in events)
