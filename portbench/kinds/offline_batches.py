"""``offline_batches``: bulk classification, batch after batch, as fast as
the system takes them.

Parameters (``portbench/traffic/<mix>.json``):

* ``batch`` — images a batch;
* ``in_flight`` — batches dispatched ahead of the oldest one's host copy
  of its outputs;
* ``distinct_batches`` — seeded batches made before the window and fed
  in turn;
* ``check_batches`` — how many of the batches the window finished the
  check compares, drawn from the seed;
* ``trace_slice_s`` — with ``--trace 1``, the seconds the profiler
  records from the window's middle.

A batch counts when its outputs reach the host inside the window.

The system (``portbench/systems/<system>.py``) gives ``offline(run)``,
which builds and warms the program and makes the batches from the seed
(all of it set-up), and ``check(run, kept, offline)``, run after the
window once the program is freed, on the sampled ``(batch index,
outputs)``. ``offline(run)`` returns a callable ``(batch) -> outputs`` on
the device with ``pool`` (the batches, stacked), ``classes`` (outputs a
row) and ``close()``.
"""

from __future__ import annotations

import collections
import time
from typing import Dict, List

import torch

from portbench import seeds
from portbench.trace import DeviceTrace

__all__ = ["check", "run"]


def check(name: str, spec: Dict) -> None:
    for key in ("batch", "in_flight", "distinct_batches", "check_batches"):
        if int(spec[key]) < 1:
            raise ValueError(f"traffic {name}: {key} must be >= 1")
    if float(spec["trace_slice_s"]) <= 0:
        raise ValueError(f"traffic {name}: trace_slice_s must be > 0")


def run(run, system) -> None:
    offline = system.offline(run)
    try:
        tracer = DeviceTrace(run.device) if run.trace else None
        if tracer is not None:
            tracer.prepare()
        run.mark("tracer")
        kept = _window(run, offline, tracer)
        if run.device.type == "cuda":
            run.memory_peak_bytes = int(
                torch.cuda.max_memory_allocated(run.device))
    finally:
        offline.close()
    if tracer is not None:
        run.slice = tracer.slice()
    system.check(run, kept, offline)


def _window(run, offline, tracer) -> List:
    """Dispatch batches for the window; returns the sampled batches'
    ``(batch index, outputs)``."""
    spec = run.traffic
    dev = run.device
    depth = int(spec["in_flight"])
    batch = int(spec["batch"])
    pool = offline.pool
    cuda = dev.type == "cuda"
    host = [torch.empty((batch, offline.classes), dtype=torch.float32,
                        pin_memory=cuda) for _ in range(depth)]
    events = [torch.cuda.Event() if cuda else None for _ in range(depth)]
    k = int(spec["check_batches"])
    pick = seeds.rng(run.seed, "check.sample")
    kept: List = []
    calls: List = []
    slice_s = float(spec["trace_slice_s"])
    t_trace = run.seconds / 2 - slice_s / 2
    traced = None
    inflight = collections.deque()
    done = issued = 0

    def retire() -> None:
        nonlocal done
        i, slot = inflight.popleft()
        if cuda:
            events[slot].synchronize()
        if time.perf_counter() <= run.t1:
            # reservoir sampling of the batches that finished in time
            if len(kept) < k:
                kept.append((i, host[slot].numpy().copy()))
            else:
                j = int(pick.integers(0, done + 1))
                if j < k:
                    kept[j] = (i, host[slot].numpy().copy())
            done += 1

    run.setup_s = time.perf_counter() - run.t_process
    run.t0 = time.perf_counter()
    run.t1 = run.t0 + run.seconds
    with torch.no_grad():
        while True:
            now = time.perf_counter()
            if now >= run.t1:
                break
            if tracer is not None and traced is None \
                    and now - run.t0 >= t_trace:
                tracer.start()
                traced = time.perf_counter()
            elif traced is not None and tracer.recording \
                    and now - traced >= slice_s:
                tracer.stop(work={"batch": batch})
            if len(inflight) == depth:
                retire()
            slot = issued % depth
            t = time.perf_counter()
            out = offline(pool[issued % pool.shape[0]])
            calls.append((t, time.perf_counter()))
            host[slot].copy_(out, non_blocking=cuda)
            if cuda:
                events[slot].record()
            inflight.append((issued, slot))
            issued += 1
        while inflight:
            retire()
    if tracer is not None and tracer.recording:
        tracer.stop(work={"batch": batch})
    run.spans["executor.call"] = calls
    run.counters = {"before": {"images": 0},
                    "after": {"images": done * batch}}
    run.attempted = issued * batch
    return kept
