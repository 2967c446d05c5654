"""Program parallelism: one 8-slot MVU bank per placement, many banks.

Counterpart of ``repro/distributed/program_parallel.py``. The paper's
throughput story is *array scaling*: the same 8-MVU fabric is instantiated
as many times as the FPGA allows, and a bigger part simply carries more
banks (§4, "regardless of the target FPGA size"). The reference makes each
jax device one bank. Here a bank is a :class:`Bank`: a device and, on a
card, a CUDA stream of its own. Banks go round-robin over the visible
cards, so four banks on one H100 are four streams on ``cuda:0`` whose work
the card may overlap; on the CPU every bank is the CPU and the banks run
one after another. Three placements scale a compiled
:class:`~repro_torch.compiler.lower.Program` across banks:

* :class:`ShardedProgram` — data parallel: the batch is split into equal
  shards, each shard runs on its bank's stream, and the outputs are
  concatenated (the paper's *Distributed* mapping);
* banked placement (``banks=`` on
  :class:`repro_torch.compiler.executor.BucketedRunner`) — whole
  micro-batches run on one bank chosen by the
  :class:`~repro_torch.serving.scheduler.SlotScheduler`;
* :class:`PipelinedProgram` — the paper's *Pipelined* mapping: consecutive
  Program steps live on consecutive banks, and microbatch ``m`` enters
  stage ``s`` once stage ``s - 1`` has recorded an event for it on its
  stream (the hop is a wait on that event, not a host sync).

Replication goes through :class:`ReplicaCache`, keyed on the identity of
the source tensor and the target device: the registry's content-addressed
pack cache makes precision variants of one model hold the *same*
``w_packed`` tensors, so each unique plane lands on each device once. A
tensor already on the target device is its own replica: on one card every
bank serves from the same planes and the cache issues no copy.

A bank's output is made on its stream; a caller reads it only after its
own stream waits on the bank's (an event wait, recorded with
``record_stream`` for the caching allocator), which every function here
does before it returns.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import weakref
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.compiler import executor as _executor

__all__ = ["BANK_AXIS", "Bank", "BankMesh", "bank_mesh", "bank_devices",
           "banks_of", "home_devices", "on_bank", "after_caller", "join",
           "ReplicaCache", "replicate_params", "ShardedProgram",
           "PipelinedProgram", "stage_partition"]

BANK_AXIS = "bank"


@dataclasses.dataclass(frozen=True, eq=False)
class Bank:
    """One MVU bank: its index, its device, and on a card its own CUDA
    stream (``None`` on the CPU)."""

    index: int
    device: torch.device
    stream: Optional[torch.cuda.Stream] = None


class BankMesh(tuple):
    """A 1-D tuple of :class:`Bank` records whose ``shape`` is
    ``{"bank": n}``, as the reference's ``Mesh`` over the ``bank`` axis
    reads."""

    axis_names = (BANK_AXIS,)

    @property
    def shape(self) -> Dict[str, int]:
        return {BANK_AXIS: len(self)}


def _visible(device) -> List[torch.device]:
    """Every visible card for ``device=None`` (raises where there is none,
    as :func:`~repro_torch.resolve_device` does), else that device."""
    if device is None:
        resolve_device(None)
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [resolve_device(device)]


def bank_devices(n_banks: Optional[int] = None,
                 devices: Optional[Sequence] = None, *,
                 device=None) -> List[Bank]:
    """``n_banks`` banks (default: one per device), round-robin over
    ``devices`` (default: every visible card, or ``device`` when given —
    ``device="cpu"`` for CPU banks). Each bank on a card gets a stream of
    its own. ``devices`` may hold :class:`Bank` records, which are taken as
    they are. With no card and no ``device="cpu"`` this raises; it never
    carries on on the CPU."""
    devs = list(devices) if devices is not None else _visible(device)
    if not devs:
        raise ValueError("no devices to place banks on")
    n = len(devs) if n_banks is None else n_banks
    if n < 1:
        raise ValueError(f"need at least 1 bank, got n_banks={n}")
    if all(isinstance(d, Bank) for d in devs):
        if n > len(devs):
            raise ValueError(f"n_banks={n} but only {len(devs)} bank(s) "
                             "were given")
        return devs[:n]
    banks = []
    for i in range(n):
        d = resolve_device(devs[i % len(devs)])
        stream = torch.cuda.Stream(d) if d.type == "cuda" else None
        banks.append(Bank(i, d, stream))
    return banks


def bank_mesh(n_banks: Optional[int] = None, *,
              devices: Optional[Sequence] = None, device=None) -> BankMesh:
    """The 1-D ``bank`` axis: a :class:`BankMesh` of :func:`bank_devices`."""
    return BankMesh(bank_devices(n_banks, devices, device=device))


def home_devices(device: torch.device) -> Optional[List[torch.device]]:
    """The ``devices`` banks default to for work on ``device``: every
    visible card (``None``) for the card, else that device itself."""
    return None if device.type == "cuda" else [device]


def on_bank(bank: Bank):
    """The context that makes ``bank``'s stream current (none on the CPU)."""
    if bank.stream is None:
        return contextlib.nullcontext()
    return torch.cuda.stream(bank.stream)


def after_caller(bank: Bank, t: torch.Tensor) -> None:
    """Make ``bank``'s stream wait for the caller's work on ``t`` (a tensor
    the caller's stream made) before the bank reads it."""
    if bank.stream is not None and t.is_cuda:
        bank.stream.wait_stream(torch.cuda.current_stream(t.device))
        t.record_stream(bank.stream)


def join(bank: Bank, t: torch.Tensor) -> torch.Tensor:
    """Make the caller's stream wait for ``bank``'s work on ``t`` before
    anything reads it there; ``t`` is returned."""
    if bank.stream is not None:
        cur = torch.cuda.current_stream(t.device)
        cur.wait_stream(bank.stream)
        t.record_stream(cur)
    return t


# --------------------------------------------------------------------------
# replica cache: each unique weight plane lands on each device once
# --------------------------------------------------------------------------

class ReplicaCache:
    """Identity-keyed dedup of device replicas.

    ``replicate(t, device)`` returns the (cached) copy of ``t`` on
    ``device``. The key is ``(id(t), device)`` with a weakref on the
    source, so:

    * tensors shared between Programs — the registry's content-addressed
      ``w_packed`` planes — replicate once per device and every variant
      serves from the same copies;
    * dropping the last reference to the source evicts the entry (the
      cache never pins freed planes).

    A tensor already on ``device`` is its own replica: it is returned as
    it is and counted under ``shared``/``shared_bytes`` (no copy issued).
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._cache: Dict[tuple, tuple] = {}    # guarded-by: _lock
        self.replicas = 0          # copies actually issued
        self.shared = 0            # replications answered without a copy
        self.shared_bytes = 0      # bytes NOT copied thanks to sharing

    def _hit(self, t: torch.Tensor) -> None:
        self.shared += 1
        self.shared_bytes += t.numel() * t.element_size()

    def replicate(self, t, device):
        device = resolve_device(device)
        if not isinstance(t, torch.Tensor):
            return t
        if t.device == device:
            with self._lock:
                self._hit(t)
            return t
        key = (id(t), device)
        with self._lock:
            hit = self._cache.get(key)
            if hit is not None and hit[0]() is t:
                self._hit(t)
                return hit[1]
        rep = t.to(device)
        ref = weakref.ref(t, lambda _, k=key: self._cache.pop(k, None))
        with self._lock:
            # re-check under the lock: a concurrent replicate of the same
            # plane may have won the race while this one copied — keep its
            # replica so "once per device" and the counters stay truthful
            hit = self._cache.get(key)
            if hit is not None and hit[0]() is t:
                self._hit(t)
                return hit[1]
            self._cache[key] = (ref, rep)
            self.replicas += 1
        return rep

    def stats(self) -> Dict:
        with self._lock:
            return {"entries": len(self._cache), "replicas": self.replicas,
                    "shared": self.shared,
                    "shared_bytes": self.shared_bytes}


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def replicate_params(params, device, *,
                     cache: Optional[ReplicaCache] = None):
    """Every tensor of a Program params tree on ``device``, deduping shared
    leaves through ``cache``."""
    device = resolve_device(device)
    if cache is None:
        return _tree_map(lambda t: t.to(device) if isinstance(
            t, torch.Tensor) else t, params)
    return _tree_map(lambda t: cache.replicate(t, device), params)


def banks_of(mesh) -> List[Bank]:
    """The banks of a bank mesh (anything with a ``bank`` axis in its
    ``shape`` that iterates over :class:`Bank` records)."""
    if BANK_AXIS not in getattr(mesh, "shape", {}):
        raise ValueError(f"mesh has axes {getattr(mesh, 'axis_names', ())}"
                         f", expected a {BANK_AXIS!r} axis — build it with "
                         "bank_mesh()")
    return list(mesh)


# --------------------------------------------------------------------------
# data-parallel: the batch split over the banks
# --------------------------------------------------------------------------

class ShardedProgram:
    """Batch-sharded execution of one compiled Program over a bank mesh.

    The batch is split into ``n_banks`` equal shards; shard ``i`` runs on
    bank ``i``'s stream against that bank's parameter replica, and the
    outputs are concatenated on the caller's stream once it has waited on
    every bank. Every lowered step acts per example, so each shard equals
    the single-bank forward of its rows at the shard's batch. Batches must
    divide by the bank count; the serving path guarantees that with
    buckets that are multiples of it
    (:func:`repro_torch.compiler.executor.bucket_sizes` with ``multiple``).
    The shards run eagerly; :class:`~repro_torch.compiler.executor.
    BucketedRunner` with ``mesh=`` replays one CUDA graph per bank.
    """

    def __init__(self, program, mesh=None, *,
                 replica_cache: Optional[ReplicaCache] = None):
        self.program = program
        self.mesh = (mesh if mesh is not None
                     else bank_mesh(devices=home_devices(program.device)))
        self.banks = banks_of(self.mesh)
        self.n_banks = len(self.banks)
        self.params = [replicate_params(program.params, b.device,
                                        cache=replica_cache)
                       for b in self.banks]
        self._run = _executor.make_runner(program)

    def __call__(self, x) -> torch.Tensor:
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.asarray(x, np.float32))
        if x.shape[0] % self.n_banks != 0:
            raise ValueError(
                f"batch {x.shape[0]} does not divide across "
                f"{self.n_banks} banks — pad to a multiple (the bucketed "
                "runner does this automatically)")
        s = x.shape[0] // self.n_banks
        out_dev = self.banks[0].device
        outs = []
        with torch.no_grad():
            for i, (bank, params) in enumerate(zip(self.banks,
                                                   self.params)):
                shard = x[i * s:(i + 1) * s]
                after_caller(bank, shard)
                with on_bank(bank):
                    y = self._run(params, shard.to(bank.device))
                outs.append(join(bank, y).to(out_dev))
            return torch.cat(outs, dim=0)


# --------------------------------------------------------------------------
# pipeline-parallel: consecutive Program steps on consecutive banks
# --------------------------------------------------------------------------

_HEAVY_KINDS = {"conv_packed", "gemm_packed", "host_conv", "host_gemm"}


def _step_cost(st) -> float:
    return 1.0 if st.kind in _HEAVY_KINDS else 0.01


def stage_partition(program, n_stages: int):
    """Cut a Program's step list into ``n_stages`` contiguous stages.

    A cut position is *valid* when exactly one live tensor crosses it
    (that tensor becomes the bank→bank transfer); residual-block interiors
    — where the skip tensor is live alongside the main path — are
    excluded. Among valid positions, cuts are placed nearest the cost
    quantiles (heavy = packed and host conv/gemm steps) so stages balance.

    Returns ``(bounds, stage_inputs, stage_outputs)``: ``bounds`` is a
    list of ``(start, end)`` step-index ranges; the name lists give each
    stage's boundary tensors.
    """
    steps = program.steps
    if n_stages < 1:
        raise ValueError(f"n_stages must be >= 1, got {n_stages}")
    if n_stages == 1:
        return ([(0, len(steps))], [program.input_name],
                [program.output_name])
    if n_stages > len(steps):
        raise ValueError(f"n_stages={n_stages} exceeds the Program's "
                         f"{len(steps)} steps")
    produced = {program.input_name: -1}
    for i, st in enumerate(steps):
        produced[st.output] = i
    consumed: Dict[str, List[int]] = {}
    for i, st in enumerate(steps):
        for t in st.inputs:
            consumed.setdefault(t, []).append(i)
    # the program output is "consumed" after the last step
    consumed.setdefault(program.output_name, []).append(len(steps))

    cuts: Dict[int, str] = {}
    for p in range(1, len(steps)):
        crossing = {t for t, pi in produced.items()
                    if pi < p and any(c >= p for c in consumed.get(t, []))}
        if len(crossing) == 1:
            cuts[p] = next(iter(crossing))
    if len(cuts) < n_stages - 1:
        raise ValueError(
            f"Program {program.graph_name!r} has only {len(cuts)} valid "
            f"pipeline cut(s) (positions where one tensor is live) but "
            f"n_stages={n_stages} needs {n_stages - 1}")

    costs = [_step_cost(st) for st in steps]
    cum = np.cumsum(costs)
    total = float(cum[-1])
    avail = sorted(cuts)
    chosen: List[int] = []
    prev = 0
    for s in range(1, n_stages):
        still_needed = n_stages - 1 - len(chosen) - 1
        cands = [p for p in avail
                 if p > prev and sum(1 for q in avail if q > p)
                 >= still_needed]
        if not cands:
            raise ValueError(
                f"cannot place cut {s} of {n_stages - 1}: no valid "
                f"position after step {prev} leaves enough later cuts")
        target = total * s / n_stages
        p = min(cands, key=lambda p: (abs(float(cum[p - 1]) - target), p))
        chosen.append(p)
        prev = p
    bounds = [0] + chosen + [len(steps)]
    ranges = [(bounds[i], bounds[i + 1]) for i in range(n_stages)]
    stage_inputs = [program.input_name] + [cuts[p] for p in chosen]
    stage_outputs = [cuts[p] for p in chosen] + [program.output_name]
    return ranges, stage_inputs, stage_outputs


class PipelinedProgram:
    """GPipe-style wavefront over a Program's own step list.

    Stage ``s`` (a contiguous slice of steps, balanced by cost) lives on
    bank ``s``. Microbatch ``m`` enters stage ``s`` once stage ``s - 1``
    has recorded an event for it on its stream: the hop (the paper's
    §3.1.6 MVU→MVU crossbar write) is a wait on that event, so stage ``s``
    of microbatch ``m`` may overlap stage ``s - 1`` of microbatch
    ``m + 1`` on the card. Stages run eagerly.

    Stages partition the step list and every tensor crosses exactly one
    boundary, so each microbatch's output equals the single-bank Program
    on its rows.
    """

    def __init__(self, program, mesh=None, *,
                 n_stages: Optional[int] = None,
                 n_microbatches: Optional[int] = None,
                 devices: Optional[Sequence] = None,
                 replica_cache: Optional[ReplicaCache] = None):
        if mesh is not None:
            devices = banks_of(mesh)
        elif devices is None:
            devices = home_devices(program.device)
        banks = bank_devices(n_stages, devices)
        self.program = program
        self.banks = banks
        self.n_stages = len(banks)
        self.n_microbatches = n_microbatches
        bounds, ins, outs = stage_partition(program, self.n_stages)
        self.stage_bounds: List[Tuple[int, int]] = bounds
        self._fns = []
        self._params = []
        for s, (a, b) in enumerate(bounds):
            stage_steps = program.steps[a:b]
            self._fns.append(_executor.make_runner(
                program, steps=stage_steps, input_name=ins[s],
                output_name=outs[s]))
            sub = {st.name: program.params[st.name] for st in stage_steps
                   if st.name in program.params}
            self._params.append(replicate_params(sub, banks[s].device,
                                                 cache=replica_cache))

    def __call__(self, x, *, n_microbatches: Optional[int] = None
                 ) -> torch.Tensor:
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.asarray(x, np.float32))
        n = x.shape[0]
        nm = n_microbatches or self.n_microbatches or min(self.n_stages, n)
        if nm < 1 or n % nm != 0:
            raise ValueError(
                f"batch {n} is not divisible into n_microbatches={nm} "
                f"({self.n_stages} stages) — pad the batch or pick a "
                "dividing microbatch count")
        mb = n // nm
        last = self.banks[-1]
        outs = []
        with torch.no_grad():
            for m in range(nm):
                h = x[m * mb:(m + 1) * mb]
                after_caller(self.banks[0], h)
                done = None            # stage s-1's event for microbatch m
                for s, bank in enumerate(self.banks):
                    with on_bank(bank):
                        if done is not None:
                            bank.stream.wait_event(done)
                            if h.device != bank.device:
                                # a hop to another card copies on the
                                # source card's current stream
                                src = torch.cuda.current_stream(h.device)
                                src.wait_event(done)
                                h.record_stream(src)
                            else:
                                h.record_stream(bank.stream)
                        h = self._fns[s](self._params[s], h.to(bank.device))
                        if bank.stream is not None:
                            done = torch.cuda.Event()
                            done.record(bank.stream)
                outs.append(h)
            with on_bank(last):
                y = torch.cat(outs, dim=0)
            return join(last, y)
