"""Program executor: runs a lowered :class:`~repro_torch.compiler.lower.Program`
on batched inputs.

Counterpart of ``repro/compiler/executor.py``. Each step kind maps to one
dispatch function. The packed steps go through :mod:`repro_torch.kernels.ops`,
which picks the CUDA kernel or its plain version by the tensor's device, so
one Program runs on the card or on the CPU unchanged. ``conv_packed`` steps
run K2 and ``gemm_packed`` steps K3. A step that carries a ``tile`` (the
compiler tuned it at the calibration batch) launches the tuner's choice
for the shape it actually runs at (:mod:`repro_torch.kernels.tuning`,
memoized: at a padding bucket the eager pass before the capture decides
it, and the graph replays it); a step without one, such as a step of a
store the reference wrote, launches the kernel's own heuristic.

PyTorch runs eagerly; the counterpart of the reference's jitted executable
per padding bucket is :class:`BucketedRunner`'s CUDA graph per bucket,
captured once on the card and replayed for every later batch of that
bucket.

:func:`make_plain_runner` runs the packed steps through the kernels' plain
versions whatever the device — the yardstick the card's kernels are held
against, never a fallback of :func:`make_runner`.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Set

import numpy as np
import torch

from repro_torch.core.pipeline_modules import host_conv2d, maxpool_relu
from repro_torch.core.quant import QuantSpec, quantize_int
from repro_torch.kernels import ops, tuning
from repro_torch.kernels.bitserial_conv import bitserial_conv2d_ref
from repro_torch.kernels.quantize_pack import pack_codes_ref, quantize_pack_ref
from repro_torch.obs.metrics import MetricsRegistry

__all__ = ["make_runner", "make_plain_runner", "make_step_runner",
           "bucket_sizes", "bucket_for", "BucketedRunner",
           "make_bucketed_runner"]


def _requant_spec(attrs) -> Optional[QuantSpec]:
    if attrs.get("out") in ("packed", "codes", "requant_codes"):
        return QuantSpec(attrs["requant_bits"], attrs["requant_signed"])
    return None


def _tile(st):
    """None (the tuner, for the call's own shape) for a tuned step, the
    kernel's heuristic for a step with no tile."""
    return None if "tile" in st.attrs else tuning.HEURISTIC


def _conv_packed(st, p, x, conv=ops.serial_conv2d_packed_op):
    return conv(
        x, p["w_packed"], p["scale"], p.get("bias"),
        spec=st.attrs["spec"], ci=st.attrs["ci"], stride=st.attrs["stride"],
        padding=st.attrs["padding"], relu=st.attrs["relu"],
        requant=_requant_spec(st.attrs),
        requant_scale=p.get("requant_scale"),
        emit_packed=st.attrs["out"] == "packed", tile=_tile(st))


def _gemm_packed(st, p, x, plain=False):
    return ops.serial_matmul_packed_op(
        x, p["w_packed"], p["scale"], p.get("bias"),
        spec=st.attrs["spec"], k=st.attrs["k"], relu=st.attrs["relu"],
        requant=_requant_spec(st.attrs),
        requant_scale=p.get("requant_scale"),
        emit_packed=st.attrs["out"] == "packed", plain=plain,
        tile=_tile(st))


def _affine(st, p, y):
    if "scale" in p:
        y = y * p["scale"]
    if "bias" in p:
        y = y + p["bias"]
    return torch.clamp_min(y, 0) if st.attrs["relu"] else y


def _host_conv(st, p, x):
    return _affine(st, p, host_conv2d(x, p["w"], st.attrs["stride"],
                                      st.attrs["padding"]))


def _host_gemm(st, p, x):
    return _affine(st, p, x @ p["w"].to(x.dtype))


def _quantize_pack(st, p, x):
    spec = QuantSpec(st.attrs["bits"], st.attrs["signed"])
    return ops.quantize_pack_activations(x, p["act_alpha"], spec)


def _quantize_pack_plain(st, p, x):
    spec = QuantSpec(st.attrs["bits"], st.attrs["signed"])
    return ops.over_rows(lambda r: quantize_pack_ref(r, p["act_alpha"], spec),
                         x, spec.bits)


def _pack_codes(st, p, x):
    return ops.pack_activations(x.to(torch.int32), st.attrs["bits"])


def _pack_codes_plain(st, p, x):
    bits = st.attrs["bits"]
    return ops.over_rows(lambda r: pack_codes_ref(r, bits), x.to(torch.int32),
                         bits)


def _maxpool(st, p, x):
    # integer codes pool as int32 (max commutes with the monotone
    # quantizer, so pooling codes == pooling floats then quantizing)
    if not torch.is_floating_point(x):
        x = x.to(torch.int32)
    return maxpool_relu(x, st.attrs["window"], st.attrs["stride"],
                        with_relu=False)


_APPLY: Dict[str, Callable] = {
    "conv_packed": _conv_packed,
    "gemm_packed": _gemm_packed,
    "host_conv": _host_conv,
    "host_gemm": _host_gemm,
    "quantize_pack": _quantize_pack,
    "pack_codes": _pack_codes,
    "maxpool": _maxpool,
    "global_pool": lambda st, p, x: torch.mean(x, dim=(1, 2)),
    "flatten": lambda st, p, x: x.reshape(x.shape[0], -1),
    "relu": lambda st, p, x: torch.clamp_min(x, 0),
    "add": lambda st, p, a, b: a + b,
    "dequant": lambda st, p, x: x.to(torch.float32) * p["alpha"],
    "fake_quant": lambda st, p, x: quantize_int(
        x, p["scale"], QuantSpec(st.attrs["bits"], st.attrs["signed"])
    ).to(torch.float32) * p["scale"],
}

#: the packed steps through the kernels' plain versions, on any device
_PLAIN: Dict[str, Callable] = dict(
    _APPLY,
    conv_packed=lambda st, p, x: _conv_packed(st, p, x,
                                              conv=bitserial_conv2d_ref),
    gemm_packed=lambda st, p, x: _gemm_packed(st, p, x, plain=True),
    quantize_pack=_quantize_pack_plain,
    pack_codes=_pack_codes_plain,
)


def _runner(program, table, steps=None, input_name=None, output_name=None):
    steps = program.steps if steps is None else tuple(steps)
    input_name = program.input_name if input_name is None else input_name
    output_name = (program.output_name if output_name is None
                   else output_name)
    for st in steps:
        if st.kind not in table:
            raise KeyError(f"no executor for step kind {st.kind!r}")

    def run(params, x):
        env = {input_name: x}
        for st in steps:
            args = [env[i] for i in st.inputs]
            env[st.output] = table[st.kind](st, params.get(st.name, {}), *args)
        return env[output_name]

    return run


def make_runner(program, *, steps=None, input_name: Optional[str] = None,
                output_name: Optional[str] = None) -> Callable:
    """Build ``run(params, x) -> output`` for one Program.

    ``steps``/``input_name``/``output_name`` override the Program's own
    (default: the whole step list): a contiguous slice of steps with its
    boundary tensors is one pipeline stage
    (:class:`repro_torch.distributed.program_parallel.PipelinedProgram`)."""
    return _runner(program, _APPLY, steps, input_name, output_name)


def make_plain_runner(program) -> Callable:
    """``run(params, x)`` with every packed step on its kernel's plain
    version, on whatever device ``x`` lies — the oracle for the card."""
    return _runner(program, _PLAIN)


def make_step_runner(program, step) -> Callable:
    """Build ``run(params, *inputs) -> output`` for a single Program step
    (inputs positionally in ``step.inputs`` order)."""
    fn = _APPLY.get(step.kind)
    if fn is None:
        raise KeyError(f"no executor for step kind {step.kind!r}")

    def run(params, *inputs):
        return fn(step, params.get(step.name, {}), *inputs)

    return run


# --------------------------------------------------------------------------
# batch-bucket entry points (the serving runtime's capture discipline)
# --------------------------------------------------------------------------

def bucket_sizes(max_batch: int, multiple: int = 1) -> List[int]:
    """Padding buckets: powers of two up to, and always including,
    ``max_batch`` — the closed set of batch shapes serving ever runs.

    ``multiple``: every bucket is a multiple of it (the bank count, when a
    bucket is batch-sharded across banks — each bank must receive an
    equal shard). ``max_batch`` is rounded up to the next multiple.
    """
    if max_batch < 1:
        raise ValueError("max_batch must be >= 1")
    if multiple < 1:
        raise ValueError("bucket multiple must be >= 1")
    cap = -(-max_batch // multiple) * multiple
    sizes, b = [], multiple
    while b < cap:
        sizes.append(b)
        b *= 2
    sizes.append(cap)
    return sizes


def bucket_for(n: int, max_batch: int, multiple: int = 1) -> int:
    """Smallest bucket holding ``n`` examples."""
    for b in bucket_sizes(max_batch, multiple):
        if n <= b:
            return b
    raise ValueError(f"batch {n} exceeds max_batch={max_batch}")


class _BucketGraph:
    """One (bank, bucket)'s captured forward: the graph, the static buffers
    it reads and writes, and the parameter tensors it was captured over.

    A graph replays the addresses it recorded but keeps nothing alive, and
    the registry may swap a Program's ``w_packed`` for an equal shared
    plane after a capture; holding the captured tensors keeps every
    address the graph reads valid for the graph's life."""

    __slots__ = ("graph", "x", "out", "params")

    def __init__(self, graph, x, out, params):
        self.graph = graph
        self.x = x
        self.out = out
        self.params = params


class BucketedRunner:
    """Program caller with power-of-two padding buckets, one captured CUDA
    graph per (bank, bucket) on the card.

    Each batch is padded with zero rows up to its bucket, so the set of
    batch shapes the kernels ever see is closed (``bucket_sizes``). Every
    lowered step acts per example, so padding rows cannot leak into real
    rows.

    Placement (the mesh-of-MVU-banks serving path — one of):

    * default (``"single"``) — the whole batch runs on the Program's
      device, on the caller's stream: bank 0, with no stream of its own;
    * ``mesh`` (``"sharded"``, a :func:`~repro_torch.distributed.
      program_parallel.bank_mesh`) — each bucket is split into equal
      shards, one per bank, each replayed on its bank's stream; buckets
      are multiples of the bank count;
    * ``banks`` (``"banked"``, :class:`~repro_torch.distributed.
      program_parallel.Bank` records or devices) — the whole batch runs on
      one bank: ``runner(x, bank=b)`` replays bank ``b``'s graph on its
      stream.

    Each bank serves from its parameter replica (placed once per device
    through ``replica_cache``; on one card the Program's own tensors) and
    captures its own graph per bucket with its own static buffers: one
    graph cannot replay concurrently with itself, and shared buffers would
    race. A bank's output is read only after the caller's stream has
    waited on the bank's, so the caller may use it at once.

    On the card the first batch of a (bank, bucket) runs the forward
    eagerly once (the kernels' modules load, cuDNN and cuBLAS get their
    workspaces outside the capture), then captures it as one
    ``torch.cuda.CUDAGraph`` over a static input buffer and the output it
    writes, and replays it. Every later batch copies its rows into the
    input buffer (from pinned memory, without blocking the host), zeroes
    the padding rows, replays, and clones its rows of the output. A
    capture runs with
    ``capture_error_mode="thread_local"`` on the bank's stream (a side
    stream of its own for ``"single"``), so other threads may use the card
    meanwhile — all but torch's CUDA random generator, which is
    process-wide and refuses to advance during any capture;
    :meth:`warmup` captures every (bank, bucket) before traffic. There is
    no eager fallback on the card: a capture that fails raises. On the CPU
    every call runs eagerly, the banks one after another, with the same
    counters. ``plain`` captures the kernels' plain versions the same way.

    ``compiles``/``hits`` count first-seen (bank, bucket) keys and repeats
    as the reference's jit cache does (a sharded bucket is one key; a
    compile is a capture on the card), registry-backed as the reference's
    ``runner_bucket_compiles_total``/``runner_bucket_hits_total``. The
    kernel wrappers count Python calls, so a replay adds nothing to them:
    ``capture_launches[k]`` holds the launches counted while capturing
    graph ``k`` (other threads launching the port's kernels during a
    capture would be counted too) and ``replays[k]`` the replays run, so
    the launches a graph ran are their product. Every one of these is
    keyed ``(bank, bucket)``, the single placement's graphs under bank 0.
    """

    def __init__(self, program, *, max_batch: int = 32,
                 plain: bool = False, mesh=None, banks=None,
                 replica_cache=None,
                 metrics: Optional[MetricsRegistry] = None):
        from repro_torch.distributed import program_parallel as pp
        if mesh is not None and banks is not None:
            raise ValueError("pass mesh= (sharded) or banks= (placed), "
                             "not both")
        self.program = program
        self.max_batch = max_batch
        self.plain = plain
        self._multiple = 1
        if mesh is not None:
            self._banks = pp.banks_of(mesh)
            self._multiple = len(self._banks)
            self.placement = "sharded"
        elif banks is not None:
            if not list(banks):
                raise ValueError("banks= needs at least one device")
            self._banks = pp.bank_devices(None, banks)
            self.placement = "banked"
        else:
            self._banks = [pp.Bank(0, program.device)]
            self.placement = "single"
        self.n_banks = len(self._banks)
        self._bank_params = (
            [program.params] if self.placement == "single" else
            [pp.replicate_params(program.params, b.device,
                                 cache=replica_cache) for b in self._banks])
        self._run = (make_plain_runner if self.plain else make_runner)(program)
        self._graphed = self._banks[0].device.type == "cuda"
        self._graphs: Dict[tuple, _BucketGraph] = {}  # guarded-by: _lock
        self._seen: Set[tuple] = set()                # guarded-by: _lock
        # held over each call: the static buffers are shared by every
        # caller of one (bank, bucket)
        self._lock = threading.Lock()
        #: launches counted while capturing each graph, and replays run
        self.capture_launches: Dict = {}
        self.replays: Dict = {}
        #: host seconds of each graph's eager warm-up pass and capture
        self.capture_seconds: Dict = {}
        self.metrics_registry = (metrics if metrics is not None
                                 else MetricsRegistry())
        self._c_compiles = self.metrics_registry.counter(
            "runner_bucket_compiles_total", "new (bank, bucket) jit keys")
        self._c_hits = self.metrics_registry.counter(
            "runner_bucket_hits_total", "warm (bank, bucket) jit hits")

    @property
    def compiles(self) -> int:
        return int(self._c_compiles.value())

    @property
    def hits(self) -> int:
        return int(self._c_hits.value())

    def _capture(self, i: int, b: int, x: torch.Tensor) -> _BucketGraph:
        """Eager warm-up pass on the bank's stream, then the capture."""
        bank, params = self._banks[i], self._bank_params[i]
        dev = bank.device
        t0 = time.perf_counter()
        side = bank.stream or torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._run(params, x)
        torch.cuda.current_stream(dev).wait_stream(side)
        held = [t for p in params.values()
                for t in p.values() if isinstance(t, torch.Tensor)]
        graph = torch.cuda.CUDAGraph()
        before = ops.launch_counts()
        with torch.cuda.graph(graph, stream=bank.stream,
                              capture_error_mode="thread_local"):
            out = self._run(params, x)
        after = ops.launch_counts()
        self.capture_seconds[(i, b)] = time.perf_counter() - t0
        self.capture_launches[(i, b)] = {n: after[n] - before[n]
                                         for n in after}
        return _BucketGraph(graph, x, out, held)

    def _forward(self, i: int, b: int,
                 x: torch.Tensor) -> torch.Tensor:  # requires: _lock
        """Bank ``i``'s forward at bucket ``b`` of the rows ``x`` padded
        with zeros to the bank's share of the bucket (all of it unless
        sharded): the output's first ``len(x)`` rows, ready on the caller's
        stream."""
        from repro_torch.distributed.program_parallel import (after_caller,
                                                              join, on_bank)
        bank, n, rows = self._banks[i], x.shape[0], b // self._multiple
        if not self._graphed:
            x = x.to(bank.device)
            if rows != n:
                x = torch.cat([x, x.new_zeros((rows - n,) + x.shape[1:])])
            return self._run(self._bank_params[i], x)[:n]
        with torch.cuda.device(bank.device):
            g = self._graphs.get((i, b))
            if g is None:
                xs = torch.zeros((rows,) + tuple(x.shape[1:]),
                                 dtype=torch.float32, device=bank.device)
                xs[:n].copy_(x)
                g = self._graphs[(i, b)] = self._capture(i, b, xs)
            else:
                after_caller(bank, x)
                with on_bank(bank):
                    g.x[:n].copy_(x if x.is_cuda else x.pin_memory(),
                                  non_blocking=True)
                    g.x[n:].zero_()
            with on_bank(bank):
                g.graph.replay()
                out = g.out[:n].clone()
            self.replays[(i, b)] = self.replays.get((i, b), 0) + 1
            return join(bank, out)

    def __call__(self, x, *, bank: Optional[int] = None) -> torch.Tensor:
        if self.placement == "banked":
            bank = 0 if bank is None else bank
            if not 0 <= bank < self.n_banks:
                raise ValueError(f"bank {bank} out of range "
                                 f"[0, {self.n_banks})")
        elif bank not in (None, 0):
            raise ValueError(f"bank {bank} out of range [0, 1): placement "
                             f"{self.placement!r} picks no bank")
        bank = bank or 0
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.asarray(x, np.float32))
        n = x.shape[0]
        b = bucket_for(n, self.max_batch, self._multiple)
        with self._lock:
            if (bank, b) in self._seen:
                self._c_hits.inc()
            else:
                self._seen.add((bank, b))
                self._c_compiles.inc()
            with torch.no_grad():
                x = x.to(torch.float32)
                if self.placement != "sharded":
                    return self._forward(bank, b, x)
                s = b // self.n_banks
                outs = [self._forward(i, b, x[i * s:(i + 1) * s])
                        for i in range(self.n_banks)]
                dev = self._banks[0].device
                return torch.cat([o.to(dev) for o in outs], dim=0)

    def warmup(self, example_shape=None) -> int:
        """Capture (on the CPU: run) every (bucket, bank) ahead of traffic;
        returns the number of compiles triggered."""
        shape = (tuple(example_shape) if example_shape is not None
                 else self.program.meta.get("input_shape"))
        if shape is None:
            raise ValueError("program has no recorded input_shape — pass "
                             "example_shape explicitly")
        before = self.compiles
        banks = (range(self.n_banks) if self.placement == "banked"
                 else (0,))
        for b in bucket_sizes(self.max_batch, self._multiple):
            for bank in banks:
                if (bank, b) not in self._seen:
                    self(torch.zeros((b,) + shape, dtype=torch.float32),
                         bank=bank)
        if self._graphed:
            for dev in {bk.device for bk in self._banks}:
                torch.cuda.synchronize(dev)
        return self.compiles - before

    def stats(self) -> Dict:
        with self._lock:
            return {"compiles": self.compiles, "hits": self.hits,
                    "buckets": sorted({b for _, b in self._seen}),
                    "bucket_set": bucket_sizes(self.max_batch,
                                               self._multiple),
                    "n_banks": self.n_banks,
                    "placement": self.placement,
                    "cuda_graphs": len(self._graphs),
                    "replays": dict(self.replays)}


def make_bucketed_runner(program, *, max_batch: int = 32,
                         plain: bool = False, mesh=None, banks=None,
                         replica_cache=None,
                         metrics: Optional[MetricsRegistry] = None
                         ) -> BucketedRunner:
    """The serving entry point: ``runner(x) -> y`` over padding buckets,
    on one device, sharded over a bank ``mesh`` or placed on ``banks``."""
    return BucketedRunner(program, max_batch=max_batch, plain=plain,
                          mesh=mesh, banks=banks,
                          replica_cache=replica_cache, metrics=metrics)
