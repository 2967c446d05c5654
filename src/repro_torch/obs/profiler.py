"""Measured-time Program profiler: per-step device time next to the cycle
model's prediction.

The port's copy of ``repro/obs/profiler.py``. Everything else in
:mod:`repro_torch.obs` reports the *virtual* cycle domain — the
barrel-controller cost model that scheduling and HPM counters are built
on. This module closes the predicted-vs-measured loop: it executes a
compiled :class:`~repro_torch.compiler.lower.Program` step by step (one
callable per IR node via
:func:`~repro_torch.compiler.executor.make_step_runner`) and attributes a
measured time to each step beside the cycles the cost model predicted for
it.

**Timing.** After ``warmup`` calls, each step runs ``repeats`` times a run
of :data:`CALLS_PER_RUN` back-to-back calls; a run is timed on the card by a
``torch.cuda.Event`` pair around it (on the CPU by ``perf_counter``), its
mean per call is the run's time and the best run is the step's. Steps such
as ``maxpool`` or ``pack_codes`` take microseconds, so an event pair per
call would measure the launch; a run of calls measures the stream. Each
step also records the kernel launches one call makes (the wrappers'
counts, :func:`repro_torch.kernels.ops.launch_counts`), so a profile shows
which hand-written kernel each step ran.

The profiler is strictly opt-in: the serving/executor path never imports
it (a test checks ``sys.modules``), emits no measured spans, and
allocates no profiler counters.

Roofline terms: each serial conv/gemm step also gets analytic operations
and memory traffic at its packed precision, against one NVIDIA H100 SXM's
published dense peaks (NVIDIA's data sheet; the reference's constants are
a TPU's), so summaries report which layers are compute- vs memory-bound.

Measured spans are exported as a third Chrome-trace track ("measured"
process) next to the wall and virtual-cycle tracks::

    write_chrome_trace(tracer, path, extra_spans=profile.spans())
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.obs.tracing import Span

__all__ = ["PEAK_BF16", "PEAK_INT8", "HBM_BW", "SERIAL_KINDS",
           "CALLS_PER_RUN", "StepProfile", "ProgramProfile", "profile_program",
           "format_profile", "stream_cycles_by_layer"]

# NVIDIA H100 SXM, dense (no sparsity), at its 700 W limit
PEAK_BF16 = 989e12       # FLOP/s dense bf16
PEAK_INT8 = 1979e12      # op/s int8 (the packed bit-serial digits)
HBM_BW = 3.35e12         # bytes/s

# op kinds whose cycles the barrel-controller cost model predicts (the
# calibration targets); everything else is host-side glue
SERIAL_KINDS = ("conv_packed", "gemm_packed")

#: back-to-back calls per timed run: enough that one event pair's
#: resolution and the run's first launch are small against the run
CALLS_PER_RUN = 20


def _layer_tag(tag: str) -> str:
    """Fold codegen's pipelined XFER jobs (``"<layer>->next"``) and
    distributed replicas (``"<layer>@r0"``) onto their producing layer."""
    return tag.split("->", 1)[0].split("@", 1)[0]


def stream_cycles_by_layer(program, *,
                           mode: str = "pipelined") -> Dict[str, int]:
    """Predicted virtual cycles per cost-model layer name, from the
    Program's own command stream (compute + its output XFER jobs; HOST
    jobs carry no MVU cycles)."""
    stream = program.to_command_stream(mode=mode)
    out: Dict[str, int] = {}
    for j in stream.jobs:
        if j.mvu < 0:
            continue
        name = _layer_tag(j.tag)
        out[name] = out.get(name, 0) + int(j.cycles)
    return out


def _bits_for(program, name: str) -> Tuple[Optional[int], Optional[int]]:
    """(a_bits, w_bits) for one layer from the Program's per-layer plan."""
    bits = (program.per_layer_bits or {}).get(name)
    if bits is None:
        return None, None
    a, w = bits
    return int(a), int(w)


def _roofline_terms(node, batch: int, a_bits: Optional[int],
                    w_bits: Optional[int]) -> Dict[str, float]:
    """Analytic operations / memory bytes / bound classification for one
    lowered conv or gemm cost node at its packed precision."""
    ab = a_bits or 8
    wb = w_bits or 8
    if getattr(node, "kind", None) == "conv2d":
        ho = (node.h + 2 * node.padding - node.fh) // node.stride + 1
        wo = (node.w + 2 * node.padding - node.fw) // node.stride + 1
        flops = 2.0 * batch * ho * wo * node.c_out * node.c_in \
            * node.fh * node.fw
        bytes_hbm = (batch * node.h * node.w * node.c_in * ab
                     + node.fh * node.fw * node.c_in * node.c_out * wb
                     + batch * ho * wo * node.c_out * ab) / 8.0
    elif getattr(node, "kind", None) == "gemm":
        flops = 2.0 * batch * node.k * node.n
        bytes_hbm = (batch * node.k * ab + node.k * node.n * wb
                     + batch * node.n * ab) / 8.0
    else:
        return {}
    t_compute = flops / PEAK_INT8
    t_memory = bytes_hbm / HBM_BW
    return {
        "flops": flops,
        "bytes_hbm": bytes_hbm,
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "bound": "compute" if t_compute >= t_memory else "memory",
    }


@dataclasses.dataclass
class StepProfile:
    """One IR node's measured + predicted record."""
    name: str
    kind: str
    wall_ns: float                       # best run's mean ns per call
    runs: int
    a_bits: Optional[int] = None
    w_bits: Optional[int] = None
    pred_cycles: int = 0                 # command-stream virtual cycles
    flops: float = 0.0
    bytes_hbm: float = 0.0
    t_compute_s: float = 0.0
    t_memory_s: float = 0.0
    bound: Optional[str] = None          # "compute" | "memory" | None
    out_shape: Tuple[int, ...] = ()
    #: hand-written kernel launches per call, by kernel id (empty on the
    #: CPU, where the wrappers run their plain versions)
    launches: Dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def wall_us(self) -> float:
        return self.wall_ns / 1e3

    @property
    def roofline_s(self) -> float:
        """The least time one H100 could take for this step's work."""
        return max(self.t_compute_s, self.t_memory_s)

    @property
    def precision(self) -> str:
        if self.a_bits is None or self.w_bits is None:
            return "-"
        return f"W{self.w_bits}A{self.a_bits}"


@dataclasses.dataclass
class ProgramProfile:
    """Measured profile of one compiled Program (one batch shape) on one
    device type (``backend``: ``"cuda"`` or ``"cpu"``)."""
    graph_name: str
    backend: str
    batch: int
    warmup: int
    repeats: int
    mode: str
    steps: List[StepProfile] = dataclasses.field(default_factory=list)

    @property
    def total_wall_ns(self) -> float:
        return sum(s.wall_ns for s in self.steps)

    @property
    def serial_steps(self) -> List[StepProfile]:
        return [s for s in self.steps if s.kind in SERIAL_KINDS]

    def by_kind(self) -> Dict[str, float]:
        """Total measured ns per op kind."""
        out: Dict[str, float] = {}
        for s in self.steps:
            out[s.kind] = out.get(s.kind, 0.0) + s.wall_ns
        return out

    def by_precision(self) -> Dict[str, float]:
        """Total measured ns per WxAy precision bucket."""
        out: Dict[str, float] = {}
        for s in self.steps:
            out[s.precision] = out.get(s.precision, 0.0) + s.wall_ns
        return out

    def launches(self) -> Dict[str, int]:
        """Kernel launches of one call of every step, by kernel id."""
        out: Dict[str, int] = {}
        for s in self.steps:
            for k, n in s.launches.items():
                out[k] = out.get(k, 0) + n
        return out

    def spans(self) -> List[Span]:
        """Measured spans on a synthetic end-to-end timeline, tagged
        ``domain="measured"`` so the Chrome-trace exporter routes them
        to the third ("measured") track."""
        out: List[Span] = []
        cum = 0
        for s in self.steps:
            t1 = cum + max(1, int(round(s.wall_ns)))
            out.append(Span(
                0, s.name, cum, t1, track="measured",
                args={"domain": "measured", "kind": s.kind,
                      "precision": s.precision,
                      "pred_cycles": s.pred_cycles,
                      "bound": s.bound or "-"}))
            cum = t1
        return out

    def summary(self) -> Dict:
        serial = self.serial_steps
        n_compute = sum(1 for s in serial if s.bound == "compute")
        n_memory = sum(1 for s in serial if s.bound == "memory")
        return {
            "graph": self.graph_name,
            "backend": self.backend,
            "batch": self.batch,
            "steps": len(self.steps),
            "total_wall_us": round(self.total_wall_ns / 1e3, 1),
            "serial_wall_us": round(
                sum(s.wall_ns for s in serial) / 1e3, 1),
            "pred_cycles": sum(s.pred_cycles for s in self.steps),
            "by_kind_us": {k: round(v / 1e3, 1)
                           for k, v in sorted(self.by_kind().items())},
            "by_precision_us": {k: round(v / 1e3, 1)
                                for k, v in
                                sorted(self.by_precision().items())},
            "compute_bound_layers": n_compute,
            "memory_bound_layers": n_memory,
            "total_flops": sum(s.flops for s in self.steps),
            "total_bytes_hbm": sum(s.bytes_hbm for s in self.steps),
            "launches": self.launches(),
        }


def _timed_run(run, params, args, device) -> float:
    """Mean ns per call of :data:`CALLS_PER_RUN` back-to-back calls: a CUDA
    event pair around the run on the card, ``perf_counter`` on the CPU."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(CALLS_PER_RUN):
            run(params, *args)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) * 1e6 / CALLS_PER_RUN
    t0 = time.perf_counter()
    for _ in range(CALLS_PER_RUN):
        run(params, *args)
    return (time.perf_counter() - t0) * 1e9 / CALLS_PER_RUN


def profile_program(program, x=None, *, batch: int = 1, warmup: int = 1,
                    repeats: int = 3, mode: str = "pipelined",
                    metrics=None) -> ProgramProfile:
    """Execute ``program`` step by step on its device and measure each IR
    node (see the module docstring for the timing).

    ``x``: the input batch (default: zeros of ``batch`` examples of the
    recorded ``input_shape``); each step runs on its predecessors' real
    outputs. ``metrics``: optional
    :class:`~repro_torch.obs.metrics.MetricsRegistry` that receives
    ``profiler_step_wall_ns_total{step,kind}`` and
    ``profiler_runs_total``. Off-path cost is zero: no registry, no
    counters.
    """
    from repro_torch.compiler.executor import make_step_runner
    from repro_torch.kernels import ops

    device = program.device
    if x is None:
        shape = program.meta.get("input_shape") if program.meta else None
        if shape is None:
            raise ValueError("program has no recorded input_shape — pass "
                             "x explicitly")
        x = torch.zeros((batch,) + tuple(int(d) for d in shape),
                        dtype=torch.float32, device=device)
    elif not isinstance(x, torch.Tensor):
        x = torch.as_tensor(x, dtype=torch.float32)
    x = x.to(device)
    batch = int(x.shape[0])
    repeats = max(1, repeats)

    pred = stream_cycles_by_layer(program, mode=mode)
    nodes = {n.name: n for n in (program.cost_nodes or ())}

    c_wall = c_runs = None
    if metrics is not None:
        c_wall = metrics.counter(
            "profiler_step_wall_ns_total",
            "best-run measured ns per call per profiled step")
        c_runs = metrics.counter(
            "profiler_runs_total", "profile_program invocations")

    prof = ProgramProfile(
        graph_name=program.graph_name, backend=device.type, batch=batch,
        warmup=warmup, repeats=repeats, mode=mode)

    env = {program.input_name: x}
    with torch.no_grad():
        for st in program.steps:
            run = make_step_runner(program, st)
            args = [env[i] for i in st.inputs]
            out = run(program.params, *args)      # first warm-up call
            for _ in range(max(0, warmup - 1)):
                run(program.params, *args)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            before = ops.launch_counts()
            best = min(_timed_run(run, program.params, args, device)
                       for _ in range(repeats))
            after = ops.launch_counts()
            env[st.output] = out

            a_bits, w_bits = _bits_for(program, st.name)
            rec = StepProfile(
                name=st.name, kind=st.kind, wall_ns=float(best),
                runs=repeats, a_bits=a_bits, w_bits=w_bits,
                pred_cycles=int(pred.get(st.name, 0)),
                out_shape=tuple(int(d) for d in out.shape),
                launches={k: (after[k] - before[k])
                          // (repeats * CALLS_PER_RUN)
                          for k in after if after[k] != before[k]})
            node = nodes.get(st.name)
            if node is not None and st.kind in SERIAL_KINDS:
                rec.__dict__.update(_roofline_terms(node, batch, a_bits,
                                                    w_bits))
            prof.steps.append(rec)
            if c_wall is not None:
                c_wall.inc(rec.wall_ns, step=st.name, kind=st.kind)
    if c_runs is not None:
        c_runs.inc()
    return prof


def format_profile(profile: ProgramProfile, calibration=None) -> str:
    """Per-layer table: measured time, predicted cycles, the H100
    roofline time and (when a fitted
    :class:`~repro_torch.obs.calibrate.Calibration` is supplied) the
    fitted ns/cycle, relative residual, and outlier flag."""
    rows = []
    head = ["layer", "kind", "prec", "wall_us", "pred_cycles",
            "roofline_us", "bound", "launches"]
    if calibration is not None:
        head += ["ns/cyc", "resid", "flag"]
    rows.append(head)
    for s in profile.steps:
        roof = (f"{s.roofline_s * 1e6:10.3f}" if s.bound is not None
                else "-")
        launches = ",".join(f"{k}x{n}" for k, n in sorted(
            s.launches.items())) or "-"
        row = [s.name, s.kind, s.precision, f"{s.wall_us:10.1f}",
               f"{s.pred_cycles:12d}", roof, s.bound or "-", launches]
        if calibration is not None:
            if s.pred_cycles > 0:
                r = calibration.residuals.get(s.name)
                row += [f"{calibration.ns_for(s.kind):8.2f}",
                        f"{r:+7.2f}" if r is not None else "      -",
                        "OUTLIER" if s.name in calibration.outliers
                        else ""]
            else:
                row += ["       -", "      -", ""]
        rows.append(row)
    widths = [max(len(str(r[i])) for r in rows)
              for i in range(len(rows[0]))]
    lines = []
    for i, r in enumerate(rows):
        lines.append("  ".join(str(c).ljust(w)
                               for c, w in zip(r, widths)).rstrip())
        if i == 0:
            lines.append("  ".join("-" * w for w in widths))
    s = profile.summary()
    lines.append("")
    lines.append(
        f"total {s['total_wall_us']:.1f}us over {s['steps']} steps "
        f"(batch={s['batch']}, device={s['backend']}); "
        f"{s['compute_bound_layers']} compute-bound / "
        f"{s['memory_bound_layers']} memory-bound serial layers "
        f"(roofline: one H100 SXM, {PEAK_INT8 / 1e12:.0f} TOP/s int8, "
        f"{HBM_BW / 1e12:.2f} TB/s)")
    return "\n".join(lines)
