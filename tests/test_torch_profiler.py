"""The port's measured layer against the JAX package: the per-step
profiler (its predicted cycles and roofline terms equal the reference's on
the same Program, exactly), the measured Chrome-trace track, the
ns-per-cycle fit (equal to the reference's fit on the same samples,
exactly), its round trip through the artifact store, the scheduler and
service calibration surface, the LM engine's per-step samples, and the
profiler staying off the serving path.

Measured times are CPU times here: the tests hold that they are positive
and finite, never their values. Every other comparison is exact — the
same integer cycle arithmetic, the same float expressions of the shapes,
and the same median-of-ratios arithmetic in Python.
"""

import _torch_threads  # noqa: F401  (first: caps torch's threads under xdist)

import math
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from repro.compiler import compile_graph as j_compile_graph
from repro.compiler.bench_graphs import tiny_mixed_cnn as j_tiny_mixed_cnn
from repro.obs import calibrate as jcalibrate
from repro.obs import profile_program as j_profile_program
from repro.obs.profiler import stream_cycles_by_layer as j_cycles_by_layer

from repro_torch.compiler import ArtifactStore, program_from_numpy
from repro_torch.compiler.bench_graphs import tiny_mixed_cnn
from repro_torch.compiler.lower import compile_graph
from repro_torch.core.codegen import CommandStream
from repro_torch.core.mvu import MVUJob, OpKind
from repro_torch.obs import (MetricsRegistry, Tracer, chrome_trace,
                             fit, fit_samples, format_calibration,
                             format_profile, profile_program)
from repro_torch.obs import calibrate, profiler
from repro_torch.serving import (InferenceService, ModelRegistry,
                                 SlotScheduler)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _record(prog):
    from repro.compiler.artifact import _enc
    return {"graph_name": prog.graph_name, "input_name": prog.input_name,
            "output_name": prog.output_name,
            "steps": [{"name": s.name, "kind": s.kind,
                       "inputs": list(s.inputs), "output": s.output,
                       "attrs": _enc(dict(s.attrs))} for s in prog.steps],
            "params": {k: {n: np.asarray(a) for n, a in p.items()}
                       for k, p in prog.params.items()},
            "meta": _enc(dict(prog.meta)),
            "cost_nodes": _enc(list(prog.cost_nodes))}


@pytest.fixture(scope="module")
def progs():
    """tiny_mixed_cnn: the reference's Program and the same Program carried
    across to the port."""
    g, calib = j_tiny_mixed_cnn()
    jprog = j_compile_graph(g, jnp.asarray(calib))
    return jprog, program_from_numpy(_record(jprog), device="cpu")


@pytest.fixture(scope="module")
def profs(progs):
    jprog, prog = progs
    return (j_profile_program(jprog, batch=4, warmup=1, repeats=1),
            profile_program(prog, batch=4, warmup=1, repeats=2))


def test_profile_covers_every_step(progs, profs):
    _, prog = progs
    _, prof = profs
    assert [s.name for s in prof.steps] == [st.name for st in prog.steps]
    assert all(math.isfinite(s.wall_ns) and s.wall_ns > 0
               for s in prof.steps)
    assert all(s.runs == 2 for s in prof.steps)
    assert prof.backend == "cpu" and prof.batch == 4
    assert prof.total_wall_ns == sum(s.wall_ns for s in prof.steps)
    # on the CPU the wrappers run their plain versions: no launch counted
    assert all(s.launches == {} for s in prof.steps)
    assert len(prof.serial_steps) == 3
    for s in prof.steps:
        if s.kind not in profiler.SERIAL_KINDS:
            assert s.pred_cycles == 0 and s.bound is None


def test_predicted_cycles_equal_reference(progs, profs):
    jprog, prog = progs
    jprof, prof = profs
    assert profiler.stream_cycles_by_layer(prog) == j_cycles_by_layer(jprog)
    for mode in ("pipelined", "distributed"):
        assert profiler.stream_cycles_by_layer(prog, mode=mode) == \
            j_cycles_by_layer(jprog, mode=mode)
    assert [s.pred_cycles for s in prof.steps] == \
        [s.pred_cycles for s in jprof.steps]


def test_roofline_terms_equal_reference(profs):
    """Operations, bytes, precision and output shapes equal the
    reference's; the peaks are the H100's, so the times and the bound
    follow from them, not from the reference's TPU figures."""
    jprof, prof = profs
    for s, j in zip(prof.steps, jprof.steps):
        assert (s.name, s.kind, s.precision, s.out_shape) == \
            (j.name, j.kind, j.precision, j.out_shape)
        assert (s.flops, s.bytes_hbm) == (j.flops, j.bytes_hbm)
        if s.bound is not None:
            assert s.t_compute_s == s.flops / 1979e12
            assert s.t_memory_s == s.bytes_hbm / 3.35e12
            assert s.roofline_s == max(s.t_compute_s, s.t_memory_s)
    assert (profiler.PEAK_INT8, profiler.PEAK_BF16, profiler.HBM_BW) == \
        (1979e12, 989e12, 3.35e12)
    sj, sp = jprof.summary(), prof.summary()
    for key in ("steps", "pred_cycles", "total_flops", "total_bytes_hbm"):
        assert sp[key] == sj[key], key


def test_profile_on_a_port_compile(tmp_path):
    """The port's own compile profiles with real inputs and a metrics
    registry; the summary and table carry every step."""
    g, calib = tiny_mixed_cnn()
    prog = compile_graph(g, calib, device="cpu")
    m = MetricsRegistry()
    prof = profile_program(prog, calib, repeats=1, metrics=m)
    assert prof.batch == 4
    assert m.get("profiler_step_wall_ns_total").value(
        step="c1", kind="conv_packed") > 0
    assert m.get("profiler_runs_total").value() == 1
    s = prof.summary()
    assert s["steps"] == len(prog.steps)
    assert s["compute_bound_layers"] + s["memory_bound_layers"] == 3
    table = format_profile(prof)
    assert "c1" in table and "roofline_us" in table and "H100" in table


def test_measured_spans_third_trace_track(profs):
    _, prof = profs
    tr = Tracer()
    ctx = tr.start_trace(t_ns=1_000)
    tr.span(ctx, "execute", 1_000, 2_000, cycle_start=0, cycle_end=10)
    doc = chrome_trace(tr, extra_spans=prof.spans())
    measured = sorted((e for e in doc["traceEvents"]
                       if e["pid"] == "measured"), key=lambda e: e["ts"])
    assert len(measured) == len(prof.steps)
    assert measured[0]["ts"] == 0.0
    for a, b in zip(measured, measured[1:]):
        assert b["ts"] == pytest.approx(a["ts"] + a["dur"])
    assert all(e["args"]["domain"] == "measured" for e in measured)
    wall = [e for e in doc["traceEvents"] if e["pid"] == "wall"]
    assert len(wall) == 1 and wall[0]["ts"] == 0.0


# -------------------------------------------------------------- calibration

def _cal_fields(cal):
    return (cal.ns_per_cycle, cal.residuals, cal.outliers, cal.tolerance,
            cal.n_samples, cal.max_abs_residual)


SAMPLE_SETS = {
    "outlier": [("l0", "gemm_packed", 1000, 8000.0),
                ("l1", "gemm_packed", 1000, 8200.0),
                ("l2", "gemm_packed", 1000, 7900.0),
                ("slow", "gemm_packed", 1000, 80000.0)],
    "two_kinds": [("c1", "conv_packed", 36096, 215000.5),
                  ("c2", "conv_packed", 18048, 61000.25),
                  ("c3", "conv_packed", 768, 40000.0),
                  ("fc", "gemm_packed", 128, 9000.0)],
    "dropped": [("z", "k", 0, 100.0), ("n", "k", 10, -1.0)],
    "empty": [],
}


@pytest.mark.parametrize("name", sorted(SAMPLE_SETS))
@pytest.mark.parametrize("tolerance", [0.25, 1.0])
def test_fit_samples_equals_reference(name, tolerance):
    samples = SAMPLE_SETS[name]
    got = fit_samples(samples, backend="cuda", tolerance=tolerance)
    ref = jcalibrate.fit_samples(samples, tolerance=tolerance)
    assert _cal_fields(got) == _cal_fields(ref)
    assert got.backend == "cuda"


def test_fit_from_profile_equals_reference_fit_of_its_samples(profs):
    _, prof = profs
    cal = fit(prof)
    samples = [(s.name, s.kind, s.pred_cycles, s.wall_ns)
               for s in prof.steps if s.pred_cycles > 0]
    assert _cal_fields(cal) == _cal_fields(jcalibrate.fit_samples(samples))
    assert cal.backend == "cpu" and cal.meta["graph"] == prof.graph_name
    assert cal.ns_for("no_such_kind") == cal.ns_for() > 0
    assert cal.predict_wall_seconds(1e6) == 1e6 * cal.ns_for() * 1e-9
    assert "ns/cycle" in format_calibration(cal)
    table = format_profile(prof, cal)
    assert "ns/cyc" in table and "resid" in table


def test_calibration_store_roundtrip(tmp_path):
    store = ArtifactStore(str(tmp_path))
    cal = fit_samples(SAMPLE_SETS["two_kinds"], backend="cuda")
    key = calibrate.save(store, cal, "cnn@W2A2")
    assert key == calibrate.calibration_key("cuda", "cnn@W2A2")
    assert calibrate.load(store, "cuda", "cnn@W2A2") == cal
    # a CPU fit is never served on the card, nor the card's on the CPU
    assert calibrate.load(store, "cpu", "cnn@W2A2") is None
    assert calibrate.load(store, "cuda", "missing") is None
    store.tuning_put(calibrate.calibration_key("cuda", "bogus"), "tile",
                     {"block_m": 8})
    assert calibrate.load(store, "cuda", "bogus") is None


# --------------------------------------------------- scheduler / service

def _host_stream() -> CommandStream:
    jobs = [MVUJob(op=OpKind.GEMV, mvu=0, a_bits=2, w_bits=2,
                   m_tiles=4, k_tiles=4, tag="l0"),
            MVUJob(op=OpKind.GEMV, mvu=1, a_bits=4, w_bits=4,
                   m_tiles=2, k_tiles=2, tag="l1", depends_on=(0,))]
    return CommandStream(jobs=jobs, mode="pipelined")


def _cal(ns):
    return calibrate.Calibration(
        backend="cpu", ns_per_cycle={"*": ns}, residuals={}, outliers=(),
        tolerance=1.0, n_samples=4, max_abs_residual=0.1)


def test_scheduler_books_wall_time_at_the_fitted_rate():
    sched = SlotScheduler()
    cs = _host_stream()
    adm = sched.admit("m@W2A2", 1, stream=cs)
    assert adm.est_seconds == adm.est_cycles / sched.controller.freq_hz
    assert sched.metrics()["calibration"]["source"] == "nominal"
    sched.set_calibration(_cal(8.0))
    adm2 = sched.admit("m@W2A2", 1, stream=cs)
    assert adm2.est_seconds == adm2.est_cycles * 8.0 * 1e-9
    sched.complete(adm2, adm2.est_cycles * 8.0e-9)
    m = sched.metrics()["calibration"]
    assert m["source"] == "fitted" and m["ns_per_cycle"] == 8.0
    sched.set_calibration(None)
    assert sched.metrics()["calibration"]["source"] == "nominal"


def test_service_calibration_passthrough():
    reg = ModelRegistry(device="cpu")
    key = reg.register_callable("eng", lambda reqs: [r * 2 for r in reqs],
                                stream=_host_stream())
    svc = InferenceService(reg, max_wait_s=0.0)
    svc.set_calibration(_cal(4.0))
    with svc:
        futs = svc.submit_many(key, [1.0, 2.0])
        svc.drain(timeout=60)
        assert [f.result() for f in futs] == [2.0, 4.0]
    m = svc.metrics()["scheduler"]["calibration"]
    assert m["source"] == "fitted" and m["ns_per_cycle"] == 4.0
    assert m["observed_ns_per_cycle"] is not None


def test_lm_engine_wall_samples_feed_the_fit():
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import GenRequest
    from repro_torch.serving import ContinuousLMEngine
    eng = ContinuousLMEngine(get_arch("stablelm-1.6b").smoke, batch_slots=2,
                             max_len=16, seed=0, device="cpu")
    eng.warmup()
    assert eng.wall_samples() == []
    eng.bind_runtime(SlotScheduler(), "lm@W4A8")
    eng.serve([GenRequest(np.zeros(2, np.int32), 4)])
    samples = eng.wall_samples()
    assert samples and all(c > 0 and w > 0 for c, w in samples)
    named = [("decode_step", "lm_decode", c, w) for c, w in samples]
    cal = fit_samples(named, backend="cpu")
    assert cal.ns_for("lm_decode") > 0
    assert _cal_fields(cal) == _cal_fields(jcalibrate.fit_samples(named))


# ------------------------------------------------------------- off the path

def test_serving_path_never_imports_the_profiler():
    """A CNN served through the registry and the service on the CPU, in a
    fresh interpreter: neither the profiler nor the calibration module is
    imported, and the trace has no measured track."""
    code = """
import sys
import numpy as np
from repro_torch.compiler.bench_graphs import tiny_mixed_cnn
from repro_torch.obs import chrome_trace
from repro_torch.serving import InferenceService, ModelRegistry
g, calib = tiny_mixed_cnn()
reg = ModelRegistry(device="cpu")
key = reg.register_graph("tiny", g, calib, __import__(
    "repro_torch.models.layers", fromlist=["QuantPolicy"]).QuantPolicy(
    mode="serial", w_bits=2, a_bits=2, radix_bits=7))
with InferenceService(reg, max_wait_s=0.0) as svc:
    futs = svc.submit_many(key, list(calib[:3]))
    svc.drain(timeout=60)
    assert all(f.result().shape == (10,) for f in futs)
    pids = {e["pid"] for e in chrome_trace(svc.tracer)["traceEvents"]}
assert "measured" not in pids, pids
bad = [m for m in ("repro_torch.obs.profiler", "repro_torch.obs.calibrate")
       if m in sys.modules]
print("imported:", bad)
sys.exit(1 if bad else 0)
"""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
