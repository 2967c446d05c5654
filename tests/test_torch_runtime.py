"""The port's cycle-domain runtime against the JAX package: the barrel
controller (``runtime/controller``), the HPM counter file (``obs/hpm``),
the stream verifier and its ``REPRO_VERIFY`` gate (``analysis``), the
command-stream lowering of compiled Programs (``compiler/lower``), the
serving path's failure types (``runtime/fault_tolerance``), and a scan
that keeps every port module and ``chip_smoke.py`` free of ``jax`` and
``repro`` imports.

Everything here is pure Python integer arithmetic on both sides, so every
comparison is exact: job lists, cycle counts, ``SimReport`` fields, HPM
snapshots, error checks and their blame.
"""

import _torch_threads  # noqa: F401  (first: caps torch's threads under xdist)

import ast
import dataclasses
import os

import numpy as np
import pytest

from repro.analysis.verify_stream import StreamError as JStreamError
from repro.analysis.verify_stream import verify_stream as j_verify_stream
from repro.compiler import compile_graph as j_compile_graph
from repro.compiler import Graph as JGraph
from repro.compiler import Node as JNode
from repro.compiler.artifact import _enc, _encode_job
from repro.configs import get_arch as j_get_arch
from repro.core import codegen as jcg
from repro.core import cost_model as jcm
from repro.core.mvu import OpKind as JOpKind
from repro.models.layers import QuantPolicy as JPolicy
from repro.obs.hpm import HPMCounterFile as JHPMFile
from repro.obs.metrics import MetricsRegistry as JRegistry
from repro.obs.export import prometheus_text as j_prometheus_text
from repro.runtime.controller import BarrelController as JController
from repro.runtime.fault_tolerance import FailureInjector as JInjector
from repro.runtime.fault_tolerance import WorkerFailure as JWorkerFailure
from repro.serving import decode_cost_stream as j_decode_cost_stream

from repro_torch import analysis
from repro_torch.analysis.verify_ir import VerifyError
from repro_torch.analysis.verify_stream import StreamError, verify_stream
from repro_torch.compiler.ir import Graph, Node
from repro_torch.compiler.lower import (LoweredConv, LoweredGemm,
                                        compile_graph, program_from_numpy)
from repro_torch.configs import get_arch
from repro_torch.core import codegen as tcg
from repro_torch.core import cost_model as tcm
from repro_torch.core.mvu import OpKind
from repro_torch.models.layers import QuantPolicy
from repro_torch.obs import HPMCounterFile, MetricsRegistry, prometheus_text
from repro_torch.runtime.controller import BarrelController
from repro_torch.runtime.fault_tolerance import (BankFailure, FailureInjector,
                                                 WorkerFailure)
from repro_torch.serving import decode_cost_stream

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CALIB = np.random.RandomState(42).rand(4, 8, 8, 8).astype(np.float32)


def tiny_cnn(graph_cls, node_cls, seed: int = 0):
    """The reference serving tests' ``tiny_cnn_graph``: conv(8->16, 8x8) +
    relu + gap + fc, built with either side's IR classes."""
    rng = np.random.RandomState(seed)
    return graph_cls(
        "tiny_cnn", {"x": (None, 8, 8, 8)}, ["y"],
        [node_cls("c1", "conv2d", ["x", "c1.w"], "c1.y",
                  {"stride": 1, "padding": 1}),
         node_cls("c1.relu", "relu", ["c1.y"], "c1.r"),
         node_cls("gap", "global_avg_pool", ["c1.r"], "pooled"),
         node_cls("fc", "gemm", ["pooled", "fc.w"], "y")],
        {"c1.w": (rng.randn(3, 3, 8, 16) * 0.2).astype(np.float32),
         "fc.w": (rng.randn(16, 10) * 0.2).astype(np.float32)})


def _policy(cls, a_bits, w_bits):
    return cls(mode="serial", w_bits=w_bits, a_bits=a_bits, radix_bits=7)


def _jobs(stream):
    """Every field of every job, as the reference's artifact records it,
    plus its tile count and cycles."""
    return [dict(_encode_job(j), tile_ops=j.tile_ops, cycles=j.cycles)
            for j in stream.jobs]


def _report(rep):
    return (rep.makespan_cycles, rep.per_job_start, rep.per_job_end,
            rep.per_mvu_busy, rep.hart_free, rep.hpm.snapshot(),
            rep.utilization)


def _as_port_layers(layers):
    out = []
    for l in layers:
        cls = (tcm.ConvLayer if isinstance(l, jcm.ConvLayer)
               else tcm.LinearLayer)
        out.append(cls(**dataclasses.asdict(l)))
    return out


@pytest.fixture(scope="module")
def tiny_programs():
    """tiny_cnn at W2A2 and W2A8: the reference's Programs, each carried
    across with its codegen nodes, and the port's own compiles."""
    out = {}
    for ab in (2, 8):
        jp = j_compile_graph(tiny_cnn(JGraph, JNode), CALIB,
                             policy=_policy(JPolicy, ab, 2), backend="xla")
        record = {
            "graph_name": jp.graph_name, "input_name": jp.input_name,
            "output_name": jp.output_name,
            "steps": [{"name": s.name, "kind": s.kind,
                       "inputs": list(s.inputs), "output": s.output,
                       "attrs": _enc(dict(s.attrs))} for s in jp.steps],
            "params": {k: {n: np.asarray(a) for n, a in p.items()}
                       for k, p in jp.params.items()},
            "meta": _enc(dict(jp.meta)),
            "cost_nodes": _enc(list(jp.cost_nodes)),
        }
        carried = program_from_numpy(record, device="cpu")
        own = compile_graph(tiny_cnn(Graph, Node), CALIB,
                            policy=_policy(QuantPolicy, ab, 2),
                            device="cpu")
        out[ab] = (jp, carried, own)
    return out


# ----------------------------------------------------------------- lowering

@pytest.mark.parametrize("mode", ["pipelined", "distributed"])
@pytest.mark.parametrize("a_bits", [2, 8])
def test_to_command_stream_equals_reference(tiny_programs, mode, a_bits):
    """A Program carried across lowers to the reference's stream job for
    job; the port's own compile of the same graph gives the same jobs."""
    jp, carried, own = tiny_programs[a_bits]
    ref = _jobs(jp.to_command_stream(mode=mode))
    assert _jobs(carried.to_command_stream(mode=mode)) == ref
    assert _jobs(own.to_command_stream(mode=mode)) == ref
    assert own.per_layer_bits == jp.per_layer_bits == carried.per_layer_bits
    assert [dataclasses.asdict(c) for c in own.cost_nodes] == \
        [dataclasses.asdict(c) for c in jp.cost_nodes]
    assert isinstance(own.cost_nodes[0], LoweredConv)
    assert isinstance(own.cost_nodes[1], LoweredGemm)
    # generate() on the Program itself equals the method's stream
    assert _jobs(tcg.generate(carried, mode=mode)) == ref


def test_program_from_numpy_refuses_unknown_markers():
    record = {"graph_name": "g", "input_name": "x", "output_name": "y",
              "steps": [], "params": {},
              "cost_nodes": [{"__tile__": {"bm": 8}}]}
    with pytest.raises(ValueError, match="__tile__"):
        program_from_numpy(record, device="cpu")


def test_to_command_stream_verifies_under_the_gate(tiny_programs,
                                                   monkeypatch):
    """With REPRO_VERIFY set the stream is checked (one count per call);
    unset, the gated sites stay silent."""
    _, carried, _ = tiny_programs[2]
    analysis.reset_counters()
    monkeypatch.setenv("REPRO_VERIFY", "1")
    carried.to_command_stream()
    assert analysis.counters()["to_command_stream"] == 1
    monkeypatch.setenv("REPRO_VERIFY", "0")
    carried.to_command_stream()
    sites = analysis.GATED_SITES + analysis.UNGATED_SITES
    assert analysis.counters() == dict(dict.fromkeys(sites, 0),
                                       to_command_stream=1)


# -------------------------------------------------------------- controller

def _streams():
    """Both sides' streams: the full-width stablelm-1.6b decode-step stream
    the LM engine books, and ResNet9/CNV from the cost model's zoo, in
    both mapping modes."""
    jcfg = j_get_arch("stablelm-1.6b").full
    tcfg = get_arch("stablelm-1.6b").full
    out = [("stablelm-decode", decode_cost_stream(tcfg),
            j_decode_cost_stream(jcfg))]
    for name in ("RESNET9_CIFAR10", "CNV_CIFAR10"):
        jl = getattr(jcm, name)
        for mode in ("pipelined", "distributed"):
            out.append((f"{name}-{mode}",
                        tcg.generate(_as_port_layers(jl), mode=mode,
                                     a_bits=2, w_bits=2),
                        jcg.generate(jl, mode=mode, a_bits=2, w_bits=2)))
    return out


@pytest.mark.parametrize("i", range(5))
def test_controller_simulate_equals_reference(i):
    """SimReport field for field, HPM snapshot included: an idle fabric, a
    ``hart_free`` seed carried from the previous report, and
    ``cycle_scale``."""
    name, ts, js = _streams()[i]
    assert _jobs(ts) == _jobs(js), name
    tc, jc = BarrelController(), JController()
    for kw in ({}, {"cycle_scale": 4}, {"xfer_cycles_per_job": 16}):
        a, b = tc.simulate(ts, **kw), jc.simulate(js, **kw)
        assert _report(a) == _report(b), (name, kw)
        seeded = tc.simulate(ts, hart_free=a.hart_free, cycle_scale=3)
        assert _report(seeded) == _report(
            jc.simulate(js, hart_free=b.hart_free, cycle_scale=3))
        assert seeded.makespan_cycles > a.makespan_cycles
    with pytest.raises(ValueError, match="hart_free"):
        tc.simulate(ts, hart_free=[0])


def test_controller_execute_and_hpm_file_equal_reference():
    """The execute path dispatches in order and counts jobs in the HPM
    file; merged files, their Prometheus mirror and top tags agree."""
    _, ts, js = _streams()[1]
    seen = {"port": [], "ref": []}
    tc, jc = BarrelController(), JController()
    for side, ctl, kinds in (("port", tc, OpKind), ("ref", jc, JOpKind)):
        for op in ("conv2d", "xfer"):
            ctl.register(kinds(op),
                         lambda job, env, s=side: seen[s].append(job.tag))
    tm, jm = MetricsRegistry(), JRegistry()
    tf, jf = HPMCounterFile(8, metrics=tm), JHPMFile(8, metrics=jm)
    tc.execute(ts, {}, hpm=tf)
    jc.execute(js, {}, hpm=jf)
    assert seen["port"] == seen["ref"] and seen["port"]
    for k in (1, 5):
        tf.merge(tc.simulate(ts, cycle_scale=k).hpm)
        jf.merge(jc.simulate(js, cycle_scale=k).hpm)
    assert tf.snapshot() == jf.snapshot()
    assert tf.top_tags(4) == jf.top_tags(4)
    assert prometheus_text(tm) == j_prometheus_text(jm)
    with pytest.raises(ValueError, match="no hpm"):
        tf.record(dataclasses.replace(tc.simulate(ts), hpm=None), ts)


def test_controller_execute_refuses_out_of_order_stream():
    _, ts, _ = _streams()[1]
    bad = dataclasses.replace(ts, jobs=[ts.jobs[1], ts.jobs[0]]
                              + ts.jobs[2:])
    with pytest.raises(RuntimeError, match="scheduled before deps"):
        BarrelController().execute(bad, {})


# ---------------------------------------------------------------- verifier

def _broken(stream, i, **change):
    jobs = list(stream.jobs)
    jobs[i] = dataclasses.replace(jobs[i], **change)
    return dataclasses.replace(stream, jobs=jobs)


@pytest.mark.parametrize("case", [
    ("forward-dependency", 3, {"depends_on": (5,)}),
    ("duplicate-tag", 4, {"tag": "conv1"}),
    ("host-on-mvu", 0, {"mvu": 2}),
    ("precision-range", 3, {"a_bits": 9}),
    ("zero-size", 3, {"m_tiles": 0}),
])
def test_verify_stream_blames_like_the_reference(case):
    """Accepts what the reference accepts (with the same reconciliation
    report); on a broken stream raises the same check, blame and
    message."""
    _, i, change = case
    _, ts, js = _streams()[1]
    assert _report(verify_stream(ts)) == _report(j_verify_stream(js))
    assert _report(ts.verify()) == _report(js.verify())
    tb, jb = _broken(ts, i, **change), _broken(js, i, **change)
    with pytest.raises(StreamError) as te:
        verify_stream(tb)
    with pytest.raises(JStreamError) as je:
        j_verify_stream(jb)
    assert (te.value.check, te.value.blame, str(te.value)) == \
        (je.value.check, je.value.blame, str(je.value))
    assert isinstance(te.value, VerifyError)
    # a caller-chosen blame (the scheduler's admission site) wins
    with pytest.raises(StreamError, match=r"\[blame: admission of x\]"):
        verify_stream(tb, blame="admission of x")


def test_verify_stream_reconciles_cycle_scale():
    name, ts, js = _streams()[0]
    for kw in ({"cycle_scale": 7}, {"reconcile": False}):
        a, b = verify_stream(ts, **kw), j_verify_stream(js, **kw)
        assert (a is None) == (b is None)
        if a is not None:
            assert _report(a) == _report(b)


# ---------------------------------------------------------- fault tolerance

def test_failure_injector_equals_reference():
    t, j = FailureInjector(fail_at_steps=(2, 5)), JInjector(
        fail_at_steps=(2, 5))
    fired = {"port": [], "ref": []}
    for side, inj, exc in (("port", t, WorkerFailure),
                           ("ref", j, JWorkerFailure)):
        for step in (0, 2, 2, 5, 5, 7):
            try:
                inj.check(step)
            except exc as e:
                fired[side].append(str(e))
    assert fired["port"] == fired["ref"] == [
        "injected failure at step 2", "injected failure at step 5"]
    e = BankFailure("bank 1 lost", bank=1)
    assert isinstance(e, WorkerFailure) and e.bank == 1


# ------------------------------------------------------------ import scan

def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


def test_port_and_chip_smoke_import_no_jax_or_reference():
    """An AST scan (imports anywhere: top level, functions, try blocks) of
    every module under src/repro_torch and of chip_smoke.py."""
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "src", "repro_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 40
    scanned = {os.path.relpath(f, ROOT) for f in files}
    assert {os.path.join("src", "repro_torch", "models", "moe.py"),
            os.path.join("src", "repro_torch", "configs",
                         "deepseek_v2_lite_16b.py"),
            os.path.join("src", "repro_torch", "optim", "optimizer.py"),
            os.path.join("src", "repro_torch", "data", "pipeline.py"),
            os.path.join("src", "repro_torch", "runtime", "checkpoint.py"),
            os.path.join("src", "repro_torch", "launch", "train.py")
            } <= scanned
    bad = []
    for f in files:
        for line, mod in _imports(f):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "repro"):
                bad.append(f"{os.path.relpath(f, ROOT)}:{line}: {mod}")
    assert not bad, bad
    assert list(_imports(os.path.join(ROOT, "src", "repro_torch", "serving",
                                      "service.py")))   # the scan sees them
