"""The port's serving runtime against the JAX package: the registry (lazy
compile, packed-plane sharing, LRU eviction), the dynamic batcher, the
slot scheduler on the barrel controller, ``InferenceService`` (CNN
variants through the bucketed runner, the continuous LM engine as a
callable), the exporters, and the serving CLI, all on the CPU.

Inputs are made from seeds with numpy. Tolerances, each with its reason:

* Cycle counts, admissions, scheduler/HPM snapshots, registry counters,
  batcher order, error messages, Chrome traces of the same spans, LM
  tokens: exact — the same pure-Python or integer arithmetic.
* A service answer against the same Program run eagerly on the same
  padded batch (its micro-batch, as the trace records it, at its bucket):
  exact — the same float expressions at the same shapes.
* A service answer against the reference's ``prog(x)`` on a Program
  carried across: 2% of the largest logit, argmax equal, as
  ``tests/test_torch_slice.py`` states it for logits from images (float
  sums in another order can move a rare activation code).
"""

import _torch_threads  # noqa: F401  (first: caps torch's threads under xdist)

import collections
import gc
import io
import contextlib
import json
import os
import threading
import time
import urllib.request
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compiler import Graph as JGraph
from repro.compiler import Node as JNode
from repro.compiler.artifact import _enc
from repro.configs import get_arch as j_get_arch
from repro.launch.serve import GenRequest as JRequest
from repro.models import transformer as jt
from repro.models.layers import QuantPolicy as JPolicy
from repro.obs import Tracer as JTracer
from repro.obs import chrome_trace as j_chrome_trace
from repro.obs import format_trace_summary as j_format_trace_summary
from repro.obs import trace_summary as j_trace_summary
from repro.serving import ContinuousLMEngine as JEngine
from repro.serving import InferenceService as JService
from repro.serving import ModelRegistry as JRegistry
from repro.serving import SlotScheduler as JScheduler

from repro_torch.compiler import executor
from repro_torch.compiler.ir import Graph, Node
from repro_torch.compiler.lower import program_from_numpy
from repro_torch.configs import get_arch
from repro_torch.launch import serve
from repro_torch.launch.serve import GenRequest
from repro_torch.models.layers import QuantPolicy
from repro_torch.models.transformer import params_from_numpy
from repro_torch.obs import (Tracer, chrome_trace, format_trace_summary,
                             prometheus_text, start_metrics_server,
                             trace_summary)
from repro_torch.runtime.fault_tolerance import BankFailure
from repro_torch.serving import (ContinuousLMEngine, DynamicBatcher,
                                 InferenceService, ModelKey, ModelRegistry,
                                 QueueFull, Request, SlotScheduler)

CALIB = np.random.RandomState(42).rand(4, 8, 8, 8).astype(np.float32)
ARCH = "stablelm-1.6b"
STREAM_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "data", "resnet9_w2a2_stream.json")


def tiny_cnn(graph_cls=Graph, node_cls=Node, seed: int = 0):
    """The reference serving tests' ``tiny_cnn_graph``: conv(8->16, 8x8) +
    relu + gap + fc — the packed conv and the packed gemm."""
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


def policy(a_bits, w_bits, cls=QuantPolicy):
    return cls(mode="serial", w_bits=w_bits, a_bits=a_bits, radix_bits=7)


@pytest.fixture(scope="module")
def two_precision_registry():
    """One graph at W2A2 and W2A8 (same w_bits: packed planes must share)."""
    reg = ModelRegistry(device="cpu")
    g = tiny_cnn()
    k_lo = reg.register_graph("tiny", g, CALIB, policy(2, 2))
    k_hi = reg.register_graph("tiny", g, CALIB, policy(8, 2),
                              precision="W2A8")
    return reg, k_lo, k_hi


@pytest.fixture(scope="module")
def ref_registry():
    reg = JRegistry(backend="xla")
    g = tiny_cnn(JGraph, JNode)
    k_lo = reg.register_graph("tiny", g, CALIB, policy(2, 2, JPolicy))
    k_hi = reg.register_graph("tiny", g, CALIB, policy(8, 2, JPolicy),
                              precision="W2A8")
    return reg, k_lo, k_hi


# -------------------------------------------------------------- registry

def test_registry_lazy_compile_and_sharing():
    reg = ModelRegistry(device="cpu")
    g = tiny_cnn()
    k_lo = reg.register_graph("tiny", g, CALIB, policy(2, 2))
    k_hi = reg.register_graph("tiny", g, CALIB, policy(8, 2),
                              precision="W2A8")
    assert reg.stats()["compiles"] == 0            # nothing until first use
    assert reg.resident_program(k_lo) is None
    p_lo, p_hi = reg.program(k_lo), reg.program(k_hi)
    s = reg.stats()
    assert s["compiles"] == 2 and s["resident_programs"] == 2
    # both quantize weights at w_bits=2: the same packed tensors, once
    assert s["shared_arrays"] == 2
    for name in ("c1", "fc"):
        a, b = p_lo.params[name]["w_packed"], p_hi.params[name]["w_packed"]
        assert a is b and a.data_ptr() == b.data_ptr()
    assert s["shared_bytes"] == sum(
        p_lo.params[n]["w_packed"].numel() * 4 for n in ("c1", "fc"))
    assert s["pack_cache_entries"] == 2
    assert reg.program(k_lo) is p_lo and reg.stats()["compiles"] == 2
    assert reg.variants("tiny") == [k_lo, k_hi]
    assert str(k_hi) == "tiny@W2A8"


def test_registry_eviction_recompiles():
    reg = ModelRegistry(device="cpu", max_programs=1)
    g = tiny_cnn()
    k1 = reg.register_graph("tiny", g, CALIB, policy(2, 2))
    k2 = reg.register_graph("tiny", g, CALIB, policy(4, 2),
                            precision="W2A4")
    reg.program(k1)
    reg.program(k2)                      # evicts k1 (LRU, capacity 1)
    assert reg.stats()["evictions"] == 1
    assert reg.resident_program(k1) is None
    n = reg.stats()["compiles"]
    reg.program(k1)                      # transparently recompiles
    assert reg.stats()["compiles"] == n + 1
    pinned = reg.register_program("pinned", reg.program(k1),
                                  precision="W2A2")
    reg.program(k2)
    assert reg.resident_program(pinned) is not None


def test_registry_errors_equal_reference():
    """Duplicate and unknown keys, and a Program asked of an engine, raise
    the reference's errors with its messages."""
    msgs = []
    for reg, g, pol in ((ModelRegistry(device="cpu"), tiny_cnn(),
                         policy(2, 2)),
                        (JRegistry(), tiny_cnn(JGraph, JNode),
                         policy(2, 2, JPolicy))):
        got = []
        reg.register_graph("tiny", g, CALIB, pol)
        for fn, exc in (
                (lambda: reg.register_graph("tiny", g, CALIB, pol),
                 ValueError),
                (lambda: reg.entry(type(reg.keys()[0])("nope", "W2A2")),
                 KeyError),
                (lambda: reg.program(reg.register_callable(
                    "eng", lambda reqs: reqs)), TypeError)):
            with pytest.raises(exc) as ei:
                fn()
            got.append(str(ei.value))
        msgs.append(got)
    assert msgs[0] == msgs[1]


def test_registry_store_and_multi_bank_wait_for_their_modules():
    """Multi-bank serving came with distributed/program_parallel: the
    three entry points that refused ``n_banks > 1``/``mesh=``/``banks=``
    take them on CPU banks, and a placement is validated whatever
    ``n_banks`` is, as the reference's (the store's cases are positive
    tests in tests/test_torch_artifact.py; the multi-bank paths' own tests
    are in tests/test_torch_program_parallel.py)."""
    from repro_torch.distributed import program_parallel as pp
    reg = ModelRegistry(device="cpu")
    for kw in ({"n_banks": 2}, {"mesh": pp.bank_mesh(2, device="cpu")}):
        svc = InferenceService(reg, **kw)
        assert (svc.n_banks, svc.placement) == (2, "banked")
        assert svc.metrics()["banks"]["replica_cache"]["replicas"] == 0
    with pytest.raises(ValueError, match="placement"):
        InferenceService(reg, placement="nope")
    with serve.CNNServer(n_banks=2, placement="sharded",
                         device="cpu") as srv:
        assert srv.service.batcher.round_to == 2
    prog = reg.program(reg.register_graph("tiny", tiny_cnn(), CALIB,
                                          policy(2, 2)))
    run = executor.make_bucketed_runner(prog, max_batch=4,
                                        banks=["cpu", "cpu"])
    assert (run.n_banks, run.placement) == (2, "banked")
    with pytest.raises(ValueError, match="not both"):
        executor.make_bucketed_runner(prog, banks=["cpu"],
                                      mesh=pp.bank_mesh(1, device="cpu"))


# --------------------------------------------------------------- batcher

def _mk_req(key, payload=0.0, t=None):
    r = Request(key, payload)
    if t is not None:
        r.t_submit = t
    return r


def test_batcher_groups_oldest_first():
    ka, kb = ModelKey("a", "W2A2"), ModelKey("b", "W2A2")
    b = DynamicBatcher(max_batch=4, max_wait_s=0.0, max_queue=16)
    b.put(_mk_req(kb, t=1.0))
    for i in range(6):
        b.put(_mk_req(ka, payload=i, t=2.0 + i))
    mb = b.next_batch(timeout=0.1)
    assert mb.key == kb and mb.size == 1       # oldest head wins
    mb = b.next_batch(timeout=0.1)
    assert mb.key == ka and mb.size == 4       # capped at max_batch, FIFO
    assert [r.payload for r in mb.requests] == [0, 1, 2, 3]
    assert b.next_batch(timeout=0.1).size == 2
    assert b.next_batch(timeout=0.01) is None  # drained
    assert b.depth == 0 and b.batches == 3


def test_batcher_backpressure_and_flush():
    k = ModelKey("a", "W2A2")
    b = DynamicBatcher(max_batch=4, max_wait_s=0.0, max_queue=3)
    for _ in range(3):
        b.put(_mk_req(k))
    with pytest.raises(QueueFull):
        b.put(_mk_req(k), block=False)
    with pytest.raises(QueueFull):
        b.put(_mk_req(k), timeout=0.01)
    assert b.flush_pending(RuntimeError("shutdown")) == 3
    assert b.depth == 0


def test_batcher_timeout_binds_inside_window():
    """A long coalescing window must not override the caller's timeout."""
    k = ModelKey("a", "W2A2")
    b = DynamicBatcher(max_batch=8, max_wait_s=10.0, max_queue=8)
    b.put(_mk_req(k))
    t0 = time.perf_counter()
    assert b.next_batch(timeout=0.05) is None
    assert time.perf_counter() - t0 < 2.0
    assert b.depth == 1                       # request still queued


def test_batcher_close_rejects_puts():
    k = ModelKey("a", "W2A2")
    b = DynamicBatcher(max_batch=4, max_wait_s=0.0, max_queue=4)
    b.close()
    with pytest.raises(RuntimeError, match="closed"):
        b.put(_mk_req(k))
    b.reopen()
    b.put(_mk_req(k))
    assert b.depth == 1


def test_batcher_waits_out_coalescing_window():
    k = ModelKey("a", "W2A2")
    b = DynamicBatcher(max_batch=8, max_wait_s=0.15, max_queue=64)
    got = {}

    def consume():
        got["mb"] = b.next_batch(timeout=2.0)

    t = threading.Thread(target=consume)
    t.start()
    b.put(_mk_req(k))
    time.sleep(0.03)
    b.put(_mk_req(k))      # lands inside the window -> same micro-batch
    t.join(timeout=5)
    assert not t.is_alive()
    assert got["mb"].size == 2


# --------------------------------------------------------------- scheduler

def _admission(a):
    return (a.batch, a.start_cycle, a.finish_cycle, a.est_cycles,
            a.est_seconds, a.banks)


def test_scheduler_precision_scaling_and_utilization(two_precision_registry,
                                                     ref_registry):
    """The reference test's numbers, equal on both sides: W2A8 books more
    than twice W2A2's cycles, starts after it on the shared fabric, and
    the utilization, HPM files and metrics snapshots agree."""
    reg, k_lo, k_hi = two_precision_registry
    jreg, j_lo, j_hi = ref_registry
    port, ref = SlotScheduler(), JScheduler()
    for sched, r, lo, hi in ((port, reg, k_lo, k_hi),
                             (ref, jreg, j_lo, j_hi)):
        a_lo = sched.admit(lo, 4, program=r.program(lo))
        a_hi = sched.admit(hi, 4, program=r.program(hi))
        assert a_hi.est_cycles > 2 * a_lo.est_cycles
        assert a_hi.start_cycle >= a_lo.start_cycle
        sched.complete(a_hi, 0.5)
        m = sched.metrics()
        assert m["admitted_batches"] == 2 and m["admitted_requests"] == 8
        assert 0.0 < m["mean_busy_utilization"] <= 1.0
        assert all(0.0 <= u <= 1.0 for u in m["slot_utilization"])
        assert sched.admit(type(lo)("lm", "native"), 2) is None
    assert port.metrics() == ref.metrics()
    assert port.hpm() == ref.hpm()
    assert port.utilization() == ref.utilization()
    assert port.metrics()["unscheduled_batches"] == 1


@pytest.mark.parametrize("placement", ["banked", "sharded"])
def test_scheduler_banks_and_calibration_equal_reference(
        two_precision_registry, ref_registry, placement):
    """Cycle-domain banks need no second card: two banks, mixed
    precisions, a fitted ns-per-cycle model attached half way."""

    class Cal:
        def predict_wall_seconds(self, cycles):
            return cycles * 3e-9

        def ns_for(self):
            return 3.0

    reg, k_lo, k_hi = two_precision_registry
    jreg, j_lo, j_hi = ref_registry
    got = []
    for sched, r, keys in (
            (SlotScheduler(n_banks=2, placement=placement), reg,
             (k_lo, k_hi)),
            (JScheduler(n_banks=2, placement=placement), jreg,
             (j_lo, j_hi))):
        adm = []
        for i, n in enumerate((3, 8, 1, 5, 2, 7)):
            key = keys[i % 2]
            if i == 3:
                sched.set_calibration(Cal())
            adm.append(_admission(sched.admit(key, n,
                                              program=r.program(key))))
        got.append((adm, sched.metrics(), sched.bank_utilization()))
    assert got[0] == got[1]


def test_scheduler_verifies_admitted_streams(two_precision_registry,
                                             monkeypatch):
    from repro_torch import analysis
    reg, k_lo, _ = two_precision_registry
    analysis.reset_counters()
    monkeypatch.setenv("REPRO_VERIFY", "1")
    sched = SlotScheduler()
    sched.admit(k_lo, 2, program=reg.program(k_lo))
    sched.admit(k_lo, 2, program=reg.program(k_lo))   # cached: no recheck
    assert analysis.counters()["stream_admission"] == 1


# --------------------------------------------------------------- service

def served_batches(tracer):
    """The micro-batches a service ran, from its trace: trace ids that
    share one execute span, in submission (FIFO) order."""
    groups = collections.defaultdict(list)
    size = {}
    for s in tracer.spans():
        if s.name == "execute" and s.trace_id:
            groups[(s.t0_ns, s.t1_ns)].append(s.trace_id)
        if s.name == "queue" and s.trace_id:
            size[s.trace_id] = s.args["batch"]
    out = [sorted(ids) for _, ids in sorted(groups.items())]
    for ids in out:
        assert all(size[i] == len(ids) for i in ids)
    return out


def eager_at_bucket(prog, xs, max_batch):
    """The Program run eagerly on these rows padded with zeros to their
    bucket: what the service's answer must equal."""
    b = executor.bucket_for(len(xs), max_batch)
    x = np.zeros((b,) + xs[0].shape, np.float32)
    x[:len(xs)] = np.stack(xs)
    return prog(torch.from_numpy(x))[:len(xs)].numpy()


def test_service_mixed_precision_soak_bit_exact(two_precision_registry):
    """Interleaved requests across two precisions and several batch sizes
    through the service: every answer equals its variant's eager forward
    on its micro-batch at its bucket, nothing compiles after warmup, the
    scheduler booked every batch and the straggler saw every one."""
    reg, k_lo, k_hi = two_precision_registry
    progs = {k_lo: reg.program(k_lo), k_hi: reg.program(k_hi)}
    svc = InferenceService(reg, max_batch=8, max_wait_s=0.02)
    rng = np.random.RandomState(7)
    submitted = []                      # (key, payload, future)
    with svc:
        assert svc.warmup() == 2 * len(executor.bucket_sizes(8))
        warm = {k: v["compiles"]
                for k, v in svc.metrics()["bucket_caches"].items()}
        for i, n in enumerate([1, 3, 8, 6, 2, 5, 1, 4]):
            key = (k_lo, k_hi)[i % 2]
            xs = [rng.rand(8, 8, 8).astype(np.float32) for _ in range(n)]
            submitted += [(key, x, f)
                          for x, f in zip(xs, svc.submit_many(key, xs))]
            svc.drain(timeout=60)
        m = svc.metrics()
    by_id = {i + 1: s for i, s in enumerate(submitted)}
    for ids in served_batches(svc.tracer):
        key = by_id[ids[0]][0]
        assert all(by_id[i][0] == key for i in ids)
        want = eager_at_bucket(progs[key], [by_id[i][1] for i in ids], 8)
        got = np.stack([by_id[i][2].result() for i in ids])
        np.testing.assert_array_equal(got, want)
    assert m["completed"] == len(submitted) == 30 and m["failed"] == 0
    for k, st in m["bucket_caches"].items():
        assert st["compiles"] == warm[k] and st["hits"] > 0
    sched = m["scheduler"]
    assert sched["admitted_requests"] == 30
    assert sched["admitted_batches"] == m["batches"]
    assert sched["unscheduled_batches"] == 0 and sched["virtual_cycles"] > 0
    assert m["straggler"]["observed"] == m["batches"] > 0
    assert m["registry"]["shared_arrays"] == 2


def test_service_carried_program_agrees_with_reference():
    """The reference's W2A2 tiny_cnn Program, carried across and served:
    the answers agree with the reference's own ``prog(x)``."""
    jreg = JRegistry(backend="xla")
    jkey = jreg.register_graph("tiny", tiny_cnn(JGraph, JNode), CALIB,
                               policy(2, 2, JPolicy))
    jp = jreg.program(jkey)
    record = {"graph_name": jp.graph_name, "input_name": jp.input_name,
              "output_name": jp.output_name,
              "steps": [{"name": s.name, "kind": s.kind,
                         "inputs": list(s.inputs), "output": s.output,
                         "attrs": _enc(dict(s.attrs))} for s in jp.steps],
              "params": {k: {n: np.asarray(a) for n, a in p.items()}
                         for k, p in jp.params.items()},
              "meta": _enc(dict(jp.meta)),
              "cost_nodes": _enc(list(jp.cost_nodes))}
    reg = ModelRegistry(device="cpu")
    key = reg.register_program("tiny", program_from_numpy(record, "cpu"),
                               precision="W2A2")
    xs = np.random.RandomState(3).rand(6, 8, 8, 8).astype(np.float32)
    with InferenceService(reg, max_wait_s=0.0) as svc:
        got = np.stack([f.result() for f in svc.submit_many(key, list(xs))])
    want = np.asarray(jp(jnp.asarray(xs)))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=0.02 * np.abs(want).max())
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_service_backpressure_raises_queuefull():
    reg = ModelRegistry(device="cpu")
    gate = threading.Event()

    def slow_engine(reqs):
        gate.wait(timeout=10)
        return [0 for _ in reqs]

    key = reg.register_callable("slow", slow_engine)
    svc = InferenceService(reg, max_batch=1, max_wait_s=0.0, max_queue=3)
    with svc:
        svc.submit(key, None)
        deadline = time.perf_counter() + 5
        while time.perf_counter() < deadline:
            try:
                while True:
                    svc.submit(key, None, block=False)
            except QueueFull:
                break
        else:
            pytest.fail("queue never filled")
        with pytest.raises(QueueFull):
            svc.submit(key, None, block=False)
        gate.set()
        svc.drain(timeout=30)
    assert svc.metrics()["failed"] == 0


def test_submit_requires_started_service(two_precision_registry):
    reg, k_lo, _ = two_precision_registry
    svc = InferenceService(reg)
    with pytest.raises(RuntimeError, match="not started"):
        svc.submit(k_lo, np.zeros((8, 8, 8), np.float32))


@pytest.mark.parametrize("reg_plain,svc_plain,want", [
    (False, None, False), (True, None, True), (True, False, False),
    (False, True, True)])
def test_service_runner_takes_the_registrys_plain(reg_plain, svc_plain,
                                                  want):
    """Program variants run the kernels' plain versions when the registry
    says ``plain``; ``InferenceService(plain=)`` overrides it. The answer
    equals the chosen runner's on the same bucket."""
    reg = ModelRegistry(device="cpu", plain=reg_plain)
    key = reg.register_graph("tiny", tiny_cnn(), CALIB, policy(2, 2))
    x = np.random.RandomState(5).rand(1, 8, 8, 8).astype(np.float32)
    with InferenceService(reg, max_batch=1, max_wait_s=0.0,
                          plain=svc_plain) as svc:
        got = svc.submit(key, x[0]).result()
        runner = svc._runners[key]
    assert runner.plain is want
    prog = reg.program(key)
    run = executor.make_plain_runner if want else executor.make_runner
    np.testing.assert_array_equal(
        got, run(prog)(prog.params, torch.from_numpy(x))[0])


def test_service_releases_evicted_programs():
    """A served variant must not pin a Program the registry evicted: the
    runner (and any graphs it captured) is dropped, the variant rebuilds
    against the recompiled Program and stays bit-exact."""
    reg = ModelRegistry(device="cpu", max_programs=1)
    g = tiny_cnn()
    k1 = reg.register_graph("tiny", g, CALIB, policy(2, 2))
    k2 = reg.register_graph("tiny", g, CALIB, policy(4, 2),
                            precision="W2A4")
    x = np.random.RandomState(3).rand(8, 8, 8).astype(np.float32)
    svc = InferenceService(reg, max_batch=4, max_wait_s=0.0)
    with svc:
        y1 = svc.submit(k1, x).result()
        old = weakref.ref(svc._runners[k1])
        svc.submit(k2, x).result()            # evicts k1's Program
        assert reg.stats()["evictions"] == 1
        assert reg.resident_program(k1) is None
        n = reg.stats()["compiles"]
        y1_again = svc.submit(k1, x).result() # rebuild: recompile + rerun
        assert reg.stats()["compiles"] == n + 1
        np.testing.assert_array_equal(y1, y1_again)
        for key, runner in svc._runners.items():
            resident = reg.resident_program(key)
            assert resident is None or runner.program is resident
    gc.collect()
    assert old() is None                       # the old runner is freed


def test_metrics_safe_during_live_traffic():
    reg = ModelRegistry(device="cpu")
    key = reg.register_callable("fast", lambda reqs: [0 for _ in reqs],
                                max_batch=1)
    errs = []
    svc = InferenceService(reg, max_batch=1, max_wait_s=0.0)
    with svc:
        stop = threading.Event()

        def poll():
            while not stop.is_set():
                try:
                    svc.metrics()
                except Exception as e:  # noqa: BLE001
                    errs.append(e)
                    return

        t = threading.Thread(target=poll)
        t.start()
        for _ in range(300):
            svc.submit(key, None)
        svc.drain(timeout=60)
        stop.set()
        t.join(timeout=10)
        assert not t.is_alive()
    assert not errs, errs
    assert svc.metrics()["completed"] == 300


def test_service_straggler_wired():
    reg = ModelRegistry(device="cpu")
    delays = iter([0.0] * 10 + [0.3] + [0.0] * 3)

    def engine(reqs):
        time.sleep(next(delays, 0.0))
        return [0 for _ in reqs]

    key = reg.register_callable("jittery", engine, max_batch=1)
    svc = InferenceService(reg, max_batch=1, max_wait_s=0.0)
    with svc:
        for _ in range(14):
            svc.submit(key, None)
            svc.drain(timeout=30)
        snap = svc.metrics()["straggler"]
    assert snap["observed"] == 14
    assert snap["events"] >= 1, snap


@pytest.mark.parametrize("retries,fails", [(1, 1), (1, 99)])
def test_service_requeues_on_bank_failure(retries, fails):
    """A transient BankFailure requeues the micro-batch (bounded by
    max_retries); past the budget the request fails with it."""
    calls = {"n": 0}

    def flaky(reqs):
        calls["n"] += 1
        if calls["n"] <= fails:
            raise BankFailure("bank 0 dropped", bank=0)
        return [r + 1 for r in reqs]

    reg = ModelRegistry(device="cpu")
    key = reg.register_callable("flaky", flaky)
    svc = InferenceService(reg, max_wait_s=0.0, max_retries=retries)
    with svc:
        fut = svc.submit(key, 1.0)
        svc.drain(timeout=30)
    assert svc.requeues == 1
    if fails == 1:
        assert fut.result() == 2.0 and svc.failed == 0
    else:
        with pytest.raises(BankFailure):
            fut.result()
        assert svc.failed == 1
    assert svc.metrics_registry.get("service_requeues_total").value() == 1


def test_service_trace_and_exports(tmp_path):
    """A served callable with a command stream: four phases per request in
    both clock domains, the scheduler's hart rows, HPM reconciled with the
    busy clock, the Prometheus page (served over HTTP on 127.0.0.1) and
    the CLI's trace summary."""
    from repro_torch.core.cost_model import LinearLayer
    from repro_torch.core.codegen import generate
    stream = generate([LinearLayer("a", 64, 64), LinearLayer("b", 64, 32)])
    reg = ModelRegistry(device="cpu")
    key = reg.register_callable("eng", lambda reqs: [r * 2 for r in reqs],
                                stream=stream)
    svc = InferenceService(reg, max_wait_s=0.0)
    with svc:
        futs = svc.submit_many(key, [float(i) for i in range(4)])
        svc.drain(timeout=30)
        assert [f.result() for f in futs] == [0.0, 2.0, 4.0, 6.0]
    doc = chrome_trace(svc.tracer)
    ev = doc["traceEvents"]
    assert {"queue", "schedule", "execute", "finalize"} <= {
        e["name"] for e in ev if e["pid"] == "wall"}
    tracks = {e["tid"] for e in ev if e["pid"] == "virtual-cycles"}
    assert {"bank0/hart0", "bank0/hart1"} <= tracks
    rows = trace_summary(doc)
    assert len(rows) == 4 and all(r["cycles"] > 0 for r in rows)
    hpm = svc.scheduler.hpm()[0]
    assert [b + x for b, x in zip(hpm["busy"], hpm["xfer"])] == \
        svc.scheduler._busy[0]
    text = prometheus_text(svc.registries())
    assert "repro_service_completed_total 4" in text
    assert "repro_hpm_hart_cycles_total" in text
    t = start_metrics_server(0, svc.registries)
    try:
        port = t.server.server_address[1]
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metrics", timeout=5).read().decode()
        assert "repro_service_completed_total 4" in body
    finally:
        t.server.shutdown()
        t.server.server_close()


def test_chrome_trace_and_summary_equal_reference():
    """The same spans into either side's tracer export the same Chrome
    trace, summary rows and table."""
    docs = []
    for tracer_cls, export in ((Tracer, (chrome_trace, trace_summary,
                                         format_trace_summary)),
                               (JTracer, (j_chrome_trace, j_trace_summary,
                                          j_format_trace_summary))):
        tr = tracer_cls()
        us = 1000
        for total_q in (5, 50, 7):
            ctx = tr.start_trace(t_ns=0)
            t = 0
            for name, dur in zip(("queue", "schedule", "execute",
                                  "finalize"), (total_q, 2, 3, 1)):
                tr.span(ctx, name, t * us, (t + dur) * us,
                        cycle_start=0, cycle_end=100, track="w")
                t += dur
        tr.cycle_span("tiny@W2A2", 100, 600, track="bank0/hart1", batch=4)
        doc = export[0](tr)
        doc["otherData"]["tracer"] = None    # identical but for the class
        rows = export[1](doc, top_k=2)
        docs.append((json.dumps(doc, sort_keys=True), rows,
                     export[2](rows)))
    assert docs[0] == docs[1]


# ----------------------------------------------------- LM through service

@pytest.fixture(scope="module")
def lm_smoke():
    """The stablelm-1.6b smoke config on both sides with the reference's
    random parameters, packed."""
    jcfg = j_get_arch(ARCH).smoke
    tcfg = get_arch(ARCH).smoke
    params = jt.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jax.tree.map(np.asarray, jt.pack_params(params, jcfg))


def _mixed(cls, n=10):
    rng = np.random.RandomState(11)
    out = []
    for _ in range(n):
        k = int(rng.randint(1, 13))
        out.append(cls(rng.randint(0, 64, (k,)).astype(np.int32),
                       int(rng.randint(1, 17 - k))))
    return out


def test_lm_engine_through_service_equals_reference(lm_smoke):
    """The engine as a callable: every request's tokens equal the JAX
    engine's served through the JAX service; the scheduler books one
    admission per decode step; nothing compiles after the warmup."""
    jcfg, tcfg, packed = lm_smoke
    jeng = JEngine(jcfg, params=jax.tree.map(jnp.asarray, packed),
                   batch_slots=2, max_len=16, backend="xla")
    jeng.warmup()
    eng = ContinuousLMEngine(tcfg, params_from_numpy(packed, "cpu"),
                             batch_slots=2, max_len=16, device="cpu")
    eng.warmup()
    outs = {}
    for side, e, reg, svc_cls, req in (
            ("ref", jeng, JRegistry(), JService, JRequest),
            ("port", eng, ModelRegistry(device="cpu"), InferenceService,
             GenRequest)):
        key = reg.register_callable("lm", e, precision="W4A8")
        steps0 = e.decode_steps
        svc = svc_cls(reg, max_batch=16, max_wait_s=0.0)
        with svc:
            futs = svc.submit_many(key, _mixed(req))
            svc.drain(timeout=300)
            outs[side] = [f.result().out_tokens for f in futs]
            m = svc.metrics()
        if side == "port":
            sched = m["scheduler"]
            assert sched["admitted_batches"] == e.decode_steps - steps0 > 0
            assert sched["unscheduled_batches"] == 0
            em = m["engines"][str(key)]
            assert em["jit"]["recompiles_after_warmup"] == 0
            assert m["tokens_per_s"] == em["tokens_per_s"] > 0
            assert m["completed"] == 10 and m["queue_depth"] == 0
            decode = [s for s in svc.tracer.spans()
                      if s.track == "lm-decode"]
            assert len(decode) == sched["admitted_batches"]
    assert outs["port"] == outs["ref"]
    assert [len(t) for t in outs["port"]] == [r.max_new_tokens
                                             for r in _mixed(GenRequest)]


# ------------------------------------------------------------------- CLI

def _run_cli(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve.main(argv)
    return buf.getvalue()


def test_serve_cli_cnn_prints_reference_lines(tmp_path):
    """The CNN CLI classifies through the service and prints the
    reference CLI's lines — bucket caches and the cycle report (the
    reference's stream for ResNet9 W2A2) — and its trace summarizes."""
    trace = str(tmp_path / "trace.json")
    text = _run_cli(["--arch", "resnet9-cifar10", "--batch", "4",
                     "--device", "cpu", "--trace-out", trace])
    assert "classified 4 images in" in text and "img/s" in text
    assert "serving: p50=" in text and "bucket_caches={" in text
    with open(STREAM_FILE) as f:
        assert json.load(f)["summary"] in text
    assert f"-> {trace}" in text
    summary = _run_cli(["trace", trace, "--top-k", "3"])
    assert "total_ms" in summary and "queue_ms" in summary
    assert "tracer: 8/8 requests sampled" in summary


def test_serve_cli_lm_through_the_service():
    text = _run_cli(["--arch", ARCH, "--device", "cpu", "--smoke",
                     "--batch", "2", "--new-tokens", "3",
                     "--metrics-port", "0", "--metrics-every", "0.05"])
    assert "metrics: serving Prometheus text on http://127.0.0.1:" in text
    assert "generated 12 tokens over 8 requests" in text
    assert "recompiles_after_warmup=0" in text
    steps = int(text.split("decode_steps=")[1].split()[0])
    assert f"scheduler_steps={steps}" in text and steps > 0
    assert "sample:" in text
