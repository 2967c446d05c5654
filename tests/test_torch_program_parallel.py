"""The port's array scaling (``repro_torch.distributed.program_parallel``,
the bucketed runner's bank placements, the multi-bank service and CLI) on
four CPU banks, against the JAX package.

The reference's compiled ``tiny_mixed_cnn`` (both packages have it: packed
conv, packed conv, global pool, packed gemm) is carried across with
``program_from_numpy`` at W2A2 and W4A8. Every comparison with it is exact
(``array_equal``): each lowered step acts per example, so a shard, a
microbatch or a bank's micro-batch equals the reference's ``prog`` on the
same rows. The reference's own mesh paths need several jax devices (its
tests fake eight in a subprocess); here the pure functions
(``bucket_sizes``, ``bucket_for``, ``stage_partition``) are compared
directly, the reference's banked runner runs its four banks on the one
CPU device, and the port's sharded and pipelined paths are held against
the reference's single-device ``prog`` on each shard.
"""

import _torch_threads  # noqa: F401  (first: caps torch's threads under xdist)

import collections
import contextlib
import gc
import io
import types

import jax
import numpy as np
import pytest
import torch

from repro.compiler import bench_graphs as jgraphs
from repro.compiler import executor as jexec
from repro.compiler import lower as jlower
from repro.compiler.artifact import _enc
from repro.distributed import program_parallel as jpp
from repro.models.layers import QuantPolicy as JPolicy
from repro.serving import DynamicBatcher as JBatcher
from repro.serving import ModelKey as JKey
from repro.serving import Request as JRequest
from repro.serving import SlotScheduler as JScheduler

from repro_torch.compiler import executor
from repro_torch.compiler.lower import program_from_numpy
from repro_torch.distributed import program_parallel as pp
from repro_torch.launch import serve
from repro_torch.serving import (DynamicBatcher, InferenceService, ModelKey,
                                 ModelRegistry, Request, SlotScheduler)

N_BANKS = 4


def _record(prog):
    """A live JAX Program as the numpy record ``program_from_numpy`` reads,
    its code generator's nodes included (the scheduler books its stream)."""
    return {
        "graph_name": prog.graph_name, "input_name": prog.input_name,
        "output_name": prog.output_name,
        "steps": [{"name": s.name, "kind": s.kind, "inputs": list(s.inputs),
                   "output": s.output, "attrs": _enc(dict(s.attrs))}
                  for s in prog.steps],
        "params": {k: {n: np.asarray(a) for n, a in p.items()}
                   for k, p in prog.params.items()},
        "meta": _enc(dict(prog.meta)),
        "cost_nodes": _enc(list(prog.cost_nodes)),
    }


@pytest.fixture(scope="module")
def progs():
    """{precision: (reference Program, the port's carried copy)}."""
    g, calib = jgraphs.tiny_mixed_cnn()
    out = {}
    for label, (a, w) in (("W2A2", (2, 2)), ("W4A8", (8, 4))):
        jp = jlower.compile_graph(g, calib, policy=JPolicy(
            mode="serial", w_bits=w, a_bits=a, radix_bits=7))
        out[label] = (jp, program_from_numpy(_record(jp), device="cpu"))
    return out


def _images(n, seed):
    return np.random.RandomState(seed).rand(n, 8, 8, 8).astype(np.float32)


def _ref(jp, x):
    return np.asarray(jp(x))


def _padded(xs, b):
    x = np.zeros((b,) + xs.shape[1:], np.float32)
    x[:len(xs)] = xs
    return x


@pytest.fixture
def cpu_mesh():
    return pp.bank_mesh(N_BANKS, device="cpu")


# ------------------------------------------------------------- buckets

def test_bucket_sizes_and_bucket_for_equal_reference():
    for max_batch in range(1, 41):
        for multiple in range(1, 9):
            sizes = executor.bucket_sizes(max_batch, multiple)
            assert sizes == jexec.bucket_sizes(max_batch, multiple)
            for n in range(1, sizes[-1] + 1):
                assert (executor.bucket_for(n, max_batch, multiple)
                        == jexec.bucket_for(n, max_batch, multiple))
            with pytest.raises(ValueError, match="exceeds"):
                executor.bucket_for(sizes[-1] + 1, max_batch, multiple)
    for bad in ((8, 0), (0, 1)):
        with pytest.raises(ValueError) as mine:
            executor.bucket_sizes(*bad)
        with pytest.raises(ValueError) as theirs:
            jexec.bucket_sizes(*bad)
        assert str(mine.value) == str(theirs.value)


# ----------------------------------------------------- stage partition

def _residual_program(ns):
    """A step list whose residual interior admits no cut: x -> a -> b,
    c = a + b, d, y (cuts valid after a, c and d only)."""
    steps = [ns(name="s0", kind="conv_packed", inputs=("x",), output="a"),
             ns(name="s1", kind="conv_packed", inputs=("a",), output="b"),
             ns(name="s2", kind="add", inputs=("a", "b"), output="c"),
             ns(name="s3", kind="host_conv", inputs=("c",), output="d"),
             ns(name="s4", kind="gemm_packed", inputs=("d",), output="y")]
    return ns(graph_name="residual", steps=tuple(steps), input_name="x",
              output_name="y")


@pytest.mark.parametrize("which", ["tiny_mixed_cnn", "residual"])
def test_stage_partition_equals_reference(progs, which):
    """Bounds and boundary names for 1..4 stages, and every validation
    error, word for word."""
    if which == "residual":
        prog = jprog = _residual_program(types.SimpleNamespace)
    else:
        jprog, prog = progs["W2A2"]
    n_steps = len(prog.steps)
    for n in range(0, n_steps + 2):
        try:
            want = jpp.stage_partition(jprog, n)
        except ValueError as e:
            with pytest.raises(ValueError) as mine:
                pp.stage_partition(prog, n)
            assert str(mine.value) == str(e)
            continue
        assert pp.stage_partition(prog, n) == want
    if which == "residual":
        assert pp.stage_partition(prog, 4)[0] == [(0, 1), (1, 3), (3, 4),
                                                  (4, 5)]
        with pytest.raises(ValueError, match="only 3 valid"):
            pp.stage_partition(prog, 5)


# ------------------------------------------------------------ banks

def test_bank_devices_and_meshes():
    banks = pp.bank_devices(N_BANKS, device="cpu")
    assert [b.index for b in banks] == list(range(N_BANKS))
    assert all(b.device == torch.device("cpu") and b.stream is None
               for b in banks)
    assert pp.bank_devices(2, banks) == banks[:2]     # Banks pass through
    mesh = pp.bank_mesh(3, devices=["cpu"])           # round-robin
    assert mesh.shape == {pp.BANK_AXIS: 3} and len(mesh) == 3
    assert mesh.axis_names == (pp.BANK_AXIS,)
    with pytest.raises(ValueError, match="at least 1 bank"):
        pp.bank_devices(0, device="cpu")
    with pytest.raises(ValueError, match="only 2 bank"):
        pp.bank_devices(3, banks[:2])
    with pytest.raises(ValueError, match="'bank' axis"):
        pp.ShardedProgram(None, {"data": 2})


def test_bank_devices_raise_without_a_card(monkeypatch):
    """No card and no ``device="cpu"``: raise, never carry on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: pp.bank_devices(4), lambda: pp.bank_mesh(4),
                 lambda: serve.CNNServer(n_banks=4)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_replica_cache_dedups_and_releases():
    """A copy per (source, device), shared by every later request; a
    tensor on its own device is its own replica; entries die with their
    sources. ``meta`` is the second placement."""
    cache = pp.ReplicaCache()
    meta = torch.device("meta")
    a = torch.arange(128, dtype=torch.float32)
    r1 = cache.replicate(a, meta)
    r2 = cache.replicate(a, meta)                     # same source: a hit
    assert r1 is r2 and r1.device == meta and r1.shape == a.shape
    st = cache.stats()
    assert (st["replicas"], st["shared"], st["entries"]) == (1, 1, 1)
    assert st["shared_bytes"] == a.numel() * a.element_size()
    b = torch.arange(128, dtype=torch.float32)        # equal, new identity
    assert cache.replicate(b, meta) is not r1
    assert cache.stats()["replicas"] == 2
    assert cache.replicate(a, "cpu") is a             # its own replica
    st = cache.stats()
    assert st["replicas"] == 2 and st["shared"] == 2 and st["entries"] == 2
    tree = {"c": {"w_packed": a, "scale": b}}
    placed = pp.replicate_params(tree, meta, cache=cache)
    assert placed["c"]["w_packed"] is r1 and cache.stats()["replicas"] == 2
    del a, b, tree
    gc.collect()
    assert cache.stats()["entries"] == 0
    del r1, r2, placed


# ----------------------------------------- sharded and pipelined Programs

def test_sharded_program_equals_reference_per_shard(progs, cpu_mesh):
    """Each bank's shard equals the reference's ``prog`` on those rows and
    the port's single-bank forward; an indivisible batch raises."""
    jp, prog = progs["W2A2"]
    x = _images(16, 1)
    sp = pp.ShardedProgram(prog, cpu_mesh)
    assert sp.n_banks == N_BANKS
    got = sp(x).numpy()
    s = len(x) // N_BANKS
    for i in range(N_BANKS):
        np.testing.assert_array_equal(got[i * s:(i + 1) * s],
                                      _ref(jp, x[i * s:(i + 1) * s]))
    np.testing.assert_array_equal(got, prog(torch.from_numpy(x)).numpy())
    with pytest.raises(ValueError, match="does not divide"):
        sp(x[:6])


@pytest.mark.parametrize("n_stages,n_microbatches", [(2, 4), (3, 2), (4, 4),
                                                     (4, None)])
def test_pipelined_program_equals_reference_per_microbatch(
        progs, n_stages, n_microbatches):
    jp, prog = progs["W4A8"]
    x = _images(16, 2)
    pl = pp.PipelinedProgram(prog, n_stages=n_stages, devices=["cpu"])
    assert len(pl.banks) == n_stages
    assert pl.stage_bounds == jpp.stage_partition(jp, n_stages)[0]
    got = pl(x, n_microbatches=n_microbatches).numpy()
    mb = len(x) // (n_microbatches or n_stages)
    for m in range(0, len(x), mb):
        np.testing.assert_array_equal(got[m:m + mb], _ref(jp, x[m:m + mb]))
    np.testing.assert_array_equal(got, prog(torch.from_numpy(x)).numpy())
    with pytest.raises(ValueError, match="not divisible"):
        pl(x, n_microbatches=5)


# --------------------------------------------- the bucketed runner's banks

def test_banked_runner_equals_reference_runner(progs):
    """The reference's banked runner (four banks on its one CPU device) and
    the port's on four CPU banks: the same (bank, bucket) compiles and
    hits, and the same answers on every bank."""
    jp, prog = progs["W2A2"]
    jrun = jexec.make_bucketed_runner(jp, max_batch=8,
                                      banks=[jax.devices()[0]] * N_BANKS)
    run = executor.make_bucketed_runner(
        prog, max_batch=8, banks=pp.bank_devices(N_BANKS, device="cpu"))
    assert run.warmup() == jrun.warmup() == N_BANKS * 4
    x = _images(8, 3)
    for i, n in enumerate((1, 3, 5, 8, 2)):
        bank = i % N_BANKS
        np.testing.assert_array_equal(run(x[:n], bank=bank).numpy(),
                                      np.asarray(jrun(x[:n], bank=bank)))
    st, jst = run.stats(), jrun.stats()
    for key in ("compiles", "hits", "buckets", "bucket_set", "n_banks",
                "placement"):
        assert st[key] == jst[key], key
    with pytest.raises(ValueError, match="out of range"):
        run(x[:1], bank=N_BANKS)


def test_sharded_runner_buckets_and_answers(progs, cpu_mesh):
    """``mesh=``: buckets are multiples of the bank count (one key each, as
    the reference's), and each answer equals the reference's ``prog`` on
    its padded rows."""
    jp, prog = progs["W2A2"]
    run = executor.make_bucketed_runner(prog, max_batch=12, mesh=cpu_mesh)
    assert run.placement == "sharded" and run.n_banks == N_BANKS
    assert run.warmup() == len(jexec.bucket_sizes(12, N_BANKS)) == 3
    x = _images(12, 4)
    for n in (1, 5, 12):
        b = executor.bucket_for(n, 12, N_BANKS)
        np.testing.assert_array_equal(run(x[:n]).numpy(),
                                      _ref(jp, _padded(x[:n], b))[:n])
    st = run.stats()
    assert st["bucket_set"] == [4, 8, 12] and st["hits"] == 3
    with pytest.raises(ValueError, match="out of range"):
        run(x[:1], bank=1)


# ------------------------------------------- scheduler and batcher at 4

@pytest.mark.parametrize("placement", ["banked", "sharded"])
def test_scheduler_on_four_banks_equals_reference(progs, placement):
    """The same admissions (both precisions, batches of 1 to 16) on four
    cycle-domain banks: every admission (bank, cycles) and the metrics
    (bank utilization and requests, 32 slots, HPM files) equal the
    reference's; sharded books each bank ``batch / 4``."""
    got = []
    for sched, key_cls, side in ((SlotScheduler, ModelKey, 1),
                                 (JScheduler, JKey, 0)):
        s = sched(n_banks=N_BANKS, placement=placement)
        adm = []
        for i, n in enumerate((1, 3, 16, 6, 2, 8, 5, 16)):
            label = ("W2A2", "W4A8")[i % 2]
            a = s.admit(key_cls("tiny", label), n,
                        program=progs[label][side])
            adm.append((a.batch, a.banks, a.start_cycle, a.finish_cycle,
                        a.est_cycles))
        m = s.metrics()
        assert len(m["slot_utilization"]) == 8 * N_BANKS
        got.append((adm, m))
    assert got[0] == got[1]
    adm, m = got[0]
    if placement == "sharded":
        assert all(banks == tuple(range(min(n, N_BANKS)))
                   for n, banks, *_ in adm)
        assert m["bank_requests"] == [17, 15, 13, 12]     # divmod splits
    else:
        assert sorted({b for _, (b,), *_ in adm}) == list(range(N_BANKS))
    assert sum(m["bank_requests"]) == 57


def test_batcher_rounds_takes_to_the_bank_count_as_the_reference():
    """``round_to=4``: 11 waiting requests ship as 8 then 3, on both
    sides."""
    sizes = []
    for cls, req, key in ((DynamicBatcher, Request, ModelKey("a", "W2A2")),
                          (JBatcher, JRequest, JKey("a", "W2A2"))):
        b = cls(max_batch=16, max_wait_s=0.0, max_queue=32, round_to=4)
        for _ in range(11):
            b.put(req(key, 0.0))
        sizes.append([b.next_batch(timeout=0.1).size for _ in range(2)])
    assert sizes == [[8, 3], [8, 3]]


# ----------------------------------------------------- the service soak

def _served(tracer):
    """The micro-batches a service ran, from its trace: trace ids sharing
    one execute span, in submission order."""
    groups = collections.defaultdict(list)
    for s in tracer.spans():
        if s.name == "execute" and s.trace_id:
            groups[(s.t0_ns, s.t1_ns)].append(s.trace_id)
    return [sorted(ids) for _, ids in sorted(groups.items())]


@pytest.mark.parametrize("placement", ["banked", "sharded"])
def test_service_soak_on_four_banks(progs, placement):
    """Interleaved W2A2/W4A8 requests of 1, 3, 16 and 6 images, twice
    over, through ``InferenceService(n_banks=4)`` (the reference's soak at
    a little under half its 120 requests): every answer equals the reference's
    ``prog`` and the port's single-bank forward on its micro-batch at its
    bucket, nothing compiles after warmup, every bank is booked, and the
    metrics carry the banks."""
    reg = ModelRegistry(device="cpu")
    keys = {label: reg.register_program("tiny", prog, precision=label)
            for label, (_, prog) in progs.items()}
    multiple = N_BANKS if placement == "sharded" else 1
    svc = InferenceService(reg, max_batch=16, max_wait_s=0.02,
                           n_banks=N_BANKS, placement=placement)
    assert svc.batcher.round_to == multiple
    rng = np.random.RandomState(7)
    submitted = []
    with svc:
        svc.warmup()
        warm = {k: v["compiles"]
                for k, v in svc.metrics()["bucket_caches"].items()}
        i = 0
        while len(submitted) < 48:
            label = ("W2A2", "W4A8")[i % 2]
            xs = [rng.rand(8, 8, 8).astype(np.float32)
                  for _ in range((1, 3, 16, 6)[i % 4])]
            submitted += [(label, x, f) for x, f in
                          zip(xs, svc.submit_many(keys[label], xs))]
            svc.drain(timeout=60)
            i += 1
        m = svc.metrics()
    by_id = {i + 1: s for i, s in enumerate(submitted)}
    for ids in _served(svc.tracer):
        label = by_id[ids[0]][0]
        assert all(by_id[i][0] == label for i in ids)
        jp, prog = progs[label]
        xb = _padded(np.stack([by_id[i][1] for i in ids]),
                     executor.bucket_for(len(ids), 16, multiple))
        got = np.stack([by_id[i][2].result() for i in ids])
        np.testing.assert_array_equal(got, _ref(jp, xb)[:len(ids)])
        np.testing.assert_array_equal(
            got, prog(torch.from_numpy(xb)).numpy()[:len(ids)])
    assert m["completed"] == len(submitted) == 52 and m["failed"] == 0
    for k, st in m["bucket_caches"].items():
        assert st["compiles"] == warm[k] and st["hits"] > 0
        assert st["n_banks"] == N_BANKS and st["placement"] == placement
    sched = m["scheduler"]
    assert sched["n_banks"] == N_BANKS and sched["placement"] == placement
    assert all(r > 0 for r in sched["bank_requests"]), sched
    assert all(u > 0.01 for u in sched["bank_utilization"]), sched
    assert len(sched["slot_utilization"]) == 8 * N_BANKS
    banks = m["banks"]
    assert (banks["n_banks"], banks["placement"]) == (N_BANKS, placement)
    rc = banks["replica_cache"]
    assert rc["replicas"] == 0 and rc["shared"] > 0     # one device


def test_serve_cli_cnn_on_four_banks(monkeypatch):
    """``--banks 4 --placement sharded`` prints the reference's bank lines
    (the server's largest bucket cut to 8 to keep the CPU run short: the
    CLI warms every bucket); a placement without ``--banks`` prints its
    note before the server is built."""
    import functools

    def cli(argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            serve.main(argv)
        return buf.getvalue()

    monkeypatch.setattr(serve, "CNNServer",
                        functools.partial(serve.CNNServer, max_batch=8))
    text = cli(["--arch", "resnet9-cifar10", "--batch", "8", "--device",
                "cpu", "--banks", str(N_BANKS), "--placement", "sharded"])
    assert f"serving across {N_BANKS} MVU banks (placement=sharded)" in text
    assert "classified 8 images in" in text
    assert "banks: util=[" in text and "replica_cache={" in text

    class Built(Exception):
        pass

    def refuse(**kw):
        raise Built(kw)

    monkeypatch.setattr(serve, "CNNServer", refuse)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), pytest.raises(Built) as built:
        serve.main(["--arch", "resnet9-cifar10", "--device", "cpu",
                    "--placement", "sharded"])
    assert ("note: --placement sharded has no effect without --banks N "
            "(serving single-device)") in buf.getvalue()
    assert built.value.args[0]["n_banks"] is None
