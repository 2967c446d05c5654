"""The port's continuous-batching LM engine and the modules it needs, on the
CPU against the JAX package: per-row KV positions (``update_kv_cache``,
``_sdpa_full``, ``prefill(last_pos=)``, ``decode_step`` with a (B,)
``pos``), ``ContinuousLMEngine`` on the reference test's 12 mixed requests,
its scheduler booking and tracing, the cycle model it books
(``core/mvu``, ``core/cost_model``, ``core/codegen``,
``decode_cost_stream``), the straggler detector and the metrics registry's
Prometheus text.

The LM runs at the 2-layer ``stablelm-1.6b`` smoke config with the
reference's random parameters carried across by ``params_from_numpy``; the
reference runs with ``backend="xla"`` (its plain path).

Tolerances, each with its reason:

* KV cache writes, greedy tokens, command-stream jobs, cycle counts,
  frames per second, packed weight words, straggler flags and the text
  exposition: exact — the same integer arithmetic, the same tokens, the
  same pure-Python model.
* Attention outputs and logits (float32): 1e-4 of the largest value, as
  ``tests/test_torch_lm.py`` states it (float32 ulps of the softmax and
  norms, which can move an 8-bit activation code), with equal argmax.
"""

import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.core import codegen as jcg
from repro.core import cost_model as jcm
from repro.core import mvu as jmvu
from repro.launch.serve import GenRequest as JRequest
from repro.models import attention as jattn
from repro.models import transformer as jt
from repro.obs.export import prometheus_text as j_prometheus_text
from repro.obs.metrics import MetricsRegistry as JRegistry
from repro.runtime.straggler import StragglerDetector as JStraggler
from repro.serving import ContinuousLMEngine as JEngine
from repro.serving import decode_cost_stream as j_decode_cost_stream

from repro_torch.configs import get_arch
from repro_torch.core import codegen as tcg
from repro_torch.core import cost_model as tcm
from repro_torch.core import mvu as tmvu
from repro_torch.launch.serve import GenRequest, Server
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as tt
from repro_torch.models.transformer import params_from_numpy
from repro_torch.obs import MetricsRegistry, Tracer, prometheus_text
from repro_torch.runtime.straggler import StragglerDetector
from repro_torch.serving import (ContinuousLMEngine, decode_cost_stream,
                                 supports_continuous)

ARCH = "stablelm-1.6b"
SLOTS, MAX_LEN = 2, 16


def _t(a):
    return params_from_numpy(a, "cpu")


def _close(got, ref, rel=1e-4):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0,
                               atol=rel * np.abs(ref).max())


@pytest.fixture(scope="module")
def smoke():
    """The smoke config (both sides) and the reference's random params,
    packed (numpy)."""
    jcfg = j_get_arch(ARCH).smoke
    tcfg = get_arch(ARCH).smoke
    params = jt.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jax.tree.map(np.asarray, jt.pack_params(params, jcfg))


def _mixed_requests(cls):
    """The reference test's 12 mixed requests (tests/test_serving.py)."""
    rng = np.random.RandomState(11)
    reqs = []
    for _ in range(12):
        n = int(rng.randint(1, 13))
        m = int(rng.randint(1, 17 - n))
        reqs.append(cls(rng.randint(0, 64, (n,)).astype(np.int32), m))
    return reqs


@pytest.fixture(scope="module")
def jengine(smoke):
    jcfg, _, packed = smoke
    eng = JEngine(jcfg, params=jax.tree.map(jnp.asarray, packed),
                  batch_slots=SLOTS, max_len=MAX_LEN, backend="xla")
    eng.warmup()
    return eng


@pytest.fixture(scope="module")
def engines(smoke):
    """The port's engine on both paths (K1 + K3 and K4), warmed up."""
    _, tcfg, packed = smoke
    out = {}
    for pa in (True, False):
        eng = ContinuousLMEngine(tcfg, _t(packed), batch_slots=SLOTS,
                                 max_len=MAX_LEN, pack_acts=pa, device="cpu")
        eng.warmup()
        out[pa] = eng
    return out


# ------------------------------------------------------ per-row positions

@pytest.mark.parametrize("s", [1, 3])
def test_update_kv_cache_per_row_equals_reference(s):
    """Every row written at its own depth, in place; a start past
    ``T - S`` clamps as ``dynamic_update_slice`` does. Exact."""
    rng = np.random.default_rng(s)
    b, t, h, d = 3, 8, 2, 4
    k0 = rng.standard_normal((b, t, h, d)).astype(np.float32)
    v0 = rng.standard_normal((b, t, h, d)).astype(np.float32)
    kn = rng.standard_normal((b, s, h, d)).astype(np.float32)
    vn = rng.standard_normal((b, s, h, d)).astype(np.float32)
    pos = np.array([0, 3, t - 1], np.int32)      # the last row clamps at S=3
    ref = jattn.update_kv_cache({"k": jnp.asarray(k0), "v": jnp.asarray(v0),
                                 "len": jnp.zeros((), jnp.int32)},
                                jnp.asarray(kn), jnp.asarray(vn),
                                jnp.asarray(pos))
    cache = {"k": torch.from_numpy(k0.copy()),
             "v": torch.from_numpy(v0.copy()), "len": 0}
    k_buf = cache["k"]
    got = tattn.update_kv_cache(cache, torch.from_numpy(kn),
                                torch.from_numpy(vn), torch.from_numpy(pos))
    assert got["k"] is k_buf                     # written in place
    np.testing.assert_array_equal(got["k"].numpy(), np.asarray(ref["k"]))
    np.testing.assert_array_equal(got["v"].numpy(), np.asarray(ref["v"]))
    np.testing.assert_array_equal(got["len"].numpy(), np.asarray(ref["len"]))


def test_sdpa_per_row_q_offset_equals_reference():
    rng = np.random.default_rng(7)
    b, sq, sk, h, hkv, d = 3, 2, 10, 4, 2, 8
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, hkv, d)).astype(np.float32)
    off = np.array([0, 4, 8], np.int32)
    ref = jattn._sdpa_full(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           causal=True, window=None,
                           q_offset=jnp.asarray(off))
    got = tattn._sdpa_full(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), causal=True,
                           q_offset=torch.from_numpy(off))
    _close(got, ref)
    # a row at offset 0 with one query sees only key 0: its output is v[0]
    np.testing.assert_allclose(got[0, 0].numpy(),
                               np.repeat(v[0, 0], h // hkv, axis=0),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("pack_acts", [True, False])
def test_prefill_last_pos_and_per_row_decode_equal_reference(smoke,
                                                             pack_acts):
    """Right-padded prompts of 3, 7 and 5 tokens: ``prefill(last_pos=)``
    gathers each row's logits at its last real token, then ``decode_step``
    advances each row at its own position."""
    jcfg, tcfg, packed = smoke
    jcfg = jt.serve_policy(jcfg, pack_acts=pack_acts)
    tcfg = tt.serve_policy(tcfg, pack_acts=pack_acts)
    lens = np.array([3, 7, 5], np.int32)
    toks = np.random.default_rng(8).integers(0, 512, (3, 8)).astype(np.int32)
    for i, n in enumerate(lens):
        toks[i, n:] = 0
    jlog, jc = jt.prefill(packed, {"tokens": jnp.asarray(toks)}, jcfg,
                          max_len=12, last_pos=jnp.asarray(lens - 1))
    tp = _t(packed)
    tlog, tc = tt.prefill(tp, {"tokens": torch.from_numpy(toks).long()},
                          tcfg, max_len=12,
                          last_pos=torch.from_numpy(lens - 1).long())
    _close(tlog, jlog)
    nxt = np.asarray(jnp.argmax(jlog, -1)).astype(np.int32)[:, None]
    np.testing.assert_array_equal(
        torch.argmax(tlog, -1).numpy()[:, None], nxt)
    jlog2, _ = jt.decode_step(packed, jc, jnp.asarray(nxt),
                              jnp.asarray(lens), jcfg)
    tlog2, tc = tt.decode_step(tp, tc, torch.from_numpy(nxt),
                               torch.from_numpy(lens), tcfg)
    _close(tlog2, jlog2)
    np.testing.assert_array_equal(torch.argmax(tlog2, -1).numpy(),
                                  np.asarray(jnp.argmax(jlog2, -1)))
    np.testing.assert_array_equal(tc[0]["len"].numpy(), lens + 1)


# ---------------------------------------------------------------- engine

@pytest.mark.parametrize("pack_acts", [True, False])
def test_engine_equals_reference_engine_and_static_server(
        smoke, jengine, engines, pack_acts):
    """Token-granular join/leave changes no request's greedy output: the
    port's engine equals the reference's engine and the port's 1-slot
    static server, request by request, with nothing compiled after the
    warmup. A stale token column (the step's buffer handed on instead of
    a copy) would give finished requests another step's tokens."""
    _, tcfg, packed = smoke
    eng = engines[pack_acts]
    ref = [r.out_tokens for r in jengine.serve(_mixed_requests(JRequest))]
    out = eng.serve(_mixed_requests(GenRequest))
    got = [r.out_tokens for r in out]
    assert [len(t) for t in got] == [r.max_new_tokens for r in out]
    assert got == ref
    solo = Server(tcfg, _t(packed), batch_slots=1, max_len=MAX_LEN,
                  pack_acts=pack_acts, device="cpu")
    for r in out:
        one = solo.generate([GenRequest(r.prompt.copy(),
                                        r.max_new_tokens)])[0]
        assert r.out_tokens == one.out_tokens, (len(r.prompt),
                                                r.max_new_tokens)
    st = eng.stats()
    assert st["recompiles_after_warmup"] == 0
    assert st["compiles"] == {"prefill": 5, "insert": 1, "decode": 1}
    assert not st["cuda_graph"]
    assert st["step_launches"] == {"K1": 0, "K3": 0, "K4": 0}
    assert eng.engine_metrics()["slot_occupancy"] > 0.5


def test_engine_validates_budget(engines):
    eng = engines[True]
    with pytest.raises(ValueError, match="KV budget"):
        eng.serve([GenRequest(np.arange(10, dtype=np.int32), 7)])
    with pytest.raises(ValueError, match="empty prompt"):
        eng.serve([GenRequest(np.zeros(0, np.int32), 2)])
    with pytest.raises(ValueError, match="max_new_tokens=-1 < 0"):
        eng.serve([GenRequest(np.arange(3, dtype=np.int32), -1)])


def test_engine_zero_and_one_token(engines):
    """``max_new_tokens=0`` never occupies a slot; ``=1`` frees its slot at
    the insert boundary (no decode step)."""
    eng = engines[True]
    steps0 = eng.decode_steps
    out = eng.serve([GenRequest(np.arange(3, dtype=np.int32), 0),
                     GenRequest(np.arange(3, dtype=np.int32), 1)])
    assert out[0].out_tokens == []
    assert len(out[1].out_tokens) == 1
    assert eng.decode_steps == steps0


def test_engine_rejects_what_the_port_cannot_host(smoke, monkeypatch):
    """Families and activations the port has not got take the reference's
    "static Server path" error, not ``layer_groups``'
    NotImplementedError; a missing card raises instead of running on the
    CPU."""
    _, tcfg, _ = smoke
    for cfg in (dataclasses.replace(tcfg, family="ssm"),
                dataclasses.replace(tcfg, family="moe"),
                dataclasses.replace(tcfg, act="gelu")):
        assert not supports_continuous(cfg)
        with pytest.raises(ValueError, match="static Server path"):
            ContinuousLMEngine(cfg, batch_slots=2, max_len=16, device="cpu")
    assert supports_continuous(tcfg)
    with pytest.raises(NotImplementedError, match="LSQ"):
        ContinuousLMEngine(tcfg, quantized=False, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ContinuousLMEngine(tcfg)


@dataclasses.dataclass
class _Admission:
    est_cycles: int
    est_seconds: float
    start_cycle: int
    finish_cycle: int


class _RecordingScheduler:
    """The scheduler surface the engine books: ``admit`` then
    ``complete``, one pair per decode step."""

    def __init__(self):
        self.admits, self.completed, self.clock = [], 0, 0

    def admit(self, key, n_active, *, stream):
        cyc = stream.total_cycles_pipelined() * n_active
        self.admits.append((key, n_active, len(stream.jobs)))
        adm = _Admission(cyc, cyc / 250e6, self.clock, self.clock + cyc)
        self.clock += cyc
        return adm

    def complete(self, adm, seconds):
        self.completed += 1


def test_engine_books_scheduler_and_tracer_per_step(smoke):
    """One admission per decode step, sized by its active slots — the same
    sequence the reference's engine books on the same requests — and one
    ``lm-decode`` span per step carrying the booked cycles."""
    jcfg, tcfg, packed = smoke
    reqs = _mixed_requests(GenRequest)[:6]
    jeng = JEngine(jcfg, params=jax.tree.map(jnp.asarray, packed),
                   batch_slots=SLOTS, max_len=MAX_LEN, backend="xla")
    eng = ContinuousLMEngine(tcfg, _t(packed), batch_slots=SLOTS,
                             max_len=MAX_LEN, device="cpu")
    jsched, sched, tracer = (_RecordingScheduler(), _RecordingScheduler(),
                             Tracer())
    jeng.bind_runtime(jsched, "lm")
    eng.bind_runtime(sched, "lm", tracer=tracer)
    jeng.serve([JRequest(r.prompt.copy(), r.max_new_tokens) for r in reqs])
    eng.serve(reqs)
    steps = eng.decode_steps
    assert steps > 0 and sched.completed == steps == len(sched.admits)
    assert [a[1] for a in sched.admits] == [a[1] for a in jsched.admits]
    assert sum(a[1] for a in sched.admits) == eng.occupied_slot_steps
    assert all(a[0] == "lm" and a[2] == len(eng.step_stream.jobs)
               for a in sched.admits)
    spans = [s for s in tracer.spans() if s.track == "lm-decode"]
    assert len(spans) == steps
    assert [s.args["n_active"] for s in spans] == [a[1]
                                                   for a in sched.admits]
    assert all(s.cycles > 0 and s.t1_ns >= s.t0_ns for s in spans)
    samples = eng.wall_samples()
    assert len(samples) == steps and all(c > 0 for c, _ in samples)
    assert eng.engine_metrics()["observed_ns_per_cycle"] > 0


# ----------------------------------------------------------- cycle model

def _job_key(j):
    def agu(a):
        return None if a is None else (a.base, tuple(
            (l.length, l.jump) for l in a.loops))
    return (j.op.value, j.mvu, j.a_bits, j.w_bits, j.a_signed, j.w_signed,
            j.out_bits, j.m_tiles, j.k_tiles, j.n_outputs, agu(j.agu_act),
            agu(j.agu_wgt), j.use_scaler, j.use_pool, j.use_relu,
            j.dest_mvu, j.tag, tuple(j.depends_on), j.tile_ops, j.cycles)


def _same_stream(got, ref):
    assert got.mode == ref.mode
    assert [_job_key(j) for j in got.jobs] == [_job_key(j) for j in ref.jobs]
    assert got.per_mvu_cycles == ref.per_mvu_cycles
    assert got.total_cycles_pipelined() == ref.total_cycles_pipelined()
    assert got.total_cycles_distributed() == ref.total_cycles_distributed()
    assert got.summary() == ref.summary()


@pytest.mark.parametrize("size", ["smoke", "full"])
def test_decode_cost_stream_equals_reference(size):
    jcfg = getattr(j_get_arch(ARCH), size)
    tcfg = getattr(get_arch(ARCH), size)
    got, ref = decode_cost_stream(tcfg), j_decode_cost_stream(jcfg)
    _same_stream(got, ref)
    assert len(got.jobs) == 2 * (7 * tcfg.n_layers + 1)


def _zoo(side):
    cm = tcm if side == "port" else jcm
    return {"resnet50": cm.resnet50_layers(), "resnet9": cm.RESNET9_CIFAR10,
            "cnv": cm.CNV_CIFAR10}


def _lm_layers(cfg):
    """The GEMVs of one decode step of a dense SwiGLU stack (reference
    layer objects), in ``decode_cost_stream``'s order."""
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.n_heads * cfg.head_dim
    kv = cfg.n_kv_heads * cfg.head_dim
    out = []
    for i in range(cfg.n_layers):
        for name, k, n in (("wq", d, hd), ("wk", d, kv), ("wv", d, kv),
                           ("wo", hd, d), ("w_up", d, f), ("w_gate", d, f),
                           ("w_down", f, d)):
            out.append(jcm.LinearLayer(f"l{i}.{name}", k, n))
    return out + [jcm.LinearLayer("head", d, cfg.vocab_size)]


def _as_port(layers):
    out = []
    for l in layers:
        cls = tcm.ConvLayer if isinstance(l, jcm.ConvLayer) else \
            tcm.LinearLayer
        out.append(cls(**dataclasses.asdict(l)))
    return out


@pytest.mark.parametrize("mode", ["pipelined", "distributed"])
@pytest.mark.parametrize("net", ["resnet50", "resnet9", "cnv",
                                 "stablelm-smoke", "stablelm-full"])
def test_codegen_generate_equals_reference(mode, net):
    """Job for job and cycle for cycle, at W2A2 and with a per-layer
    precision map."""
    if net.startswith("stablelm"):
        jl = _lm_layers(getattr(get_arch(ARCH), net.split("-")[1]))
    else:
        jl = _zoo("ref")[net]
    tl = _as_port(jl)
    assert [dataclasses.asdict(a) for a in tl] == \
        [dataclasses.asdict(a) for a in jl]
    for kw in ({"a_bits": 2, "w_bits": 2},
               {"a_bits": 8, "w_bits": 4,
                "per_layer_bits": {jl[1].name: (1, 2), jl[-2].name: (4, 4)}}):
        _same_stream(tcg.generate(tl, mode=mode, **kw),
                     jcg.generate(jl, mode=mode, **kw))


def test_layer_cycles_and_fps_equal_reference():
    port, ref = _zoo("port"), _zoo("ref")
    for name in port:
        tl, jl = port[name], ref[name]
        for edge in ("dense", "pad_skip", "paper_edge"):
            for ab, wb in ((1, 1), (1, 2), (2, 2), (8, 4)):
                assert tcm.network_cycles(tl, ab, wb, edge) == \
                    jcm.network_cycles(jl, ab, wb, edge)
                assert [tcm.layer_cycles(l, ab, wb, edge=edge) for l in tl] \
                    == [jcm.layer_cycles(l, ab, wb, edge=edge) for l in jl]
                assert tcm.pipelined_fps(tl, ab, wb, edge=edge) == \
                    jcm.pipelined_fps(jl, ab, wb, edge=edge)
                assert tcm.distributed_fps(tl, ab, wb, edge=edge) == \
                    jcm.distributed_fps(jl, ab, wb, edge=edge)
    assert tcm.HWConfig().peak_macs == jcm.HWConfig().peak_macs
    assert tcm.RESNET9_PAPER_CYCLES == jcm.RESNET9_PAPER_CYCLES


def test_mvu_jobs_and_agu_walk_equal_reference():
    for k, n, ab, wb in ((70, 130, 2, 2), (2048, 5632, 8, 4), (64, 64, 1, 1)):
        assert _job_key(tmvu.gemv_job(3, k, n, ab, wb, tag="g")) == \
            _job_key(jmvu.gemv_job(3, k, n, ab, wb, tag="g"))
    for args in ((32, 32, 64, 128, 3, 3, 2, 2), (7, 7, 3, 64, 7, 7, 1, 2)):
        for pad_skip in (True, False):
            t = tmvu.conv2d_job(1, *args, stride=2, pad_skip=pad_skip)
            j = jmvu.conv2d_job(1, *args, stride=2, pad_skip=pad_skip)
            assert _job_key(t) == _job_key(j)
            assert t.agu_act.addresses(limit=200) == \
                j.agu_act.addresses(limit=200)
            assert t.agu_wgt.addresses(limit=200) == \
                j.agu_wgt.addresses(limit=200)
    with pytest.raises(ValueError, match="at most 5"):
        tmvu.AGUConfig(loops=(tmvu.AGULoop(2),) * 6)


def test_export_weights_equals_reference():
    """Dense and HWIO conv weights whose step sizes are exact in float32
    (multiples of 1/8, so the mean sums alike in any order): the packed
    words equal the reference's uint32 words, the scales equal."""
    rng = np.random.default_rng(12)
    params = {"fc": rng.integers(-8, 9, (70, 12)).astype(np.float32) / 8,
              "conv": rng.integers(-8, 9, (3, 3, 16, 8)).astype(
                  np.float32) / 8}
    ref = jcg.export_weights({k: jnp.asarray(v) for k, v in params.items()},
                             w_bits=2, per_layer_bits={"conv": 4})
    got = tcg.export_weights({k: torch.from_numpy(v)
                              for k, v in params.items()},
                             w_bits=2, per_layer_bits={"conv": 4})
    for name in params:
        np.testing.assert_array_equal(
            got[name].packed.numpy(),
            np.asarray(ref[name].packed).view(np.int32))
        np.testing.assert_array_equal(got[name].scale.numpy(),
                                      np.asarray(ref[name].scale))
        assert (got[name].bits, got[name].signed, got[name].k) == \
            (ref[name].bits, ref[name].signed, ref[name].k)
    with pytest.raises(NotImplementedError, match="verify_stream"):
        tcg.generate(_as_port(jcm.CNV_CIFAR10)).verify()


# ------------------------------------------------------ obs and straggler

def test_straggler_flags_equal_reference():
    rng = np.random.default_rng(13)
    series = 0.01 + rng.random(120) * 1e-3
    series[[20, 40, 41, 42, 43, 44, 90]] *= 4
    t, j = StragglerDetector(window=16), JStraggler(window=16)
    hooks = collections.Counter()
    t.on_rebalance = lambda ev: hooks.update(["rebalance"])
    t.on_exclude = lambda ev: hooks.update(["exclude"])
    for i, d in enumerate(series):
        a, b = t.observe(i, float(d)), j.observe(i, float(d))
        assert (a is None) == (b is None)
    assert [dataclasses.astuple(e) for e in t.events] == \
        [dataclasses.astuple(e) for e in j.events]
    assert t.snapshot() == j.snapshot()
    assert len(t.events) >= 6 and hooks["exclude"] == 1


def test_metrics_registry_text_exposition_equals_reference():
    regs = (MetricsRegistry(), JRegistry())
    for reg in regs:
        reg.counter("lm_tokens_out_total", "tokens produced").inc(7)
        c = reg.counter("lm_jit_calls_total", "step calls")
        c.inc(fn="decode")
        c.inc(3, fn="prefill")
        g = reg.gauge("lm_queue_peak", "queue high-water mark")
        g.set_max(4)
        g.set_max(2)
        h = reg.histogram("step_s", "step wall", buckets=(0.001, 0.01, 0.1))
        for v in (0.0005, 0.002, 0.05, 0.5):
            h.observe(v, path="k3")
        reg.counter("off").inc()
    port, ref = regs
    assert prometheus_text(port) == j_prometheus_text(ref)
    assert prometheus_text([port, port]) == j_prometheus_text([ref, ref])
    assert port.snapshot() == ref.snapshot()
    assert port.get("step_s").quantile(0.5, path="k3") == \
        ref.get("step_s").quantile(0.5, path="k3")
    port.disable()
    port.counter("off").inc()
    assert port.get("off").value() == 1
