"""The port's quantized LM serving path on the CPU against the JAX package:
``pack_qdense`` / ``qdense`` (K1 + K3 or K4 through their plain versions),
norms and rotary, attention with a KV cache, ``prefill`` / ``decode_step``
of the 2-layer ``stablelm-1.6b`` smoke config, and ``Server.generate``.
Parameters come from the reference (``jax.random``) and are carried across
with ``params_from_numpy``.

Tolerances, each with its reason:

* Packed words, codes and ``qdense`` outputs: exact. The same integer
  path, and the same single rounding of ``acc * scale (+ bias)`` (one FMA
  under the reference's ``jit``) and of the cast to the input's dtype.
* A float ``qdense`` (mode ``none``): float32 sums in another order,
  1e-5 relative.
* ``layer_norm``, ``rms_norm``, ``rotary`` / ``apply_rotary``: 1e-6
  absolute on O(1) values — float32 means, ``rsqrt``, ``pow`` and
  ``cos``/``sin`` in another library.
* Attention and the smoke model's logits (float32): 1e-4 of the largest
  logit. The softmax and the norms differ by float32 ulps, and a ulp can
  move an activation code across a rounding boundary of the next 8-bit
  quantizer; the bound leaves room for a few such flips. None happened in
  the runs it was set from, where the logits agreed within 3e-7 of the
  largest.
* Greedy tokens of ``Server.generate``: equal.
"""

import io
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.core.quant import QuantSpec as JQuant
from repro.core.quant import quantize_int as j_quantize_int
from repro.kernels.ops import pack_activations as j_pack_activations
from repro.launch.serve import GenRequest as JRequest
from repro.launch.serve import Server as JServer
from repro.models import attention as jattn
from repro.models import layers as jl
from repro.models import transformer as jt

from repro_torch.configs import get_arch
from repro_torch.core.quant import QuantSpec, quantize_int
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.launch.serve import GenRequest, Server, make_lm_engine
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tl
from repro_torch.models import transformer as tt
from repro_torch.models.transformer import params_from_numpy

ARCH = "stablelm-1.6b"
MAX_LEN = 32


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return params_from_numpy(a, "cpu")


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _policy(pack_acts):
    return tl.QuantPolicy(mode="qat", w_bits=4, a_bits=8, pack_acts=pack_acts)


def _jpolicy(pack_acts):
    return jl.QuantPolicy(mode="qat", w_bits=4, a_bits=8, pack_acts=pack_acts)


# ------------------------------------------------------------ qdense


@pytest.mark.parametrize("lead", [(), (3,)])
def test_pack_qdense_words_equal_reference(lead):
    """qat-initialised params: ``alpha_w`` is the constant of
    ``qdense_init``, so the packed words match the reference's exactly."""
    key = jax.random.PRNGKey(len(lead))
    if lead:
        p = jax.vmap(lambda k: jl.qdense_init(k, 70, 40, _jpolicy(False),
                                              bias=True))(
            jax.random.split(key, lead[0]))
    else:
        p = jl.qdense_init(key, 70, 40, _jpolicy(False), bias=True)
    ref = _np_tree(jl.pack_qdense(p, _jpolicy(False)))
    got = tl.pack_qdense(_t(_np_tree(p)), _policy(False))
    assert tuple(got["w_packed"].shape) == lead + (4, 3, 40)
    np.testing.assert_array_equal(got["w_packed"].numpy(),
                                  ref["w_packed"].view(np.int32))
    np.testing.assert_array_equal(got["scale"].numpy(), ref["scale"])
    np.testing.assert_array_equal(got["alpha_a"].numpy(), ref["alpha_a"])
    np.testing.assert_array_equal(got["b"].numpy(), ref["b"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pack_acts", [True, False])
def test_qdense_equals_reference(pack_acts, dtype):
    """Packed params carried across: the port's ``qdense`` (K1 + K3, or
    K4) equals the reference's jitted one bit for bit, with a bias (the
    FMA) and in bf16 (the quantizer divides in float32)."""
    p = jl.qdense_init(jax.random.PRNGKey(7), 96, 72, _jpolicy(pack_acts),
                       bias=True)
    p["b"] = jax.random.normal(jax.random.PRNGKey(8), (72,)) * 0.1
    packed = jl.pack_qdense(p, _jpolicy(pack_acts))
    x = np.random.default_rng(1).standard_normal((2, 5, 96)).astype(
        np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    ref = jax.jit(lambda pp, xx: jl.qdense(pp, xx, _jpolicy(pack_acts)))(
        packed, jnp.asarray(x, jdt))
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    got = tl.qdense(_t(_np_tree(packed)), torch.from_numpy(x).to(tdt),
                    _policy(pack_acts))
    assert got.dtype == tdt and tuple(got.shape) == (2, 5, 72)
    np.testing.assert_array_equal(_np(got), np.asarray(ref, np.float32))


@pytest.mark.parametrize("groups", [2, 3])
@pytest.mark.parametrize("pack_acts", [True, False])
def test_qdense_shared_equals_qdense_list(pack_acts, groups):
    """``qdense_shared`` (one K1 for every member with ``pack_acts``) is
    exactly a list of ``qdense`` calls, on bf16 input with each member's own
    step size and bias; each member equals the reference's jitted
    ``qdense``."""
    ps = []
    for g in range(groups):
        p = jl.qdense_init(jax.random.PRNGKey(20 + g), 96, 40 + 8 * g,
                           _jpolicy(pack_acts), bias=True)
        p["b"] = jax.random.normal(jax.random.PRNGKey(30 + g),
                                   (40 + 8 * g,)) * 0.1
        p["alpha_a"] = jnp.float32(0.02 + 0.015 * g)
        ps.append(jl.pack_qdense(p, _jpolicy(pack_acts)))
    x = np.random.default_rng(9).standard_normal((2, 5, 96)).astype(
        np.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    tps = [_t(_np_tree(p)) for p in ps]
    got = tl.qdense_shared(tps, xt, _policy(pack_acts))
    want = [tl.qdense(p, xt, _policy(pack_acts)) for p in tps]
    assert len(got) == groups
    jq = jax.jit(lambda pp, xx: jl.qdense(pp, xx, _jpolicy(pack_acts)))
    for g, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)
        ref = jq(ps[g], jnp.asarray(x, jnp.bfloat16))
        np.testing.assert_array_equal(_np(a), np.asarray(ref, np.float32))


@pytest.mark.parametrize("pack_acts", [True, False])
def test_lm_step_quantize_packs_each_activation_once(smoke, monkeypatch,
                                                     pack_acts):
    """A decode step quantize-packs each layer's four distinct activations
    once: q/k/v share one grouped call (3 steps), gate/up one (2 steps), o
    and down one each. The K4 path (``pack_acts=False``) packs none."""
    _, tcfg, _, packed = smoke
    tcfg = tt.serve_policy(tcfg, pack_acts=pack_acts)
    calls = []   # the step count of each quantize-pack (one K1 launch)
    multi = ops.quantize_pack_activations_multi

    def count(x, alphas, spec, **kw):
        calls.append(len(alphas))
        return multi(x, alphas, spec, **kw)

    monkeypatch.setattr(ops, "quantize_pack_activations_multi", count)
    tp = _t(packed)
    toks = torch.from_numpy(np.arange(12, dtype=np.int64).reshape(2, 6))
    _, caches = tt.prefill(tp, {"tokens": toks}, tcfg, max_len=8)
    calls.clear()
    tt.decode_step(tp, caches, toks[:, :1], 6, tcfg)
    want = [3, 1, 2, 1] * tcfg.n_layers if pack_acts else []
    assert calls == want


def test_quantize_pack_on_float_equals_quantize_then_pack():
    """K1's float entry on ``x.float()`` computes exactly ``quantize_int``
    then ``pack_activations`` — the two ``qdense`` routes quantize alike,
    bf16 inputs and exact .5 ties included."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((3, 7, 100)).astype(np.float32))
    alpha = torch.tensor(0.125)
    x[0, 0, :16] = (torch.arange(16) - 8 + 0.5) * alpha
    spec = QuantSpec(8, True)
    for xx in (x, x.to(torch.bfloat16)):
        a = ops.quantize_pack_activations(xx.float(), alpha, spec)
        b = ops.pack_activations(quantize_int(xx.float(), alpha, spec), 8)
        assert torch.equal(a, b)
    ref = j_pack_activations(j_quantize_int(
        jnp.asarray(x.numpy(), jnp.bfloat16), jnp.float32(0.125),
        JQuant(8, True)), 8)
    got = ops.quantize_pack_activations(x.to(torch.bfloat16).float(), alpha,
                                        spec)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(ref).view(np.int32))


def test_float_and_qat_qdense():
    p = jl.qdense_init(jax.random.PRNGKey(3), 16, 24, jl.QuantPolicy(),
                       bias=True)
    x = np.random.default_rng(3).standard_normal((4, 16)).astype(np.float32)
    ref = np.asarray(jl.qdense(p, jnp.asarray(x), jl.QuantPolicy()))
    got = tl.qdense(_t(_np_tree(p)), torch.from_numpy(x), tl.QuantPolicy())
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)
    pq = _t(_np_tree(jl.qdense_init(jax.random.PRNGKey(3), 16, 24,
                                    _jpolicy(True))))
    with pytest.raises(NotImplementedError, match="LSQ"):
        tl.qdense(pq, torch.from_numpy(x), _policy(True))


# ----------------------------------------------------------- norms / rope

def test_norms_and_rotary_match_reference():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32) * 3
    w = rng.standard_normal(16).astype(np.float32)
    b = rng.standard_normal(16).astype(np.float32)
    tx, tw, tb = (torch.from_numpy(a) for a in (x, w, b))
    np.testing.assert_allclose(
        tl.layer_norm(tx, tw, tb).numpy(),
        np.asarray(jl.layer_norm(jnp.asarray(x), w, b)), rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        tl.rms_norm(tx, tw).numpy(),
        np.asarray(jl.rms_norm(jnp.asarray(x), w)), rtol=0, atol=1e-6)
    pos = np.arange(5)[None, :] + 40
    jc, js = jl.rotary(jnp.asarray(pos), 8)
    tc, ts = tl.rotary(torch.from_numpy(pos), 8)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-6)
    for rd in (8, 16):
        c, s = tl.rotary(torch.from_numpy(pos), rd)
        jc, js = jl.rotary(jnp.asarray(pos), rd)
        np.testing.assert_allclose(
            tl.apply_rotary(tx, c, s, rd).numpy(),
            np.asarray(jl.apply_rotary(jnp.asarray(x), jc, js, rd)),
            rtol=0, atol=1e-6)


# ----------------------------------------------------- attention / model

@pytest.fixture(scope="module")
def smoke():
    """The smoke config (both sides), the reference's random float params
    and their packed form (numpy)."""
    jcfg = j_get_arch(ARCH).smoke
    tcfg = get_arch(ARCH).smoke
    params = jt.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, _np_tree(params), _np_tree(jt.pack_params(params,
                                                                 jcfg))


def _close(got, ref, rel=1e-4):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(_np(got), ref, rtol=0,
                               atol=rel * np.abs(ref).max())


def test_attn_apply_with_cache(smoke):
    """Prefill 6 tokens into a cache, then decode one at position 6."""
    jcfg, tcfg, _, packed = smoke
    p = jax.tree.map(lambda a: a[0], packed["groups"][0]["attn"])
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 6, 64)).astype(np.float32)
    x1 = rng.standard_normal((2, 1, 64)).astype(np.float32)
    run = jax.jit(lambda p, x, c, pos, cache_pos: jattn.attn_apply(
        p, x, jcfg.attn_cfg(), jcfg.policy, positions=pos, cache=c,
        cache_pos=cache_pos), static_argnums=4)
    jcache = jattn.init_kv_cache(2, 10, 4, 16, dtype=jnp.float32)
    jout, jcache = run(p, jnp.asarray(x), jcache, None, 0)
    jout1, jcache = run(p, jnp.asarray(x1), jcache, jnp.full((1, 1), 6), 6)
    tp = _t(p)
    tcache = tattn.init_kv_cache(2, 10, 4, 16, dtype=torch.float32)
    tout, tcache = tattn.attn_apply(tp, torch.from_numpy(x), tcfg.attn_cfg(),
                                    tcfg.policy, cache=tcache, cache_pos=0)
    tout1, tcache = tattn.attn_apply(
        tp, torch.from_numpy(x1), tcfg.attn_cfg(), tcfg.policy,
        positions=torch.full((1, 1), 6), cache=tcache, cache_pos=6)
    _close(tout, jout)
    _close(tout1, jout1)
    _close(tcache["k"], jcache["k"])
    _close(tcache["v"], jcache["v"])
    assert tcache["len"] == int(jcache["len"]) == 7


@pytest.mark.parametrize("pack_acts", [True, False])
def test_prefill_and_decode_match_reference(smoke, pack_acts):
    jcfg, tcfg, _, packed = smoke
    jcfg = jt.serve_policy(jcfg, pack_acts=pack_acts)
    tcfg = tt.serve_policy(tcfg, pack_acts=pack_acts)
    toks = np.random.default_rng(6).integers(0, 512, (3, 7)).astype(np.int32)
    jlog, jc = jt.prefill(packed, {"tokens": jnp.asarray(toks)}, jcfg,
                          max_len=12)
    tp = _t(packed)
    tlog, tc = tt.prefill(tp, {"tokens": torch.from_numpy(toks).long()},
                          tcfg, max_len=12)
    _close(tlog, jlog)
    nxt = np.array(jnp.argmax(jlog, -1))[:, None]
    assert np.array_equal(torch.argmax(tlog, -1).numpy()[:, None], nxt)
    jlog2, _ = jt.decode_step(packed, jc, jnp.asarray(nxt), jnp.int32(7),
                              jcfg)
    tlog2, tc = tt.decode_step(tp, tc, torch.from_numpy(nxt).long(), 7, tcfg)
    _close(tlog2, jlog2)
    assert tc[0]["len"] == 8
    # the full forward over the same tokens
    jfull, _ = jt.forward(packed, {"tokens": jnp.asarray(toks)}, jcfg)
    tfull, aux = tt.forward(tp, {"tokens": torch.from_numpy(toks).long()},
                            tcfg)
    _close(tfull, jfull)
    assert aux == {}


def test_port_init_and_pack_params_shapes(smoke):
    _, tcfg, _, packed = smoke
    gen = torch.Generator().manual_seed(0)
    own = tt.pack_params(tt.init_params(gen, tcfg), tcfg)
    ref = _t(packed)

    def shapes(tree, prefix=""):
        if isinstance(tree, dict):
            out = {}
            for k, v in tree.items():
                out.update(shapes(v, f"{prefix}/{k}"))
            return out
        if isinstance(tree, list):
            out = {}
            for i, v in enumerate(tree):
                out.update(shapes(v, f"{prefix}/{i}"))
            return out
        return {prefix: (tuple(tree.shape), tree.dtype)}

    assert shapes(own) == shapes(ref)
    # packed params pass through a second packing unchanged
    again = tt.pack_params(own, tcfg)["groups"][0]["mlp"]["w_up"]
    assert again["w_packed"] is own["groups"][0]["mlp"]["w_up"]["w_packed"]


# -------------------------------------------------------------- serving

@pytest.fixture(scope="module")
def servers(smoke):
    """The reference's quantized Server (``backend="xla"``) and the port's
    with the same packed params, both pack_acts settings."""
    jcfg, tcfg, _, packed = smoke
    js = JServer(jcfg, params=jax.tree.map(jnp.asarray, packed),
                 batch_slots=4, max_len=MAX_LEN, backend="xla")
    ts = {pa: Server(tcfg, _t(packed), batch_slots=4, max_len=MAX_LEN,
                     pack_acts=pa, device="cpu") for pa in (True, False)}
    return js, ts


def test_server_generate_equals_reference(servers):
    """Three left-padded prompts in four slots (one dummy): the port's
    greedy tokens equal the reference's, through K1 + K3 and through K4."""
    js, ts = servers
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, 512, (n,)).astype(np.int32) for n in (5, 9, 3)]
    budgets = (6, 3, 8)
    ref = js.generate([JRequest(p.copy(), b) for p, b in zip(prompts,
                                                              budgets)])
    for pa, srv in ts.items():
        out = srv.generate([GenRequest(p.copy(), b) for p, b in zip(prompts,
                                                                    budgets)])
        assert [r.out_tokens for r in out] == [r.out_tokens for r in ref], pa
        assert srv.last_stats == js.last_stats
        assert tuple(srv.last_logits.shape) == (4, 512)


def _raises_alike(js, ts, requests):
    with pytest.raises(ValueError) as jerr:
        js.generate([JRequest(r.prompt, r.max_new_tokens) for r in requests])
    with pytest.raises(ValueError) as terr:
        ts.generate(requests)
    return str(jerr.value), str(terr.value)


def test_server_edge_cases_raise_like_reference(servers):
    js, ts = servers
    srv = ts[True]
    assert _raises_alike(js, srv, [])[1] == \
        "generate() needs at least one request"
    j, t = _raises_alike(js, srv, [GenRequest(np.arange(33, dtype=np.int32),
                                              2)])
    assert j == t and "longer than max_len" in t
    j, t = _raises_alike(js, srv, [GenRequest(np.arange(4, dtype=np.int32),
                                              29)])
    assert j == t and "KV budget" in t
    j, t = _raises_alike(js, srv, [GenRequest(np.arange(4, dtype=np.int32), 1)
                                   for _ in range(5)])
    assert "5 requests exceed batch_slots=4" in t and "exceed" in j
    # exactly on budget is fine
    out = srv.generate([GenRequest(np.arange(4, dtype=np.int32), 28)])
    assert len(out[0].out_tokens) == 28
    assert srv.last_stats["padded_slots"] == 3


def test_server_dummy_slots_do_not_change_tokens(servers, smoke):
    _, tcfg, _, packed = smoke
    _, ts = servers
    prompt = (np.arange(9, dtype=np.int32) * 5) % 512
    padded = ts[True].generate([GenRequest(prompt.copy(), 4)])[0]
    solo = Server(tcfg, _t(packed), batch_slots=1, max_len=MAX_LEN,
                  device="cpu")
    assert solo.generate([GenRequest(prompt.copy(), 4)])[0].out_tokens == \
        padded.out_tokens
    assert solo.last_stats["padded_slots"] == 0
    engine = make_lm_engine(ts[False])
    reqs = [GenRequest(prompt.copy(), 2) for _ in range(6)]
    assert [r.out_tokens for r in engine(reqs)] == \
        [padded.out_tokens[:2]] * 6


def test_server_refuses_float_serving_and_missing_card(monkeypatch, smoke):
    _, tcfg, _, _ = smoke
    with pytest.raises(NotImplementedError, match="LSQ"):
        Server(tcfg, quantized=False, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Server(tcfg)


def test_serve_cli_lm_on_cpu():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve.main(["--arch", ARCH, "--device", "cpu", "--smoke", "--batch",
                    "2", "--new-tokens", "3", "--no-pack-acts"])
    text = buf.getvalue()
    # the reference CLI's mixed load through the continuous engine: 8
    # requests, every 4th with 3 new tokens, the others 1
    assert "generated 12 tokens over 8 requests" in text and "K4" in text
    assert "recompiles_after_warmup=0" in text and "sample:" in text
