"""The port's hybrid family (``models/hybrid.py``, hymba-1.5b) and the
sliding-window attention it needs, on the CPU against the JAX package:
the window mask, the rolling KV cache (a windowed prefill, then decode
steps past the window), one hybrid layer on carried weights, the stack's
layer groups (global layers between windowed runs), decode after prefill
past the window, ``Server.generate`` on the smoke config through K1 +
K3 and K4 (plain versions here), and training past the window through
chunked attention under remat. JAX runs its XLA path.

Tolerances, each with its reason:

* Attention outputs, a layer's output, the stack's logits and the caches:
  1e-4 of the largest value, as ``tests/test_torch_lm.py`` holds the
  dense stack: float32 ulps in the softmax, the norms and the scan can
  move an activation code across a rounding boundary of the next 8-bit
  quantizer; the bound leaves room for a few such flips.
* Greedy tokens: equal.
"""

import _torch_threads  # noqa: F401  (first: caps torch's threads under xdist)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.launch.serve import GenRequest as JRequest
from repro.launch.serve import Server as JServer
from repro.models import attention as jattn
from repro.models import hybrid as jhyb
from repro.models import transformer as jt

from repro_torch.configs import get_arch
from repro_torch.core.tree import tree_flatten, tree_unflatten
from repro_torch.launch.serve import GenRequest, Server
from repro_torch.models import attention as tattn
from repro_torch.models import hybrid as thyb
from repro_torch.models import transformer as tt
from repro_torch.models.transformer import params_from_numpy

ARCH = "hymba-1.5b"
MAX_LEN = 32


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return params_from_numpy(a, "cpu")


def _close(got, ref, rel=1e-4):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(got.detach().float().numpy(), ref, rtol=0,
                               atol=rel * np.abs(ref).max())


@pytest.fixture(scope="module")
def smoke():
    """The smoke config (both sides), the reference's random float params
    and their packed form (numpy), both made under ``jit``."""
    jcfg = j_get_arch(ARCH).smoke
    tcfg = get_arch(ARCH).smoke
    params = jax.jit(lambda k: jt.init_params(k, jcfg))(
        jax.random.PRNGKey(0))
    packed = jax.jit(lambda pp: jt.pack_params(pp, jcfg))(params)
    return jcfg, tcfg, _np_tree(params), _np_tree(packed)


# ------------------------------------------------------------ attention

@pytest.mark.parametrize("window,q_offset", [(3, 0), (5, 4), (None, 2)])
def test_sdpa_full_window_mask_equals_reference(window, q_offset):
    rng = np.random.default_rng(1)
    q = rng.standard_normal((2, 6, 4, 8)).astype(np.float32)
    k = rng.standard_normal((2, 10, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, 10, 2, 8)).astype(np.float32)
    ref = jattn._sdpa_full(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           causal=True, window=window, q_offset=q_offset)
    got = tattn._sdpa_full(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), causal=True,
                           q_offset=q_offset, window=window)
    _close(got, ref)


@pytest.mark.parametrize("max_len,window,prefill,steps", [
    (16, 4, 6, 3),     # the prefill overfills the window, keeps its tail
    (16, 6, 4, 5),     # a short prefill, then decode steps past the window
    (6, 8, 3, 2),      # a window wider than the cache: masks only
])
def test_rolling_cache_equals_reference(smoke, max_len, window, prefill,
                                        steps):
    """``attn_apply`` on a sliding-window cache, prefill then decode steps,
    against the reference's ``attn_apply`` / ``update_kv_cache``: outputs
    and the buffers (rolled in place) after every call."""
    jcfg, tcfg, _, packed = smoke
    p = jax.tree.map(lambda a: a[0], packed["groups"][1]["hybrid"]["attn"])
    jac = jcfg.attn_cfg(window=window)
    tac = tcfg.attn_cfg(window=window)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, prefill, 64)).astype(np.float32)
    jc = jattn.init_kv_cache(2, max_len, 2, 16, dtype=jnp.float32,
                             window=window)
    tc = tattn.init_kv_cache(2, max_len, 2, 16, dtype=torch.float32,
                             window=window)
    assert ("rolling" in tc) == ("rolling" in jc) == (window <= max_len)
    assert tuple(tc["k"].shape) == jc["k"].shape
    tp = _t(p)
    run = jax.jit(lambda pp, xx, pos, cc, cpos: jattn.attn_apply(
        pp, xx, jac, jcfg.policy, positions=pos, cache=cc, cache_pos=cpos))
    jout, jc = run(p, jnp.asarray(x), None, jc, 0)
    tout, tc = tattn.attn_apply(tp, torch.from_numpy(x), tac, tcfg.policy,
                                cache=tc, cache_pos=0)
    _close(tout, jout)
    for pos in range(prefill, prefill + steps):
        x1 = rng.standard_normal((2, 1, 64)).astype(np.float32)
        jout, jc = run(p, jnp.asarray(x1), jnp.full((1, 1), pos), jc,
                       jnp.int32(pos))
        tout, tc = tattn.attn_apply(tp, torch.from_numpy(x1), tac,
                                    tcfg.policy,
                                    positions=torch.full((1, 1), pos),
                                    cache=tc, cache_pos=pos)
        _close(tout, jout)
        _close(tc["k"], jc["k"])
        _close(tc["v"], jc["v"])
        assert tc["len"] == int(jc["len"]) == pos + 1


def test_rolling_cache_refuses_per_row_positions():
    c = tattn.init_kv_cache(2, 16, 2, 4, dtype=torch.float32, window=4)
    kv = torch.zeros((2, 1, 2, 4))
    with pytest.raises(ValueError, match="rolling"):
        tattn.update_kv_cache(c, kv, kv, torch.tensor([3, 5]))


# ---------------------------------------------------------- the layer

@pytest.mark.parametrize("pack_acts", [True, False])
def test_hybrid_apply_equals_reference(smoke, pack_acts):
    """One windowed hybrid layer (window 8, a rolling cache) on carried
    packed weights: a prefill of 10 tokens, then three decode steps."""
    jcfg, tcfg, _, packed = smoke
    p = jax.tree.map(lambda a: a[0], packed["groups"][1]["hybrid"])
    jhc = jhyb.HybridConfig(jcfg.attn_cfg(window=8), jcfg.ssm_cfg())
    thc = thyb.HybridConfig(tcfg.attn_cfg(window=8), tcfg.ssm_cfg())
    jpol = dataclasses.replace(jcfg.policy, pack_acts=pack_acts)
    tpol = dataclasses.replace(tcfg.policy, pack_acts=pack_acts)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 10, 64)).astype(np.float32)
    jc = jhyb.init_hybrid_cache(2, 16, jhc, dtype=jnp.float32)
    tc = thyb.init_hybrid_cache(2, 16, thc, dtype=torch.float32)
    tp = _t(p)
    run = jax.jit(lambda pp, xx, pos, cc, cpos, decode: jhyb.hybrid_apply(
        pp, xx, jhc, jpol, positions=pos, cache=cc, cache_pos=cpos,
        decode=decode), static_argnums=5)
    jout, jc = run(p, jnp.asarray(x), None, jc, 0, False)
    tout, tc = thyb.hybrid_apply(tp, torch.from_numpy(x), thc, tpol,
                                 cache=tc, cache_pos=0)
    _close(tout, jout)
    for pos in range(10, 13):
        x1 = rng.standard_normal((2, 1, 64)).astype(np.float32)
        jout, jc = run(p, jnp.asarray(x1), jnp.full((1, 1), pos), jc,
                       jnp.int32(pos), True)
        tout, tc = thyb.hybrid_apply(tp, torch.from_numpy(x1), thc, tpol,
                                     positions=torch.full((1, 1), pos),
                                     cache=tc, cache_pos=pos, decode=True)
        _close(tout, jout)
        _close(tc["attn"]["k"], jc["attn"]["k"])
        _close(tc["ssm"]["h"], jc["ssm"]["h"])
    assert tc["attn"]["len"] == tc["ssm"]["len"] == 13


# ---------------------------------------------------------- the stack

@pytest.mark.parametrize("size", ["smoke", "full"])
def test_layer_groups_equal_reference(size):
    """FULL: global 0, window 1-15, global 16, window 17-30, global 31."""
    got = tt.layer_groups(getattr(get_arch(ARCH), size))
    ref = jt.layer_groups(getattr(j_get_arch(ARCH), size))
    assert [(g.kind, g.n, g.use_moe, g.window) for g in got] == \
        [(g.kind, g.n, g.use_moe, g.window) for g in ref]
    if size == "full":
        assert [(g.n, g.window) for g in got] == [
            (1, None), (15, 1024), (1, None), (14, 1024), (1, None)]


def test_init_params_and_carried_trees_agree(smoke):
    """The port's own draw has the reference's tree (nested hybrid blocks,
    an untied head); carried float and packed params equal it in shape
    and dtype, leaf by leaf."""
    _, tcfg, params, packed = smoke
    own = tt.init_params(torch.Generator().manual_seed(0), tcfg)
    assert sorted(own["groups"][1]) == ["hybrid", "mlp", "norm1", "norm2"]
    for mine, ref in ((own, params), (tt.pack_params(own, tcfg), packed)):
        a, b = tree_flatten(mine), tree_flatten(_t(ref))
        assert a[1] == b[1]
        assert ([(tuple(t.shape), t.dtype) for t in a[0]]
                == [(tuple(t.shape), t.dtype) for t in b[0]])


BASE = dict(n_layers=3, d_model=32, n_heads=4, n_kv_heads=2, head_dim=8,
            d_ff=64, vocab_size=101, dtype="float32", remat=False)
HYBRID_EXTRA = dict(ssm_state=8, ssm_head_dim=8, ssm_chunk=4, window=8,
                    global_attn_layers=(0,))


def test_decode_matches_forward():
    """The reference's ``test_decode_matches_forward`` for the hybrid
    family on the port: a prefill of 8 into rolling caches of window 8,
    then four decode steps past the window; the port's forward against
    the reference's on the same carried params."""
    jcfg = jt.ModelConfig(name="t", family="hybrid", **BASE, **HYBRID_EXTRA)
    tcfg = tt.ModelConfig(name="t", family="hybrid", **BASE, **HYBRID_EXTRA)
    jp = jax.jit(lambda k: jt.init_params(k, jcfg))(jax.random.PRNGKey(0))
    params = _t(_np_tree(jp))
    toks = np.random.RandomState(0).randint(0, 101, (1, 12))
    jfull, _ = jax.jit(lambda pp, t: jt.forward(pp, {"tokens": t}, jcfg))(
        jp, jnp.asarray(toks))
    t = torch.from_numpy(toks).long()
    with torch.no_grad():
        full, _ = tt.forward(params, {"tokens": t}, tcfg)
        _close(full, jfull)
        lg, caches = tt.prefill(params, {"tokens": t[:, :8]}, tcfg,
                                max_len=12)
        assert "rolling" in caches[1]["attn"]
        np.testing.assert_allclose(lg.numpy(), full[:, 7].numpy(),
                                   rtol=1e-4, atol=1e-4)
        for i in range(8, 12):
            lg, caches = tt.decode_step(params, caches, t[:, i:i + 1], i,
                                        tcfg)
    np.testing.assert_allclose(lg.numpy(), full[:, 11].numpy(), rtol=1e-4,
                               atol=1e-4)
    assert caches[1]["attn"]["len"] == caches[1]["ssm"]["len"] == 12


@pytest.mark.parametrize("pack_acts", [True, False])
def test_prefill_and_decode_logits_equal_reference(smoke, pack_acts):
    """The smoke stack (window 8, rolling) on carried packed params: a
    prefill of 9 and three decode steps."""
    jcfg, tcfg, _, packed = smoke
    jcfg = jt.serve_policy(jcfg, pack_acts=pack_acts)
    tcfg = tt.serve_policy(tcfg, pack_acts=pack_acts)
    toks = np.random.default_rng(6).integers(0, 512, (3, 9)).astype(np.int32)
    jprefill = jax.jit(lambda pp, b: jt.prefill(pp, b, jcfg, max_len=16))
    jdecode = jax.jit(lambda pp, c, t, pos: jt.decode_step(pp, c, t, pos,
                                                           jcfg))
    jlog, jc = jprefill(packed, {"tokens": jnp.asarray(toks)})
    tp = _t(packed)
    tlog, tc = tt.prefill(tp, {"tokens": torch.from_numpy(toks).long()},
                          tcfg, max_len=16)
    _close(tlog, jlog)
    for pos in (9, 10, 11):
        nxt = np.array(jnp.argmax(jlog, -1))[:, None]
        assert np.array_equal(torch.argmax(tlog, -1).numpy()[:, None], nxt)
        jlog, jc = jdecode(packed, jc, jnp.asarray(nxt), jnp.int32(pos))
        tlog, tc = tt.decode_step(tp, tc, torch.from_numpy(nxt).long(), pos,
                                  tcfg)
        _close(tlog, jlog)
    _close(tc[1]["attn"]["k"], jc[1]["attn"]["k"])
    _close(tc[1]["ssm"]["h"], jc[1]["ssm"]["h"])


# -------------------------------------------------------------- serving

@pytest.fixture(scope="module")
def jax_tokens(smoke):
    jcfg, _, _, packed = smoke
    js = JServer(jcfg, params=jax.tree.map(jnp.asarray, packed),
                 batch_slots=4, max_len=MAX_LEN, backend="xla")
    return [r.out_tokens for r in js.generate(
        [JRequest(p.copy(), b) for p, b in zip(_prompts(), BUDGETS)])]


BUDGETS = (6, 3, 8)


def _prompts():
    rng = np.random.RandomState(0)
    return [rng.randint(0, 512, (n,)).astype(np.int32) for n in (5, 9, 3)]


@pytest.mark.parametrize("pack_acts", [True, False])
def test_server_generate_equals_reference(smoke, jax_tokens, pack_acts):
    """Three left-padded prompts in four slots (one dummy), windowed
    layers rolling past their 8 slots: greedy tokens equal the
    reference's through K1 + K3 and through K4."""
    _, tcfg, _, packed = smoke
    srv = Server(tcfg, _t(packed), batch_slots=4, max_len=MAX_LEN,
                 pack_acts=pack_acts, device="cpu")
    out = srv.generate([GenRequest(p.copy(), b)
                        for p, b in zip(_prompts(), BUDGETS)])
    assert [r.out_tokens for r in out] == jax_tokens
    assert tuple(srv.last_logits.shape) == (4, 512)


def test_chunked_window_training_under_remat_matches_reference(smoke):
    """Training past the window: 16 tokens through chunked attention (4 x 4
    blocks, the windowed layers skipping the blocks their mask does not
    reach) with each layer checkpointed; the loss and every gradient
    against ``jax.value_and_grad`` of the reference's chunked stack (loss
    1e-5 relative, each gradient 1e-3 of its largest element, as
    ``tests/test_torch_train.py``)."""
    jcfg, tcfg, params, _ = smoke
    knobs = dict(use_chunked_attn=True, attn_q_chunk=4, attn_kv_chunk=4)
    jc = dataclasses.replace(jcfg, **knobs)
    tc = dataclasses.replace(tcfg, remat=True, **knobs)
    rng = np.random.RandomState(4)
    b = {k: rng.randint(0, 512, (2, 16)).astype(np.int32)
         for k in ("tokens", "labels")}
    (jl, _), jg = jax.jit(jax.value_and_grad(jt.loss_fn, has_aux=True),
                          static_argnums=2)(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, b), jc)
    leaves, treedef = tree_flatten(_t(params))
    leaves = [l.requires_grad_(True) for l in leaves]
    loss, _ = tt.loss_fn(tree_unflatten(treedef, leaves),
                         {k: torch.from_numpy(v).long()
                          for k, v in b.items()}, tc)
    grads = torch.autograd.grad(loss, leaves)
    ref = np.float64(jl)
    assert abs(float(loss.detach()) - ref) <= 1e-5 * abs(ref)
    for g, r in zip(grads, jax.tree.leaves(jg)):
        r = np.asarray(r, np.float64)
        assert np.abs(g.double().numpy() - r).max() <= 1e-3 * np.abs(r).max()
