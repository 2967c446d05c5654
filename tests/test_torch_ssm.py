"""The port's SSM family (``models/ssm.py``, mamba2-780m) on the CPU
against the JAX package: the chunked SSD scan and its step oracle, the
depthwise causal conv, ``ssm_apply`` / ``ssm_decode_step`` on carried
weights, the stack's layer groups and tied head, decode after prefill,
``Server.generate`` on the smoke config through K1 + K3 and K4 (plain
versions here), and the CLI's static path. JAX runs its XLA path.

Tolerances, each with its reason:

* The SSD scan (chunked and step oracle, port against JAX and against
  each other): ``rtol=2e-4, atol=2e-5``, the reference's own bound
  between its two scans (``test_ssd_chunked_property``): float32 sums of
  exponentials in another order.
* The causal conv: 1e-6 absolute on O(1) values (four float32 products
  summed; XLA may contract them into FMAs).
* A layer's output, the stack's logits, its caches: 1e-4 of the largest
  value, as ``tests/test_torch_lm.py`` holds the dense stack: float32
  ulps in the norms and the scan can move an activation code across a
  rounding boundary of the next 8-bit quantizer; the bound leaves room for
  a few such flips.
* Greedy tokens: equal.
"""

import _torch_threads  # noqa: F401  (first: caps torch's threads under xdist)

import contextlib
import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.launch.serve import GenRequest as JRequest
from repro.launch.serve import Server as JServer
from repro.models import ssm as jssm
from repro.models import transformer as jt

from repro_torch.configs import get_arch
from repro_torch.core.tree import tree_flatten
from repro_torch.launch import serve
from repro_torch.launch.serve import GenRequest, Server
from repro_torch.launch import train as ttrain
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as tt
from repro_torch.models.transformer import params_from_numpy

ARCH = "mamba2-780m"
MAX_LEN = 32
SCAN = dict(rtol=2e-4, atol=2e-5)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return params_from_numpy(a, "cpu")


def _close(got, ref, rel=1e-4):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(got.detach().float().numpy(), ref, rtol=0,
                               atol=rel * np.abs(ref).max())


# ------------------------------------------------------------- the scan

def _scan_inputs(b, s, h, p, g, n, seed=3, with_h0=False):
    rng = np.random.RandomState(seed)
    arrs = {
        "x": rng.randn(b, s, h, p), "dt": np.abs(rng.randn(b, s, h)) * 0.5
        + 0.05, "a_log": rng.randn(h) * 0.3, "b": rng.randn(b, s, g, n) * 0.3,
        "c": rng.randn(b, s, g, n) * 0.3, "d": rng.randn(h)}
    if with_h0:
        arrs["h0"] = rng.randn(b, h, n, p) * 0.5
    return {k: v.astype(np.float32) for k, v in arrs.items()}


@pytest.mark.parametrize("b,s,h,p,g,n,chunk,with_h0", [
    (1, 16, 2, 4, 1, 8, 4, False),     # test_ssd_chunked_property's shapes
    (2, 24, 4, 8, 2, 16, 8, False),
    (1, 7, 2, 4, 1, 4, 16, False),
    (2, 13, 4, 8, 2, 16, 4, True),     # ragged: 13 padded to 16, a state in
])
def test_ssd_scans_equal_reference(b, s, h, p, g, n, chunk, with_h0):
    a = _scan_inputs(b, s, h, p, g, n, with_h0=with_h0)
    jcfg = jssm.SSMConfig(d_model=h * p, d_state=n, head_dim=p, n_groups=g,
                          chunk=chunk)
    tcfg = tssm.SSMConfig(d_model=h * p, d_state=n, head_dim=p, n_groups=g,
                          chunk=chunk)
    ja = {k: jnp.asarray(v) for k, v in a.items()}
    ta = {k: torch.from_numpy(v) for k, v in a.items()}
    args = ("x", "dt", "a_log", "b", "c", "d")
    jy, jh = jssm.ssd_chunked(*(ja[k] for k in args), jcfg, h0=ja.get("h0"))
    jy_ref, jh_ref = jssm.ssd_scan_ref(*(ja[k] for k in args),
                                       h0=ja.get("h0"))
    ty, th = tssm.ssd_chunked(*(ta[k] for k in args), tcfg, h0=ta.get("h0"))
    ty_ref, th_ref = tssm.ssd_scan_ref(*(ta[k] for k in args),
                                       h0=ta.get("h0"))
    assert ty.shape == (b, s, h, p) and th.shape == (b, h, n, p)
    for got, ref in ((ty, jy), (th, jh), (ty_ref, jy_ref), (th_ref, jh_ref),
                     (ty, ty_ref.numpy()), (th, th_ref.numpy())):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **SCAN)


def test_ssd_chunked_keeps_bf16_and_scans_in_float32():
    a = _scan_inputs(1, 9, 2, 4, 1, 8)
    cfg = tssm.SSMConfig(d_model=8, d_state=8, head_dim=4, chunk=4)
    x = torch.from_numpy(a["x"]).bfloat16()
    y, h = tssm.ssd_chunked(x, torch.from_numpy(a["dt"]),
                            torch.from_numpy(a["a_log"]),
                            torch.from_numpy(a["b"]).bfloat16(),
                            torch.from_numpy(a["c"]).bfloat16(),
                            torch.from_numpy(a["d"]), cfg)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_equals_reference(with_state):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 12)).astype(np.float32)
    w = (rng.standard_normal((4, 12)) * 0.2).astype(np.float32)
    bias = rng.standard_normal(12).astype(np.float32)
    st = (rng.standard_normal((2, 3, 12)).astype(np.float32) if with_state
          else None)
    jo, js = jssm._causal_conv(jnp.asarray(x), jnp.asarray(w),
                               jnp.asarray(bias),
                               None if st is None else jnp.asarray(st))
    to, ts = tssm._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                               torch.from_numpy(bias),
                               None if st is None else torch.from_numpy(st))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


# ---------------------------------------------------------- the layer

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


@pytest.mark.parametrize("which", ["packed", "float"])
@pytest.mark.parametrize("pack_acts", [True, False])
def test_ssm_apply_and_decode_step_equal_reference(smoke, which, pack_acts):
    """One layer's prefill of 11 tokens (two chunks and a padded third),
    then two decode steps over its state, on carried weights: packed (K1
    + K3 or K4) and float (LSQ fake quant)."""
    jcfg, tcfg, params, packed = smoke
    tree = packed if which == "packed" else params
    p = jax.tree.map(lambda a: a[0], tree["groups"][0]["ssm"])
    jpol = dataclasses.replace(jcfg.policy, pack_acts=pack_acts)
    tpol = dataclasses.replace(tcfg.policy, pack_acts=pack_acts)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 11, 64)).astype(np.float32)
    steps = rng.standard_normal((2, 2, 1, 64)).astype(np.float32)
    jc = jssm.init_ssm_cache(2, jcfg.ssm_cfg())
    jout, jc = jax.jit(lambda pp, xx, cc: jssm.ssm_apply(
        pp, xx, jcfg.ssm_cfg(), jpol, cache=cc))(p, jnp.asarray(x), jc)
    tp = _t(p)
    tc = tssm.init_ssm_cache(2, tcfg.ssm_cfg())
    tout, tc = tssm.ssm_apply(tp, torch.from_numpy(x), tcfg.ssm_cfg(), tpol,
                              cache=tc)
    _close(tout, jout)
    _close(tc["h"], jc["h"])
    _close(tc["conv"], jc["conv"])
    assert tc["len"] == int(jc["len"]) == 11
    for xs in steps:
        jout, jc = jax.jit(lambda pp, xx, cc: jssm.ssm_decode_step(
            pp, xx, jcfg.ssm_cfg(), jpol, cc))(p, jnp.asarray(xs), jc)
        tout, tc = tssm.ssm_decode_step(tp, torch.from_numpy(xs),
                                        tcfg.ssm_cfg(), tpol, tc)
        _close(tout, jout)
        _close(tc["h"], jc["h"])
    assert tc["len"] == int(jc["len"]) == 13


# ---------------------------------------------------------- the stack

@pytest.mark.parametrize("size", ["smoke", "full"])
def test_layer_groups_equal_reference(size):
    got = tt.layer_groups(getattr(get_arch(ARCH), size))
    ref = jt.layer_groups(getattr(j_get_arch(ARCH), size))
    assert [(g.kind, g.n, g.use_moe, g.window) for g in got] == \
        [(g.kind, g.n, g.use_moe, g.window) for g in ref] == \
        [("ssm", 3 if size == "smoke" else 48, False, None)]


def test_init_params_tied_and_carried_trees_agree(smoke):
    """The port's own draw has the reference's tree (no head: tied), the
    SSM block no second norm and no MLP; carried packed params equal it
    in shape and dtype, leaf by leaf."""
    _, tcfg, params, packed = smoke
    own = tt.init_params(torch.Generator().manual_seed(0), tcfg)
    assert "head" not in own and "head" not in params
    assert sorted(own["groups"][0]) == ["norm1", "ssm"]
    assert _layout(own) == _layout(_t(params))
    assert _layout(tt.pack_params(own, tcfg)) == _layout(_t(packed))


def _layout(tree):
    """A parameter tree's containers and its leaves' shapes and dtypes."""
    leaves, treedef = tree_flatten(tree)
    return treedef, [(tuple(t.shape), t.dtype) for t in leaves]


BASE = dict(n_layers=3, d_model=32, n_heads=4, n_kv_heads=2, head_dim=8,
            d_ff=64, vocab_size=101, dtype="float32", remat=False)
SSM_EXTRA = dict(ssm_state=16, ssm_head_dim=8, ssm_chunk=4)


def test_decode_matches_forward():
    """The reference's ``test_decode_matches_forward`` for the SSM family
    on the port (prefill of 8, four decode steps), and the port's forward
    against the reference's on the same carried params."""
    jcfg = jt.ModelConfig(name="t", family="ssm", **BASE, **SSM_EXTRA)
    tcfg = tt.ModelConfig(name="t", family="ssm", **BASE, **SSM_EXTRA)
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
        np.testing.assert_allclose(lg.numpy(), full[:, 7].numpy(),
                                   rtol=1e-4, atol=1e-4)
        for i in range(8, 12):
            lg, caches = tt.decode_step(params, caches, t[:, i:i + 1], i,
                                        tcfg)
    np.testing.assert_allclose(lg.numpy(), full[:, 11].numpy(), rtol=1e-4,
                               atol=1e-4)
    assert caches[0]["len"] == 12


@pytest.mark.parametrize("pack_acts", [True, False])
def test_prefill_and_decode_logits_equal_reference(smoke, pack_acts):
    """The smoke stack's prefill and two decode steps (the tied head) on
    carried packed params."""
    jcfg, tcfg, _, packed = smoke
    jcfg = jt.serve_policy(jcfg, pack_acts=pack_acts)
    tcfg = tt.serve_policy(tcfg, pack_acts=pack_acts)
    toks = np.random.default_rng(6).integers(0, 512, (3, 9)).astype(np.int32)
    jlog, jc = jt.prefill(packed, {"tokens": jnp.asarray(toks)}, jcfg,
                          max_len=12)
    tp = _t(packed)
    tlog, tc = tt.prefill(tp, {"tokens": torch.from_numpy(toks).long()},
                          tcfg, max_len=12)
    _close(tlog, jlog)
    for pos in (9, 10):
        nxt = np.array(jnp.argmax(jlog, -1))[:, None]
        assert np.array_equal(torch.argmax(tlog, -1).numpy()[:, None], nxt)
        jlog, jc = jt.decode_step(packed, jc, jnp.asarray(nxt),
                                  jnp.int32(pos), jcfg)
        tlog, tc = tt.decode_step(tp, tc, torch.from_numpy(nxt).long(), pos,
                                  tcfg)
        _close(tlog, jlog)
        _close(tc[0]["h"], jc[0]["h"])


# -------------------------------------------------------------- serving

@pytest.fixture(scope="module")
def jax_tokens(smoke):
    """The reference's quantized Server (XLA) on three prompts."""
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
    """Three left-padded prompts in four slots (one dummy): greedy tokens
    equal the reference's through K1 + K3 and through K4; the tied head is
    the embedding cast once."""
    _, tcfg, _, packed = smoke
    srv = Server(tcfg, _t(packed), batch_slots=4, max_len=MAX_LEN,
                 pack_acts=pack_acts, device="cpu")
    out = srv.generate([GenRequest(p.copy(), b)
                        for p, b in zip(_prompts(), BUDGETS)])
    assert [r.out_tokens for r in out] == jax_tokens
    assert tuple(srv.last_logits.shape) == (4, 512)
    assert torch.equal(srv.params["head"]["w"].T, srv.params["embed"])


def test_serve_cli_takes_the_static_path():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve.main(["--arch", ARCH, "--device", "cpu", "--smoke", "--batch",
                    "2", "--new-tokens", "3"])
    text = buf.getvalue()
    assert "doesn't fit the continuous slot arena" in text
    assert "generated 6 tokens" in text and "static batch" in text
    assert "3 layers, K1 + K3" in text and "sample:" in text


def test_train_cli_trains_the_ssm_family():
    """The training CLI on the smoke config: the SSD scan's backward
    under LSQ, through ``Trainer``."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ttrain.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                     "--steps", "3", "--batch", "2", "--seq", "16"])
    text = buf.getvalue()
    assert "done: 3 steps of mamba2-780m-smoke" in text and "on cpu" in text
