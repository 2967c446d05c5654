"""The port's DeepSeek-V2-Lite slice on the CPU against the JAX package: LSQ
fake-quant's forward, the grouped K4 entry's plain version, the MoE layer
(routing, dispatch, the packed expert accumulators, the combine) and MLA
(prefill, decode at a host position and at per-row positions), then the
whole model through ``Server``, ``ContinuousLMEngine`` and the CLI, and
the cycle model it books.

The model runs at the ``deepseek-v2-lite-16b`` smoke config (3 layers: one
dense, two MLA + MoE with 4 experts, top-2, one shared expert; float32)
with the reference's random parameters carried across by
``params_from_numpy``; the reference runs its plain path
(``backend="xla"``). One JAX ``Server`` run and one JAX engine run are
shared by the module's tests.

Tolerances, each with its reason:

* Routing (experts, keep, buffer rows), the dispatched buffer, integer
  accumulators, drop fractions, greedy tokens, command-stream jobs and
  packed words: exact — the same integer arithmetic and the same copies.
* LSQ fake-quant: exact — one IEEE divide, a round half to even, a clip
  and one product, in the input's dtype on both sides.
* MoE and MLA outputs, caches and logits (float32): 1e-4 of the largest
  value, as ``tests/test_torch_lm.py`` states it for the dense stack
  (float32 ulps of the softmax, norms and products, which can move an
  8-bit activation code).
"""

import _torch_threads  # noqa: F401  (first: caps torch's threads under xdist)

import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.core import bitops as jbitops
from repro.core.bitserial import SerialSpec as JSpec
from repro.core.bitserial import plan_spec as j_plan_spec
from repro.core.bitserial import serial_matmul_packed as j_serial_packed
from repro.core.quant import QuantSpec as JQuant
from repro.core.quant import lsq_fake_quant as j_lsq
from repro.core.quant import quantize_int as j_quantize_int
from repro.launch.serve import GenRequest as JRequest
from repro.launch.serve import Server as JServer
from repro.models import attention as jattn
from repro.models import moe as jmoe
from repro.models import transformer as jt
from repro.serving import ContinuousLMEngine as JEngine
from repro.serving import decode_cost_stream as j_decode_cost_stream

from repro_torch.configs import get_arch
from repro_torch.core.bitserial import SerialSpec, plan_spec
from repro_torch.core.quant import QuantSpec, lsq_fake_quant, quantize_int
from repro_torch.kernels import bitserial_matmul as km
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.launch.serve import GenRequest, Server
from repro_torch.models import attention as tattn
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as tt
from repro_torch.models.layers import QuantPolicy
from repro_torch.models.transformer import params_from_numpy
from repro_torch.serving import ContinuousLMEngine, decode_cost_stream

ARCH = "deepseek-v2-lite-16b"
SLOTS, MAX_LEN = 4, 32


def _t(a):
    return params_from_numpy(a, "cpu")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, ref, rel=1e-4):
    ref = np.asarray(ref, np.float32)
    got = got.float().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rel * max(np.abs(ref).max(), 1e-30))


def _layer(tree, i):
    return jax.tree.map(lambda a: a[i], tree)


@pytest.fixture(scope="module")
def smoke():
    """The smoke config (both sides) and the reference's random params,
    float and packed (numpy)."""
    jcfg = j_get_arch(ARCH).smoke
    tcfg = get_arch(ARCH).smoke
    params = jt.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, _np(params), _np(jt.pack_params(params, jcfg))


# --------------------------------------------------------------- LSQ fwd

@pytest.mark.parametrize("bits,signed,per_channel", [
    (4, True, True), (8, True, False), (8, False, False), (2, True, True)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lsq_fake_quant_forward_equals_reference(bits, signed, per_channel,
                                                 dtype):
    rng = np.random.default_rng(bits + 10 * signed)
    x = rng.standard_normal((6, 40)).astype(np.float32) * 3
    if per_channel:
        alpha = (rng.random((1, 40)) * 0.5 + 0.05).astype(np.float32)
        alpha[0, 3] = -alpha[0, 3]          # |alpha| is the step
        alpha[0, 5] = 0.0                   # clamped to 1e-8
    else:
        alpha = np.float32(0.37)
    x[0, :8] = np.float32(0.37) * (np.arange(8) + 0.5)  # .5 boundaries
    spec = JQuant(bits, signed)
    jx = jnp.asarray(x).astype(dtype)
    ref = np.asarray(j_lsq(jx, jnp.asarray(alpha).astype(dtype), spec)
                     .astype(jnp.float32))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    ta = torch.as_tensor(alpha).to(getattr(torch, dtype))
    got = lsq_fake_quant(tx, ta, QuantSpec(bits, signed))
    assert got.dtype == tx.dtype
    np.testing.assert_array_equal(got.float().numpy(), ref)


# ------------------------------------------------------------ grouped K4

def _grouped_case(e, c, k, n, spec, seed, zeros=None):
    """Random codes (E, C, K) and packed weights (E, w_bits, ceil(K/32),
    N); ``zeros``: "experts" (two experts in three all zero, as the
    dispatch leaves empty ones), "row" (one row of each expert zero) or
    "all"."""
    rng = np.random.default_rng(seed)
    lo_a = -(1 << (spec.a_bits - 1)) if spec.a_signed else 0
    hi_a = (1 << (spec.a_bits - 1)) if spec.a_signed else 1 << spec.a_bits
    lo_w = -(1 << (spec.w_bits - 1)) if spec.w_signed else 0
    hi_w = (1 << (spec.w_bits - 1)) if spec.w_signed else 1 << spec.w_bits
    codes = rng.integers(lo_a, hi_a, (e, c, k)).astype(np.int32)
    if zeros == "experts":
        codes[np.arange(e) % 3 != 1] = 0
    elif zeros == "row":
        codes[:, c // 2] = 0
    elif zeros == "all":
        codes[:] = 0
    w = rng.integers(lo_w, hi_w, (e, k, n)).astype(np.int32)
    planes = jbitops.pad_to(jbitops.to_bitplanes(jnp.asarray(w), spec.w_bits),
                            32, axis=-2)              # (bits, E, K', N)
    wp = jnp.moveaxis(jbitops.pack_bitplanes(planes, axis=-2), 0, 1)
    return codes, np.asarray(wp)


@pytest.mark.parametrize("e,c,k,n,spec,zeros", [
    # W4A8, ragged K and N; decode's C = 1; radix 1; unsigned W8A8
    pytest.param(3, 5, 100, 70, (8, 4, True, True, 8), None,
                 id="3-5-100-70-spec0"),
    pytest.param(4, 1, 64, 40, (8, 4, True, True, 8), None,
                 id="4-1-64-40-spec1"),
    pytest.param(2, 3, 65, 33, (2, 2, True, True, 1), None,
                 id="2-3-65-33-spec2"),
    pytest.param(2, 4, 96, 64, (8, 8, False, True, 7), None,
                 id="2-4-96-64-spec3"),
    # mostly zero, as a decode step's dispatch buffer is
    pytest.param(64, 1, 64, 40, (8, 4, True, True, 8), "experts",
                 id="64-1-64-40-W4A8-zero-experts"),
    pytest.param(3, 4, 100, 70, (8, 4, True, True, 8), "row",
                 id="3-4-100-70-W4A8-zero-row"),
    pytest.param(4, 2, 64, 40, (8, 4, True, True, 8), "all",
                 id="4-2-64-40-W4A8-all-zero"),
    pytest.param(8, 2, 65, 33, (2, 2, True, True, 1), "experts",
                 id="8-2-65-33-W2A2-zero-experts"),
    pytest.param(6, 3, 96, 64, (8, 8, False, True, 7), "row",
                 id="6-3-96-64-W8A8u-zero-row"),
])
def test_grouped_k4_plain_equals_reference_per_expert(e, c, k, n, spec,
                                                      zeros):
    """``serial_matmul_packed`` per expert, the reference's
    ``_expert_matmul`` (``vmap`` over experts): the grouped entry's plain
    version, the CPU dispatcher and the op give the same int32 words, and
    a zero row gives zero words in both."""
    codes, wp = _grouped_case(e, c, k, n, JSpec(*spec), e * 100 + c, zeros)
    ref = np.asarray(jax.vmap(lambda x, w: j_serial_packed(
        x, w, spec=JSpec(*spec), k=k))(jnp.asarray(codes), jnp.asarray(wp)))
    tcodes, twp = torch.from_numpy(codes), _t(wp)
    tspec = SerialSpec(*spec)
    for got in (km.bitserial_matmul_grouped_ref(tcodes, twp, spec=tspec, k=k),
                km.bitserial_matmul_grouped(tcodes, twp, spec=tspec, k=k),
                ops.serial_matmul_grouped_op(tcodes, twp, spec=tspec, k=k)):
        assert got.dtype == torch.int32 and got.shape == (e, c, n)
        np.testing.assert_array_equal(got.numpy(), ref)
    zero_rows = ~codes.any(-1)
    assert not ref[zero_rows].any()
    assert zero_rows.any() == (zeros is not None)


def test_grouped_k4_cuda_entry_refuses_cpu_tensors():
    codes, wp = _grouped_case(2, 1, 32, 8, JSpec(8, 4, True, True, 8), 1)
    with pytest.raises(ValueError, match="must be on"):
        km.bitserial_matmul_grouped_cuda(torch.from_numpy(codes), _t(wp),
                                         spec=SerialSpec(8, 4), k=32)


# ------------------------------------------------------------------- MoE

def _moe_layer(packed_tree, i=0):
    """MoE layer ``i`` of the smoke stack's MoE group."""
    return _layer(packed_tree["groups"][1]["moe"], i)


def _record(monkeypatch, module):
    """Wrap ``module._expert_matmul`` to record each call's input and
    output as numpy."""
    calls = []
    inner = module._expert_matmul

    def spy(p, x, policy):
        out = inner(p, x, policy)
        calls.append((np.asarray(x.detach() if torch.is_tensor(x) else x),
                      np.asarray(out.detach() if torch.is_tensor(out)
                                 else out)))
        return out

    monkeypatch.setattr(module, "_expert_matmul", spy)
    return calls


def _ref_routing(router, xt, k, e, capacity, norm):
    """The reference's routing lines (``repro/models/moe.py`` moe_apply,
    one group)."""
    logits = jnp.einsum("td,de->te", xt.astype(jnp.float32),
                        router.astype(jnp.float32))
    probs = jax.nn.softmax(logits, axis=-1)
    gate_vals, expert_idx = jax.lax.top_k(probs, k)
    if norm:
        gate_vals = gate_vals / (jnp.sum(gate_vals, -1, keepdims=True) + 1e-9)
    eq = expert_idx[:, :, None] == expert_idx[:, None, :]
    tri = jnp.tril(jnp.ones((k, k), bool), k=-1)
    slot = jnp.sum(eq & tri[None], axis=-1)
    counts = jnp.zeros((xt.shape[0], e), jnp.int32).at[
        jnp.arange(xt.shape[0])[:, None], expert_idx].add(1)
    prior = jnp.cumsum(counts, axis=0) - counts
    pos = jnp.take_along_axis(prior, expert_idx, axis=-1) + slot
    keep = pos < capacity
    flat = jnp.where(keep, expert_idx * capacity + pos, e * capacity)
    return (np.asarray(gate_vals), np.asarray(expert_idx), np.asarray(keep),
            np.asarray(flat))


@pytest.mark.parametrize("t,capacity", [(4, None), (16, None), (40, None),
                                        (16, 1), (16, 3)])
def test_moe_apply_equals_reference(smoke, monkeypatch, t, capacity):
    """Packed MoE layer: routing, dispatched buffer and drop fraction
    exact; every expert projection's int32 accumulators exact on the
    reference's own inputs; the output within tolerance."""
    jcfg, tcfg, _, packed = smoke
    mcfg_j, mcfg_t = jcfg.moe_cfg(), tcfg.moe_cfg()
    p = _moe_layer(packed)
    rng = np.random.default_rng(t)
    x = (rng.standard_normal((1, t, jcfg.d_model)) * 2).astype(np.float32)
    cap = capacity or tmoe.capacity_for(t, mcfg_t)
    assert cap == (capacity or int(np.ceil(t * mcfg_j.top_k
                                           / mcfg_j.n_experts
                                           * mcfg_j.capacity_factor)))

    gv, ei, keep, flat = _ref_routing(jnp.asarray(p["router"]),
                                      jnp.asarray(x[0]), mcfg_j.top_k,
                                      mcfg_j.n_experts, cap,
                                      mcfg_j.norm_topk_prob)
    tp = _t(p)
    _, tgv, tei = tmoe._route(tp, torch.from_numpy(x[0]), mcfg_t)
    tkeep, tflat = tmoe.dispatch(tei, mcfg_t.n_experts, cap)
    np.testing.assert_array_equal(tei.numpy(), ei)
    np.testing.assert_array_equal(tkeep.numpy(), keep)
    np.testing.assert_array_equal(tflat.numpy(), flat)
    _close(tgv, gv)

    jcalls = _record(monkeypatch, jmoe)
    ref, jaux = jmoe.moe_apply(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                               mcfg_j, jcfg.policy, capacity=capacity,
                               n_groups=1)
    tcalls = _record(monkeypatch, tmoe)
    got, taux = tmoe.moe_apply(tp, torch.from_numpy(x), mcfg_t, tcfg.policy,
                               capacity=capacity)
    assert len(jcalls) == len(tcalls) == 3          # up, gate, down
    # the dispatched buffer (E, C, d): exact copies of the routed tokens
    np.testing.assert_array_equal(tcalls[0][0], jcalls[0][0][0])
    assert float(taux["drop_frac"]) == float(jaux["drop_frac"])
    _close(taux["lb_loss"], jaux["lb_loss"])
    # each projection's accumulators on the reference's own input
    spec = j_plan_spec(jcfg.policy.spec())    # as _expert_matmul plans it
    for (jx, _), name in zip(jcalls, ("w_up", "w_gate", "w_down")):
        pw = p[name]
        jx = jx[0]                                   # (E, C, K), one group
        codes = np.asarray(j_quantize_int(
            jnp.asarray(jx), jnp.asarray(pw["alpha_a"])[:, None, None],
            JQuant(8, True)))
        ref_acc = np.asarray(jax.vmap(lambda c, w: j_serial_packed(
            c, w, spec=spec, k=jx.shape[-1]))(jnp.asarray(codes),
                                             jnp.asarray(pw["w_packed"])))
        got_acc = ops.serial_matmul_grouped_op(
            torch.from_numpy(np.array(codes)), _t(pw["w_packed"]),
            spec=plan_spec(tcfg.policy.spec()), k=jx.shape[-1])
        np.testing.assert_array_equal(got_acc.numpy(), ref_acc)
    _close(got, ref)


@pytest.mark.parametrize("t", [1, 4, 16])
def test_empty_experts_have_zero_codes_and_accumulators(t):
    """What grouped K4's skip rests on, in both packages: at the full
    model's routing (E = 64, top-6) and T tokens (C = 1, 1, 2), every row
    of the dispatch buffer that ``dispatch`` fills with no token (all of
    an empty expert's among them) quantizes to zero codes, in the port's
    ``quantize_int`` and the reference's, and its int32 accumulators are
    exact zeros, in ``bitserial_matmul_grouped_ref`` and in
    ``vmap(serial_matmul_packed)``: for up and gate, and for down on
    ``silu(gate) * up``."""
    e, k, d, f = 64, 6, 64, 40
    mcfg = tmoe.MoEConfig(d_model=d, d_ff_expert=f, n_experts=e, top_k=k)
    cap = tmoe.capacity_for(t, mcfg)
    assert cap == (1, 1, 2)[(1, 4, 16).index(t)]
    rng = np.random.default_rng(200 + t)
    x = (rng.standard_normal((t, d)) * 2).astype(np.float32)
    router = rng.standard_normal((d, e)).astype(np.float32)
    _, ei, keep, flat = _ref_routing(jnp.asarray(router), jnp.asarray(x), k,
                                     e, cap, True)
    _, _, tei = tmoe._route({"router": torch.from_numpy(router)},
                            torch.from_numpy(x), mcfg)
    tkeep, tflat = tmoe.dispatch(tei, e, cap)
    np.testing.assert_array_equal(tei.numpy(), ei)
    np.testing.assert_array_equal(tkeep.numpy(), keep)
    np.testing.assert_array_equal(tflat.numpy(), flat)
    filled = np.zeros(e * cap + 1, bool)
    filled[flat[keep]] = True
    rows = filled[:-1].reshape(e, cap)
    empty = ~rows.any(1)
    assert empty.sum() >= e - t * k and rows.any()
    # the dispatch buffer, as moe_apply scatters it
    buf = torch.zeros((e * cap + 1, d))
    buf.index_add_(0, tflat.reshape(-1), torch.from_numpy(x)[:, None, :]
                   .expand(t, k, d).reshape(-1, d))
    hbuf = buf[:-1].reshape(e, cap, d)
    jspec = JSpec(8, 4, True, True, 8)
    tspec = SerialSpec(8, 4, True, True, 8)

    def codes_both(h, seed):
        """Codes of h (E, C, K) with a step per expert, both packages."""
        a = (np.random.default_rng(seed).random(e) * 0.05 + 0.01).astype(
            np.float32)
        tc = quantize_int(h, torch.from_numpy(a)[:, None, None],
                          QuantSpec(8, True))
        jc = np.asarray(j_quantize_int(jnp.asarray(h.numpy()),
                                       jnp.asarray(a)[:, None, None],
                                       JQuant(8, True)))
        np.testing.assert_array_equal(tc.numpy(), jc)
        assert not jc[~rows].any()
        return tc, jc

    def acc_both(tc, jc, kdim, n, seed):
        """Accumulators of codes against random packed W4 weights, both
        packages; zero on every unfilled row."""
        _, wp = _grouped_case(e, 1, kdim, n, jspec, seed)
        ref = np.asarray(jax.vmap(lambda c, w: j_serial_packed(
            c, w, spec=jspec, k=kdim))(jnp.asarray(jc), jnp.asarray(wp)))
        got = km.bitserial_matmul_grouped_ref(tc, _t(wp), spec=tspec, k=kdim)
        np.testing.assert_array_equal(got.numpy(), ref)
        assert not ref[~rows].any() and not ref[empty].any()
        return got

    tc, jc = codes_both(hbuf, 1)
    up = acc_both(tc, jc, d, f, 2).float() * 0.01
    gate = acc_both(tc, jc, d, f, 3).float() * 0.01
    h = torch.nn.functional.silu(gate) * up
    assert not h[torch.from_numpy(~rows)].any()
    tc, jc = codes_both(h, 4)
    acc_both(tc, jc, f, d, 5)


def test_moe_float_qat_and_ref_apply_equal_reference(smoke):
    """Float params: ``moe_apply`` with LSQ fake-quant experts, and the
    dense loop-over-experts oracle ``moe_ref_apply``."""
    jcfg, tcfg, params, _ = smoke
    p = _layer(params["groups"][1]["moe"], 1)
    x = np.random.default_rng(5).standard_normal(
        (2, 6, jcfg.d_model)).astype(np.float32)
    ref, _ = jmoe.moe_apply(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                            jcfg.moe_cfg(), jcfg.policy, n_groups=1)
    got, _ = tmoe.moe_apply(_t(p), torch.from_numpy(x), tcfg.moe_cfg(),
                            tcfg.policy)
    _close(got, ref)
    ref = jmoe.moe_ref_apply(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                             jcfg.moe_cfg(), jcfg.policy)
    got = tmoe.moe_ref_apply(_t(p), torch.from_numpy(x), tcfg.moe_cfg(),
                             tcfg.policy)
    _close(got, ref)


def test_moe_apply_with_ample_capacity_equals_the_oracle(smoke):
    """Unquantized experts and a capacity no token can exceed: the
    capacity dispatch computes the loop-over-experts oracle."""
    _, tcfg, params, _ = smoke
    p = _t(_layer(params["groups"][1]["moe"], 0))
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (10, tcfg.d_model)).astype(np.float32))
    none = QuantPolicy(mode="none")
    got, aux = tmoe.moe_apply(p, x, tcfg.moe_cfg(), none,
                              capacity=10 * tcfg.top_k)
    assert float(aux["drop_frac"]) == 0.0
    _close(got, tmoe.moe_ref_apply(p, x, tcfg.moe_cfg(), none), rel=1e-5)


# ------------------------------------------------------------------- MLA

def _mla_params(tree, group=0):
    return _layer(tree["groups"][group]["attn"], 0)


def _mla_both(jcfg, tcfg, p, x, *, cache=None, pos=None, positions=None):
    """``mla_apply`` on both sides from the same numpy inputs; returns
    ((out, cache) of the reference, (out, cache) of the port)."""
    jc = None if cache is None else {
        "c": jnp.asarray(cache["c"]), "k_rope": jnp.asarray(cache["k_rope"]),
        "len": jnp.asarray(0, jnp.int32)}
    jpos = pos if pos is None or np.ndim(pos) == 0 else jnp.asarray(pos)
    jposn = None if positions is None else jnp.asarray(positions)
    ref = jattn.mla_apply(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                          jcfg.attn_cfg(), jcfg.policy, positions=jposn,
                          cache=jc, cache_pos=jpos)
    tc = None if cache is None else {
        "c": torch.from_numpy(cache["c"].copy()),
        "k_rope": torch.from_numpy(cache["k_rope"].copy()), "len": 0}
    tpos = pos if pos is None or np.ndim(pos) == 0 else torch.from_numpy(pos)
    tposn = None if positions is None else torch.from_numpy(positions)
    got = tattn.mla_apply(_t(p), torch.from_numpy(x), tcfg.attn_cfg(),
                          tcfg.policy, positions=tposn, cache=tc,
                          cache_pos=tpos)
    return ref, got


@pytest.mark.parametrize("which", ["packed", "float"])
def test_mla_prefill_equals_reference(smoke, which):
    """Prefill seeds the latent cache and attends through K/V that
    ``qdense(w_uk)``/``qdense(w_uv)`` materialize (LSQ fake-quant on their
    float params; on float params every projection is fake-quant)."""
    jcfg, tcfg, params, packed = smoke
    p = _mla_params(packed if which == "packed" else params)
    x = np.random.default_rng(7).standard_normal(
        (2, 6, jcfg.d_model)).astype(np.float32)
    acfg = jcfg.attn_cfg()
    cache = {"c": np.zeros((2, 16, acfg.kv_lora), np.float32),
             "k_rope": np.zeros((2, 16, acfg.qk_rope_dim), np.float32)}
    (rout, rc), (gout, gc) = _mla_both(jcfg, tcfg, p, x, cache=cache, pos=0)
    _close(gout, rout)
    assert gc["len"] == int(rc["len"]) == 6
    for name in ("c", "k_rope"):
        _close(gc[name], rc[name])
    # no cache: the training forward
    (rout, _), (gout, gnone) = _mla_both(jcfg, tcfg, p, x)
    _close(gout, rout)
    assert gnone is None


@pytest.mark.parametrize("pos", [6, np.array([6, 3], np.int32),
                                 np.array([0, 9], np.int32)])
def test_mla_decode_equals_reference(smoke, pos):
    """Decode: the absorbed float32 form over the latent cache (raw float
    ``w_uk``/``w_uv``), at a host position and at per-row positions."""
    jcfg, tcfg, _, packed = smoke
    p = _mla_params(packed, group=1)
    rng = np.random.default_rng(8)
    acfg = jcfg.attn_cfg()
    cache = {"c": rng.standard_normal((2, 16, acfg.kv_lora)).astype(
                 np.float32),
             "k_rope": rng.standard_normal((2, 16, acfg.qk_rope_dim)).astype(
                 np.float32)}
    x = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
    if np.ndim(pos):
        positions = pos[:, None].astype(np.int32)
    else:
        positions = np.full((1, 1), pos, np.int32)
    (rout, rc), (gout, gc) = _mla_both(jcfg, tcfg, p, x, cache=cache,
                                       pos=pos, positions=positions)
    _close(gout, rout)
    for name in ("c", "k_rope"):
        _close(gc[name], rc[name])
    np.testing.assert_array_equal(np.asarray(gc["len"]),
                                  np.asarray(rc["len"]))


# ----------------------------------------------------------------- model

def test_init_params_packed_layer_by_layer(smoke):
    """``init_params(packed=True)`` packs each layer as it is drawn: the
    same words as packing the float draw afterwards, in the reference's
    packed layout (the routed experts' (L, E, w_bits, K/32, N), MLA's
    ``w_uk``/``w_uv`` float)."""
    _, tcfg, _, packed = smoke
    own = tt.init_params(torch.Generator().manual_seed(3), tcfg, packed=True)
    again = tt.pack_params(tt.init_params(torch.Generator().manual_seed(3),
                                          tcfg), tcfg)
    ref = _t(packed)

    def leaves(tree, prefix=""):
        if isinstance(tree, dict):
            return {k2: v2 for k, v in tree.items()
                    for k2, v2 in leaves(v, f"{prefix}/{k}").items()}
        if isinstance(tree, list):
            return {k2: v2 for i, v in enumerate(tree)
                    for k2, v2 in leaves(v, f"{prefix}/{i}").items()}
        return {prefix: tree}

    lo, la, lr = leaves(own), leaves(again), leaves(ref)
    assert ({k: (tuple(v.shape), v.dtype) for k, v in lo.items()}
            == {k: (tuple(v.shape), v.dtype) for k, v in lr.items()})
    assert all(torch.equal(lo[k], la[k]) for k in lo)
    assert "w" in own["groups"][1]["attn"]["w_uk"]
    assert own["groups"][1]["moe"]["w_up"]["w_packed"].shape == (
        2, 4, 4, 2, 32)


def test_forward_logits_and_lb_loss_equal_reference(smoke):
    """The whole stack's forward on packed params: logits, and the Switch
    load-balance loss summed over the MoE layers."""
    jcfg, tcfg, _, packed = smoke
    toks = np.random.default_rng(10).integers(0, 512, (2, 7))
    ref, jaux = jt.forward(jax.tree.map(jnp.asarray, packed),
                           {"tokens": jnp.asarray(toks)}, jcfg)
    got, taux = tt.forward(_t(packed), {"tokens": torch.from_numpy(toks)},
                           tcfg)
    _close(got, ref)
    assert set(taux) == {"lb_loss"}
    _close(taux["lb_loss"], jaux["lb_loss"])


@pytest.fixture(scope="module")
def jax_runs(smoke):
    """One JAX ``Server`` run (3 prompts, 8 new tokens) and one JAX engine
    run (the CLI-shaped mixed load), shared by the module's tests."""
    jcfg, _, _, packed = smoke
    jp = jax.tree.map(jnp.asarray, packed)
    js = JServer(jcfg, jp, batch_slots=SLOTS, max_len=MAX_LEN)
    server = [r.out_tokens for r in js.generate(
        [JRequest(p.copy(), 8) for p in _prompts()])]
    je = JEngine(jcfg, params=jp, batch_slots=SLOTS, max_len=MAX_LEN,
                 backend="xla")
    engine = [r.out_tokens for r in je.serve(
        [JRequest(p.copy(), n) for p, n in _mixed()])]
    return {"server": server, "engine": engine}


def _prompts():
    return [np.arange(n, dtype=np.int32) * 7 % 512 for n in (3, 6, 9)]


def _mixed():
    """The reference CLI's mixed load shape: 8 prompts of 4-16 tokens from
    RandomState(0), every 4th request 8 new tokens, the others 2."""
    rng = np.random.RandomState(0)
    return [(rng.randint(0, 512, (int(rng.randint(4, 17)),)).astype(
        np.int32), 8 if i % 4 == 0 else 2) for i in range(8)]


@pytest.mark.parametrize("pack_acts", [True, False])
def test_server_greedy_tokens_equal_reference(smoke, jax_runs, pack_acts):
    _, tcfg, _, packed = smoke
    srv = Server(tcfg, _t(packed), batch_slots=SLOTS, max_len=MAX_LEN,
                 pack_acts=pack_acts, device="cpu")
    got = [r.out_tokens for r in srv.generate(
        [GenRequest(p.copy(), 8) for p in _prompts()])]
    assert got == jax_runs["server"]


@pytest.mark.parametrize("pack_acts", [True, False])
def test_engine_greedy_tokens_equal_reference(smoke, jax_runs, pack_acts):
    """The continuous engine (MLA latent cache inserted into the arena,
    MoE capacity over the arena's rows) gives the JAX engine's tokens; it
    keeps one drop fraction per step and MoE layer."""
    _, tcfg, _, packed = smoke
    eng = ContinuousLMEngine(tcfg, _t(packed), batch_slots=SLOTS,
                             max_len=MAX_LEN, pack_acts=pack_acts,
                             device="cpu")
    got = [r.out_tokens for r in eng.serve(
        [GenRequest(p.copy(), n) for p, n in _mixed()])]
    assert got == jax_runs["engine"]
    drops = eng.drop_fractions()
    assert drops.shape == (eng.decode_steps, 2)
    assert ((drops >= 0) & (drops <= 1)).all()
    assert eng.stats()["step_launches"] == {"K1": 0, "K3": 0, "K4": 0,
                                            "K4g": 0}


@pytest.mark.parametrize("size", ["smoke", "full"])
def test_decode_cost_stream_equals_reference(size):
    """MLA projections and the MoE layers' active experts (top-k routed +
    shared), job for job."""
    got = decode_cost_stream(getattr(get_arch(ARCH), size))
    ref = j_decode_cost_stream(getattr(j_get_arch(ARCH), size))
    assert got.mode == ref.mode
    assert len(got.jobs) == len(ref.jobs) == 2 * (
        6 * getattr(get_arch(ARCH), size).n_layers + 1)
    for a, b in zip(got.jobs, ref.jobs):
        assert (a.op.value, a.tag, a.m_tiles, a.k_tiles, a.n_outputs,
                a.a_bits, a.w_bits, a.cycles, tuple(a.depends_on)) == (
            b.op.value, b.tag, b.m_tiles, b.k_tiles, b.n_outputs, b.a_bits,
            b.w_bits, b.cycles, tuple(b.depends_on))
    assert got.summary() == ref.summary()
    assert got.total_cycles_pipelined() == ref.total_cycles_pipelined()


def test_serve_cli_deepseek_on_cpu():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve.main(["--arch", ARCH, "--device", "cpu", "--smoke", "--batch",
                    "2", "--new-tokens", "3"])
    text = buf.getvalue()
    assert "generated 12 tokens over 8 requests" in text
    assert "K1 + K3 + grouped K4" in text and "3 layers" in text
    assert "recompiles_after_warmup=0" in text and "sample:" in text


def test_quantize_codes_for_the_experts_in_float32(smoke):
    """The experts' activation codes come from a float32 divide whatever
    the compute dtype, as the reference promotes bf16 / float32."""
    _, tcfg, _, packed = smoke
    p = _t(_moe_layer(packed))["w_up"]
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (4, 2, tcfg.d_model)).astype(np.float32)).bfloat16()
    aa = p["alpha_a"][:, None, None]
    want = quantize_int(x.float(), aa, QuantSpec(8, True))
    ref = np.asarray(j_quantize_int(jnp.asarray(x.float().numpy()).astype(
        jnp.bfloat16), jnp.asarray(aa.numpy()), JQuant(8, True)))
    np.testing.assert_array_equal(want.numpy(), ref)
