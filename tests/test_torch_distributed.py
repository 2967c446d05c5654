"""The port's single-process pieces of ``repro/distributed`` — ``gpipe`` and
``stage_stack`` over CPU banks, the logical-axis context — and the MoE
that reads it (group-local dispatch, the ``relu2``/``gelu`` experts),
against the JAX package on the CPU.

``gpipe`` is held to the sequential stack within the reference test's own
tolerance (rtol 2e-4, atol 2e-5); the MoE to the reference's ``moe_apply``
and ``moe_ref_apply`` within ``tests/test_torch_moe.py``'s (1e-4 of the
largest magnitude), on the reference's own parameters carried across with
``params_from_numpy``, float (LSQ fake-quant) and packed.
"""

import _torch_threads  # noqa: F401  (first: caps torch's threads under xdist)

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import context as jctx
from repro.distributed.pipeline_parallel import stage_stack as j_stage_stack
from repro.models import moe as jmoe
from repro.models.layers import QuantPolicy as JPolicy
from repro.models.layers import pack_qdense as j_pack_qdense

from repro_torch.distributed import context as tctx
from repro_torch.distributed import program_parallel as pp
from repro_torch.distributed.pipeline_parallel import gpipe, stage_stack
from repro_torch.kernels import ops
from repro_torch.models import moe as tmoe
from repro_torch.models.layers import QuantPolicy
from repro_torch.models.transformer import params_from_numpy


def _close(got, ref, rel=1e-4):
    ref = np.asarray(ref, np.float32)
    got = got.float().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rel * max(np.abs(ref).max(), 1e-30))


# ------------------------------------------------------------------ gpipe

L, D = 8, 16


def _layer(w, h):
    return torch.tanh(h @ w)


def _stage_fn(wstage, h):            # wstage: (L/S, D, D)
    for w in wstage:
        h = _layer(w, h)
    return h


@pytest.mark.parametrize("n_stages,n_microbatches", [(4, 4), (4, None),
                                                     (2, 8), (1, 2)])
def test_gpipe_equals_the_sequential_stack(n_stages, n_microbatches):
    """The reference test's stack (L = 8 tanh layers of 16 x 16, 16 rows)
    over CPU banks, against the port's and the reference's sequential
    stacks."""
    rng = np.random.RandomState(0)
    ws = (rng.randn(L, D, D) / np.sqrt(D)).astype(np.float32)
    x = rng.randn(16, D).astype(np.float32)
    jref = jnp.asarray(x)
    for i in range(L):
        jref = jnp.tanh(jref @ jnp.asarray(ws[i]))
    tws, tx = torch.from_numpy(ws), torch.from_numpy(x)
    ref = tx
    for i in range(L):
        ref = _layer(tws[i], ref)
    banks = pp.bank_devices(n_stages, device="cpu")
    y = gpipe(_stage_fn, stage_stack(tws, n_stages), tx, banks=banks,
              n_microbatches=n_microbatches)
    assert y.shape == (16, D)
    np.testing.assert_allclose(y.numpy(), ref.numpy(), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(y.numpy(), np.asarray(jref), rtol=2e-4,
                               atol=2e-5)


def test_stage_stack_and_gpipe_errors_equal_reference():
    ws = np.zeros((6, 2, 2), np.float32)
    assert stage_stack({"w": torch.from_numpy(ws)}, 3)["w"].shape == (
        3, 2, 2, 2)
    for n in (4, 0):
        with pytest.raises(ValueError) as mine:
            stage_stack(torch.from_numpy(ws), n)
        with pytest.raises(ValueError) as theirs:
            j_stage_stack(jnp.asarray(ws), n)
        assert str(mine.value) == str(theirs.value)
    with pytest.raises(ValueError, match="not divisible into "
                                         "n_microbatches=3"):
        gpipe(_stage_fn, stage_stack(torch.zeros((4, 2, 2)), 2),
              torch.zeros((4, 2)), banks=["cpu", "cpu"], n_microbatches=3)


# ---------------------------------------------------------------- context

def test_bind_axes_and_axis_size_equal_reference():
    """Unbound, bound (a tuple of mesh axes, a single axis, an axis the
    mesh lacks), nested and restored: the same answers in both packages;
    the port also reads a plain dict of axis sizes."""
    mesh = types.SimpleNamespace(shape={"data": 2, "model": 4, "pod": 3})

    def state(ctx):
        return (ctx.active(), ctx.axis("dp"), ctx.axis("tp"),
                [ctx.axis_size(n) for n in ("dp", "tp", "sp", "pp")])

    assert state(tctx) == state(jctx) == (False, None, None, [1, 1, 1, 1])
    binds = [dict(dp=("data", "pod"), tp="model", mesh=mesh),
             dict(dp="data", sp="model", pp="ghost", mesh=mesh),
             dict(dp="data")]
    for kw in binds:
        with tctx.bind_axes(**kw), jctx.bind_axes(**kw):
            assert state(tctx) == state(jctx)
            with tctx.bind_axes(tp="pod", mesh=mesh), jctx.bind_axes(
                    tp="pod", mesh=mesh):
                assert state(tctx) == state(jctx)
                assert tctx.axis_size("tp") == 3
            assert state(tctx) == state(jctx)
    assert state(tctx) == state(jctx) == (False, None, None, [1, 1, 1, 1])
    with tctx.bind_axes(dp=("data", "model"), mesh={"data": 2, "model": 4}):
        assert tctx.axis_size("dp") == 8
        x = torch.ones(3)
        assert tctx.constrain(x, "dp") is x


# -------------------------------------------------------------------- MoE

D_MODEL, D_FF, E, K = 32, 24, 4, 2


def _cfgs(act, n_shared):
    kw = dict(d_model=D_MODEL, d_ff_expert=D_FF, n_experts=E, top_k=K,
              n_shared=n_shared, d_ff_shared=D_FF if n_shared else 0,
              act=act)
    return jmoe.MoEConfig(**kw), tmoe.MoEConfig(**kw)


POLICY = dict(mode="qat", w_bits=4, a_bits=8)

# the reference's MoE under jit: one XLA compile per configuration, where
# its eager dispatch compiles every vmapped op of every shape (seconds)
j_moe_apply = jax.jit(jmoe.moe_apply, static_argnums=(2, 3),
                      static_argnames=("capacity", "n_groups"))
j_moe_ref_apply = jax.jit(jmoe.moe_ref_apply, static_argnums=(2, 3))


def _moe_params(act, n_shared, packed):
    """The reference's ``moe_init`` (numpy), packed with its
    ``pack_qdense`` when asked."""
    jcfg, _ = _cfgs(act, n_shared)
    pol = JPolicy(**POLICY)
    p = jmoe.moe_init(jax.random.PRNGKey(3), jcfg, pol)
    if packed:
        p = {k: (j_pack_qdense(v, pol) if isinstance(v, dict) else v)
             for k, v in p.items()}
    return jax.tree.map(np.asarray, p)


@pytest.mark.parametrize("packed", [False, True], ids=["float", "serial"])
@pytest.mark.parametrize("n_shared", [0, 1])
@pytest.mark.parametrize("act", ["relu2", "gelu"])
def test_two_matrix_experts_equal_reference(act, n_shared, packed,
                                            monkeypatch):
    """``relu2``/``gelu`` experts (no ``w_gate``, no ``shared_gate``):
    ``moe_apply`` and the dense oracle equal the reference's; on packed
    weights grouped K4 runs twice a layer (up, down)."""
    jcfg, tcfg = _cfgs(act, n_shared)
    p = _moe_params(act, n_shared, packed)
    assert "w_gate" not in p and "shared_gate" not in p
    x = np.random.default_rng(7).standard_normal(
        (2, 8, D_MODEL)).astype(np.float32)
    ref, jaux = j_moe_apply(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                            jcfg, JPolicy(**POLICY), n_groups=1)
    calls = []
    inner = ops.serial_matmul_grouped_op
    monkeypatch.setattr(ops, "serial_matmul_grouped_op",
                        lambda *a, **kw: calls.append(1) or inner(*a, **kw))
    got, aux = tmoe.moe_apply(params_from_numpy(p, "cpu"),
                              torch.from_numpy(x), tcfg,
                              QuantPolicy(**POLICY))
    assert len(calls) == (2 if packed else 0)
    _close(got, ref)
    assert float(aux["drop_frac"]) == float(jaux["drop_frac"])
    _close(aux["lb_loss"], jaux["lb_loss"])
    if not packed:
        _close(tmoe.moe_ref_apply(params_from_numpy(p, "cpu"),
                                  torch.from_numpy(x), tcfg,
                                  QuantPolicy(**POLICY)),
               j_moe_ref_apply(jax.tree.map(jnp.asarray, p),
                               jnp.asarray(x), jcfg, JPolicy(**POLICY)))


def test_moe_init_draws_the_two_matrix_layout():
    for act in ("relu2", "gelu"):
        _, tcfg = _cfgs(act, 1)
        p = tmoe.moe_init(torch.Generator().manual_seed(0), tcfg,
                          QuantPolicy(**POLICY))
        assert sorted(p) == ["router", "shared_down", "shared_up", "w_down",
                             "w_up"]
        assert p["w_up"]["w"].shape == (E, D_MODEL, D_FF)
    with pytest.raises(ValueError, match="unknown MoE act"):
        tmoe.moe_init(torch.Generator(), _cfgs("tanh", 0)[1],
                      QuantPolicy(**POLICY))


@pytest.mark.parametrize("act", ["swiglu", "relu2"])
@pytest.mark.parametrize("n_groups", [1, 2, 4])
def test_group_local_dispatch_equals_reference(act, n_groups, monkeypatch):
    """``n_groups`` groups of T/G tokens, each with its own capacity and
    buffer: the reference's result and drop fraction, packed; grouped K4
    is one launch per matrix whatever ``n_groups`` is."""
    jcfg, tcfg = _cfgs(act, 1)
    p = _moe_params(act, 1, packed=True)
    x = (np.random.default_rng(11).standard_normal((1, 16, D_MODEL))
         * 2).astype(np.float32)
    ref, jaux = j_moe_apply(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                            jcfg, JPolicy(**POLICY), n_groups=n_groups)
    calls = []
    inner = ops.serial_matmul_grouped_op
    monkeypatch.setattr(ops, "serial_matmul_grouped_op",
                        lambda *a, **kw: calls.append(a[0].shape) or
                        inner(*a, **kw))
    got, aux = tmoe.moe_apply(params_from_numpy(p, "cpu"),
                              torch.from_numpy(x), tcfg,
                              QuantPolicy(**POLICY), n_groups=n_groups)
    assert len(calls) == (3 if act == "swiglu" else 2)
    cap = tmoe.capacity_for(16 // n_groups, tcfg)
    assert calls[0] == (E, n_groups * cap, D_MODEL)
    _close(got, ref)
    assert float(aux["drop_frac"]) == float(jaux["drop_frac"])


def test_default_groups_follow_the_bound_dp_axis():
    """Unbound: one group; under ``bind_axes(dp="data", mesh={"data": 2})``
    the default is 2 (the reference's with ``n_groups=2``); a dp size that
    does not divide T falls back to 1."""
    jcfg, tcfg = _cfgs("gelu", 0)
    p = _moe_params("gelu", 0, packed=True)
    tp = params_from_numpy(p, "cpu")
    pol = QuantPolicy(**POLICY)
    x = (np.random.default_rng(12).standard_normal((16, D_MODEL))
         * 2).astype(np.float32)
    tx = torch.from_numpy(x)

    def both(g):
        want = j_moe_apply(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                           jcfg, JPolicy(**POLICY), n_groups=g)
        return tmoe.moe_apply(tp, tx, tcfg, pol, n_groups=g), want

    (one, _), (jone, _) = both(1)
    (two, aux2), (jtwo, jaux2) = both(2)
    _close(one, jone)
    _close(two, jtwo)
    assert float(aux2["drop_frac"]) == float(jaux2["drop_frac"])
    assert torch.equal(tmoe.moe_apply(tp, tx, tcfg, pol)[0], one)
    with tctx.bind_axes(dp="data", mesh={"data": 2}):
        assert torch.equal(tmoe.moe_apply(tp, tx, tcfg, pol)[0], two)
    with tctx.bind_axes(dp="data", mesh={"data": 3}):
        assert torch.equal(tmoe.moe_apply(tp, tx, tcfg, pol)[0], one)
