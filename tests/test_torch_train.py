"""The port's training path on the CPU against the JAX package: LSQ's
straight-through estimator, AdamW and its schedule, the synthetic data
stream, checkpoints in the reference's on-disk format (both ways), the
training supervisor, ``loss_fn`` with its gradients and remat, one whole
train step, the ``Trainer`` and its CLI, and float serving
(``Server``/``ContinuousLMEngine`` with ``quantized=False``).

Models run at the smoke configs (stablelm-1.6b: 2 layers, d_model 64;
deepseek-v2-lite-16b: 3 layers, MLA + 4-expert MoE; float32) with the
reference's random parameters carried across by ``params_from_numpy``.

Tolerances, each with its reason:

* LSQ forward and ``dx``, data batches, checkpoint leaves, greedy
  tokens, resumed training state, remat against no remat: exact — the
  same IEEE operations in the same order, or copies.
* Losses of the float32 smoke models: 1e-5 relative — XLA's dot and
  torch's CPU GEMM sum in another order (logits a few ulps apart).
* LSQ ``dalpha``: 1e-5 of its largest element (float32), 2e-2 (bf16) —
  the sum down to alpha's shape adds in another order.
* Gradients of the models: 1e-3 of each leaf's largest element — float32
  sums in another order; an activation code that flips at a rounding
  boundary moves the step sizes' gradients.
* AdamW on the same params and grads: 1e-6 relative — ``pow`` and
  ``sqrt`` may differ by an ulp between XLA and torch.
* Params after one whole train step: 1e-2 of ``lr`` absolute — the first
  AdamW step moves each weight by about ``lr * sign(g)``, so a gradient's
  relative error carries over scaled by ``lr``.
* ``calibrate``: 1e-4 relative — XLA divides the percentile by 100 as a
  multiply by the reciprocal, so the interpolation position can sit one
  float32 ulp away; the result moves by that ulp times the gap between
  the neighbouring order statistics.
"""

import _torch_threads  # noqa: F401  (first: caps torch's threads under xdist)

import contextlib
import dataclasses
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.core import quant as jq
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.data.pipeline import make_batch_iter as j_make_batch_iter
from repro.launch.serve import GenRequest as JRequest
from repro.launch.serve import Server as JServer
from repro.launch.train import make_train_step as j_make_train_step
from repro.models import transformer as jt
from repro.optim import optimizer as jopt
from repro.runtime.checkpoint import CheckpointManager as JCheckpointManager
from repro.serving import ContinuousLMEngine as JEngine

from repro_torch.configs import get_arch
from repro_torch.core import quant as tq
from repro_torch.core.tree import tree_flatten, tree_leaves, tree_unflatten
from repro_torch.data import Prefetcher, SyntheticLM, make_batch_iter
from repro_torch.launch import train as ttrain
from repro_torch.launch.serve import GenRequest, Server
from repro_torch.launch.train import Trainer, make_train_step
from repro_torch.models import transformer as tt
from repro_torch.models.layers import QuantPolicy
from repro_torch.models.transformer import ModelConfig, params_from_numpy
from repro_torch.optim import optimizer as topt
from repro_torch.runtime.checkpoint import CheckpointManager
from repro_torch.runtime.fault_tolerance import (FailureInjector,
                                                 TrainSupervisor,
                                                 WorkerFailure)
from repro_torch.serving import ContinuousLMEngine

LM, MOE = "stablelm-1.6b", "deepseek-v2-lite-16b"

# the reference's test_system.py model
SYS_CFG = ModelConfig(
    name="sys-test", family="dense", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256, dtype="float32",
    remat=False, policy=QuantPolicy(mode="qat", w_bits=4, a_bits=8))


def _t(a):
    return params_from_numpy(a, "cpu")


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _rel_close(got, ref, rel):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    scale = max(float(np.max(np.abs(ref))), 1e-30) if ref.size else 1.0
    err = float(np.max(np.abs(got - ref))) if ref.size else 0.0
    assert err <= rel * scale, (err, scale)


def _batch(vocab, seq, step, n, seed=0):
    b = JSyntheticLM(vocab, seq, seed=seed).batch(step, n)
    return b, {k: torch.from_numpy(v).long() for k, v in b.items()}


# ------------------------------------------------------------------- LSQ

def _lsq_case(bits, signed, per_channel, seed=0):
    """Inputs that hit both clip edges exactly, lie beyond them, and fill
    the range between."""
    rng = np.random.default_rng(seed)
    qn, qp = jq.qrange(bits, signed)
    n = 12
    alpha = (np.abs(rng.normal(size=(1, n))) * 0.2 + 0.05).astype(np.float32) \
        if per_channel else np.float32(0.3)
    x = (rng.normal(size=(40, n)) * (qp - qn) * 0.3 * np.max(alpha)
         ).astype(np.float32)
    a = np.broadcast_to(alpha, (1, n))
    x[0] = qn * a[0]                 # at the lower clip
    x[1] = qp * a[0]                 # at the upper clip
    x[2] = (qn - 3) * a[0]           # beyond
    x[3] = (qp + 3) * a[0]
    x[4] = (np.arange(n) % max(qp, 1) + 0.5) * a[0]   # rounding ties
    g = rng.normal(size=x.shape).astype(np.float32)
    return x, alpha, g


@pytest.mark.parametrize("per_channel", [False, True])
@pytest.mark.parametrize("signed", [True, False])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_lsq_gradients_match_jax(bits, signed, per_channel):
    x, alpha, g = _lsq_case(bits, signed, per_channel, seed=bits)
    jspec = jq.QuantSpec(bits, signed, per_channel)
    tspec = tq.QuantSpec(bits, signed, per_channel)
    f = lambda xx, aa: jnp.sum(jq.lsq_fake_quant(xx, aa, jspec) * g)
    y_j = jq.lsq_fake_quant(jnp.asarray(x), jnp.asarray(alpha), jspec)
    dx_j, da_j = jax.grad(f, argnums=(0, 1))(jnp.asarray(x),
                                             jnp.asarray(alpha))
    xt = torch.tensor(x, requires_grad=True)
    at = torch.tensor(alpha, requires_grad=True)
    y = tq.lsq_fake_quant(xt, at, tspec)
    (y * torch.from_numpy(g)).sum().backward()
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(y_j))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(dx_j))
    assert xt.grad.shape == xt.shape and at.grad.shape == at.shape
    _rel_close(at.grad.numpy(), da_j, 1e-5)


def test_lsq_gradients_match_jax_bf16():
    """The full-width models fake-quantize bf16 activations with a
    per-tensor step cast to bf16; the gradient reaches the float32 step."""
    x, alpha, g = _lsq_case(8, True, False, seed=5)
    jspec, tspec = jq.QuantSpec(8, True), tq.QuantSpec(8, True)
    xb = jnp.asarray(x, jnp.bfloat16)
    gb = jnp.asarray(g, jnp.bfloat16)
    f = lambda xx, aa: jnp.sum(
        (jq.lsq_fake_quant(xx, aa.astype(xx.dtype), jspec) * gb
         ).astype(jnp.float32))
    dx_j, da_j = jax.grad(f, argnums=(0, 1))(xb, jnp.asarray(alpha))
    xt = torch.tensor(x).to(torch.bfloat16).requires_grad_(True)
    at = torch.tensor(alpha, requires_grad=True)
    y = tq.lsq_fake_quant(xt, at.to(torch.bfloat16), tspec)
    (y * torch.tensor(g).to(torch.bfloat16)).float().sum().backward()
    np.testing.assert_array_equal(xt.grad.float().numpy(),
                                  np.asarray(dx_j.astype(jnp.float32)))
    assert at.grad.dtype == torch.float32
    _rel_close(at.grad.numpy(), da_j, 2e-2)


def test_lsq_ste_passthrough_gradient():
    """The reference's test_quant property: inside the clip range the
    gradient wrt x is 1, outside it is 0."""
    spec = tq.QuantSpec(8, True)
    x = torch.linspace(-2.0, 2.0, 65, requires_grad=True)
    tq.lsq_fake_quant(x, torch.tensor(0.01), spec).sum().backward()
    interior = np.abs(x.detach().numpy() / 0.01) < 127
    np.testing.assert_array_equal(x.grad.numpy()[interior], 1.0)
    np.testing.assert_array_equal(x.grad.numpy()[~interior], 0.0)
    assert interior.any() and not interior.all()


def test_lsq_alpha_learns():
    """The reference's test_quant property: from a 5x too large step,
    gradient descent on the step alone lowers the fake-quant MSE."""
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.normal(size=(256,)).astype(np.float32))
    spec = tq.QuantSpec(4, True)
    alpha = (tq.init_alpha(x, spec) * 5.0).requires_grad_(True)

    def loss(a):
        return torch.mean((tq.lsq_fake_quant(x, a, spec) - x) ** 2)

    l0 = float(loss(alpha).detach())
    for _ in range(100):
        (g,) = torch.autograd.grad(loss(alpha), alpha)
        alpha = (alpha - 0.05 * g).detach().requires_grad_(True)
    assert float(loss(alpha).detach()) < l0


@pytest.mark.parametrize("axis", [None, 0])
def test_calibrate_and_dequantize_match_jax(axis):
    rng = np.random.default_rng(3)
    x = rng.standard_t(3, size=(500, 16)).astype(np.float32)
    spec_j, spec_t = jq.QuantSpec(4, True), tq.QuantSpec(4, True)
    a_j = np.asarray(jq.calibrate(jnp.asarray(x), spec_j, axis=axis))
    a_t = tq.calibrate(torch.from_numpy(x), spec_t, axis=axis)
    assert tuple(a_t.shape) == a_j.shape
    _rel_close(a_t.numpy(), a_j, 1e-4)
    codes = rng.integers(-8, 8, size=(500, 16)).astype(np.int32)
    np.testing.assert_array_equal(
        tq.dequantize(torch.from_numpy(codes), torch.tensor(a_j)).numpy(),
        np.asarray(jq.dequantize(jnp.asarray(codes), jnp.asarray(a_j))))


# ----------------------------------------------------------------- AdamW

def _opt_tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(6, 5)).astype(np.float32),
            "layers": [{"b": rng.normal(size=(5,)).astype(np.float32),
                        "k": rng.normal(size=(2, 3, 4)).astype(np.float32)}],
            "alpha": np.float32(rng.normal())}


@pytest.mark.parametrize("grad_clip", [1.0, 100.0])
def test_adamw_matches_reference(grad_clip):
    """Three steps on the same params and grads: a 1-d leaf and a 0-d
    leaf (no decay), a 3-d stack, and a global norm above (clipped) or
    below the limit."""
    cfg_j = jopt.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=5,
                             grad_clip=grad_clip)
    cfg_t = topt.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=5,
                             grad_clip=grad_clip)
    pj = jax.tree.map(jnp.asarray, _opt_tree(0))
    sj = jopt.adamw_init(pj)
    pt = _t(_opt_tree(0))
    st = topt.adamw_init(pt)
    for step in range(3):
        g = _opt_tree(10 + step)
        pj, sj, mj = jopt.adamw_update(pj, jax.tree.map(jnp.asarray, g),
                                       sj, cfg_j)
        pt, st, mt = topt.adamw_update(pt, _t(g), st, cfg_t)
        _rel_close(float(mt["grad_norm"]), float(mj["grad_norm"]), 1e-6)
        _rel_close(float(mt["lr"]), float(mj["lr"]), 1e-6)
        for a, b in zip(tree_leaves(pt), jax.tree.leaves(pj)):
            assert a.dtype == torch.float32 and tuple(a.shape) == b.shape
            _rel_close(a.numpy(), b, 1e-6)
        for key in ("m", "v"):
            for a, b in zip(tree_leaves(st[key]), jax.tree.leaves(sj[key])):
                _rel_close(a.numpy(), b, 1e-6)
        assert st["step"].dtype == torch.int32
        assert int(st["step"]) == int(sj["step"]) == step + 1
    clipped = float(mt["grad_norm"]) > grad_clip
    assert clipped == (grad_clip == 1.0)


def test_cosine_lr_matches_reference():
    cfg_j = jopt.AdamWConfig(lr=3e-4, warmup_steps=10, total_steps=100)
    cfg_t = topt.AdamWConfig(lr=3e-4, warmup_steps=10, total_steps=100)
    for s in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        _rel_close(float(topt.cosine_lr(cfg_t, torch.tensor(s))),
                   float(jopt.cosine_lr(cfg_j, s)), 1e-6)
    assert float(topt.cosine_lr(cfg_t, torch.tensor(200))) == \
        pytest.approx(3e-5)


# ------------------------------------------------------------------ data

def test_synthetic_lm_and_batch_iter_equal_the_reference():
    for seed, step, n in ((0, 0, 8), (3, 17, 4), (0, 10_001, 8)):
        a = SyntheticLM(100, 16, seed=seed).batch(step, n)
        b = JSyntheticLM(100, 16, seed=seed).batch(step, n)
        assert sorted(a) == sorted(b) == ["labels", "tokens"]
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    ours = list(make_batch_iter(64, 8, 4, seed=2, start_step=5, n_steps=3))
    ref = list(j_make_batch_iter(64, 8, 4, seed=2, start_step=5, n_steps=3))
    assert [s for s, _ in ours] == [s for s, _ in ref] == [5, 6, 7]
    for (_, a), (_, b) in zip(ours, ref):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_prefetcher_propagates_errors():
    def bad():
        yield 1
        raise ValueError("boom")

    it = Prefetcher(bad())
    assert next(it) == 1
    with pytest.raises(ValueError, match="boom"):
        next(it)


def test_tree_flatten_order_is_the_references():
    tree = {"z": [np.ones(1), {"b": np.zeros(2), "a": np.ones(3)}],
            "a": np.arange(4.0), "m": (np.ones(5), np.zeros(6))}
    ours, treedef = tree_flatten(tree)
    ref = jax.tree.leaves(tree)
    assert [l.shape for l in ours] == [l.shape for l in ref]
    back = tree_unflatten(treedef, ours)
    assert isinstance(back["m"], tuple) and list(back["z"][1]) == ["a", "b"]
    with pytest.raises(ValueError, match="more leaves"):
        tree_unflatten(treedef, ours + [np.ones(1)])


# ----------------------------------------------------------- checkpoints

def test_checkpoint_roundtrip(tmp_path):
    ckpt = CheckpointManager(str(tmp_path))
    tree = {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "b": [torch.ones(2), {"c": torch.zeros((), dtype=torch.int32)}]}
    ckpt.save(7, tree, blocking=True)
    assert ckpt.latest_step() == 7
    tree["a"].add_(1)          # the snapshot was taken at save()
    out = ckpt.restore(7, tree)
    assert torch.equal(out["a"], torch.arange(12.0).reshape(3, 4))
    assert out["b"][1]["c"].dtype == torch.int32
    with open(tmp_path / "step_7" / "manifest.json") as f:
        man = json.load(f)
    assert man == {"step": 7, "treedef": None, "n_leaves": 3,
                   "shapes": [[3, 4], [2], []],
                   "dtypes": ["float32", "float32", "int32"]}


def test_checkpoint_async_gc_and_atomicity(tmp_path):
    ckpt = CheckpointManager(str(tmp_path / "gc"), max_to_keep=2)
    tree = {"w": torch.ones((64, 64))}
    for s in (1, 2, 3, 4):
        ckpt.save(s, tree)
    ckpt.wait()
    assert ckpt.all_steps() == [3, 4]
    # a .tmp directory is never listed as a restorable step
    atomic = CheckpointManager(str(tmp_path / "atomic"))
    os.makedirs(tmp_path / "atomic" / "step_9.tmp")
    assert atomic.all_steps() == [] and atomic.latest_step() is None


def test_checkpoint_structure_mismatch_raises(tmp_path):
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(1, {"a": torch.ones((2,))}, blocking=True)
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(1, {"a": torch.ones((3,))})
    with pytest.raises(ValueError, match="structure mismatch"):
        ckpt.restore(1, {"a": torch.ones((2,)), "b": torch.ones((2,))})


@pytest.fixture(scope="module")
def lm_smoke():
    """stablelm-1.6b's smoke config (both sides) and the reference's train
    state (float params and fresh AdamW state) as numpy."""
    jcfg, tcfg = j_get_arch(LM).smoke, get_arch(LM).smoke
    params = jt.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, _np_tree({"params": params,
                                 "opt": jopt.adamw_init(params)})


def test_checkpoints_cross_between_the_packages(tmp_path, lm_smoke):
    """A train state the reference's CheckpointManager writes restores in
    the port bit for bit, and the reverse."""
    _, _, state = lm_smoke
    jstate = jax.tree.map(jnp.asarray, state)
    JCheckpointManager(str(tmp_path / "j")).save(3, jstate, blocking=True)
    target = _t(state)
    got = CheckpointManager(str(tmp_path / "j")).restore(3, target)
    ref = jax.tree.leaves(state)
    assert len(tree_leaves(got)) == len(ref) > 30
    for a, b in zip(tree_leaves(got), ref):
        np.testing.assert_array_equal(a.numpy(), b)
        assert str(a.numpy().dtype) == str(b.dtype)
    # the port writes; the reference restores into its own structure
    leaves, treedef = tree_flatten(target)
    moved = tree_unflatten(treedef, [l + 1 if l.is_floating_point() else l
                                     for l in leaves])
    CheckpointManager(str(tmp_path / "t")).save(5, moved, blocking=True)
    abstract = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                            jstate)
    back = JCheckpointManager(str(tmp_path / "t")).restore(5, abstract)
    for a, b in zip(jax.tree.leaves(back), tree_leaves(moved)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


# ------------------------------------------------------------ supervisor

def _toy_problem():
    data = SyntheticLM(vocab_size=32, seq_len=8, seed=3)

    def build_state(ckpt_step):
        return {"w": torch.zeros((32, 32))}

    def step_fn(state, step):
        batch = data.batch(step, 4)
        eye = torch.eye(32)
        x = eye[torch.from_numpy(batch["tokens"]).long()].reshape(-1, 32)
        y = eye[torch.from_numpy(batch["labels"]).long()].reshape(-1, 32)
        g = x.T @ (x @ state["w"] - y) / x.shape[0]
        return {"w": state["w"] - 0.1 * g}, {}

    return build_state, step_fn


def test_supervisor_bit_exact_resume(tmp_path):
    build_a, step_a = _toy_problem()
    sup_a = TrainSupervisor(CheckpointManager(str(tmp_path / "a")),
                            save_every=5)
    clean = sup_a.run(build_a, step_a, n_steps=20)

    build_b, step_b = _toy_problem()
    ckpt_b = CheckpointManager(str(tmp_path / "b"))

    def build_b_resume(ckpt_step):
        state = build_b(None)
        if ckpt_step is not None:
            state = ckpt_b.restore(ckpt_step, state)
        return state

    sup_b = TrainSupervisor(ckpt_b, save_every=5)
    faulty = sup_b.run(build_b_resume, step_b, n_steps=20,
                       injector=FailureInjector(fail_at_steps=(7, 13)))
    assert sup_b.restarts == 2
    assert ckpt_b.all_steps() == [10, 15, 20]
    assert torch.equal(clean["w"], faulty["w"])


def test_supervisor_restart_budget(tmp_path):
    build, _ = _toy_problem()
    sup = TrainSupervisor(CheckpointManager(str(tmp_path)), save_every=100,
                          max_restarts=1)

    def step_always_fail(state, s):
        raise WorkerFailure("dead host")

    with pytest.raises(RuntimeError, match="restart budget"):
        sup.run(build, step_always_fail, n_steps=5,
                injector=FailureInjector(fail_at_steps=(2,), fail_once=False))
    assert sup.restarts == 2


# --------------------------------------------------- loss and gradients

def _grads(tcfg, params, batch):
    leaves, treedef = tree_flatten(params)
    leaves = [l.detach().requires_grad_(True) for l in leaves]
    loss, aux = tt.loss_fn(tree_unflatten(treedef, leaves), batch, tcfg)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), {k: v.detach() for k, v in aux.items()}, grads


@pytest.mark.parametrize("arch", [LM, MOE])
def test_loss_and_grads_match_jax(arch):
    """``loss_fn`` and its gradients against ``jax.value_and_grad`` of the
    reference's (an MoE stack adds ``0.01 * lb_loss``); remat
    ``"nothing"`` and ``"dots"`` give gradients equal bit for bit to no
    remat."""
    jcfg, tcfg = j_get_arch(arch).smoke, get_arch(arch).smoke
    jp = jt.init_params(jax.random.PRNGKey(1), jcfg)
    b, tb = _batch(jcfg.vocab_size, 16, 3, 4)
    # masked positions (labels is a view of the tokens' array: copy it)
    b["labels"] = b["labels"].copy()
    b["labels"][0, :5] = -1
    tb["labels"][0, :5] = -1
    (jl, jaux), jg = jax.value_and_grad(jt.loss_fn, has_aux=True)(
        jp, jax.tree.map(jnp.asarray, b), jcfg)
    params = _t(_np_tree(jp))
    loss, aux, grads = _grads(tcfg, params, tb)
    _rel_close(float(loss), float(jl), 1e-5)
    _rel_close(float(aux["ce"]), float(jaux["ce"]), 1e-5)
    if arch == MOE:
        assert float(jaux["lb_loss"]) > 0
        _rel_close(float(aux["lb_loss"]), float(jaux["lb_loss"]), 1e-5)
    ref = jax.tree.leaves(jg)
    assert len(grads) == len(ref)
    for g, r in zip(grads, ref):
        assert tuple(g.shape) == r.shape
        _rel_close(g.numpy(), r, 1e-3)
    for policy in ("nothing", "dots"):
        cfg = dataclasses.replace(tcfg, remat=True, remat_policy=policy)
        l2, _, g2 = _grads(cfg, params, tb)
        assert torch.equal(l2, loss)
        assert all(torch.equal(a, c) for a, c in zip(g2, grads))


def test_train_step_matches_jax(lm_smoke):
    """One whole train step (loss, backward, AdamW) from the same state
    and batch."""
    jcfg, tcfg, state = lm_smoke
    opt_j = jopt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    opt_t = topt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    b, tb = _batch(jcfg.vocab_size, 16, 0, 4)
    jnew, jm = jax.jit(j_make_train_step(jcfg, opt_j))(
        jax.tree.map(jnp.asarray, state), jax.tree.map(jnp.asarray, b))
    tstate = _t(state)
    tnew, tm = make_train_step(tcfg, opt_t)(tstate, tb)
    _rel_close(float(tm["loss"]), float(jm["loss"]), 1e-5)
    _rel_close(float(tm["ce"]), float(jm["ce"]), 1e-5)
    _rel_close(float(tm["grad_norm"]), float(jm["grad_norm"]), 1e-4)
    assert float(tm["lr"]) == float(jm["lr"])
    assert int(tnew["opt"]["step"]) == 1
    for a, r, p0 in zip(tree_leaves(tnew["params"]),
                        jax.tree.leaves(jnew["params"]),
                        tree_leaves(tstate["params"])):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-2 * opt_t.lr)
        assert not torch.equal(a, p0)     # every leaf moved
    # the caller's state is not written
    for a, b0 in zip(tree_leaves(tstate), jax.tree.leaves(state)):
        np.testing.assert_array_equal(a.numpy(), b0)


def test_training_after_serving_in_one_process(lm_smoke):
    """The shared device scalars (attention's sqrt(d), the rotary base)
    that a server makes under ``torch.inference_mode`` can be saved for
    backward by a later train step in the same process."""
    from repro_torch.models.layers import device_scalar
    _, tcfg, state = lm_smoke
    device_scalar.cache_clear()
    srv = Server(tcfg, _t(state["params"]), batch_slots=1, max_len=16,
                 quantized=False, device="cpu")
    srv.generate([GenRequest(np.arange(4, dtype=np.int32), 2)])
    _, tb = _batch(tcfg.vocab_size, 8, 0, 2)
    loss, _, grads = _grads(tcfg, _t(state["params"]), tb)
    assert np.isfinite(float(loss)) and len(grads) > 20


# --------------------------------------------------------------- trainer

def test_trainer_learns_synthetic_bigrams():
    """The reference's test_system criterion on its model."""
    trainer = Trainer(SYS_CFG, opt_cfg=topt.AdamWConfig(
        lr=2e-3, warmup_steps=5, total_steps=60), batch_size=8, seq_len=32,
        device="cpu")
    _, losses = trainer.run(60, log_every=1000)
    assert len(losses) == 60
    assert losses[-1] < losses[0] - 0.3, (losses[0], losses[-1])
    assert trainer.detector.snapshot()["observed"] == 60


def test_trainer_resumes_bit_exact(tmp_path):
    """A supervised run with an injected failure equals, bit for bit, an
    uninterrupted one (params and optimizer state), the checkpoints'
    leaves in the reference's order."""
    def run(fail, ckpt):
        trainer = Trainer(SYS_CFG, opt_cfg=topt.AdamWConfig(
            lr=1e-3, warmup_steps=5, total_steps=30),
            ckpt_dir=ckpt, batch_size=4, seq_len=16, save_every=5,
            device="cpu")
        inj = FailureInjector(fail_at_steps=(7,)) if fail else None
        return trainer.run(12, injector=inj, log_every=1000)

    clean, lc = run(False, None)
    faulty, lf = run(True, str(tmp_path))
    assert lf[:7] == lc[:7] and lf[-5:] == lc[-5:] and len(lf) == 14
    for a, b in zip(tree_leaves(clean), tree_leaves(faulty)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert CheckpointManager(str(tmp_path)).all_steps() == [5, 10, 12]


def test_trainer_needs_a_card_or_the_cpu(monkeypatch):
    opt = topt.AdamWConfig()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(SYS_CFG, opt_cfg=opt)


def test_train_cli_on_cpu(tmp_path):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ttrain.main(["--arch", LM, "--smoke", "--device", "cpu", "--steps",
                     "3", "--batch", "2", "--seq", "8", "--log-every", "1",
                     "--ckpt-dir", str(tmp_path)])
    text = buf.getvalue()
    assert text.count("step ") >= 3 and "done: 3 steps of" in text
    assert CheckpointManager(str(tmp_path)).all_steps() == [3]


# ---------------------------------------------------------- float serving

def test_float_serving_matches_the_reference(lm_smoke):
    """``Server(quantized=False)`` and ``ContinuousLMEngine(quantized=
    False)`` serve the float params through LSQ's forward and give the
    reference's greedy tokens."""
    jcfg, tcfg, state = lm_smoke
    params = state["params"]
    rng = np.random.RandomState(2)
    prompts = [rng.randint(0, jcfg.vocab_size, (n,)).astype(np.int32)
               for n in (3, 6, 9)]
    js = JServer(jcfg, params=jax.tree.map(jnp.asarray, params),
                 batch_slots=4, max_len=24, quantized=False)
    want = [r.out_tokens for r in js.generate(
        [JRequest(p.copy(), 6) for p in prompts])]
    ts = Server(tcfg, _t(params), batch_slots=4, max_len=24,
                quantized=False, device="cpu")
    got = [r.out_tokens for r in ts.generate(
        [GenRequest(p.copy(), 6) for p in prompts])]
    assert got == want
    je = JEngine(jcfg, jax.tree.map(jnp.asarray, params), batch_slots=2,
                 max_len=24, quantized=False)
    te = ContinuousLMEngine(tcfg, _t(params), batch_slots=2, max_len=24,
                            quantized=False, device="cpu")
    reqs = [(p, n) for p, n in zip(prompts, (5, 2, 4))]
    want = [r.out_tokens for r in je.serve(
        [JRequest(p.copy(), n) for p, n in reqs])]
    got = [r.out_tokens for r in te.serve(
        [GenRequest(p.copy(), n) for p, n in reqs])]
    assert got == want
