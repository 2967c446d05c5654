"""Training every family the reference trains, on the CPU against the JAX
package: the SSM (mamba2-780m), the hybrid (hymba-1.5b), the VLM
(internvl2-76b, with its patches) and the encoder-decoder
(seamless-m4t-large-v2, with its source) at their smoke configs, the
reference's random parameters carried across by ``params_from_numpy`` and
the batches made from a seed with numpy.

Checked: ``loss_fn`` and every gradient against ``jax.value_and_grad``;
remat ``"nothing"`` and ``"dots"`` against no remat (deepseek's MoE
too), and ``"dots"`` against the reference's ``"dots"``; one whole train
step against the reference's; the donated step against the step run out
of place; the ``Trainer`` on each family it takes, a supervised mamba2
resume, the encoder-decoder's refusal; ``launch/dryrun.py``'s
``train_4k`` batch against the reference's ``input_specs``.

Tolerances, each with its reason (those of ``tests/test_torch_train.py``):

* Loss and ``ce``: 1e-5 relative — XLA's dot and torch's CPU GEMM sum in
  another order (logits a few ulps apart).
* Gradients: 1e-3 of each leaf's largest element — float32 sums in
  another order, and an 8-bit activation code that flips at a rounding
  boundary moves the step sizes' gradients.
* Params after one whole train step: 1e-2 of ``lr`` absolute — the first
  AdamW step moves each weight by about ``lr * sign(g)``.
* Remat against no remat, donated against out of place, a resumed run
  against an uninterrupted one: exact — the same operations on the same
  values, in the same order.
"""

import _torch_threads  # noqa: F401  (first: caps torch's threads under xdist)

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_arch as j_get_arch
from repro.configs.base import SHAPES as J_SHAPES
from repro.configs.base import input_specs as j_input_specs
from repro.launch.train import Trainer as JTrainer
from repro.launch.train import make_train_step as j_make_train_step
from repro.models import transformer as jt
from repro.optim import optimizer as jopt

from repro_torch.configs import get_arch
from repro_torch.core.tree import tree_flatten, tree_leaves, tree_unflatten
from repro_torch.launch import dryrun
from repro_torch.launch.train import Trainer, make_train_step
from repro_torch.models import transformer as tt
from repro_torch.models.transformer import params_from_numpy
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.runtime.checkpoint import CheckpointManager
from repro_torch.runtime.fault_tolerance import FailureInjector

FAMILIES = ("mamba2-780m", "hymba-1.5b", "internvl2-76b",
            "seamless-m4t-large-v2")
MOE = "deepseek-v2-lite-16b"
ROWS, SEQ, SRC = 2, 16, 12


def _rel_close(got, ref, rel):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    scale = max(float(np.max(np.abs(ref))), 1e-30) if ref.size else 1.0
    err = float(np.max(np.abs(got - ref))) if ref.size else 0.0
    assert err <= rel * scale, (err, scale)


def _batch(cfg, seed=0):
    """Tokens and labels (a few masked), plus the patches or the source the
    family reads, as numpy."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (ROWS, SEQ)).astype(
        np.int32)}
    b["labels"] = rng.integers(0, cfg.vocab_size, (ROWS, SEQ)).astype(
        np.int32)
    b["labels"][0, :3] = -1
    if cfg.family == "vlm":
        b["frontend_embeds"] = rng.standard_normal(
            (ROWS, cfg.frontend_len, cfg.frontend_dim)).astype(np.float32)
    if cfg.family in ("encdec", "audio"):
        b["src_embeds"] = rng.standard_normal(
            (ROWS, SRC, cfg.frontend_dim)).astype(np.float32)
    return b


def _tb(b):
    return {k: (torch.from_numpy(v).long() if v.dtype == np.int32
                else torch.from_numpy(v)) for k, v in b.items()}


@functools.lru_cache(maxsize=None)
def _model(arch):
    """The reference's smoke params (seed 1) as numpy, a batch, and the
    reference's loss, ce and gradients on them."""
    jcfg = j_get_arch(arch).smoke
    jp = jax.tree.map(np.asarray, jt.init_params(jax.random.PRNGKey(1),
                                                 jcfg))
    b = _batch(jcfg)
    (jl, jaux), jg = jax.value_and_grad(jt.loss_fn, has_aux=True)(
        jax.tree.map(jnp.asarray, jp), jax.tree.map(jnp.asarray, b), jcfg)
    return jp, b, (float(jl), float(jaux["ce"]),
                   [np.asarray(g) for g in jax.tree.leaves(jg)])


def _grads(cfg, params, batch):
    leaves, treedef = tree_flatten(params)
    leaves = [l.detach().requires_grad_(True) for l in leaves]
    loss, aux = tt.loss_fn(tree_unflatten(treedef, leaves), batch, cfg)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), aux["ce"].detach(), grads


def _remat(cfg, policy):
    return dataclasses.replace(cfg, remat=True, remat_policy=policy)


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_grads_match_jax(arch):
    """``loss_fn`` and every gradient, the patches' and the source's
    projection included, against ``jax.value_and_grad``."""
    jp, b, (jl, jce, jg) = _model(arch)
    loss, ce, grads = _grads(get_arch(arch).smoke, params_from_numpy(
        jp, "cpu"), _tb(b))
    _rel_close(float(loss), jl, 1e-5)
    _rel_close(float(ce), jce, 1e-5)
    assert len(grads) == len(jg)
    for g, r in zip(grads, jg):
        assert tuple(g.shape) == r.shape
        _rel_close(g.numpy(), r, 1e-3)


@pytest.mark.parametrize("arch", FAMILIES + (MOE,))
def test_remat_policies_equal_no_remat_bit_for_bit(arch):
    """Under ``"nothing"`` and ``"dots"`` (selective checkpointing) the
    loss and every gradient equal no remat's exactly: the same ops run,
    recomputed or read back; an MoE layer's statistics still leave the
    checkpoint."""
    cfg = get_arch(arch).smoke
    params = tt.init_params(torch.Generator().manual_seed(2), cfg)
    tb = _tb(_batch(cfg))
    l0, ce0, g0 = _grads(cfg, params, tb)
    for policy in ("nothing", "dots"):
        l1, ce1, g1 = _grads(_remat(cfg, policy), params, tb)
        assert torch.equal(l1, l0) and torch.equal(ce1, ce0), policy
        assert all(torch.equal(a, c) for a, c in zip(g1, g0)), policy


class _CountMM(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.n += 1
        return func(*args, **(kwargs or {}))


def test_dots_keeps_the_projections_and_refuses_other_policies():
    """``"dots"`` saves each layer's projection outputs: its backward makes
    no ``mm`` call but the gradients' own, as many as without remat, where
    ``"nothing"``'s backward runs the projections again; any other policy
    raises."""
    cfg = get_arch("stablelm-1.6b").smoke
    params = tt.init_params(torch.Generator().manual_seed(2), cfg)
    tb = _tb(_batch(cfg))
    counts = {}
    for policy in (None, "nothing", "dots"):
        c = cfg if policy is None else _remat(cfg, policy)
        leaves, treedef = tree_flatten(params)
        leaves = [l.detach().requires_grad_(True) for l in leaves]
        loss, _ = tt.loss_fn(tree_unflatten(treedef, leaves), tb, c)
        with _CountMM() as mode:
            torch.autograd.grad(loss, leaves)
        counts[policy] = mode.n
    assert counts["dots"] == counts[None] < counts["nothing"], counts
    with pytest.raises(ValueError, match="'nothing' or 'dots'"):
        _grads(_remat(cfg, "offload"), params, tb)


@pytest.mark.parametrize("arch", ("mamba2-780m", "seamless-m4t-large-v2"))
def test_dots_grads_match_the_references_dots(arch):
    """The port's ``"dots"`` gradients against the reference's
    ``remat_policy="dots"`` (``dots_with_no_batch_dims_saveable``)."""
    jcfg = dataclasses.replace(j_get_arch(arch).smoke, remat=True,
                               remat_policy="dots")
    jp, b, _ = _model(arch)
    (jl, _), jg = jax.value_and_grad(jt.loss_fn, has_aux=True)(
        jax.tree.map(jnp.asarray, jp), jax.tree.map(jnp.asarray, b), jcfg)
    loss, _, grads = _grads(_remat(get_arch(arch).smoke, "dots"),
                            params_from_numpy(jp, "cpu"), _tb(b))
    _rel_close(float(loss), float(jl), 1e-5)
    for g, r in zip(grads, jax.tree.leaves(jg)):
        _rel_close(g.numpy(), np.asarray(r), 1e-3)


@pytest.mark.parametrize("arch", ("mamba2-780m", "hymba-1.5b"))
def test_train_step_matches_jax(arch):
    """One whole train step (loss, backward, AdamW) from the same state
    and batch as the reference's, and the donated step equal to it run
    out of place, bit for bit."""
    jcfg, tcfg = j_get_arch(arch).smoke, get_arch(arch).smoke
    jp, b, _ = _model(arch)
    state = {"params": jp, "opt": jax.tree.map(np.asarray,
                                               jopt.adamw_init(jp))}
    opt_j = jopt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    opt_t = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    jnew, jm = jax.jit(j_make_train_step(jcfg, opt_j))(
        jax.tree.map(jnp.asarray, state), jax.tree.map(jnp.asarray, b))

    def tstate():
        return params_from_numpy(state, "cpu")

    t0 = tstate()
    tnew, tm = make_train_step(tcfg, opt_t)(t0, _tb(b))
    _rel_close(float(tm["loss"]), float(jm["loss"]), 1e-5)
    _rel_close(float(tm["grad_norm"]), float(jm["grad_norm"]), 1e-4)
    for a, r, p0 in zip(tree_leaves(tnew["params"]),
                        jax.tree.leaves(jnew["params"]),
                        tree_leaves(t0["params"])):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-2 * opt_t.lr)
        assert not torch.equal(a, p0)     # every leaf moved
    donor = tstate()
    dnew, dm = make_train_step(tcfg, opt_t, donate=True)(donor, _tb(b))
    assert torch.equal(dm["loss"], tm["loss"])
    for a, c in zip(tree_leaves(dnew), tree_leaves(tnew)):
        assert a.dtype == c.dtype and torch.equal(a, c)
    # the donated state was written, the other one was not
    assert all(a is c for a, c in zip(tree_leaves(dnew["params"]),
                                      tree_leaves(donor["params"])))
    for a, c in zip(tree_leaves(t0), tree_leaves(tstate())):
        assert torch.equal(a, c)


def test_train_step_frees_its_gradients_on_return(monkeypatch):
    """No reference cycle keeps a step's gradients alive once it returns
    (a recursive closure in the tree walks did, until the garbage
    collector ran: a full set of gradients held into the next step)."""
    import gc
    import weakref
    from repro_torch.launch import train as ttrain
    seen = []
    update = ttrain.adamw_update

    def spy(params, grads, *a, **k):
        seen.extend(weakref.ref(g) for g in tree_leaves(grads))
        return update(params, grads, *a, **k)

    monkeypatch.setattr(ttrain, "adamw_update", spy)
    cfg = _remat(get_arch("internvl2-76b").smoke, "nothing")
    params = tt.init_params(torch.Generator().manual_seed(0), cfg)
    state = {"params": params, "opt": adamw_init(params)}
    batch = _tb(_batch(cfg))
    # a first step imports what checkpointing imports lazily, whose frames
    # the import machinery keeps until a collection
    make_train_step(cfg, AdamWConfig())(state, batch)
    gc.collect()
    gc.disable()
    try:
        for donate in (False, True):
            seen.clear()
            make_train_step(cfg, AdamWConfig(), donate=donate)(state, batch)
            assert seen and not any(r() is not None for r in seen), donate
    finally:
        gc.enable()


def test_donated_update_in_slabs_equals_out_of_place(monkeypatch):
    """A donated AdamW update computed a slab at a time (slabs smaller
    than a leaf, one not a whole number of rows) equals the whole-leaf
    update bit for bit."""
    from repro_torch.optim import optimizer as topt
    rng = np.random.default_rng(5)
    params = {"w": torch.from_numpy(rng.standard_normal((7, 9)).astype(
        np.float32)), "b": torch.from_numpy(rng.standard_normal(5).astype(
            np.float32)), "s": torch.tensor(0.25)}
    grads = {k: torch.from_numpy(rng.standard_normal(tuple(v.shape)).astype(
        np.float32)) * 3 for k, v in params.items()}
    cfg = AdamWConfig(lr=1e-2, warmup_steps=1, grad_clip=0.5)
    opt = adamw_init(params)
    for k in ("m", "v"):
        opt[k] = {n: t + 0.1 for n, t in opt[k].items()}
    ref_p, ref_o, ref_m = topt.adamw_update(params, grads, opt, cfg)
    monkeypatch.setattr(topt, "SLAB_ELEMS", 10)
    own = {k: v.clone() for k, v in params.items()}
    own_o = {"m": {k: v.clone() for k, v in opt["m"].items()},
             "v": {k: v.clone() for k, v in opt["v"].items()},
             "step": opt["step"]}
    p2, o2, m2 = topt.adamw_update(own, grads, own_o, cfg, inplace=True)
    assert p2["w"] is own["w"] and o2["m"]["w"] is own_o["m"]["w"]
    for a, c in zip(tree_leaves((p2, o2, m2)), tree_leaves((ref_p, ref_o,
                                                             ref_m))):
        assert torch.equal(a, c)


@pytest.mark.parametrize("arch", ("mamba2-780m", "hymba-1.5b",
                                  "internvl2-76b"))
def test_trainer_trains_the_family(arch):
    """The ``Trainer`` takes the SSM, hybrid and VLM configs (the VLM on
    tokens alone, as the reference's) under remat: finite losses, and
    every leaf moves."""
    cfg = dataclasses.replace(get_arch(arch).smoke, remat=True)
    trainer = Trainer(cfg, opt_cfg=AdamWConfig(lr=1e-3, warmup_steps=1,
                                               total_steps=3),
                      batch_size=2, seq_len=16, device="cpu")
    state, losses = trainer.run(3, log_every=100)
    assert len(losses) == 3 and np.all(np.isfinite(losses))
    init = trainer.init_state()["params"]
    assert not any(torch.equal(a, b) for a, b in zip(
        tree_leaves(state["params"]), tree_leaves(init)))


def test_supervised_mamba2_resume_bit_exact(tmp_path):
    """A supervised mamba2 run with a failure injected equals an
    uninterrupted one, losses and state, bit for bit."""
    cfg = get_arch("mamba2-780m").smoke

    def run(ckpt, fail):
        trainer = Trainer(cfg, opt_cfg=AdamWConfig(lr=1e-3, warmup_steps=2,
                                                   total_steps=10),
                          ckpt_dir=ckpt, batch_size=2, seq_len=16,
                          save_every=2, device="cpu")
        inj = FailureInjector(fail_at_steps=(3,)) if fail else None
        return trainer.run(5, injector=inj, log_every=100)

    clean, lc = run(None, False)
    faulty, lf = run(str(tmp_path), True)
    assert lf == lc[:3] + lc[2:]
    for a, b in zip(tree_leaves(clean), tree_leaves(faulty)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert CheckpointManager(str(tmp_path)).all_steps() == [2, 4, 5]


def test_trainer_refuses_an_encoder_decoder():
    """``SyntheticLM`` carries no source: the reference's ``Trainer`` fails
    at its first step with ``KeyError('src_tokens')``, the port's at
    construction with a ``ValueError`` that says why and what to call."""
    jcfg = j_get_arch("seamless-m4t-large-v2").smoke
    jtr = JTrainer(jcfg, opt_cfg=jopt.AdamWConfig(), batch_size=2,
                   seq_len=8)
    with pytest.raises(KeyError, match="src_tokens"):
        jtr.run(1, log_every=100)
    with pytest.raises(ValueError, match="src_embeds"):
        Trainer(get_arch("seamless-m4t-large-v2").smoke,
                opt_cfg=AdamWConfig(), device="cpu")


@pytest.mark.parametrize("arch", ("internvl2-76b", "seamless-m4t-large-v2"))
def test_dryrun_train_batch_equals_reference_input_specs(arch):
    """``launch/dryrun.py``'s ``train_4k`` batch has the keys, row shapes
    and dtypes of the reference's ``input_specs`` (a VLM's patches ahead of
    ``seq_len - frontend_len`` tokens, an encoder-decoder's
    ``src_embeds``), at the rows it runs."""
    cell = dryrun.build_cell(arch, "train_4k", n_layers=1)
    jspec = j_input_specs(j_get_arch(arch).full, J_SHAPES["train_4k"])
    got = dryrun._seeded_inputs(cell, 1, torch.device("cpu"), 0)
    assert set(got) == set(jspec)
    for k, spec in jspec.items():
        assert tuple(got[k].shape) == (1,) + tuple(spec.shape[1:]), k
        is_int = jnp.issubdtype(spec.dtype, jnp.integer)
        assert (got[k].dtype == torch.int64) == is_int, k
    assert int(got["labels"].min()) >= 0
    assert int(got["labels"].max()) < cell.cfg.vocab_size
