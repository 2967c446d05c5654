"""One model's tensors placed over a (data 2, model 2) mesh of four gloo
ranks (DTensor), against the unsharded port and the reference on the CPU:
the loss and every gradient of stablelm-1.6b and mamba2-780m (smoke) on
params placed by the reference's rules, deepseek-v2-lite's EP-sharded
MoE against the unsharded forward at ``n_groups=2`` (what the reference's
group-local dispatch computes on a 2-way data axis), the ``Trainer`` on
the mesh, a checkpoint restored across topologies both ways,
``constrain``, the int8 all-reduce against the reference under
``jax.vmap``, and the CLI's ``--data-par``/``--model-par``.

The ranks (``tests/_torch_mesh_ranks.py``, no jax) run in two spawns of
four at once, each rank with one thread, under a join deadline: a hung
collective fails these tests and not the suite. This process computes
the references meanwhile.

Tolerances, each with its reason:

* Losses: 1e-5 relative, to the unsharded port and to the reference — a
  sharded matmul or norm sums in another order (and the reference's XLA
  in its own), so the logits sit a few ulps apart.
* Gradients against the unsharded port: ``|a - b| <= 1e-4 |b| + 1e-6
  max|g|`` (``max|g|`` over every leaf) — reordered float32 sums; the
  absolute part covers a step size's gradient, a sum of signed terms that
  nearly cancel (MLA's ``w_uk`` step size: terms near 1 that cancel
  almost wholly).
  Against the reference: 1e-3 of each leaf's largest element, the bound
  ``test_torch_train.py`` holds the unsharded port to (an activation
  code that flips at a rounding boundary moves the step sizes'
  gradients).
* deepseek's logits and stablelm's chunked-attention logits: 1e-5 of
  the largest — reordered sums; the routing (top-k of the float32
  router) picks the same experts.
* ``Trainer``: losses and grad norms 1e-4 relative; the final params 1e-5
  absolute (3 AdamW steps of ``lr`` 1e-3 move a weight by about ``lr``
  each, and a reordered gradient moves that by its relative error).
* Checkpoints and placements: exact — copies.
* The int8 all-reduce: exact (bit for bit) — the same IEEE operations
  in the same order: the scale's division, round half to even, the
  four-row float32 sum in rank order.
* The sharded ``Server`` (stablelm-, qwen1.5- and nemotron-smoke on
  (1, 2) and (2, 2), K1 + K3 and K4), its kv heads split or its cache
  whole: tokens and last-step logits equal the unsharded port's bit for
  bit — each rank runs the unsharded per-head attention on its heads,
  its kernels on its planes, the row-parallel int32 accumulators summed
  exactly before one epilogue, and the vocab-parallel head's columns
  are the unsharded matmul's. Against the reference's ``prefill`` /
  ``decode_step`` on the same packed planes: tokens equal, logits within
  ``test_torch_lm.py``'s 1e-4 of the largest.
* qwen1.5-smoke on (1, 4), its 2 kv heads forcing the cache's positions
  over the 4 ranks, combined by log-sum-exp (a reordered float sum):
  logits within rtol 1e-5 / atol 1e-6 of the unsharded port's (an
  8-bit activation code flipped by the reorder would move them further;
  none did), tokens equal except where the unsharded top two logits lie
  within that tolerance of each other.
* ``qdense``'s placed path where the activation's K split does not line
  up with the planes' words, or the words do not divide: exact against
  the unsharded ``qdense``.
* The MoE family's sharded ``Server`` (deepseek-v2-lite- and
  qwen3-moe-smoke, K1 + K3 and K4, the experts split over ``model``):
  on (1, 2) and (1, 4) its tokens and last-step logits equal the
  unsharded port's bit for bit (each rank's experts through grouped K4,
  their rows gathered before the same combine; MLA's latent cache
  gathered per layer and each rank attending its own heads), but
  qwen3-moe on (1, 4), whose 2 kv heads split the cache's positions:
  qwen1.5's tolerance above; against the reference's ``prefill`` /
  ``decode_step`` as the dense ones. On (2, 2) the groups of the
  capacity dispatch are each rank's rows, so the mesh is held to the
  unsharded port at ``n_groups=2`` (the reference's rule), bit for bit,
  not to the one-group ``Server``.
* The SSM, hybrid and encoder-decoder families' sharded ``Server``
  (mamba2-, hymba- and seamless-smoke on (1, 2), (2, 2) and (1, 4), K1 +
  K3 and K4; seamless through ``prefill`` and ``decode_step`` on a
  seeded source): tokens and last-step logits equal the unsharded
  port's bit for bit — each rank convolves its channels and runs the
  scan on every head over the state gathered whole, the gated norm on
  the whole ``d_inner``, the cross K/V are whole on every rank — but
  hymba
  on (1, 4), whose 2 kv heads split its caches' positions and its
  windows' slots (combined by log-sum-exp): qwen1.5's tolerance above,
  tokens equal. Against the reference's ``prefill`` / ``decode_step``:
  tokens equal, logits within 1e-4 of the largest. The windows' slots
  after the run, gathered: exact (copies of the same K/V).
* The continuous engine on a mesh (``ContinuousLMEngine(mesh=)``, the
  engine tests' first 6 mixed requests, 4 slots, max_len 16): tokens
  equal the unsharded port engine's and the reference's engine's; the
  logits of one more arena step after the load equal the unsharded
  engine's bit for bit — its kv heads split or its MLA latent gathered,
  each rank runs the unsharded per-row arithmetic on its rows — but
  where qwen1.5's 2 kv heads split the cache's positions over 4 ranks:
  within rtol 1e-5 / atol 1e-6 (the log-sum-exp combine reorders a float
  sum). deepseek on (2, 2) is held to the unsharded engine dispatching in
  2 groups, as the sharded ``Server``; its drop fractions (each group's
  mean, averaged) within 1e-6 relative of the unsharded engine's, and on
  (1, 2) equal. Per-row ``decode_step`` on a placed cache, rows at
  different depths, against the unsharded per-row ``decode_step``: bit
  for bit with the heads split, the cache whole and MLA's latent; within
  the same rtol 1e-5 / atol 1e-6 with the positions split.
"""

import _torch_threads  # noqa: F401  (first: caps torch's threads under xdist)

import concurrent.futures
import dataclasses
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_mesh_ranks as ranks
from repro.configs import get_arch as j_get_arch
from repro.distributed import compression as jcomp
from repro.launch.serve import GenRequest as JRequest
from repro.launch.serve import Server as JServer
from repro.serving import ContinuousLMEngine as JEngine
from repro.models import layers as jl
from repro.models import transformer as jt

from repro_torch.configs import get_arch
from repro_torch.core.tree import tree_flatten, tree_leaves, tree_unflatten
from repro_torch.distributed.context import bind_axes
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import make_local_mesh, run_ranks
from repro_torch.launch.train import Trainer
from repro_torch.models import layers as tl
from repro_torch.models import transformer as tt
from repro_torch.runtime.checkpoint import CheckpointManager

DENSE = ("stablelm-1.6b", "mamba2-780m")
MOE = "deepseek-v2-lite-16b"
B, S = 4, 16
#: each spawn's join deadline, seconds (about 30 s of work on the CPU)
DEADLINE = 400


def _batch(vocab, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1].copy(), "labels": toks[:, 1:].copy()}


def _loss_and_grads(params, batch, cfg):
    leaves, treedef = tree_flatten(params)
    leaves = [l.detach().requires_grad_(True) for l in leaves]
    tb = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    loss, _ = tt.loss_fn(tree_unflatten(treedef, leaves), tb, cfg)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    return float(loss.detach()), [g.numpy() for g in grads]


def _unaligned_case():
    """Packed (K, 16) ``w_down`` params (the reference's packing) whose K
    words split 32 + 16 lanes on 2 ranks against an activation split
    24 + 24 (K = 48), or do not divide (K = 80, 3 words), with seeded
    (2, 3, K) activations."""
    rng = np.random.default_rng(50)
    pol = jl.QuantPolicy(mode="qat", w_bits=4, a_bits=8)
    out = {}
    for k in (48, 80):
        p = jl.qdense_init(jax.random.PRNGKey(k), k, 16, pol)
        p = jax.tree.map(np.asarray, jl.pack_qdense(p, pol))
        p["alpha_a"] = np.float32(0.04)
        x = rng.standard_normal((2, 3, k)).astype(np.float32)
        out[f"K{k}"] = (p, x)
    return out


def _serve_refs(inputs):
    """The unsharded port's ``Server`` and the reference's ``prefill`` /
    ``decode_step`` (the loop of its ``Server.generate``, whose tokens
    they are; an encoder-decoder's on the seeded source) on the same
    packed planes: tokens and last logits."""
    out = {}
    for arch in ranks.SERVE_ARCHS + ranks.MOE_ARCHS + ranks.FAMILY_ARCHS:
        cfg, jcfg = get_arch(arch).smoke, j_get_arch(arch).smoke
        params = tt.params_from_numpy(inputs["serve"][arch])
        for pa in (True, False):
            out[(arch, pa)] = ranks.serve(cfg, params, None, pa)
            if arch in ranks.MOE_ARCHS:
                out[(arch, "2 groups", pa)] = ranks.serve(
                    cfg, params, None, pa, n_groups=2)
        if arch == "qwen1.5-110b":
            out[(arch, "int8")] = ranks.serve(ranks.int8_cache(cfg), params,
                                              None, True)
            out[(arch, "int8 chunked")] = ranks.serve(
                ranks.chunked(ranks.int8_cache(cfg)), params, None, True)
        jp = jax.tree.map(jnp.asarray, inputs["serve"][arch])
        if cfg.family == "audio":
            out[(arch, "reference")] = _source_reference(jcfg, jp)
            continue
        reqs = ranks.serve_requests(cfg.vocab_size)
        js = JServer(jcfg, params=jp, batch_slots=4,
                     max_len=ranks.SERVE_MAX_LEN, backend="xla")
        toks = [r.out_tokens for r in js.generate(
            [JRequest(r.prompt.copy(), r.max_new_tokens) for r in reqs])]
        s = max(len(r.prompt) for r in reqs)
        padded = np.zeros((4, s), np.int32)
        for i, r in enumerate(reqs):
            padded[i, -len(r.prompt):] = r.prompt
        logits, caches = js._prefill(js.params, {"tokens": jnp.asarray(
            padded)})
        for t in range(1, ranks.SERVE_NEW):
            tok = jnp.argmax(logits, -1)[:, None]
            logits, caches = js._decode(js.params, caches, tok,
                                        jnp.int32(s + t - 1))
        out[(arch, "reference")] = (toks, np.asarray(logits))
    out["window_slots"] = ranks.window_slots(inputs["serve"]["hymba-1.5b"],
                                             None)
    out["engine"], out["engine_reference"] = _engine_refs(inputs)
    out["per_row"] = {
        name: ranks.per_row_steps(ranks.engine_config(arch, kv),
                                  tt.params_from_numpy(inputs["serve"][arch]),
                                  None, max_len)
        for name, arch, _, max_len, kv in ranks.PER_ROW_CASES}
    for name, (p_np, x_np) in inputs["unaligned"].items():
        for pa in (True, False):
            pol = tl.QuantPolicy(mode="serial", w_bits=4, a_bits=8,
                                 pack_acts=pa)
            with torch.no_grad():
                out[("unaligned", name, pa)] = tl.qdense(
                    tt.params_from_numpy(p_np), torch.from_numpy(x_np),
                    pol).numpy()
    return out


def _grouped(case) -> int:
    """The MoE dispatch groups an engine case's mesh makes: its data
    ranks (deepseek on (2, 2)), else 1."""
    arch, tag, _, _ = case
    return 2 if tag == "2x2" and arch in ranks.MOE_ARCHS else 1


def _engine_refs(inputs):
    """The unsharded port engine on each :data:`ranks.ENGINE_CASES` case
    (its MoE in the case's dispatch groups), and the reference's
    ``ContinuousLMEngine`` (XLA) on the same packed planes and requests
    where it dispatches as the case does (one group): tokens."""
    port, ref = {}, {}
    for case in ranks.ENGINE_CASES:
        arch, _, pa, kv = case
        params = tt.params_from_numpy(inputs["serve"][arch])
        port[case] = ranks.engine(ranks.engine_config(arch, kv), params,
                                  None, pa, n_groups=_grouped(case))
        if _grouped(case) > 1:
            continue
        jcfg = j_get_arch(arch).smoke
        if kv is not None:
            jcfg = dataclasses.replace(jcfg, kv_bits=kv)
        jeng = JEngine(jcfg, params=jax.tree.map(jnp.asarray,
                                                 inputs["serve"][arch]),
                       batch_slots=ranks.ENGINE_SLOTS,
                       max_len=ranks.ENGINE_MAX_LEN, backend="xla")
        ref[case] = [r.out_tokens for r in jeng.serve(
            [JRequest(r.prompt.copy(), r.max_new_tokens)
             for r in ranks.engine_requests()])]
    return port, ref


def _source_reference(jcfg, jp):
    """The reference's ``prefill`` on the padded prompts and the seeded
    source, then its greedy ``decode_step``s: tokens and last logits."""
    jcfg = jt.serve_policy(jcfg, backend="xla")
    toks = ranks.padded_prompts(jcfg.vocab_size)
    logits, caches = jt.prefill(
        jp, {"tokens": jnp.asarray(toks, jnp.int32),
             "src_embeds": jnp.asarray(ranks.source(jcfg))}, jcfg,
        max_len=ranks.SERVE_MAX_LEN)
    cols = []
    for t in range(ranks.SERVE_NEW):
        tok = jnp.argmax(logits, -1)[:, None]
        cols.append(np.asarray(tok))
        if t + 1 < ranks.SERVE_NEW:
            logits, caches = jt.decode_step(jp, caches, tok,
                                            jnp.int32(toks.shape[1] + t),
                                            jcfg)
    return np.concatenate(cols, axis=1).tolist(), np.asarray(logits)


def _references(inputs):
    """Everything the ranks' results are held against (runs while they
    run)."""
    ref = {"serve": _serve_refs(inputs)}
    for arch in DENSE:
        jcfg, cfg = j_get_arch(arch).smoke, get_arch(arch).smoke
        params_np, batch = inputs["models"][arch]
        (jl, _), jg = jax.value_and_grad(jt.loss_fn, has_aux=True)(
            jax.tree.map(jnp.asarray, params_np),
            jax.tree.map(jnp.asarray, batch), jcfg)
        loss, grads = _loss_and_grads(tt.params_from_numpy(params_np),
                                      batch, cfg)
        ref[arch] = dict(j_loss=float(jl),
                         j_grads=[np.asarray(g) for g in jax.tree.leaves(jg)],
                         loss=loss, grads=grads)
    params_np, batch = inputs["models"]["stablelm-1.6b"]
    with torch.no_grad():
        logits, _ = tt.forward(
            tt.params_from_numpy(params_np),
            {k: torch.from_numpy(v).long() for k, v in batch.items()},
            ranks.chunked(get_arch("stablelm-1.6b").smoke))
    ref["chunked_logits"] = logits.numpy()
    moe = get_arch(MOE).smoke
    params = tt.init_params(torch.Generator().manual_seed(0), moe)
    tb = {k: torch.from_numpy(v).long()
          for k, v in inputs["moe_batch"].items()}
    # the unsharded forward with the dispatch a 2-way data axis makes
    with bind_axes(dp="data", mesh={"data": 2}):
        with torch.no_grad():
            logits, aux = tt.forward(params, tb, moe)
        ref["moe"] = dict(logits=logits.numpy(), lb=float(aux["lb_loss"]))
        ref["moe"]["loss"], ref["moe"]["grads"] = _loss_and_grads(
            params, inputs["moe_batch"], moe)
    tr = Trainer(get_arch("stablelm-1.6b").smoke, opt_cfg=ranks.OPT,
                 device="cpu", **ranks.TRAIN)
    state, losses = tr.run(3, log_every=100)
    ref["train"] = (losses, [h["grad_norm"] for h in tr.history],
                    [l.numpy() for l in tree_leaves(state)])
    ref["train_target"] = tr.init_state()
    g, e = (jnp.asarray(a) for a in inputs["compress"])
    ref["compress_mean"] = np.asarray(jax.vmap(
        lambda x: jcomp.compressed_allreduce_mean(x, "data"),
        axis_name="data")(g))
    ref["compress_tree"] = jax.vmap(
        lambda x, r: jcomp.compress_tree({"a": x, "b": [x[:17] * 3]},
                                         {"a": r, "b": [jnp.zeros(17)]},
                                         "data"),
        axis_name="data")(g, e)
    return ref


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    """``(inputs, references, per-rank results)`` of the two spawns."""
    d = tmp_path_factory.mktemp("mesh")
    models = {}
    for i, arch in enumerate(DENSE):
        jcfg = j_get_arch(arch).smoke
        jp = jt.init_params(jax.random.PRNGKey(i), jcfg)
        models[arch] = (jax.tree.map(np.asarray, jp),
                        _batch(jcfg.vocab_size, 10 + i))
    serve_np = {}
    for i, arch in enumerate(ranks.SERVE_ARCHS + ranks.MOE_ARCHS
                             + ranks.FAMILY_ARCHS):
        jcfg = j_get_arch(arch).smoke
        serve_np[arch] = jax.tree.map(np.asarray, jt.pack_params(
            jt.init_params(jax.random.PRNGKey(40 + i), jcfg), jcfg))
    rng = np.random.default_rng(0)
    inputs = dict(
        serve=serve_np, unaligned=_unaligned_case(),
        models=models, moe_batch=_batch(get_arch(MOE).smoke.vocab_size, 20),
        compress=(rng.standard_normal((4, 64)).astype(np.float32),
                  (rng.standard_normal((4, 64)) * 0.01).astype(np.float32)),
        ckpt_plain=str(d / "plain"), ckpt_mesh=str(d / "mesh"))
    # a checkpoint written unsharded: the Trainer's initial state
    init = Trainer(get_arch("stablelm-1.6b").smoke, opt_cfg=ranks.OPT,
                   device="cpu", **ranks.TRAIN).init_state()
    CheckpointManager(inputs["ckpt_plain"]).save(0, init, blocking=True)
    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        futs = [ex.submit(run_ranks, ranks.mesh_rank, 4, device="cpu",
                          args=(inputs, part), timeout=DEADLINE, threads=1)
                for part in ("dense", "ssm_moe")]
        ref = _references(inputs)
        results = [{**a, **b, "serve": {**a["serve"], **b["serve"]},
                    "engine": {**a["engine"], **b["engine"]}}
                   for a, b in zip(*(f.result() for f in futs))]
    ref["init"] = [l.numpy() for l in tree_leaves(init)]
    return inputs, ref, results


def _close_grads(got, want):
    gmax = max(float(np.max(np.abs(w))) for w in want if w.size)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, i
        err = np.abs(g.astype(np.float64) - w)
        assert np.all(err <= 1e-4 * np.abs(w) + 1e-6 * gmax), (
            i, float(err.max()), gmax)


def _rel_close(got, ref, rel):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    scale = max(float(np.max(np.abs(ref))), 1e-30)
    assert float(np.max(np.abs(got - ref))) <= rel * scale


def test_make_local_mesh_raises_without_a_card_or_ranks():
    """No fallback: without a card and without ``device="cpu"`` the mesh,
    the runner and ``Trainer(mesh=)`` raise; a mesh of four needs four
    processes."""
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_local_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_ranks(ranks.mesh_rank, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(get_arch("stablelm-1.6b").smoke, opt_cfg=ranks.OPT,
                mesh=object())
    with pytest.raises(RuntimeError, match="4 processes"):
        make_local_mesh(2, 2, device="cpu")


@pytest.mark.parametrize("arch", DENSE)
def test_sharded_loss_and_grads_equal_unsharded(mesh_run, arch):
    """The loss and every gradient (reduced to its parameter's
    placements, gathered) on params placed by ``tree_shardings`` equal
    the unsharded port's and the reference's; the mesh splits something
    over both axes."""
    _, ref, res = mesh_run
    loss, grads, placements = res[0][arch]
    r = ref[arch]
    assert abs(loss - r["loss"]) <= 1e-5 * abs(r["loss"])
    assert abs(loss - r["j_loss"]) <= 1e-5 * abs(r["j_loss"])
    _close_grads(grads, r["grads"])
    for g, w in zip(grads, r["j_grads"]):
        _rel_close(g, w, 1e-3)
    assert any("Shard" in p and "Replicate" not in p for p in placements)
    for other in res[1:]:
        assert other[arch][0] == loss


def test_chunked_attention_on_the_mesh_equals_unsharded(mesh_run):
    """stablelm's forward through the chunked attention (8 x 8 blocks),
    its batch over ``data`` and heads over ``model`` (the reference's
    constraints), equals the unsharded chunked forward."""
    _, ref, res = mesh_run
    _rel_close(res[0]["chunked_logits"], ref["chunked_logits"], 1e-5)


def test_deepseek_ep_forward_equals_grouped_unsharded(mesh_run):
    """The MoE's experts split over ``model`` (EP) and its groups over
    ``data``: logits and ``lb_loss`` equal the unsharded forward at
    ``n_groups=2``, and so do the loss and the gradients."""
    _, ref, res = mesh_run
    r = ref["moe"]
    out = res[0]
    assert out["moe_placements"] == "(Shard(dim=2), Shard(dim=1))"
    _rel_close(out["moe_logits"], r["logits"], 1e-5)
    assert abs(out["moe_lb"] - r["lb"]) <= 1e-5 * abs(r["lb"])
    loss, grads, _ = out["moe_grads"]
    assert abs(loss - r["loss"]) <= 1e-5 * abs(r["loss"])
    _close_grads(grads, r["grads"])


def test_trainer_on_mesh_equals_unsharded_trainer(mesh_run):
    """``Trainer(mesh=)``: 3 steps of the smoke stablelm from the same
    seed, as the unsharded ``Trainer``'s."""
    _, ref, res = mesh_run
    losses, gnorms, state = res[0]["train"]
    r_losses, r_gnorms, r_state = ref["train"]
    np.testing.assert_allclose(losses, r_losses, rtol=1e-4)
    np.testing.assert_allclose(gnorms, r_gnorms, rtol=1e-4)
    assert len(state) == len(r_state)
    for a, b in zip(state, r_state):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


def test_traced_mesh_step_collectives_equal_a_fake_mesh(mesh_run):
    """One more ``Trainer`` step on each gloo rank of the 2 x 2 mesh under
    ``launch/hlo_analysis.py``'s ``CostMode``: every rank's collective
    counts and bytes equal those of the same step counted on rank 0 of a
    fake 2 x 2 mesh in this process, its state and batch on ``meta``."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.distributed import placed
    from repro_torch.distributed.sharding import batch_pspec, to_placements
    from repro_torch.launch.dryrun import _MetaGenerator
    from repro_torch.launch.hlo_analysis import analyze
    from repro_torch.launch.mesh import fake_mesh
    from repro_torch.launch.train import init_placed_params, make_train_step
    from repro_torch.optim import adamw_init
    _, _, res = mesh_run
    cfg = get_arch("stablelm-1.6b").smoke
    with fake_mesh((2, 2), device_type="cpu") as mesh:
        params = init_placed_params(_MetaGenerator(), cfg, mesh)
        toks = torch.empty((ranks.TRAIN["batch_size"], ranks.TRAIN["seq_len"]),
                           dtype=torch.int64, device="meta")
        pl = to_placements(batch_pspec(tuple(toks.shape), mesh), mesh)
        batch = {k: distribute_tensor(toks, mesh, pl, src_data_rank=None)
                 for k in ("tokens", "labels")}
        with placed.mesh_context(mesh):
            _, cost = analyze(make_train_step(cfg, ranks.OPT),
                              {"params": params, "opt": adamw_init(params)},
                              batch)
    assert cost.collective_counts["all-reduce"] > 0
    for r in res:
        assert r["train_cost"] == (cost.collective_counts,
                                   cost.collective_bytes)


def test_split_heads_of_a_placed_projection(mesh_run):
    """``placed.split_heads``: 3 heads of 8 whose 24 columns are split
    over the 2-way ``model`` axis (DTensor cannot view them in place) are
    made whole on ``model`` and viewed; values and the gradient equal the
    plain reshape's, the gradient placed as the input."""
    x = np.arange(2 * 5 * 24.).reshape(2, 5, 24).astype(np.float32)
    for r in mesh_run[2]:
        shape, heads, g_pl, g = r["split_heads"]
        assert shape == (2, 5, 3, 8)
        np.testing.assert_array_equal(heads, x.reshape(2, 5, 3, 8))
        np.testing.assert_array_equal(g, 2 * x)
        assert g_pl == "(Shard(dim=0), Shard(dim=2))"


def test_elastic_restore_from_unsharded_onto_the_mesh(mesh_run):
    """A checkpoint written unsharded, restored onto the 2 x 2 mesh by
    ``tree_shardings``: placed, and equal bit for bit once gathered."""
    _, ref, res = mesh_run
    leaves, placements = res[0]["restored"]
    assert len(leaves) == len(ref["init"])
    for a, b in zip(leaves, ref["init"]):
        np.testing.assert_array_equal(a, b)
    assert any("Shard(dim=1), Shard(dim=0)" in p for p in placements)


def test_elastic_restore_from_the_mesh_unsharded(mesh_run):
    """The mesh ``Trainer``'s checkpoint (written by rank 0 from the
    gathered state) restores unsharded, equal bit for bit to the state
    the ranks hold."""
    inputs, ref, res = mesh_run
    ck = CheckpointManager(inputs["ckpt_mesh"])
    assert ck.latest_step() == 3
    state = ck.restore(3, ref["train_target"])
    got = [l.numpy() for l in tree_leaves(state)]
    for a, b in zip(got, res[0]["train"][2]):
        np.testing.assert_array_equal(a, b)
    assert sorted(os.listdir(inputs["ckpt_mesh"])) == ["step_3"]


def test_constrain_redistributes_placed_tensors(mesh_run):
    """Bound ``dp``/``tp``, ``constrain`` splits a replicated DTensor as
    asked, sums a partial one, and returns a plain tensor itself."""
    _, _, res = mesh_run
    for out in res:
        by_both, by_dp, plain_same = out["constrain"]
        assert by_both == "(Shard(dim=0), Shard(dim=1))"
        assert by_dp == "(Shard(dim=0), Replicate())"
        assert plain_same
        placements, local = out["constrain_partial"]
        assert placements == "(Replicate(), Replicate())"
        np.testing.assert_array_equal(local, np.full((2, 4), 6.0))


def test_compressed_allreduce_mean_equals_reference(mesh_run):
    """Four ranks' int8 all-reduce of a seeded (4, 64) gradient equals the
    reference's under ``jax.vmap(axis_name=)``, every rank, bit for
    bit."""
    _, ref, res = mesh_run
    for r, out in enumerate(res):
        assert out["rank"] == r
        np.testing.assert_array_equal(out["compress_mean"],
                                      ref["compress_mean"][r])


def test_compress_tree_equals_reference(mesh_run):
    """Error feedback over a tree (a leaf whose size is not a multiple of
    four among them): the reduced gradients and new residuals equal the
    reference's bit for bit."""
    _, ref, res = mesh_run
    red, err = ref["compress_tree"]
    for r, out in enumerate(res):
        a, ea, b, eb = out["compress_tree"]
        np.testing.assert_array_equal(a, np.asarray(red["a"][r]))
        np.testing.assert_array_equal(ea, np.asarray(err["a"][r]))
        np.testing.assert_array_equal(b, np.asarray(red["b"][0][r]))
        np.testing.assert_array_equal(eb, np.asarray(err["b"][0][r]))


def test_remat_recompute_keeps_the_bound_axes():
    """A checkpointed layer runs again in the backward, which can run
    after the binding's ``with`` or on another thread (autograd's, on the
    card), where the thread-local binding is absent: the recompute
    re-enters the forward's binding, so deepseek's MoE keeps its 2 groups
    (a 2-way data axis) and the gradients equal a backward inside the
    binding, bit for bit."""
    cfg = dataclasses.replace(get_arch(MOE).smoke, remat=True)
    params = tt.init_params(torch.Generator().manual_seed(0), cfg)
    tb = {k: torch.from_numpy(v).long()
          for k, v in _batch(cfg.vocab_size, 30).items()}

    def grads(where):
        leaves, treedef = tree_flatten(params)
        leaves = [l.detach().requires_grad_(True) for l in leaves]
        out = {}

        def backward():
            try:
                out["g"] = torch.autograd.grad(loss, leaves,
                                               allow_unused=True,
                                               materialize_grads=True)
            except Exception as e:       # raised again on the test's thread
                out["error"] = e

        with bind_axes(dp="data", mesh={"data": 2}):
            loss, _ = tt.loss_fn(tree_unflatten(treedef, leaves), tb, cfg)
            if where == "inside":
                backward()
        if where == "after":
            backward()
        elif where == "thread":
            t = threading.Thread(target=backward)
            t.start()
            t.join(60)
            assert not t.is_alive()
        if "error" in out:
            raise out["error"]
        return out["g"]

    ref = grads("inside")
    for where in ("after", "thread"):
        assert all(torch.equal(a, b) for a, b in zip(grads(where), ref))


def test_cli_trains_on_a_data_model_mesh(capfd):
    """``--data-par 2 --model-par 2 --device cpu --smoke --steps 2``
    starts four gloo ranks itself; rank 0 alone prints."""
    ttrain.main(["--arch", "stablelm-1.6b", "--smoke", "--device", "cpu",
                 "--data-par", "2", "--model-par", "2", "--steps", "2",
                 "--batch", "4", "--seq", "16", "--log-every", "1"])
    out = capfd.readouterr().out
    assert out.count("done: 2 steps of stablelm-1.6b-smoke") == 1
    assert "(data 2, model 2) mesh of cpu" in out
    assert out.count("step     1 loss") == 1


def test_cli_serves_on_a_model_mesh(capfd):
    """``serve --smoke --device cpu --model-par 2`` starts two gloo ranks
    itself; rank 0 alone prints. stablelm-1.6b, which the slot arena
    takes, serves the engine's mixed load on each rank through the
    serving runtime: its sample equals the unsharded CLI's, run the same
    way. mamba2-780m, which it does not take, serves the static load
    through the sharded ``Server``: its sample is the unsharded
    ``Server``'s tokens on the CLI's prompts."""
    argv = ["--smoke", "--device", "cpu", "--batch", "2", "--new-tokens",
            "3"]
    capfd.readouterr()
    tserve.main(["--arch", "stablelm-1.6b"] + argv)
    plain = capfd.readouterr().out
    sample = [l for l in plain.splitlines() if l.startswith("sample: ")]
    assert len(sample) == 1 and "continuous batching) on cpu" in plain
    tserve.main(["--arch", "stablelm-1.6b", "--model-par", "2"] + argv)
    out = capfd.readouterr().out
    assert out.count("stablelm-1.6b-smoke: generated 12 tokens over 8 "
                     "requests") == 1
    assert "continuous batching) on a (data 1, model 2) mesh of cpu" in out
    assert "recompiles_after_warmup=0" in out
    assert sample[0] in out.splitlines()

    cfg = get_arch("mamba2-780m").smoke
    rng = np.random.RandomState(0)
    reqs = [tserve.GenRequest(rng.randint(0, cfg.vocab_size, (8,)).astype(
        np.int32), 3) for _ in range(2)]
    want = tserve.Server(cfg, batch_slots=2, max_len=tserve.LM_MAX_LEN,
                         seed=0, device="cpu").generate(reqs)[0].out_tokens
    capfd.readouterr()
    tserve.main(["--arch", "mamba2-780m", "--model-par", "2"] + argv)
    out = capfd.readouterr().out
    assert out.count("mamba2-780m-smoke: generated 6 tokens") == 1
    assert "static batch) on a (data 1, model 2) mesh of cpu" in out
    assert f"sample: {want}" in out


# ------------------------------------------------------ sharded serving

@pytest.mark.parametrize("arch", ranks.SERVE_ARCHS)
@pytest.mark.parametrize("tag", ["1x2", "2x2"])
@pytest.mark.parametrize("pack_acts", [True, False])
def test_sharded_server_equals_unsharded_and_reference(mesh_run, arch, tag,
                                                      pack_acts):
    """``Server(mesh=)`` on (data 1, model 2) and (data 2, model 2) gloo
    meshes, K1 + K3 and K4: every rank's tokens and last-step logits
    equal the unsharded port's bit for bit, and the reference's within
    ``test_torch_lm.py``'s bound (tokens equal)."""
    _, ref, res = mesh_run
    want_toks, want = ref["serve"][(arch, pack_acts)]
    j_toks, j_logits = ref["serve"][(arch, "reference")]
    for r in res:
        toks, logits = r["serve"][(arch, tag, pack_acts)]
        assert toks == want_toks == j_toks
        np.testing.assert_array_equal(logits, want)
    np.testing.assert_allclose(want, j_logits, rtol=0,
                               atol=1e-4 * np.abs(j_logits).max())


@pytest.mark.parametrize("pack_acts,cache", [(True, "float"),
                                              (False, "float"),
                                              (True, "int8"),
                                              (True, "int8 chunked")])
def test_position_split_cache_combines_to_unsharded(mesh_run, pack_acts,
                                                    cache):
    """qwen1.5-110b-smoke on (data 1, model 4): 2 kv heads do not divide
    over 4 ranks, so ``cache_pspec`` splits the cache's positions (4
    slots a rank, every rank holding some of the 14 positions written),
    the int8 cache's codes and scales alike; each rank's partial softmax,
    combined by log-sum-exp, gives the unsharded logits within rtol 1e-5
    / atol 1e-6 and its tokens. With ``use_chunked_attn`` the prefill
    into the empty int8 cache attends the fresh K/V, chunked, as the
    unsharded one does (not the cache's dequantized codes)."""
    _, ref, res = mesh_run
    plain = cache == "float"
    want_toks, want = ref["serve"][("qwen1.5-110b",
                                    pack_acts if plain else cache)]
    assert res[0]["serve_cache_placements"] == \
        "(Shard(dim=1), Shard(dim=2))"
    for r in res:
        toks, logits = r["serve"][("qwen1.5-110b",
                                   "1x4" if plain else f"1x4 {cache}",
                                   pack_acts)]
        np.testing.assert_allclose(logits, want, rtol=1e-5, atol=1e-6)
        top2 = np.sort(want, axis=-1)[:, -2:]
        near = np.abs(top2[:, 1] - top2[:, 0]) <= 1e-5 * np.abs(
            top2[:, 1]) + 1e-6
        for b, (t, w) in enumerate(zip(toks, want_toks)):
            assert t == w or near[b], (b, t, w)


@pytest.mark.parametrize("arch", ranks.MOE_ARCHS)
@pytest.mark.parametrize("tag", ["1x2", "1x4", "2x2"])
@pytest.mark.parametrize("pack_acts", [True, False])
def test_sharded_moe_server_equals_unsharded_and_reference(mesh_run, arch,
                                                          tag, pack_acts):
    """``Server(mesh=)`` serving the MoE family, K1 + K3 and K4, the
    experts split over ``model``: on (data 1, model 2) and (1, 4) every
    rank's tokens and last-step logits equal the unsharded port's bit for
    bit (qwen3-moe on (1, 4), its cache's positions split: within rtol
    1e-5 / atol 1e-6, tokens equal but at a near tie) and the reference's
    within ``test_torch_lm.py``'s bound; on (2, 2) they equal the
    unsharded port's at ``n_groups=2`` bit for bit (each data rank's rows
    one dispatch group, the reference's rule)."""
    _, ref, res = mesh_run
    grouped = tag == "2x2"
    want_toks, want = ref["serve"][(arch, "2 groups", pack_acts) if grouped
                                   else (arch, pack_acts)]
    combined = (arch, tag) == ("qwen3-moe-235b-a22b", "1x4")
    for r in res:
        toks, logits = r["serve"][(arch, tag, pack_acts)]
        if combined:
            np.testing.assert_allclose(logits, want, rtol=1e-5, atol=1e-6)
            top2 = np.sort(want, axis=-1)[:, -2:]
            near = np.abs(top2[:, 1] - top2[:, 0]) <= 1e-5 * np.abs(
                top2[:, 1]) + 1e-6
            assert all(t == w or near[b] for b, (t, w) in enumerate(
                zip(toks, want_toks)))
        else:
            assert toks == want_toks
            np.testing.assert_array_equal(logits, want)
    if not grouped:
        j_toks, j_logits = ref["serve"][(arch, "reference")]
        assert want_toks == j_toks
        np.testing.assert_allclose(want, j_logits, rtol=0,
                                   atol=1e-4 * np.abs(j_logits).max())


@pytest.mark.parametrize("arch", ranks.FAMILY_ARCHS)
@pytest.mark.parametrize("tag", ["1x2", "1x4", "2x2"])
@pytest.mark.parametrize("pack_acts", [True, False])
def test_sharded_family_server_equals_unsharded_and_reference(
        mesh_run, arch, tag, pack_acts):
    """``Server(mesh=)`` serving mamba2 (its SSM state split by heads),
    hymba (the SSM branch beside sliding windows) and seamless (through
    ``prefill`` and ``decode_step`` on a seeded source, its cross K/V
    whole on every ``model`` rank), K1 + K3 and K4, on (data 1, model 2),
    (1, 4) and (2, 2): every rank's tokens and last-step logits equal the
    unsharded port's bit for bit (hymba on (1, 4), its caches' positions
    and its windows' slots split over 4 ranks: within rtol 1e-5 / atol
    1e-6, tokens equal), and the reference's within
    ``test_torch_lm.py``'s bound."""
    _, ref, res = mesh_run
    want_toks, want = ref["serve"][(arch, pack_acts)]
    j_toks, j_logits = ref["serve"][(arch, "reference")]
    combined = (arch, tag) == ("hymba-1.5b", "1x4")
    for r in res:
        toks, logits = r["serve"][(arch, tag, pack_acts)]
        assert toks == want_toks
        if combined:
            np.testing.assert_allclose(logits, want, rtol=1e-5, atol=1e-6)
        else:
            np.testing.assert_array_equal(logits, want)
    assert want_toks == j_toks
    np.testing.assert_allclose(want, j_logits, rtol=0,
                               atol=1e-4 * np.abs(j_logits).max())


def _engine_id(case):
    arch, tag, pa, kv = case
    return (f"{arch}-{tag}-{'k3' if pa else 'k4'}"
            + ("" if kv is None else f"-int{kv}"))


@pytest.mark.parametrize("case", ranks.ENGINE_CASES, ids=_engine_id)
def test_mesh_engine_equals_unsharded_and_reference_engines(mesh_run, case):
    """``ContinuousLMEngine(mesh=)`` on the engine tests' mixed requests:
    on every rank the tokens equal the unsharded port engine's (deepseek
    on (2, 2): dispatching in 2 groups) and the reference's engine's, no
    step compiles after warmup, and one more arena step's logits equal
    the unsharded engine's bit for bit, or within rtol 1e-5 / atol 1e-6
    where qwen1.5's cache splits its positions over 4 ranks; the MoE's
    drop fractions are kept per step, as unsharded."""
    arch, tag, _, _ = case
    _, ref, res = mesh_run
    want = ref["serve"]["engine"][case]
    data, model = (int(v) for v in tag.split("x"))
    for r in res:
        got = r["engine"][case]
        assert got["tokens"] == want["tokens"]
        assert got["recompiles"] == want["recompiles"] == 0
        assert got["mesh"] == {"data": data, "model": model}
        assert not got["graph"]
        if arch == "qwen1.5-110b":
            np.testing.assert_allclose(got["logits"], want["logits"],
                                       rtol=1e-5, atol=1e-6)
        else:
            np.testing.assert_array_equal(got["logits"], want["logits"])
        if arch in ranks.MOE_ARCHS:
            assert got["drops"].shape == want["drops"].shape
            assert got["drops"].shape[0] > 0
            np.testing.assert_allclose(got["drops"], want["drops"],
                                       rtol=0 if data == 1 else 1e-6)
        else:
            assert got["drops"] is None
    if _grouped(case) == 1:
        assert want["tokens"] == ref["serve"]["engine_reference"][case]


@pytest.mark.parametrize("name", [c[0] for c in ranks.PER_ROW_CASES])
def test_per_row_decode_on_a_placed_cache_equals_unsharded(mesh_run, name):
    """Per-row ``decode_step`` (rows at positions 9, 4, 2 and 7, three
    steps) on each placement of the caches against the unsharded per-row
    ``decode_step``: stablelm's kv heads split on (1, 2), qwen1.5's cache
    whole on (1, 4) (14 positions do not divide) and deepseek's MLA latent
    on (1, 2) bit for bit; qwen1.5's positions split on (1, 4), bf16 and
    int8, within rtol 1e-5 / atol 1e-6. A rolling buffer (hymba's sliding
    windows) raises ``ValueError``, placed or not."""
    _, ref, res = mesh_run
    want = ref["serve"]["per_row"][name]
    for r in res:
        got = r["per_row"][name]
        if name == "rolling":
            assert isinstance(got, str) and isinstance(want, str)
            assert got.startswith("ValueError: per-row cache positions on "
                                  "a placed rolling"), got
            assert want.startswith("ValueError: a rolling"), want
            continue
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            if name.startswith("positions"):
                np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
            else:
                np.testing.assert_array_equal(g, w)


def test_window_slots_shift_across_ranks_as_unsharded(mesh_run):
    """hymba-smoke on (data 1, model 4): 2 kv heads do not divide over 4
    ranks, so ``cache_pspec`` splits a sliding window's 8 slots, 2 a
    rank; after a prefill of 9 positions and 4 decode steps (positions up
    to 13: every step shifts a slot across each rank boundary) the
    gathered slots equal the unsharded rolling buffer's bit for bit."""
    _, ref, res = mesh_run
    want = ref["serve"]["window_slots"]
    assert res[0]["window_cache_placements"] == \
        "(Shard(dim=1), Shard(dim=2))"
    for r in res:
        for got, w in zip(r["window_slots"], want):
            np.testing.assert_array_equal(got, w)


@pytest.mark.parametrize("name", ["K48", "K80"])
@pytest.mark.parametrize("pack_acts", [True, False])
def test_placed_qdense_gathers_an_unaligned_activation(mesh_run, name,
                                                       pack_acts):
    """K = 48 on 2 ranks: the planes' words split 32 + 16 lanes, the
    activation 24 + 24, so it is gathered and sliced on the words before
    K1 (never packed from a slice straddling a word), the int32
    accumulators summed; K = 80: 3 words do not divide, the planes stay
    whole and the activation is gathered. Both equal the unsharded
    ``qdense`` bit for bit."""
    _, ref, res = mesh_run
    want = ref["serve"][("unaligned", name, pack_acts)]
    planes = {"K48": "(Replicate(), Shard(dim=1))",
              "K80": "(Replicate(), Replicate())"}[name]
    for r in res:
        got, out_pl, w_pl = r["unaligned"][(name, pack_acts)]
        np.testing.assert_array_equal(got, want)
        assert w_pl == planes and out_pl == "(Replicate(), Replicate())"


def test_row_parallel_sums_int32_accumulators_not_float_outputs():
    """Why the row-parallel projection reduces int32 accumulators before
    one epilogue: on a seeded (4, 256) x (256, 64) W4A8 product with a
    bias, K split into two word ranges, the int32 sum of K3's raw
    accumulators (``raw_acc``) through the plain epilogue equals the
    unsharded fused output bit for bit; summing each half's float output
    (each with the epilogue, the bias on each half) does not, nor does it
    with the bias added once."""
    from repro_torch.core.bitserial import SerialSpec
    from repro_torch.kernels import bitserial_matmul as km
    from repro_torch.kernels.epilogue import epilogue
    from repro_torch.kernels.quantize_pack import pack_codes_ref
    rng = np.random.default_rng(60)
    spec = SerialSpec(8, 4, True, True, 8)
    xc = torch.from_numpy(rng.integers(-128, 128, (4, 256)).astype(np.int32))
    wc = torch.from_numpy(rng.integers(-8, 8, (256, 64)).astype(np.int32))
    scale = torch.from_numpy((rng.random(64) * 1e-3).astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal(64).astype(np.float32))

    def planes(w):
        return pack_codes_ref(w.t().contiguous(), 4).permute(0, 2, 1) \
            .contiguous()

    def k3(x, w, *a, **kw):
        return km.bitserial_matmul_v2(pack_codes_ref(x.contiguous(), 8),
                                      planes(w), *a, spec=spec,
                                      k=x.shape[1], **kw)

    whole = k3(xc, wc, scale, bias)
    halves = [(xc[:, :128], wc[:128]), (xc[:, 128:], wc[128:])]
    acc = sum(k3(x, w, None, raw_acc=True) for x, w in halves)
    assert acc.dtype == torch.int32
    assert torch.equal(epilogue(acc, scale, bias, relu=False, requant=None),
                       whole)
    floats = sum(k3(x, w, scale, bias) for x, w in halves)
    assert not torch.equal(floats, whole)
    once = sum(k3(x, w, scale) for x, w in halves) + bias
    assert not torch.equal(once, whole)


def test_serve_cell_on_a_fake_mesh_counts_per_device():
    """``dryrun.cost_cell`` of stablelm-1.6b ``decode_32k`` at 2 layers of
    full width on a fake (data 2, model 2) mesh: every dim divides, so
    one device's integer FLOPs (K3 on its quarter: a quarter of the rows
    times half of N or of K) times 4 equal the unsharded step's; the
    all-reduces are the row-parallel o and down projections' int32
    accumulators, (B/2, d_model) each, and the embedding's float32 rows,
    one each per layer and step; the K3 and K1 calls per step are the
    unsharded step's."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.hlo_analysis import analyze
    from repro_torch.launch.serve import Server
    cell = dryrun.build_cell("stablelm-1.6b", "decode_32k", n_layers=2)
    rec = dryrun.cost_cell(cell, mesh_shape=(2, 2))
    cfg, b = cell.cfg, cell.shape.global_batch
    srv = Server(cfg, tt.init_params(dryrun._MetaGenerator(), cfg,
                                     packed=True),
                 batch_slots=b, max_len=cell.max_len, device="meta")
    caches = tt.init_caches(srv.cfg, b, cell.max_len, device="meta")
    toks = torch.empty((b, 1), dtype=torch.int64, device="meta")
    with torch.inference_mode():
        _, one = analyze(tt.decode_step, srv.params, caches, toks,
                         cell.max_len - 1, srv.cfg)
    assert rec["cost_mesh"] == {"data": 2, "model": 2}
    assert rec["flops_int"] * 4 == one.flops_int > 0
    assert rec["kernel_calls"] == one.kernel_calls
    layers, rows, d = cfg.n_layers, b // 2, cfg.d_model
    col = rec["collectives"]
    assert col["counts"]["all-reduce"] == 2 * layers + 1
    assert col["bytes"]["all-reduce"] == (2 * layers * rows * d * 4
                                          + rows * d * 4)


def test_moe_serve_cell_on_a_fake_mesh_counts_per_device():
    """``dryrun.cost_cell`` of deepseek-v2-lite-16b ``decode_32k`` at 2
    layers of full width (the dense first layer and one MoE layer) on a
    fake (data 2, model 2) mesh: the K1, K3 and grouped K4 calls per
    step are the unsharded step's (grouped K4 once a routed projection,
    on each rank's 32 experts); no parameter moves (no all-to-all: the
    experts' scales were placed by the expert axis once, at init); the
    all-gathers are, per layer, MLA's queries (a decode step attends
    every head on every rank), its down-projected kv and its latent cache
    ``c`` and ``k_rope`` (each rank's 64 rows, all 32,768 positions,
    bf16), per MoE layer the experts' output rows (the rank's group, 64
    experts x the capacity), and the logits' vocabulary."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.hlo_analysis import analyze
    from repro_torch.launch.serve import Server
    from repro_torch.models.moe import capacity_for
    cell = dryrun.build_cell("deepseek-v2-lite-16b", "decode_32k",
                             n_layers=2)
    rec = dryrun.cost_cell(cell, mesh_shape=(2, 2))
    cfg, b, t = cell.cfg, cell.shape.global_batch, cell.max_len
    srv = Server(cfg, tt.init_params(dryrun._MetaGenerator(), cfg,
                                     packed=True),
                 batch_slots=b, max_len=t, device="meta")
    caches = tt.init_caches(srv.cfg, b, t, device="meta")
    toks = torch.empty((b, 1), dtype=torch.int64, device="meta")
    with torch.inference_mode():
        _, one = analyze(tt.decode_step, srv.params, caches, toks, t - 1,
                         srv.cfg)
    assert rec["cost_mesh"] == {"data": 2, "model": 2}
    assert rec["kernel_calls"] == one.kernel_calls
    assert rec["kernel_calls"]["K4g"] == 3 * (cfg.n_layers
                                              - cfg.n_dense_layers)
    col = rec["collectives"]
    assert col["counts"]["all-to-all"] == 0
    layers, moe_layers, rows = cfg.n_layers, 1, b // 2
    bf16 = 2
    cap = capacity_for(rows, cfg.moe_cfg())
    latent = cfg.kv_lora + cfg.qk_rope_dim
    queries = cfg.n_heads * (cfg.qk_nope_dim + cfg.qk_rope_dim)
    gathered = (layers * rows * (queries + latent) * bf16
                + layers * rows * t * latent * bf16
                + moe_layers * cfg.n_experts * cap * cfg.d_model * bf16
                + rows * cfg.vocab_size * bf16)
    assert col["counts"]["all-gather"] == 4 * layers + moe_layers + 1
    assert col["bytes"]["all-gather"] == gathered


def _family_collectives(cfg, rows: int, ranks_: int) -> dict:
    """The collectives one device of a fake ``ranks_``-way ``model`` axis
    counts in a ``decode_step`` of ``cfg`` (``rows`` a data rank), by
    family: ``{kind: (count, bytes)}``."""
    bf16, i32, f32, L = 2, 4, 4, cfg.n_layers
    if cfg.family == "ssm":
        # in_proj's fused output and the conv's output gathered whole
        # (bf16), and the state's heads (float32) for the scan on every
        # head; out_proj's int32 sums
        di = cfg.ssm_expand * cfg.d_model
        heads = di // cfg.ssm_head_dim
        cols = 2 * di + 2 * cfg.ssm_state + heads + di + 2 * cfg.ssm_state
        state = heads * cfg.ssm_state * cfg.ssm_head_dim
        return {"all-gather": (3 * L, L * rows * (cols * bf16 + state * f32)),
                "all-reduce": (L, L * rows * cfg.d_model * i32)}
    if cfg.family == "hybrid":
        # 5 kv heads: the caches' positions and the window's slots split;
        # q, k, v whole over the heads, the conv's output (its 50 heads,
        # and in_proj's 6,482 columns, do not divide: those whole), the
        # MLP's h (down's 172 words do not divide) gathered; the window's
        # shift: each rank's first slot of K and of V; each layer's
        # attention combined by log-sum-exp (max, sum, weighted values)
        di = cfg.ssm_expand * cfg.d_model
        kv = cfg.n_kv_heads * cfg.head_dim
        cols = cfg.n_heads * cfg.head_dim + 2 * kv + di + \
            2 * cfg.ssm_state + cfg.d_ff
        windowed = sum(g.n for g in tt.layer_groups(cfg)
                       if g.window is not None)
        heads = rows * cfg.n_heads
        return {"all-gather": (5 * L + 2 * windowed,
                               L * rows * cols * bf16
                               + 2 * windowed * rows * ranks_ * kv * bf16),
                "all-reduce": (3 * L, L * (2 * heads + heads
                                           * cfg.head_dim) * f32)}
    # the encoder-decoder: the cross K/V whole in the cache, the cross
    # queries gathered whole (every rank attends every head); o, the
    # cross o and down row-parallel
    return {"all-gather": (L, L * rows * cfg.n_heads * cfg.head_dim * bf16),
            "all-reduce": (3 * L, 3 * L * rows * cfg.d_model * i32)}


@pytest.mark.parametrize("arch", ranks.FAMILY_ARCHS)
def test_family_serve_cell_on_a_fake_mesh_counts_per_device(arch):
    """``dryrun.cost_cell`` of mamba2-780m, hymba-1.5b and
    seamless-m4t-large-v2 ``decode_32k`` at 2 layers of full width on
    the fake 16 x 16 production mesh: the kernel calls per step are the
    unsharded step's, and the collectives are each family's: mamba2's
    three gathers a layer (in_proj's fused output, the conv's output and
    the state's 48 heads, 3 a rank, for the scan on every head) and
    out_proj's int32 sum; hymba's (1,024-slot
    windows split 64 a rank) with its rolling shift — each rank's first
    slot of K and V, all-gathered — and the log-sum-exp combine;
    seamless's row-parallel sums and its cross queries gathered whole
    (its cross K/V whole in the cache: every rank attends every head)."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.hlo_analysis import analyze
    from repro_torch.launch.serve import Server
    cell = dryrun.build_cell(arch, "decode_32k", n_layers=2)
    rec = dryrun.cost_cell(cell)
    cfg, b, t = cell.cfg, cell.shape.global_batch, cell.max_len
    srv = Server(cfg, tt.init_params(dryrun._MetaGenerator(), cfg,
                                     packed=True),
                 batch_slots=b, max_len=t, device="meta")
    caches = tt.init_caches(srv.cfg, b, t, device="meta",
                            src_len=cell.src_len)
    toks = torch.empty((b, 1), dtype=torch.int64, device="meta")
    with torch.inference_mode():
        _, one = analyze(tt.decode_step, srv.params, caches, toks, t - 1,
                         srv.cfg)
    assert rec["cost_mesh"] == {"data": 16, "model": 16}
    assert rec["kernel_calls"] == one.kernel_calls
    assert 0 < rec["flops_int"] < one.flops_int
    col = rec["collectives"]
    for kind, (count, nbytes) in _family_collectives(cfg, b // 16,
                                                     16).items():
        assert (col["counts"][kind], col["bytes"][kind]) == (count, nbytes)
    assert col["counts"]["all-to-all"] == 0


def test_mesh_refuses_what_this_slice_does_not_serve():
    """Every family builds on a mesh: the SSM, hybrid and encoder-decoder
    families (mamba2, hymba, seamless) and the MoE family (deepseek,
    qwen3-moe). Float serving raises ``NotImplementedError``; a mesh of
    another device type and ``batch_slots`` that do not divide over
    ``data`` raise ``ValueError``, for the engine too; the engine refuses
    the families its slot arena does not take (SSM or hybrid state,
    rolling windows, an encoder's input), on a mesh as off it; and a
    per-row position on a placed rolling buffer raises ``ValueError``.
    The dry run counts a family's serve cell (mamba2's, once refused) per
    device of the fake 16 x 16 mesh."""
    import torch
    from repro_torch.distributed import placed
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_mesh
    from repro_torch.launch.serve import Server
    from repro_torch.serving import ContinuousLMEngine
    lm = get_arch("stablelm-1.6b").smoke
    with fake_mesh((2, 2), device_type="cpu") as mesh:
        for arch in ranks.FAMILY_ARCHS + ranks.MOE_ARCHS:
            Server(get_arch(arch).smoke, device="cpu", mesh=mesh)
        with pytest.raises(NotImplementedError, match="float serving"):
            Server(lm, device="cpu", mesh=mesh, quantized=False)
        with pytest.raises(ValueError, match="does not divide"):
            Server(lm, batch_slots=3, device="cpu", mesh=mesh)
        with pytest.raises(ValueError, match="does not divide"):
            ContinuousLMEngine(lm, batch_slots=3, device="cpu", mesh=mesh)
        with pytest.raises(NotImplementedError, match="float serving"):
            ContinuousLMEngine(lm, device="cpu", mesh=mesh, quantized=False)
        for arch in ranks.FAMILY_ARCHS:
            with pytest.raises(ValueError, match="continuous slot arena"):
                ContinuousLMEngine(get_arch(arch).smoke, device="cpu",
                                   mesh=mesh)
    with fake_mesh((1, 4), device_type="cpu") as mesh:
        hymba = get_arch("hymba-1.5b").smoke
        srv = Server(hymba, device="cpu", mesh=mesh)
        caches = tt.init_caches(srv.cfg, 4, 16, device="cpu", mesh=mesh)
        window = [i for i, g in enumerate(tt.layer_groups(hymba))
                  if g.window is not None][0]
        assert "rolling" in caches[window]["attn"]
        assert placed.is_placed(caches[window]["attn"]["k"])
        with srv._context(), pytest.raises(
                ValueError, match="per-row cache positions on a placed "
                                  "rolling"):
            tt.decode_step(srv.params, caches,
                           srv._place_batch(torch.zeros((4, 1),
                                                        dtype=torch.long)),
                           torch.tensor([3, 1, 0, 2], dtype=torch.int32),
                           srv.cfg)
    with fake_mesh((1, 2), device_type="cuda") as mesh:
        with pytest.raises(ValueError, match="cuda mesh"):
            Server(lm, device="cpu", mesh=mesh)
    rec = dryrun.cost_cell(dryrun.build_cell("mamba2-780m", "decode_32k",
                                             n_layers=1))
    assert rec["cost_mesh"] == {"data": 16, "model": 16}
    assert "cost_mesh_reason" not in rec
    assert rec["kernel_calls"]["K1"] == 2 and rec["kernel_calls"]["K3"] == 2
    assert rec["collectives"]["counts"]["all-gather"] == 3


def test_placed_packings_give_the_same_words(mesh_run):
    """On the (2, 2) mesh, each rank's planes, scales and every other leaf
    are the same words and placements whether the layers are drawn,
    packed and split one at a time (``init_placed_params(packed=True)``,
    what ``Server(mesh=)`` draws), the whole packed params are placed
    (``place_tree``), or the placed float params are packed
    (``pack_params``); the planes are split."""
    for r in mesh_run[2]:
        same, split = r["placed_packing"]
        assert same == [True, True] and split > 0
