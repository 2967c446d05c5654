"""The rank side of ``tests/test_torch_mesh.py``: functions that
``repro_torch.launch.mesh.run_ranks`` starts in spawned gloo ranks. This
module imports torch and the port only (no jax), so a rank starts fast;
the test module computes every reference and unsharded result and hands
the ranks numpy inputs."""

import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.core.tree import tree_flatten, tree_leaves, tree_unflatten
from repro_torch.distributed import placed
from repro_torch.distributed.compression import (compress_tree,
                                                 compressed_allreduce_mean)
from repro_torch.distributed.context import bind_axes, constrain
from repro_torch.distributed.sharding import (batch_pspec, distribute_tree,
                                              to_placements, tree_shardings)
from repro_torch.launch.hlo_analysis import analyze
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.launch.train import Trainer, make_train_step
from repro_torch.models import transformer as tt
from repro_torch.optim import AdamWConfig
from repro_torch.optim.optimizer import reduce_gradients
from repro_torch.runtime.checkpoint import CheckpointManager

#: the mesh tests' Trainer runs: 3 steps of the smoke config
TRAIN = dict(batch_size=4, seq_len=16, seed=0)
OPT = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=3)


def chunked(cfg):
    """``cfg`` with the chunked attention, 8 x 8 blocks (2 x 2 of them at
    the tests' 16 tokens)."""
    return dataclasses.replace(cfg, use_chunked_attn=True, attn_q_chunk=8,
                               attn_kv_chunk=8)


def _np(t):
    return t.detach().cpu().numpy()


def _place_batch(batch, mesh):
    from torch.distributed.tensor import distribute_tensor
    return {k: distribute_tensor(
        torch.from_numpy(v).long(), mesh,
        to_placements(batch_pspec(v.shape, mesh), mesh), src_data_rank=None)
        for k, v in batch.items()}


def _loss_and_grads(params, batch, cfg, mesh):
    """The loss and the gradients (reduced to the params' placements) of
    placed params, each gathered whole."""
    leaves, treedef = tree_flatten(params)
    leaves = [l.detach().requires_grad_(True) for l in leaves]
    with placed.mesh_context(mesh):
        loss, _ = tt.loss_fn(tree_unflatten(treedef, leaves), batch, cfg)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
    grads = tree_leaves(reduce_gradients(list(grads), leaves))
    placements = [str(tuple(g.placements)) for g in grads]
    return (float(placed.plain(loss.detach())),
            [_np(placed.plain(g)) for g in grads], placements)


def mesh_rank(rank, inputs, part):
    """The 2 x 2 gloo mesh's checks of one ``part`` (the test runs the two
    in two process groups at once): ``"dense"`` — ``constrain``,
    stablelm's loss and gradients and its chunked attention, the
    ``Trainer``, the checkpoints and the int8 all-reduce; ``"ssm_moe"`` — mamba2's loss and gradients and
    deepseek's EP-sharded MoE. Returns, on every rank, a dict of results
    (gathered whole)."""
    mesh = make_local_mesh(2, 2, device="cpu")
    out = {"rank": rank, "coord": tuple(mesh.get_coordinate())}
    if part == "dense":
        _dense(rank, inputs, mesh, out)
    else:
        _ssm_moe(inputs, mesh, out)
    return out


def _models(inputs, mesh, out, archs):
    """Loss and gradients on params placed by the reference's rules."""
    for arch in archs:
        params_np, batch = inputs["models"][arch]
        cfg = get_arch(arch).smoke
        params = tt.params_from_numpy(params_np)
        params = distribute_tree(params, tree_shardings(params, mesh))
        out[arch] = _loss_and_grads(params, _place_batch(batch, mesh), cfg,
                                    mesh)


def _dense(rank, inputs, mesh, out):
    # a constraint redistributes a placed tensor, a plain one passes
    from torch.distributed.tensor import distribute_tensor, Partial
    x = distribute_tensor(torch.arange(16.).reshape(4, 4), mesh,
                          to_placements((None, None), mesh))
    y = torch.ones(4)
    with bind_axes(dp="data", tp="model", mesh=mesh):
        out["constrain"] = [str(tuple(constrain(x, "dp", "tp").placements)),
                            str(tuple(constrain(x, "dp").placements)),
                            constrain(y, "dp") is y]
        part = torch.distributed.tensor.DTensor.from_local(
            torch.full((2, 4), float(rank)), mesh, [Partial(), Partial()])
        whole = constrain(part, None, None)
        out["constrain_partial"] = (str(tuple(whole.placements)),
                                    _np(whole.to_local()))

    # 3 heads of 8 split over the 2-way model axis: made whole, then viewed;
    # the gradient comes back at the input's placements
    w = distribute_tensor(torch.arange(2 * 5 * 24.).reshape(2, 5, 24), mesh,
                          to_placements(("data", None, "model"), mesh))
    w.requires_grad_(True)
    heads = placed.split_heads(w, 3, 8)
    (g,) = torch.autograd.grad((heads * heads).sum(), w)
    out["split_heads"] = (tuple(heads.shape), _np(placed.plain(heads)),
                          str(tuple(g.placements)), _np(placed.plain(g)))

    _models(inputs, mesh, out, ["stablelm-1.6b"])
    # the chunked (online-softmax) attention on the placed params
    params_np, batch = inputs["models"]["stablelm-1.6b"]
    params = tt.params_from_numpy(params_np)
    params = distribute_tree(params, tree_shardings(params, mesh))
    with torch.no_grad(), placed.mesh_context(mesh):
        logits, _ = tt.forward(params, _place_batch(batch, mesh),
                               chunked(get_arch("stablelm-1.6b").smoke))
    out["chunked_logits"] = _np(placed.plain(logits))

    # the Trainer on the mesh (checkpointed at its last step), then a
    # checkpoint written unsharded restored onto the mesh
    lm = get_arch("stablelm-1.6b").smoke
    tr = Trainer(lm, opt_cfg=OPT, ckpt_dir=inputs["ckpt_mesh"], save_every=3,
                 device="cpu", mesh=mesh, **TRAIN)
    state, losses = tr.run(3, log_every=100)
    out["train"] = (losses, [h["grad_norm"] for h in tr.history],
                    [_np(placed.plain(l)) for l in tree_leaves(state)])
    # one more step (out of place: the state above stays), traced: this
    # rank's collectives by kind
    step_batch = tr.device_batch(tr.data.batch(3, TRAIN["batch_size"]))
    with tr._step_context():
        _, cost = analyze(make_train_step(lm, OPT), state, step_batch)
    out["train_cost"] = (cost.collective_counts, cost.collective_bytes)
    target = tr.init_state()
    ck = CheckpointManager(inputs["ckpt_plain"])
    restored = ck.restore(ck.latest_step(), target,
                          shardings=tree_shardings(target, mesh))
    out["restored"] = ([_np(placed.plain(l)) for l in tree_leaves(restored)],
                       [str(tuple(l.placements))
                        for l in tree_leaves(restored)])

    # the int8 all-reduce over all four ranks
    g = torch.from_numpy(inputs["compress"][0][rank])
    e = torch.from_numpy(inputs["compress"][1][rank])
    out["compress_mean"] = _np(compressed_allreduce_mean(g))
    red, err = compress_tree({"a": g, "b": [g[:17] * 3]},
                             {"a": e, "b": [torch.zeros(17)]})
    out["compress_tree"] = (_np(red["a"]), _np(err["a"]), _np(red["b"][0]),
                            _np(err["b"][0]))


def _ssm_moe(inputs, mesh, out):
    _models(inputs, mesh, out, ["mamba2-780m"])
    # deepseek: the EP-sharded MoE's forward, loss and gradients
    moe = get_arch("deepseek-v2-lite-16b").smoke
    params = tt.init_params(torch.Generator().manual_seed(0), moe)
    params = distribute_tree(params, tree_shardings(params, mesh))
    pb = _place_batch(inputs["moe_batch"], mesh)
    with torch.no_grad(), placed.mesh_context(mesh):
        logits, aux = tt.forward(params, pb, moe)
    out["moe_logits"] = _np(placed.plain(logits))
    out["moe_lb"] = float(placed.plain(aux["lb_loss"]))
    out["moe_placements"] = str(tuple(params["groups"][1]["moe"]["w_up"][
        "w"].placements))
    out["moe_grads"] = _loss_and_grads(params, pb, moe, mesh)
