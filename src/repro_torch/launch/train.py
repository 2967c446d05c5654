"""Training: LSQ quantization-aware training with checkpoint/restart
supervision, straggler detection and async checkpoints.

Counterpart of ``repro/launch/train.py`` on one device: a step is the
forward (LSQ fake quantization on every projection, each layer
checkpointed under ``cfg.remat``), ``backward`` and the reference's AdamW;
the batches are the reference's :class:`~repro_torch.data.SyntheticLM`
stream, equal bit for bit. Every family the reference trains trains here:
:func:`make_train_step` takes any batch :func:`loss_fn` takes (a VLM's
``frontend_embeds``, an encoder-decoder's ``src_embeds`` or
``src_tokens``); the :class:`Trainer` feeds tokens alone, as the
reference's does. The trained float params export to the packed
deployment path with :func:`~repro_torch.models.transformer.pack_params`.

On a mesh (``Trainer(mesh=)``, a ``DeviceMesh`` from
:func:`~repro_torch.launch.mesh.make_local_mesh`; one process a rank) the
state is placed by the reference's ``tree_shardings`` (2-D FSDP + TP
float weights, EP experts) as DTensors, each rank drawing every layer
from the same seeded generator and keeping its shard, each batch by
``batch_pspec``, and every step runs under the reference's axis binding
(``dp`` the DP axes, ``tp`` ``model``): the gradients are reduced to
their parameters' placements before AdamW, which updates each rank's
shards. The CLI's ``--data-par``/``--model-par`` start the ranks
themselves (:func:`~repro_torch.launch.mesh.run_ranks`: NCCL, one card a
rank; gloo with ``--device cpu``); only rank 0 prints and writes.

    python -m repro_torch.launch.train --arch stablelm-1.6b --steps 8
    python -m repro_torch.launch.train --arch stablelm-1.6b --smoke --device cpu --steps 20 [--ckpt-dir D]
    python -m repro_torch.launch.train --arch stablelm-1.6b --smoke --device cpu --data-par 2 --model-par 2 --steps 2

The CLI trains the arch's full config on the card unless ``--smoke`` (the
reference's ``--smoke`` is ``store_true`` with ``default=True``, so its
CLI only ever trains the smoke config).
"""

from __future__ import annotations

import argparse
import contextlib
import time
from typing import Optional

import torch
from torch.profiler import record_function

from repro_torch import resolve_device
from repro_torch.configs import get_arch, list_archs
from repro_torch.core.pipeline_modules import disable_tf32
from repro_torch.core.tree import tree_flatten, tree_unflatten
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.distributed import placed
from repro_torch.distributed.sharding import (batch_pspec, local_slices,
                                              map_paths, param_pspec,
                                              to_placements, tree_shardings)
from repro_torch.models.transformer import ModelConfig, init_params, loss_fn
from repro_torch.optim.optimizer import AdamWConfig, adamw_init, adamw_update
from repro_torch.runtime.checkpoint import CheckpointManager
from repro_torch.runtime.fault_tolerance import FailureInjector, TrainSupervisor
from repro_torch.runtime.straggler import StepTimer, StragglerDetector

__all__ = ["Trainer", "make_train_step", "init_placed_params"]


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, *,
                    donate: bool = False):
    """``train_step(state, batch) -> (state, metrics)``: the loss and its
    gradients wrt every param leaf, then one AdamW update. ``state`` is
    ``{"params", "opt"}``; ``batch`` is whatever :func:`loss_fn` takes
    (``tokens`` and ``labels``, plus ``frontend_embeds``, ``src_embeds``
    or ``src_tokens`` for the families that read them). Metrics ``loss``,
    ``ce``, ``lr`` and ``grad_norm`` are 0-d tensors on the state's
    device. ``state`` is not written unless ``donate``: then the update is
    written into its params and moments (the reference's ``Trainer``
    donates its state to the jitted step), so a step holds one state, not
    two; the arithmetic is the same. The three parts run in the profiler
    ranges ``train_step.forward``, ``train_step.backward`` and
    ``train_step.adamw``."""

    def train_step(state, batch):
        leaves, treedef = tree_flatten(state["params"])
        leaves = [l.detach().requires_grad_(True) for l in leaves]
        with torch.enable_grad():
            with record_function("train_step.forward"):
                loss, aux = loss_fn(tree_unflatten(treedef, leaves), batch,
                                    cfg)
            with record_function("train_step.backward"):
                grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                            materialize_grads=True)
        del leaves
        with torch.no_grad(), record_function("train_step.adamw"):
            params, opt, om = adamw_update(
                state["params"], tree_unflatten(treedef, list(grads)),
                state["opt"], opt_cfg, inplace=donate)
        metrics = {"loss": placed.plain(loss.detach()),
                   "ce": placed.plain(aux["ce"].detach()), **om}
        return {"params": params, "opt": opt}, metrics

    return train_step


def init_placed_params(gen: torch.Generator, cfg: ModelConfig, mesh, *,
                       packed: bool = False):
    """:func:`~repro_torch.models.transformer.init_params` placed on
    ``mesh`` by ``param_pspec``: every rank draws every layer from ``gen``
    (seeded alike on every rank, so the draws agree) and keeps its shard,
    so no rank holds more than one full layer (and the embedding and head)
    at a time, and the whole params equal an unplaced draw's. With
    ``packed`` each layer is packed whole and then split (a sharded
    server's planes: ``_packed_spec``)."""
    from torch.distributed.tensor import DTensor
    placing = {}

    def keep(path, t, n):
        full = ((n,) if n is not None else ()) + tuple(t.shape)
        spec = param_pspec(path, full, mesh)
        placing[path] = (full, spec)
        sl = local_slices(spec[1:] if n is not None else spec,
                          tuple(t.shape), mesh)
        if all(s == slice(None) for s in sl):
            return t
        return t[sl].clone(memory_format=torch.contiguous_format)

    local = init_params(gen, cfg, packed=packed, keep=keep)

    def wrap(path, t):
        full, spec = placing[path]
        return DTensor.from_local(
            t, mesh, to_placements(spec, mesh), shape=torch.Size(full),
            stride=placed.contiguous_stride(full))

    return map_paths(wrap, local)


class Trainer:
    """Supervised trainer wiring the runtime subsystems together.

    ``device=None`` means the card: it raises when there is none (pass
    ``device="cpu"``). Every family but the encoder-decoder trains on
    :class:`~repro_torch.data.SyntheticLM` tokens (a VLM without its
    patches, as the reference's ``Trainer``); an encoder-decoder raises
    ``ValueError``, since the stream carries no source: train it through
    :func:`make_train_step` with ``src_embeds``. Parameters are drawn from
    a ``torch.Generator`` seeded with ``seed`` on the device. Each step
    donates the state (:func:`make_train_step` with ``donate``), as the
    reference's jitted step does. With ``ckpt_dir`` the run is supervised
    (:class:`~repro_torch.runtime.fault_tolerance.TrainSupervisor`: a
    checkpoint every ``save_every`` steps and at the last, restore and
    continue after a :class:`WorkerFailure`).

    ``mesh`` (a ``DeviceMesh`` with the reference's axis names, this
    process one of its ranks) trains on the mesh: the state drawn placed
    (:func:`init_placed_params`, the moments placed as their params), each
    batch placed by ``batch_pspec`` and each step run in
    :func:`~repro_torch.distributed.placed.mesh_context`; a restore
    places the checkpoint's leaves as the state's. ``device`` is this
    rank's device and must be of the mesh's type (``None``, the card,
    raises with none). Only rank 0 prints and writes checkpoints."""

    def __init__(self, cfg: ModelConfig, *, opt_cfg: AdamWConfig,
                 ckpt_dir: Optional[str] = None,
                 batch_size: int = 8, seq_len: int = 64, seed: int = 0,
                 save_every: int = 50, device=None, mesh=None):
        if cfg.family in ("encdec", "audio"):
            raise ValueError(
                f"{cfg.name}: an encoder-decoder trains on a source, and the "
                "SyntheticLM stream carries none (the reference's Trainer "
                "fails at its first step with KeyError('src_tokens')); call "
                "make_train_step with src_embeds in the batch")
        self.device = resolve_device(device)
        if mesh is not None and mesh.device_type != self.device.type:
            raise ValueError(f"a {mesh.device_type} mesh trains on its "
                             f"ranks' {mesh.device_type} devices, not "
                             f"{self.device}")
        self.mesh = mesh
        self.rank0 = mesh is None or torch.distributed.get_rank() == 0
        if self.device.type == "cuda":
            disable_tf32()
        self.cfg = cfg
        self.opt_cfg = opt_cfg
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.seed = seed
        self.data = SyntheticLM(cfg.vocab_size, seq_len, seed=seed)
        self.ckpt = (CheckpointManager(ckpt_dir) if ckpt_dir else None)
        self.save_every = save_every
        self.detector = StragglerDetector()
        #: one row per step run: loss, ce, lr, grad_norm, step, seconds
        self.history = []
        self._step_fn = make_train_step(cfg, opt_cfg, donate=True)

    def init_state(self):
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        if self.mesh is None:
            params = init_params(gen, self.cfg)
        else:
            params = init_placed_params(gen, self.cfg, self.mesh)
        return {"params": params, "opt": adamw_init(params)}

    def device_batch(self, batch):
        """A host batch (numpy int32) as int64 tensors on the device; on a
        mesh, each placed by ``batch_pspec`` (every rank reads the same
        host batch and keeps its rows)."""
        out = {k: torch.from_numpy(v).to(self.device, dtype=torch.int64)
               for k, v in batch.items()}
        if self.mesh is not None:
            from torch.distributed.tensor import distribute_tensor
            out = {k: distribute_tensor(
                v, self.mesh, to_placements(batch_pspec(tuple(v.shape),
                                                        self.mesh),
                                            self.mesh), src_data_rank=None)
                for k, v in out.items()}
        return out

    def _step_context(self):
        return (placed.mesh_context(self.mesh) if self.mesh is not None
                else contextlib.nullcontext())

    def run(self, n_steps: int, injector: Optional[FailureInjector] = None,
            log_every: int = 10):
        """Train ``n_steps`` steps from the latest checkpoint (or from
        ``init_state``); returns ``(state, losses)``, one float loss per
        step run (a replayed step after a restore adds its loss again)."""
        losses = []

        def build_state(ckpt_step):
            state = self.init_state()
            if ckpt_step is not None and self.ckpt is not None:
                sh = (tree_shardings(state, self.mesh)
                      if self.mesh is not None else None)
                state = self.ckpt.restore(ckpt_step, state, shardings=sh)
            return state

        def one_step(state, step):
            batch = self.device_batch(self.data.batch(step, self.batch_size))
            t0 = time.perf_counter()
            with StepTimer(self.detector, step), self._step_context():
                state, metrics = self._step_fn(state, batch)
                # reading the metrics waits for the device, so the timer
                # sees the step's time, not its enqueue
                row = {k: float(v) for k, v in metrics.items()}
            row.update(step=step, seconds=time.perf_counter() - t0)
            self.history.append(row)
            losses.append(row["loss"])
            if step % log_every == 0 and self.rank0:
                print(f"step {step:5d} loss {row['loss']:.4f} "
                      f"lr {row['lr']:.2e} "
                      f"gnorm {row['grad_norm']:.2f}", flush=True)
            return state, metrics

        if self.ckpt is not None:
            sup = TrainSupervisor(self.ckpt, save_every=self.save_every)
            state = sup.run(build_state, one_step, n_steps, injector=injector)
        else:
            state = build_state(None)
            for s in range(n_steps):
                state, _ = one_step(state, s)
        return state, losses


def _train(cfg: ModelConfig, args, mesh=None) -> None:
    trainer = Trainer(cfg, opt_cfg=AdamWConfig(total_steps=args.steps),
                      ckpt_dir=args.ckpt_dir, batch_size=args.batch,
                      seq_len=args.seq, seed=args.seed, device=args.device,
                      mesh=mesh)
    t0 = time.perf_counter()
    _, losses = trainer.run(args.steps, log_every=args.log_every)
    dt = time.perf_counter() - t0
    if trainer.rank0:
        on = (f"a (data {args.data_par}, model {args.model_par}) mesh of "
              f"{trainer.device.type}" if mesh is not None
              else str(trainer.device))
        print(f"done: {args.steps} steps of {cfg.name} in {dt:.1f}s "
              f"({args.steps * args.batch * args.seq / dt:.0f} tok/s) on "
              f"{on}; loss {losses[0]:.3f} -> {losses[-1]:.3f}", flush=True)


def _mesh_rank(rank: int, cfg: ModelConfig, args) -> None:
    """One rank of the CLI's mesh run (started by ``run_ranks``)."""
    from repro_torch.launch.mesh import make_local_mesh
    if args.device is not None and torch.device(args.device).type == "cuda":
        args.device = None                      # this rank's own card
    mesh = make_local_mesh(args.data_par, args.model_par,
                           device=args.device)
    _train(cfg, args, mesh)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True, choices=tuple(list_archs()))
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's reduced config (for the CPU)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--data-par", type=int, default=1,
                    help="ranks over the data axis (one process each)")
    ap.add_argument("--model-par", type=int, default=1,
                    help="ranks over the model axis (one process each)")
    args = ap.parse_args(argv)

    entry = get_arch(args.arch)
    cfg = entry.smoke if args.smoke else entry.full
    n = args.data_par * args.model_par
    if n > 1:
        from repro_torch.launch.mesh import run_ranks
        run_ranks(_mesh_rank, n, device=args.device, args=(cfg, args),
                  timeout=24 * 3600)
    else:
        _train(cfg, args)


if __name__ == "__main__":
    main()
