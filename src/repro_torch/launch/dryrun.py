"""Every (architecture x assigned shape) cell on one card: its memory
accounted from shapes, and, with ``--run`` on the card, the cell run for
real at its sequence length.

Counterpart of ``repro/launch/dryrun.py``, which lowers and compiles each
cell for a TPU pod's mesh with ``jax.ShapeDtypeStruct`` inputs. A torch
program has no ahead-of-time compile to analyze, so the port:

* builds the cell on the ``meta`` device, the counterpart of
  ``jax.eval_shape``: the parameters (float for ``train``, packed for a
  serve cell, float32 leaves counted as bf16 as the reference's
  ``_cast_serve`` does), the AdamW state, the caches at the shape's
  length and global batch, and the inputs (:func:`input_specs`). Packing
  runs on ``meta`` too (one layer per group, stacked). The record gives
  each part's bytes, the cache's bytes per row and whether the total fits
  the card's ``total_memory``;
* with ``run=True`` runs the cell on the device at its ``seq_len``, the
  batch cut to ``batch`` or to the rows that fit (``batch_run`` beside
  ``global_batch``): ``train`` one ``make_train_step`` step on the
  cell's seeded inputs (every family: a VLM's patches, an
  encoder-decoder's source; loss, the leaves that moved, peak memory),
  ``prefill`` one ``prefill`` (synchronized wall, the last position's
  greedy tokens), ``decode``
  ``Server.generate`` on short seeded prompts against caches of
  ``seq_len`` slots, each step timed (every step reads every slot, so a
  step costs what a full-depth one does).

``build_cell`` applies the reference's config replacements: the radix,
``use_chunked_attn`` for every cell but a decode, ``kv_bits`` and
``remat_policy``. Records are JSON under ``artifacts/dryrun_torch/``.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch stablelm-1.6b \\
        --shape prefill_32k                        # accounting only (CPU)
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch hymba-1.5b \\
        --shape long_500k --kv-bits 8 --run        # on the card

Every record also holds ``per_device_bytes``: each part's bytes on one
device of the reference's production mesh (``--mesh single``: data 16 x
model 16; ``multi``: pod 2 x data 16 x model 16; ``launch/mesh.py``),
each leaf's bytes divided by the product of the axis sizes its spec
(``distributed/sharding.py``: ``param_pspec`` for params and AdamW
moments, ``cache_pspec``, ``batch_pspec``) names. Only ``single`` runs
(one card); ``multi`` accounts and ``run`` with it raises.

Every record also holds one step's cost, counted by
``launch/hlo_analysis.py`` from a dispatch trace on the ``meta`` device
(:func:`cost_cell`), under the reference's keys: ``flops``,
``flops_int``, ``bytes_hbm`` and ``collectives`` (``bytes``, ``counts``
by the five kinds, ``total_bytes``), and the port's ``flops_logical``,
``kernel_calls``, ``ops``, ``cost_mesh`` and ``cost_s``. A ``train``
cell counts one ``make_train_step`` step (loss, gradients, AdamW) per
device of the production mesh, a fake process group of 256 or 512 ranks
in this process (``launch/mesh.py``'s ``fake_mesh``), the state and batch
placed as a mesh run places them; the counts are rank 0's. A
``prefill`` or ``decode`` cell (every family) counts one ``prefill`` or
one ``decode_step`` (at the cache's last position) of a sharded
``Server`` on rank 0 of the same fake mesh: the packed params placed by
``param_pspec``, the caches by ``cache_pspec``, the inputs by
``batch_pspec``; each K3/K4 launch counts its rank's local work (grouped
K4 its rank's experts), the row-parallel projections' int32 sums count
as all-reduces, and the gathers of the experts' rows, of MLA's latent
cache, of an SSM's fused in-projection, conv output and state, of an
encoder-decoder's cross K/V and queries and of the slots a split sliding
window shifts across ranks as all-gathers. ``cost=False`` leaves the
cost out. A ``run`` is not traced.

Flags as the reference's: ``--arch``, ``--shape``, ``--all``, ``--mesh``
(``single``, ``multi`` or ``both``), ``--radix``, ``--kv-bits``,
``--no-chunked``, ``--remat-policy``
(``nothing`` or ``dots``), ``--tag``, ``--out``, ``--force``; the port
adds ``--run``, ``--batch``, ``--device`` and ``--no-cost``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
import traceback
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import SHAPES, Shape, get_arch, list_archs
from repro_torch.configs.base import input_specs
from repro_torch.core.pipeline_modules import disable_tf32
from repro_torch.core.tree import tree_leaves
from repro_torch.distributed.sharding import (batch_pspec, cache_pspec,
                                              param_pspec, spec_shards,
                                              tree_paths)
from repro_torch.launch.hlo_analysis import analyze
from repro_torch.launch.mesh import fake_mesh, make_production_mesh
from repro_torch.models.transformer import (ModelConfig, init_caches,
                                            init_params, prefill)
from repro_torch.optim import AdamWConfig, adamw_init

__all__ = ["ART_DIR", "Cell", "build_cell", "account", "cost_cell",
           "run_cell", "cells_for", "main"]

ART_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "artifacts", "dryrun_torch")
#: the share of the card's memory a run may plan for when it picks its rows
FIT_SHARE = 0.85
#: the seed of a run's random weights and inputs
SEED = 0


class _MetaGenerator(torch.Generator):
    """A CPU generator whose ``device`` says ``meta``: the port's
    ``init_*`` functions draw on ``gen.device``, and a draw on ``meta``
    makes shapes only."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


@dataclasses.dataclass(frozen=True)
class Cell:
    """One (architecture x shape) cell: the replaced config, the cache
    length (``prefill``: the target tokens, the frontend's and 8 spare, as
    the reference's ``serve_prefill``; ``decode``: ``seq_len``; ``train``:
    none) and an encoder-decoder's source length."""
    arch: str
    shape: Shape
    cfg: ModelConfig
    max_len: int
    src_len: int


def _cut_depth(cfg: ModelConfig, n: int) -> ModelConfig:
    """``cfg`` at ``n`` layers, every width kept: the global-attention
    layers and the leading dense layers that fall inside, an encoder cut
    alike."""
    return dataclasses.replace(
        cfg, n_layers=n,
        global_attn_layers=tuple(g for g in cfg.global_attn_layers if g < n),
        n_dense_layers=min(cfg.n_dense_layers, n),
        n_enc_layers=min(cfg.n_enc_layers, n) if cfg.n_enc_layers else 0)


def build_cell(arch: str, shape_name: str, *, radix: int = 7,
               use_chunked: bool = True, kv_bits: Optional[int] = None,
               remat_policy: str = "nothing",
               n_layers: Optional[int] = None) -> Cell:
    """The cell's config with the reference's replacements (its
    ``build_cell``): ``radix_bits``, ``use_chunked_attn`` unless the shape
    is a decode, ``kv_bits`` and ``remat_policy``; ``n_layers`` cuts the
    depth (the port's, for checks against the plain versions)."""
    if remat_policy not in ("nothing", "dots"):
        raise ValueError(f"remat_policy={remat_policy!r}: 'nothing' or "
                         "'dots'")
    cfg = get_arch(arch).full
    shape = SHAPES[shape_name]
    cfg = dataclasses.replace(
        cfg, policy=dataclasses.replace(cfg.policy, radix_bits=radix),
        use_chunked_attn=(shape.kind != "decode") and use_chunked,
        kv_bits=kv_bits, remat_policy=remat_policy)
    if n_layers is not None:
        cfg = _cut_depth(cfg, n_layers)
    encdec = cfg.family in ("encdec", "audio")
    max_len = src_len = 0
    if shape.kind == "prefill":
        tgt = input_specs(cfg, shape)["tokens"].shape[1]
        max_len = tgt + (cfg.frontend_len if cfg.family == "vlm" else 0) + 8
        src_len = shape.seq_len if encdec else 0
    elif shape.kind == "decode":
        max_len = shape.seq_len
        src_len = shape.seq_len if encdec else 0
    return Cell(arch, shape, cfg, max_len, src_len)


def _bytes(tree, float_as: Optional[int] = None) -> int:
    """The bytes of every tensor leaf; ``float_as`` counts float32 leaves
    at that width (a serve cell's float32 leaves as bf16)."""
    total = 0
    for t in tree_leaves(tree):
        if not torch.is_tensor(t):
            continue          # a cache's ``len`` and ``rolling`` marker
        size = t.element_size()
        if float_as is not None and t.dtype == torch.float32:
            size = float_as
        total += t.numel() * size
    return total


def _device_bytes(tree, mesh, rule, float_as: Optional[int] = None) -> int:
    """The bytes one device of ``mesh`` holds of ``tree``: each tensor
    leaf's bytes (as :func:`_bytes` counts them) over the number of ways
    ``rule(path, shape, mesh)``'s spec splits it."""
    total = 0
    for path, t in tree_paths(tree):
        if not torch.is_tensor(t):
            continue
        size = t.element_size()
        if float_as is not None and t.dtype == torch.float32:
            size = float_as
        spec = rule(path, tuple(t.shape), mesh)
        total += t.numel() * size // spec_shards(spec, mesh)
    return total


def _card_bytes(device) -> Optional[int]:
    if device is None or torch.device(device).type != "cuda":
        return None
    return torch.cuda.get_device_properties(torch.device(device)).total_memory


def _saved_dots_per_token(cfg: ModelConfig) -> int:
    """The output columns of one layer's projections (the matmuls that
    ``remat_policy="dots"`` keeps), summed over the decoder's layers and
    an encoder's: what a token's saved outputs hold, in elements."""
    attn = (cfg.n_heads * cfg.head_dim + 2 * cfg.n_kv_heads * cfg.head_dim
            + cfg.d_model)
    mlp = (cfg.d_ff if cfg.act != "swiglu" else 2 * cfg.d_ff) + cfg.d_model
    if cfg.n_experts:
        mlp = ((cfg.top_k + cfg.n_shared_experts) * 3 * cfg.d_ff_expert
               + cfg.n_experts)
    ssm = 0
    if cfg.family in ("ssm", "hybrid"):
        sc = cfg.ssm_cfg()
        ssm = (2 * sc.d_inner + 2 * sc.n_groups * sc.d_state + sc.n_heads
               + cfg.d_model)
    per = {"ssm": ssm, "hybrid": attn + ssm + mlp}.get(cfg.family,
                                                        attn + mlp)
    return per * (cfg.n_layers + cfg.n_enc_layers)


def _act_bytes_per_row(cell: Cell) -> int:
    """A rough per-row working set beyond the caches, for picking the rows
    that fit: a train row's saved layer inputs (and under ``"dots"`` every
    layer's projection outputs), float32 logits three times and one
    layer's recompute, an SSM layer's chunked scan among it (a few (S/L)
    x L^2 x H float32 tensors); a prefill row's activations. A decode row
    needs its caches; the float32 copy of one layer's K/V that a step
    makes is left to :data:`FIT_SHARE`'s margin."""
    cfg, s = cell.cfg, cell.shape.seq_len
    layer = 16 * s * max(cfg.d_ff, cfg.d_model) * 4
    if cfg.family in ("ssm", "hybrid"):
        sc = cfg.ssm_cfg()
        lc = min(sc.chunk, s)
        layer += 8 * (-(-s // lc)) * lc * lc * sc.n_heads * 4
    if cell.shape.kind == "train":
        saved = (cfg.n_layers + cfg.n_enc_layers) * s * cfg.d_model * 2
        if cfg.remat_policy == "dots":
            saved += s * _saved_dots_per_token(cfg) * 2
        return saved + 3 * s * cfg.vocab_size * 4 + layer
    if cell.shape.kind == "prefill":
        return layer
    return 0


def account(cell: Cell, *, device=None, mesh_kind: str = "single") -> dict:
    """The cell's bytes from its shapes on the ``meta`` device: params,
    AdamW state (train), caches (serve: at ``max_len`` and the global
    batch), inputs; the cache per row; the rows that fit; and each part's
    bytes per device of the production mesh ``mesh_kind``."""
    cfg, shape = cell.cfg, cell.shape
    b = shape.global_batch
    train = shape.kind == "train"
    mesh = make_production_mesh(multi_pod=mesh_kind == "multi")
    gen = _MetaGenerator()
    params = init_params(gen, cfg, packed=not train)
    float_as = None if train else 2
    param_b = _bytes(params, float_as)
    dev_b = {"params": _device_bytes(params, mesh, param_pspec, float_as),
             "adamw": 0, "caches": 0}
    opt_b = 0
    if train:
        opt = adamw_init(params)
        opt_b = _bytes(opt)
        dev_b["adamw"] = _device_bytes(opt, mesh, param_pspec)
    cache_b = 0
    if not train:
        caches = init_caches(cfg, b, cell.max_len, device="meta",
                             src_len=cell.src_len)
        cache_b = _bytes(caches)
        dev_b["caches"] = _device_bytes(caches, mesh, cache_pspec)
    inputs = input_specs(cfg, shape)
    inputs_b = _bytes(inputs)
    dev_b["inputs"] = _device_bytes(
        inputs, mesh, lambda path, shp, m: batch_pspec(shp, m))
    dev_b["total"] = sum(dev_b.values())
    total = param_b + opt_b + cache_b + inputs_b
    per_row = cache_b // b
    card = _card_bytes(device)
    rec = {"bytes": {"params": param_b, "adamw": opt_b, "caches": cache_b,
                     "inputs": inputs_b, "total": total},
           "cache_len": cell.max_len, "cache_bytes_per_row": per_row,
           # packing runs on meta, so no part is computed by a formula
           "computed_from_shapes": [],
           "per_device_bytes": dict(dev_b, mesh=mesh.shape),
           "card_bytes": card,
           "fits": None if card is None else total <= card}
    if card is not None:
        # train: the old and the new state, and the gradients
        fixed = param_b + (2 * (param_b + opt_b) if train else 0)
        row = per_row + _act_bytes_per_row(cell) + inputs_b // b
        rec["rows_that_fit"] = int(max(0, min(
            b, (FIT_SHARE * card - fixed) // max(row, 1))))
    return rec


def _meta_inputs(cell: Cell) -> dict:
    """The cell's inputs on ``meta`` as a run feeds them (token ids
    int64)."""
    return {k: v.to(torch.int64) if v.dtype == torch.int32 else v
            for k, v in input_specs(cell.cfg, cell.shape).items()}


def cost_cell(cell: Cell, mesh_kind: str = "single",
              mesh_shape: Optional[tuple] = None) -> dict:
    """One step of the cell counted on the ``meta`` device
    (:func:`repro_torch.launch.hlo_analysis.analyze`): a ``train`` step,
    or a sharded ``Server``'s ``prefill`` or ``decode_step``, on rank 0 of
    the production mesh ``mesh_kind`` (a fake process group of its size;
    ``mesh_shape`` another (data, model) or (pod, data, model)). The
    reference's keys (``flops``, ``flops_int``, ``bytes_hbm``,
    ``collectives``) and the port's (``flops_logical``,
    ``kernel_calls``, ``ops``, ``cost_mesh``, ``cost_s``)."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.distributed import placed
    from repro_torch.distributed.sharding import to_placements
    from repro_torch.launch.serve import Server
    from repro_torch.launch.train import init_placed_params, make_train_step
    from repro_torch.models.transformer import decode_step
    t0 = time.perf_counter()
    cfg, shape = cell.cfg, cell.shape
    gen = _MetaGenerator()
    inputs = _meta_inputs(cell)
    sizes = mesh_shape or make_production_mesh(
        multi_pod=mesh_kind == "multi").sizes

    def place(mesh):
        return {k: distribute_tensor(
            v, mesh, to_placements(batch_pspec(tuple(v.shape), mesh), mesh),
            src_data_rank=None) for k, v in inputs.items()}

    if shape.kind == "train":
        with fake_mesh(sizes) as mesh:
            params = init_placed_params(gen, cfg, mesh)
            state = {"params": params, "opt": adamw_init(params)}
            step = make_train_step(cfg, AdamWConfig())
            with placed.mesh_context(mesh):
                _, cost = analyze(step, state, place(mesh))
            cost_mesh = dict(zip(mesh.mesh_dim_names, mesh.shape))
    else:
        with fake_mesh(sizes) as mesh:
            srv = Server(cfg, init_placed_params(gen, cfg, mesh, packed=True),
                         batch_slots=shape.global_batch,
                         max_len=cell.max_len, device="meta", mesh=mesh)
            batch = place(mesh)
            with srv._context():
                if shape.kind == "prefill":
                    _, cost = analyze(prefill, srv.params, batch, srv.cfg,
                                      max_len=cell.max_len)
                else:
                    caches = init_caches(srv.cfg, shape.global_batch,
                                         cell.max_len, device="meta",
                                         src_len=cell.src_len, mesh=mesh)
                    _, cost = analyze(decode_step, srv.params, caches,
                                      batch["tokens"], cell.max_len - 1,
                                      srv.cfg)
            cost_mesh = dict(zip(mesh.mesh_dim_names, mesh.shape))
    d = cost.as_dict()
    return {"flops": d["flops"], "flops_int": d["flops_int"],
            "flops_logical": d["flops_logical"],
            "bytes_hbm": d["bytes_hbm"],
            "collectives": {"bytes": d["collective_bytes"],
                            "counts": d["collective_counts"],
                            "total_bytes": d["total_collective_bytes"]},
            "kernel_calls": d["kernel_calls"], "ops": d["ops"],
            "cost_mesh": cost_mesh,
            "cost_s": time.perf_counter() - t0}


# ------------------------------------------------------------------ runs

def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _seeded_inputs(cell: Cell, rows: int, dev: torch.device, seed: int):
    """The cell's inputs at ``rows`` rows, from ``seed``: tokens over the
    vocabulary, frontend or source embeddings standard normal."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, spec in input_specs(cell.cfg, cell.shape).items():
        shp = (rows,) + tuple(spec.shape[1:])
        if spec.dtype == torch.int32:
            a = rng.integers(0, cell.cfg.vocab_size, shp)
            out[name] = torch.from_numpy(a).to(dev, dtype=torch.int64)
        else:
            a = rng.standard_normal(shp).astype(np.float32)
            out[name] = torch.from_numpy(a).to(dev, dtype=spec.dtype)
    return out


def _run_train(cell: Cell, rows: int, dev: torch.device) -> tuple:
    """One ``make_train_step`` step on the cell's inputs at ``rows`` rows
    (:func:`_seeded_inputs`, labels included: a VLM's patches ahead of its
    tokens, an encoder-decoder's ``src_embeds``), from params and AdamW
    state drawn from :data:`SEED`."""
    from repro_torch.launch.train import make_train_step
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = init_params(gen, cell.cfg)
    state = {"params": params, "opt": adamw_init(params)}
    batch = _seeded_inputs(cell, rows, dev, SEED + 1)
    step = make_train_step(cell.cfg, AdamWConfig())
    _sync(dev)
    t0 = time.perf_counter()
    new, metrics = step(state, batch)
    _sync(dev)
    seconds = time.perf_counter() - t0
    old_l, new_l = tree_leaves(state["params"]), tree_leaves(new["params"])
    moved = sum(not torch.equal(a, b) for a, b in zip(old_l, new_l))
    loss = float(metrics["loss"])
    return {"loss": loss, "loss_finite": math.isfinite(loss),
            "grad_norm": float(metrics["grad_norm"]),
            "leaves": len(old_l), "leaves_moved": moved,
            "inputs": {k: list(v.shape) for k, v in batch.items()},
            "step_s": seconds}, {"state": new}


def _run_prefill(cell: Cell, rows: int, dev: torch.device,
                 plain: bool) -> tuple:
    from repro_torch.launch.serve import Server
    srv = Server(cell.cfg, batch_slots=rows, max_len=cell.max_len,
                 seed=SEED, device=dev, plain=plain)
    batch = _seeded_inputs(cell, rows, dev, SEED + 1)
    _sync(dev)
    t0 = time.perf_counter()
    with torch.inference_mode():
        logits, caches = prefill(srv.params, batch, srv.cfg,
                                 max_len=cell.max_len)
        tokens = torch.argmax(logits, -1)
    _sync(dev)
    seconds = time.perf_counter() - t0
    rec = {"prefill_s": seconds, "tokens": tokens.cpu().tolist(),
           "cache_bytes_run": _bytes(caches)}
    return rec, {"logits": logits, "tokens": tokens, "server": srv}


def _run_decode(cell: Cell, rows: int, dev: torch.device, plain: bool,
                prompts, new_tokens: int) -> tuple:
    from repro_torch.launch.serve import GenRequest, Server
    srv = Server(cell.cfg, batch_slots=rows, max_len=cell.max_len,
                 seed=SEED, device=dev, plain=plain)
    if prompts is None:
        rng = np.random.default_rng(SEED + 1)
        prompts = [rng.integers(0, cell.cfg.vocab_size, 16).astype(np.int32)
                   for _ in range(rows)]
    reqs = [GenRequest(np.asarray(p, np.int32), new_tokens) for p in prompts]
    steps = []
    srv.generate(reqs, step_seconds=steps)
    cache_b = _bytes(init_caches(cell.cfg, rows, cell.max_len,
                                 device="meta", src_len=cell.src_len))
    rec = {"prefill_s": steps[0], "decode_step_s": steps[1:],
           "decode_step_s_median": (float(np.median(steps[1:]))
                                    if len(steps) > 1 else None),
           "tokens": [r.out_tokens for r in reqs],
           "cache_bytes_run": cache_b}
    return rec, {"logits": srv.last_logits, "tokens": rec["tokens"],
                 "server": srv}


def run_cell(arch: str, shape_name: str, mesh_kind: str = "single", *,
             radix: int = 7, out_dir: str = ART_DIR, force: bool = False,
             tag: str = "", use_chunked: bool = True,
             kv_bits: Optional[int] = None, remat_policy: str = "nothing",
             run: bool = False, batch: Optional[int] = None, device=None,
             n_layers: Optional[int] = None, plain: bool = False,
             prompts=None, new_tokens: int = 8,
             return_outputs: bool = False, cost: bool = True):
    """Account one cell and, with ``run``, run it on ``device`` (None: the
    card), random weights and inputs from :data:`SEED`. The record (a
    dict) is written as JSON under ``out_dir``; an existing record is
    returned as it is unless ``force`` (or ``run``, or
    ``return_outputs``). ``n_layers`` cuts the depth, ``plain`` runs the
    kernels' plain versions; ``prompts`` and ``new_tokens`` shape a decode
    run. With ``return_outputs`` returns ``(record, outputs)``: the run's
    logits and tokens on the device, and its ``Server`` or trained state.
    A failure raises, after the record (``ok`` false, the error) is
    written. ``mesh_kind`` is the production mesh the per-device bytes
    are counted on; ``"multi"`` (512 devices) accounts only, and ``run``
    with it raises ``ValueError``. ``cost`` counts one step of the cell
    (:func:`cost_cell`, on ``meta``; a ``run`` is not traced); a step the
    count cannot run leaves ``cost_error`` in the record instead."""
    if mesh_kind not in ("single", "multi"):
        raise ValueError(f"mesh {mesh_kind!r}: 'single' or 'multi'")
    if run and mesh_kind != "single":
        raise ValueError(f"mesh {mesh_kind!r} is 512 devices; only "
                         "'single' runs (on one card)")
    name = (f"{arch}__{shape_name}__{mesh_kind}__r{radix}"
            f"{'__kv' + str(kv_bits) if kv_bits else ''}"
            f"{'__nochunk' if not use_chunked else ''}"
            f"{'__L' + str(n_layers) if n_layers else ''}"
            f"{'__dots' if remat_policy == 'dots' else ''}"
            f"{'__plain' if plain else ''}{tag}")
    path = os.path.join(out_dir, name + ".json")
    if (os.path.exists(path) and not force and not run
            and not return_outputs):
        with open(path) as f:
            return json.load(f)
    t0 = time.perf_counter()
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "radix": radix, "tag": tag, "kv_bits": kv_bits,
           "use_chunked": use_chunked, "remat_policy": remat_policy,
           "n_layers": n_layers, "ok": False}
    outputs = {}
    try:
        cell = build_cell(arch, shape_name, radix=radix,
                          use_chunked=use_chunked, kv_bits=kv_bits,
                          remat_policy=remat_policy, n_layers=n_layers)
        dev = resolve_device(device) if run else None
        rec.update(kind=cell.shape.kind, seq_len=cell.shape.seq_len,
                   global_batch=cell.shape.global_batch,
                   layers=cell.cfg.n_layers,
                   use_chunked_attn=cell.cfg.use_chunked_attn)
        rec.update(account(cell, device=dev if run else device,
                           mesh_kind=mesh_kind))
        if cost:
            try:
                rec.update(cost_cell(cell, mesh_kind))
            except Exception as e:     # the accounting above still holds
                rec["cost_error"] = f"{type(e).__name__}: {e}"[:2000]
                rec["cost_traceback"] = traceback.format_exc()[-2000:]
        if run:
            rows = batch if batch is not None else rec.get("rows_that_fit")
            if not rows:
                raise RuntimeError(f"{name}: not one row fits the card "
                                   f"({rec['bytes']})")
            rows = min(rows, cell.shape.global_batch)
            rec["batch_run"] = rows
            if dev.type == "cuda":
                disable_tf32()
                torch.cuda.reset_peak_memory_stats(dev)
            kind = cell.shape.kind
            if kind == "train":
                got, outputs = _run_train(cell, rows, dev)
            elif kind == "prefill":
                got, outputs = _run_prefill(cell, rows, dev, plain)
            else:
                got, outputs = _run_decode(cell, rows, dev, plain, prompts,
                                           new_tokens)
            rec["run"] = got
            rec["run"]["peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                                        if dev.type == "cuda" else None)
        rec["ok"] = True
    except Exception as e:
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
        raise
    finally:
        rec["wall_s"] = time.perf_counter() - t0
        os.makedirs(out_dir, exist_ok=True)
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
    return (rec, outputs) if return_outputs else rec


def cells_for(arch: str):
    return get_arch(arch).shapes


def _line(rec: dict) -> str:
    gb = 1e9
    by = rec["bytes"]
    s = (f"[dryrun] {rec['arch']}__{rec['shape']}: params "
         f"{by['params'] / gb:.2f} GB, adamw {by['adamw'] / gb:.2f}, caches "
         f"{by['caches'] / gb:.2f} ({rec['cache_bytes_per_row'] / gb:.3f} a "
         f"row), inputs {by['inputs'] / gb:.4f}, total {by['total'] / gb:.2f}"
         f"; fits: {rec['fits']}; per device of the {rec['mesh']} mesh "
         f"{rec['per_device_bytes']['total'] / gb:.3f} GB")
    if "cost_error" in rec:
        s += f"; cost not counted: {rec['cost_error'][:200]}"
    if "flops" in rec:
        col = rec["collectives"]
        where = ("one device of a fake " + "x".join(
            str(v) for v in rec["cost_mesh"].values()) + " mesh")
        s += (f"; a step on {where}: {rec['flops'] / 1e12:.3f} TFLOP "
              f"(int {rec['flops_int'] / 1e12:.3f}, logical "
              f"{rec['flops_logical'] / 1e12:.3f}), HBM "
              f"{rec['bytes_hbm'] / gb:.2f} GB, collectives "
              f"{col['total_bytes'] / gb:.3f} GB "
              f"{ {k: int(v) for k, v in col['counts'].items() if v} }, "
              f"kernels "
              f"{ {k: v for k, v in rec['kernel_calls'].items() if v} } "
              f"({rec['cost_s']:.1f} s)")
    if "run" in rec:
        s += f"; ran batch {rec['batch_run']}: {json.dumps(rec['run'])[:400]}"
    return s


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--radix", type=int, default=7)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--kv-bits", type=int, default=None)
    ap.add_argument("--no-chunked", action="store_true")
    ap.add_argument("--remat-policy", default="nothing",
                    choices=["nothing", "dots"])
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default=ART_DIR)
    ap.add_argument("--run", action="store_true",
                    help="run the cell on the device (default: the card)")
    ap.add_argument("--batch", type=int, default=None,
                    help="rows to run (default: the rows that fit)")
    ap.add_argument("--device", default=None)
    ap.add_argument("--no-cost", action="store_true",
                    help="leave out the step's FLOPs, bytes and collectives")
    args = ap.parse_args(argv)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        cells = [(a, s) for a in list_archs() for s in cells_for(a)]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        raise SystemExit("--arch/--shape required unless --all is given")
    ok = True
    for arch, shape in cells:
        for mk in meshes:
            try:
                rec = run_cell(arch, shape, mk, radix=args.radix,
                               out_dir=args.out, force=args.force,
                               tag=args.tag, kv_bits=args.kv_bits,
                               use_chunked=not args.no_chunked,
                               remat_policy=args.remat_policy, run=args.run,
                               batch=args.batch, device=args.device,
                               cost=not args.no_cost)
            except Exception as e:
                print(f"[dryrun] {arch}__{shape}__{mk}: FAIL "
                      f"{type(e).__name__}: {e}", flush=True)
                ok = False
                continue
            print(_line(rec), flush=True)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
