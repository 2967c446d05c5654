"""The packed LM's parameters as a server holds them: one routine for the
static :class:`~repro_torch.launch.serve.Server` and the continuous
:class:`~repro_torch.serving.lm_engine.ContinuousLMEngine`, so that the
two serve the same tensors on a mesh and off it.

:func:`serving_params` draws (or takes) the params, packs them, casts the
head to the compute dtype once and, on a mesh, places them: the planes by
``param_pspec``, the embedding and the head whole over the DP axes, and
the layer groups' leaves that a step would otherwise move placed once
(:func:`_serving_placements`). :func:`check_mesh` refuses what a mesh
does not serve.
"""

from __future__ import annotations

import torch

from repro_torch.distributed import placed
from repro_torch.distributed.sharding import (dp_axes_of, mesh_sizes,
                                              place_tree)
from repro_torch.models.transformer import (ModelConfig, init_params,
                                            pack_params)

__all__ = ["serving_params", "check_mesh"]


def check_mesh(mesh, device: torch.device, quantized: bool,
               batch_slots: int) -> None:
    """Raise for what a mesh does not serve: a mesh of another device
    type than ``device`` (``meta`` counts, as the dry run does), float
    serving (``NotImplementedError``), or ``batch_slots`` that do not
    divide over the DP axes (each rank serves its rows)."""
    if device.type != "meta" and mesh.device_type != device.type:
        raise ValueError(f"a {mesh.device_type} mesh serves on its "
                         f"ranks' {mesh.device_type} devices, not {device}")
    if not quantized:
        raise NotImplementedError("a mesh serves the packed model; "
                                  "float serving on a mesh is not "
                                  "ported")
    dp = 1
    for a in dp_axes_of(mesh):
        dp *= mesh_sizes(mesh)[a]
    if batch_slots % dp:
        raise ValueError(f"batch_slots={batch_slots} does not "
                         f"divide over the {dp} ranks of the DP axes "
                         "(each rank serves its rows)")


def serving_params(cfg: ModelConfig, params=None, *, device: torch.device,
                   seed: int = 0, quantized: bool = True,
                   mesh=None) -> dict:
    """The params a server serves on ``device``: ``params`` (float or
    packed, on ``device``; default: random from ``seed`` there, drawn and
    packed one layer at a time when ``quantized``, drawn placed on a
    ``mesh``), packed when ``quantized`` (float ones served as they are
    otherwise), the head's float32 weight cast to the compute dtype once
    (a tied model's: the embedding's). On a ``mesh`` whole params are
    placed by ``param_pspec``, the embedding and the head made whole over
    the DP axes (a replica's vocabulary shard: no gather of the table or
    the head in a step) and the groups' leaves placed by
    :func:`_serving_placements`."""
    if params is None:
        gen = torch.Generator(device=device).manual_seed(seed)
        if mesh is not None:
            from repro_torch.launch.train import init_placed_params
            params = init_placed_params(gen, cfg, mesh, packed=True)
        else:
            params = init_params(gen, cfg, packed=quantized)
    if params["embed"].device != device:
        raise ValueError(f"params lie on {params['embed'].device}, not on "
                         f"the serving device {device}")
    # bit-transposed deployment, or the float params as they are
    params = pack_params(params, cfg) if quantized else dict(params)
    if mesh is not None and not placed.is_placed(params["embed"]):
        params = place_tree(params, mesh)
    if cfg.tie_embeddings:
        params["head"] = {"w": params["embed"].to(cfg.compute_dtype).T}
    else:
        params["head"] = dict(params["head"], w=params["head"]["w"].to(
            cfg.compute_dtype))
    if mesh is not None:
        params["embed"] = _whole_over_dp(params["embed"])
        params["head"]["w"] = _whole_over_dp(params["head"]["w"])
        params["groups"] = [_serving_placements(g)
                            for g in params["groups"]]
    return params


def _serving_placements(p):
    """A placed layer group's params as a sharded server holds them, moved
    once here so that a step moves no parameter: each routed expert
    projection's ``scale`` and ``alpha_a`` split over the experts as its
    planes are (``param_pspec`` splits ``scale``'s columns, and a rank's
    experts need all of theirs), MLA's float ``w_uk``/``w_uv`` whole on
    every rank (a rank's heads need the whole latent dim, which
    ``param_pspec`` splits over the DP axes, and a decode step attends
    every head: ``attention._mla_placed``), and an SSM's ``norm``,
    ``A_log``, ``D`` and ``dt_bias`` whole on every rank (``param_pspec``
    splits them over ``model``; the scan runs on every head and the
    gated norm's sum of squares over the whole ``d_inner``:
    ``ssm._ssm_placed``)."""
    from torch.distributed.tensor import Replicate

    def whole(t):
        return t.redistribute(t.device_mesh, [Replicate()]
                              * t.device_mesh.ndim)

    if isinstance(p, list):
        return [_serving_placements(v) for v in p]
    if not isinstance(p, dict):
        return p
    out = {}
    for k, v in p.items():
        if k == "moe":
            out[k] = {n: (_experts_by_e(t) if n in ("w_up", "w_gate",
                                                    "w_down") else t)
                      for n, t in v.items()}
        elif k in ("w_uk", "w_uv"):
            out[k] = {n: whole(t) for n, t in v.items()}
        elif k == "ssm":
            out[k] = {n: whole(t) if n in ("norm", "A_log", "D", "dt_bias")
                      else t for n, t in v.items()}
        else:
            out[k] = _serving_placements(v)
    return out


def _experts_by_e(p: dict) -> dict:
    """Routed expert params (planes (..., E, bits, K/32, N), ``scale``
    (..., E, N), ``alpha_a`` (..., E)) with ``scale`` and ``alpha_a``
    placed as the planes' expert axis."""
    from torch.distributed.tensor import Replicate, Shard
    w = p["w_packed"]
    e_dim = w.ndim - 4
    out = dict(p)
    for name, from_end in (("scale", 2), ("alpha_a", 1)):
        t = p[name]
        pls = [Shard(t.ndim - from_end) if pw.is_shard(e_dim) else
               Replicate() for pw in w.placements]
        if pls != list(t.placements):
            out[name] = t.redistribute(t.device_mesh, pls)
    return out


def _whole_over_dp(t):
    """A placed tensor made whole over the mesh's DP axes (its ``model``
    split kept)."""
    from torch.distributed.tensor import Replicate
    names = t.device_mesh.mesh_dim_names
    pls = [Replicate() if names[i] in ("pod", "data") else p
           for i, p in enumerate(t.placements)]
    return t if pls == list(t.placements) else t.redistribute(
        t.device_mesh, pls)
