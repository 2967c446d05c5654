"""The dense decoder of the model zoo: a stack of pre-norm attention + MLP
blocks with every projection quant-aware.

Counterpart of ``repro/models/transformer.py``, dense branches only (no
MoE, MLA, SSM, hybrid, encoder-decoder or frontend; SwiGLU MLPs, an untied
head, no QKV bias). Parameters are plain dicts in the reference's layout:
a layer group carries every leaf with a leading ``(L, ...)`` axis, and
:func:`_run_groups` walks it with a Python loop where the reference runs
``lax.scan``. :func:`params_from_numpy` carries the reference's parameter
pytree (float or packed) across.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.attention import (AttnConfig, attn_apply, attn_init,
                                          init_kv_cache)
from repro_torch.models.layers import (QuantPolicy, layer_norm, pack_qdense,
                                       qdense, qdense_init, qdense_shared,
                                       rms_norm)

__all__ = ["ModelConfig", "GroupSpec", "layer_groups", "init_params",
           "forward", "prefill", "decode_step", "init_caches",
           "pack_params", "serve_policy", "params_from_numpy"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # only 'dense' is ported
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    act: str = "swiglu"             # only 'swiglu' is ported
    rope_theta: float = 10000.0
    partial_rotary: float = 1.0
    norm_type: str = "rms"
    norm_eps: float = 1e-6
    policy: QuantPolicy = QuantPolicy(mode="none")
    dtype: str = "bfloat16"

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    def attn_cfg(self) -> AttnConfig:
        return AttnConfig(
            d_model=self.d_model, n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads, head_dim=self.head_dim,
            rope_theta=self.rope_theta, partial_rotary=self.partial_rotary)


@dataclasses.dataclass(frozen=True)
class GroupSpec:
    kind: str          # 'attn'
    n: int


def layer_groups(cfg: ModelConfig) -> Tuple[GroupSpec, ...]:
    """The stack as homogeneous groups: one attention group for a dense
    model; other families and MLP activations are not ported."""
    if cfg.family != "dense" or cfg.act != "swiglu":
        raise NotImplementedError(f"family {cfg.family!r} with act "
                                  f"{cfg.act!r} is not ported (dense "
                                  "SwiGLU only)")
    return (GroupSpec("attn", cfg.n_layers),)


# ------------------------------------------------------------------- params

def _block_init(gen: torch.Generator, cfg: ModelConfig, n: int) -> dict:
    d, f, dev = cfg.d_model, cfg.d_ff, gen.device
    lead = (n,)
    p = {"norm1": torch.ones(lead + (d,), device=dev),
         "attn": attn_init(gen, cfg.attn_cfg(), cfg.policy, lead=lead),
         "norm2": torch.ones(lead + (d,), device=dev)}
    if cfg.norm_type == "layer":
        p["norm1_b"] = torch.zeros(lead + (d,), device=dev)
        p["norm2_b"] = torch.zeros(lead + (d,), device=dev)
    p["mlp"] = {"w_up": qdense_init(gen, d, f, cfg.policy, lead=lead),
                "w_down": qdense_init(gen, f, d, cfg.policy, lead=lead),
                "w_gate": qdense_init(gen, d, f, cfg.policy, lead=lead)}
    return p


def init_params(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Random float parameters drawn from ``gen`` on ``gen.device``, in
    the reference's layout and scales (its numbers differ: another
    generator)."""
    d, v, dev = cfg.d_model, cfg.vocab_size, gen.device
    params = {
        "embed": torch.randn((v, d), generator=gen, device=dev) * 0.02,
        "final_norm": torch.ones((d,), device=dev),
        "groups": [_block_init(gen, cfg, spec.n)
                   for spec in layer_groups(cfg)],
    }
    if cfg.norm_type == "layer":
        params["final_norm_b"] = torch.zeros((d,), device=dev)
    params["head"] = qdense_init(gen, d, v, QuantPolicy(mode="none"))
    return params


def params_from_numpy(tree, device=None):
    """Carry a parameter pytree across: nested dicts/lists of numpy (or
    array-like) leaves, float or packed (uint32 words become int32 tensors
    holding the same bits), as tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device) for v in tree]
    a = np.asarray(tree)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a, order="C")).to(device)


# ------------------------------------------------------------------ forward

def _norm(x, w, b, cfg: ModelConfig):
    if cfg.norm_type == "layer":
        return layer_norm(x, w, b, cfg.norm_eps)
    return rms_norm(x, w, cfg.norm_eps)


def _mlp_apply(p, x, cfg: ModelConfig):
    gate, up = qdense_shared([p["w_gate"], p["w_up"]], x, cfg.policy)
    h = F.silu(gate) * up
    return qdense(p["w_down"], h, cfg.policy)


def _block_apply(p, x, cfg: ModelConfig, *, positions, cache=None,
                 cache_pos=None):
    """One pre-norm block. Returns ``(x, new_cache)``."""
    h = _norm(x, p["norm1"], p.get("norm1_b"), cfg)
    out, new_c = attn_apply(p["attn"], h, cfg.attn_cfg(), cfg.policy,
                            positions=positions, cache=cache,
                            cache_pos=cache_pos)
    x = x + out
    hm = _norm(x, p["norm2"], p.get("norm2_b"), cfg)
    return x + _mlp_apply(p["mlp"], hm, cfg), new_c


def _layer(tree, i: int):
    """Layer ``i`` of a stacked parameter tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _run_groups(groups_params, x, cfg: ModelConfig, specs, *, positions,
                caches=None, cache_pos=None):
    """Run each group's layers in order; returns ``(x, caches)``. The
    caches are written in place."""
    for gi, (gp, spec) in enumerate(zip(groups_params, specs)):
        gcache = caches[gi] if caches is not None else None
        for i in range(spec.n):
            cl = None
            if gcache is not None:
                cl = {"k": gcache["k"][i], "v": gcache["v"][i],
                      "len": gcache["len"]}
            x, nc = _block_apply(_layer(gp, i), x, cfg, positions=positions,
                                 cache=cl, cache_pos=cache_pos)
            if gcache is not None:
                gcache["len"] = nc["len"]
    return x, caches


def _embed_inputs(params, batch, cfg: ModelConfig):
    """Token embedding; returns ``(x, positions)``."""
    x = params["embed"][batch["tokens"]].to(cfg.compute_dtype)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    return x, positions


def _logits(params, x, cfg: ModelConfig):
    x = _norm(x, params["final_norm"], params.get("final_norm_b"), cfg)
    return qdense(params["head"], x, QuantPolicy(mode="none"))


def forward(params, batch, cfg: ModelConfig):
    """Full forward to logits; ``batch``: ``{"tokens": (B, S)}``. Returns
    ``(logits, aux)``; a dense stack has no auxiliary loss (``aux`` empty)."""
    x, positions = _embed_inputs(params, batch, cfg)
    x, _ = _run_groups(params["groups"], x, cfg, layer_groups(cfg),
                       positions=positions)
    return _logits(params, x, cfg), {}


# ------------------------------------------------------------------ serving

def init_caches(cfg: ModelConfig, batch: int, max_len: int, device=None):
    """One stacked KV cache per group: ``k``/``v`` (L, B, T, Hkv, D) and
    ``len`` 0. The continuous engine's slot arena is one such list."""
    caches = []
    for spec in layer_groups(cfg):
        c = init_kv_cache(batch, max_len, cfg.n_kv_heads, cfg.head_dim,
                          dtype=cfg.compute_dtype, device=device)
        caches.append({"k": c["k"][None].repeat(spec.n, 1, 1, 1, 1),
                       "v": c["v"][None].repeat(spec.n, 1, 1, 1, 1),
                       "len": c["len"]})
    return caches


def prefill(params, batch, cfg: ModelConfig, max_len: int, last_pos=None):
    """Run the prompt, building caches. Returns ``(last_logits (B, V),
    caches)``: the logits of every row's last position, or, with
    ``last_pos`` (a (B,) tensor), of row b's position ``last_pos[b]`` — the
    last real token of a right-padded prompt. Under the causal mask the
    positions up to it compute as an unpadded prompt's do."""
    x, positions = _embed_inputs(params, batch, cfg)
    caches = init_caches(cfg, x.shape[0], max_len, device=x.device)
    x, caches = _run_groups(params["groups"], x, cfg, layer_groups(cfg),
                            positions=positions, caches=caches, cache_pos=0)
    if last_pos is not None:
        x = x[torch.arange(x.shape[0], device=x.device), last_pos][:, None]
    else:
        x = x[:, -1:]
    return _logits(params, x, cfg)[:, 0], caches


def decode_step(params, caches, tokens, pos, cfg: ModelConfig):
    """One token for every row. ``tokens``: (B, 1); ``pos``: the position
    of that token, a host int for every row (a lockstep batch) or a (B,)
    tensor of per-row positions on the batch's device (the slot arena,
    every row at its own depth; nothing then reads a device value on the
    host). Returns ``(logits (B, V), caches)``."""
    x = params["embed"][tokens].to(cfg.compute_dtype)
    if torch.is_tensor(pos) and pos.dim() == 1:
        positions = pos[:, None]
    else:
        positions = torch.full((1, 1), int(pos), dtype=torch.int64,
                               device=x.device)
    x, caches = _run_groups(params["groups"], x, cfg, layer_groups(cfg),
                            positions=positions, caches=caches,
                            cache_pos=pos)
    return _logits(params, x, cfg)[:, 0], caches


def serve_policy(cfg: ModelConfig, *, pack_acts: Optional[bool] = None,
                 plain: Optional[bool] = None) -> ModelConfig:
    """``cfg`` with its QuantPolicy retargeted for deployment: activations
    packed (K1 + K3) or as codes (K4), and optionally the plain versions.
    The packed weights never change."""
    updates = {}
    if pack_acts is not None:
        updates["pack_acts"] = pack_acts
    if plain is not None:
        updates["plain"] = plain
    if not updates:
        return cfg
    return dataclasses.replace(
        cfg, policy=dataclasses.replace(cfg.policy, **updates))


def pack_params(params, cfg: ModelConfig):
    """Export float params to the deployment form: every quantized dense
    of the layer groups becomes bit-transposed packed planes. Packed
    params pass through unchanged."""
    policy = cfg.policy

    def walk(p):
        if isinstance(p, dict):
            if ("w" in p and torch.is_tensor(p["w"]) and p["w"].dim() >= 2
                    and p["w"].shape[-1] > 4):
                return pack_qdense(p, policy)
            return {k: walk(v) for k, v in p.items()}
        if isinstance(p, list):
            return [walk(v) for v in p]
        return p

    packed = dict(params)
    packed["groups"] = [walk(g) for g in params["groups"]]
    return packed
