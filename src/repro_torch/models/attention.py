"""Multi-head / grouped-query attention with a KV cache, over quantized
projections.

Counterpart of ``repro/models/attention.py``, restricted to the branches a
dense decoder takes: causal, full (no sliding window), an unquantized
cache and a scalar ``cache_pos`` (every row of the batch at the same
depth). All four projections are :func:`repro_torch.models.layers.qdense`
(q, k and v through ``qdense_shared``: one quantize-pack of their shared
input), so in deployment they run through the bit-serial kernels; scores
and the PV product stay plain float32 torch ops, as the reference
computes them outside any Pallas kernel.

The cache is updated in place (the reference's ``dynamic_update_slice``
returns a new array): one preallocated buffer per layer stack, no copy per
token.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.models.layers import (QuantPolicy, apply_rotary, qdense,
                                       qdense_init, qdense_shared, rotary)

__all__ = ["AttnConfig", "attn_init", "attn_apply", "init_kv_cache",
           "update_kv_cache", "read_kv_cache"]


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_theta: float = 10000.0
    partial_rotary: float = 1.0
    causal: bool = True

    @property
    def rotary_dim(self) -> int:
        return int(self.head_dim * self.partial_rotary)


def _sdpa_full(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
               causal: bool, q_offset: int) -> torch.Tensor:
    """Reference attention: q (B, Sq, H, D), k/v (B, Sk, Hkv, D), GQA by
    head grouping, scores and softmax in float32. ``q_offset`` is the
    (scalar) position of the first query."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    rep = h // hkv
    f32 = torch.float32
    qg = q.reshape(b, sq, hkv, rep, d)
    root = torch.tensor(math.sqrt(d), dtype=f32, device=q.device)
    scores = torch.einsum("bqgrd,bkgd->bgrqk", qg.to(f32), k.to(f32)) / root
    if causal:
        qpos = q_offset + torch.arange(sq, device=q.device)[:, None]
        kpos = torch.arange(sk, device=q.device)[None, :]
        scores = scores.masked_fill(kpos > qpos, -math.inf)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bgrqk,bkgd->bqgrd", p, v.to(f32))
    return out.reshape(b, sq, h, v.shape[-1]).to(q.dtype)


# ------------------------------------------------------------------ KV cache

def init_kv_cache(batch: int, max_len: int, n_kv: int, head_dim: int, *,
                  dtype: torch.dtype = torch.bfloat16,
                  device=None) -> dict:
    """Decode cache of ``max_len`` positions: ``k``/``v`` (B, T, Hkv, D)
    and ``len``, the number of positions written (a host int: the batch
    decodes in lockstep, so it never needs the card)."""
    return {
        "k": torch.zeros((batch, max_len, n_kv, head_dim), dtype=dtype,
                         device=device),
        "v": torch.zeros((batch, max_len, n_kv, head_dim), dtype=dtype,
                         device=device),
        "len": 0,
    }


def update_kv_cache(cache: dict, k_new: torch.Tensor, v_new: torch.Tensor,
                    pos: int) -> dict:
    """Write new K/V at positions ``pos .. pos + S - 1`` of every row (in
    place) and return the cache with ``len = pos + S``. Works for prefill
    (S > 1) and decode (S = 1)."""
    if torch.is_tensor(pos) and pos.dim() > 0:
        raise NotImplementedError("per-row cache positions (continuous "
                                  "batching) are not ported")
    pos = int(pos)
    s = k_new.shape[1]
    if pos < 0 or pos + s > cache["k"].shape[1]:
        raise ValueError(f"cache write [{pos}, {pos + s}) outside "
                         f"max_len={cache['k'].shape[1]}")
    cache["k"][:, pos:pos + s] = k_new.to(cache["k"].dtype)
    cache["v"][:, pos:pos + s] = v_new.to(cache["v"].dtype)
    upd = dict(cache)
    upd["len"] = pos + s
    return upd


def read_kv_cache(cache: dict, dtype: Optional[torch.dtype] = None):
    """The cache's K and V (B, T, Hkv, D), in ``dtype`` if given."""
    k, v = cache["k"], cache["v"]
    if dtype is not None:
        k, v = k.to(dtype), v.to(dtype)
    return k, v


# ------------------------------------------------------------- GQA attention

def attn_init(gen: torch.Generator, cfg: AttnConfig, policy: QuantPolicy, *,
              lead: tuple = ()) -> dict:
    h, hkv, dh, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    return {
        "wq": qdense_init(gen, d, h * dh, policy, lead=lead),
        "wk": qdense_init(gen, d, hkv * dh, policy, lead=lead),
        "wv": qdense_init(gen, d, hkv * dh, policy, lead=lead),
        "wo": qdense_init(gen, h * dh, d, policy, lead=lead),
    }


def attn_apply(p: dict, x: torch.Tensor, cfg: AttnConfig,
               policy: QuantPolicy, *, positions=None,
               cache: Optional[dict] = None, cache_pos: Optional[int] = None):
    """Self-attention over (B, S, D). Returns ``(out, new_cache)``; with a
    cache, the new K/V are written at ``cache_pos`` and the queries attend
    the whole cache under the causal mask."""
    b, s, _ = x.shape
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = qdense_shared([p["wq"], p["wk"], p["wv"]], x, policy)
    q = q.reshape(b, s, h, dh)
    k = k.reshape(b, s, hkv, dh)
    v = v.reshape(b, s, hkv, dh)
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    rd = cfg.rotary_dim
    if rd > 0:
        cos, sin = rotary(positions, rd, cfg.rope_theta)
        q = apply_rotary(q, cos, sin, rd)
        k = apply_rotary(k, cos, sin, rd)
    new_cache = None
    if cache is not None:
        new_cache = update_kv_cache(cache, k, v, cache_pos)
        kc, vc = read_kv_cache(new_cache, x.dtype)
        out = _sdpa_full(q, kc, vc, causal=cfg.causal, q_offset=cache_pos)
    else:
        out = _sdpa_full(q, k, v, causal=cfg.causal, q_offset=0)
    out = qdense(p["wo"], out.reshape(b, s, h * dh), policy)
    return out, new_cache
