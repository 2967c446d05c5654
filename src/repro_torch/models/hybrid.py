"""Hymba-style hybrid-head layer: attention heads and SSM heads run in
parallel on the same input, their normalized outputs mean-fused with
learnable per-branch scales (Hymba, arXiv:2411.13676).

Counterpart of ``repro/models/hybrid.py``. Most layers attend a sliding
window (a rolling cache of ``window`` slots when the window fits the
cache); a few designated global layers attend the full context.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.models.attention import (AttnConfig, attn_apply, attn_init,
                                          init_kv_cache)
from repro_torch.models.layers import QuantPolicy, rms_norm
from repro_torch.models.ssm import (SSMConfig, init_ssm_cache, ssm_apply,
                                    ssm_decode_step, ssm_init)

__all__ = ["HybridConfig", "hybrid_init", "hybrid_apply", "init_hybrid_cache"]


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    attn: AttnConfig
    ssm: SSMConfig


def hybrid_init(gen: torch.Generator, cfg: HybridConfig,
                policy: QuantPolicy) -> dict:
    d, dev = cfg.attn.d_model, gen.device
    return {
        "attn": attn_init(gen, cfg.attn, policy),
        "ssm": ssm_init(gen, cfg.ssm, policy),
        "norm_attn": torch.ones((d,), device=dev),
        "norm_ssm": torch.ones((d,), device=dev),
        "beta_attn": torch.ones((d,), device=dev),
        "beta_ssm": torch.ones((d,), device=dev),
    }


def hybrid_apply(p: dict, x: torch.Tensor, cfg: HybridConfig,
                 policy: QuantPolicy, *, positions=None,
                 cache: Optional[dict] = None, cache_pos=None,
                 use_chunked: bool = False, decode: bool = False,
                 q_chunk: int = 1024, kv_chunk: int = 1024):
    """Both branches over (B, S, D); ``decode`` steps the SSM branch one
    token, ``use_chunked`` (with its chunks) goes to the attention branch.
    Returns ``(out, new_cache)``: with a cache, ``{"attn": ..., "ssm":
    ...}`` for the caller to store."""
    a_cache = cache["attn"] if cache is not None else None
    s_cache = cache["ssm"] if cache is not None else None
    attn_out, a_new = attn_apply(p["attn"], x, cfg.attn, policy,
                                 positions=positions, cache=a_cache,
                                 cache_pos=cache_pos, use_chunked=use_chunked,
                                 q_chunk=q_chunk, kv_chunk=kv_chunk)
    if decode:
        ssm_out, s_new = ssm_decode_step(p["ssm"], x, cfg.ssm, policy,
                                         s_cache)
    else:
        ssm_out, s_new = ssm_apply(p["ssm"], x, cfg.ssm, policy,
                                   cache=s_cache)
    fused = 0.5 * (rms_norm(attn_out, p["norm_attn"]) * p["beta_attn"]
                   + rms_norm(ssm_out, p["norm_ssm"]) * p["beta_ssm"])
    new_cache = None
    if cache is not None:
        new_cache = {"attn": a_new, "ssm": s_new}
    return fused.to(x.dtype), new_cache


def init_hybrid_cache(batch: int, max_len: int, cfg: HybridConfig, *,
                      dtype: torch.dtype = torch.bfloat16,
                      device=None) -> dict:
    """A sliding-window layer keeps a rolling ``window``-slot buffer (when
    the window fits ``max_len``), a global layer the full context, both
    int8 with ``cfg.attn.kv_bits=8``; the SSM branch its constant-size
    state."""
    return {
        "attn": init_kv_cache(batch, max_len, cfg.attn.n_kv_heads,
                              cfg.attn.head_dim, kv_bits=cfg.attn.kv_bits,
                              dtype=dtype, device=device,
                              window=cfg.attn.window),
        "ssm": init_ssm_cache(batch, cfg.ssm, dtype=dtype, device=device),
    }
