"""Multi-head / grouped-query attention and DeepSeek's multi-head latent
attention (MLA), with a KV cache, over quantized projections.

Counterpart of ``repro/models/attention.py``: causal or not (an encoder),
full or sliding-window, over a bf16 or an int8 cache (``kv_bits=8``:
codes and a float32 scale per row, position and head, as
:func:`_quant_kv` rounds them), with optional q/k/v biases and
cross-attention over given K/V (an encoder-decoder's decoder). With
``use_chunked`` a forward without a cache, a prefill into an empty cache
and MLA's prefill attend through :func:`chunked_attention`, the
reference's flash-style online softmax over (q_chunk x kv_chunk) blocks,
so no (S x S) score tensor is made: at 32k tokens one layer's would take
137 GB. Like the reference's (computed by XLA, not a Pallas kernel), it
is plain torch ops on float32 blocks.
``cache_pos`` is a host int (every row of the batch at the same depth:
the static :class:`~repro_torch.launch.serve.Server`) or a (B,) tensor on
the batch's device (every row at its own depth: the slot arena of
:class:`~repro_torch.serving.lm_engine.ContinuousLMEngine`, whose decode
step is captured as a CUDA graph, so nothing on that path reads a device
value on the host). Every projection is
:func:`repro_torch.models.layers.qdense` (GQA's q, k and v through
``qdense_shared``, one quantize-pack of their shared input; MLA's q and
down-projected kv likewise), so in deployment they run through the
bit-serial kernels; scores and the PV product stay plain float32 torch
ops, as the reference computes them outside any Pallas kernel.

MLA (:func:`mla_apply`) caches the compressed latent ``c`` and the
rotary key part ``k_rope`` per token. Its prefill materializes per-head K
and V through ``qdense(w_uk)``/``qdense(w_uv)`` on their float ``qat``
params (LSQ fake-quant), its decode takes the absorbed form over the
latent cache with the raw float ``w_uk``/``w_uv`` — both exactly as the
reference does (an asymmetry of the reference, kept).

The cache is updated in place (the reference's ``dynamic_update_slice``
returns a new array): one preallocated buffer per layer stack, no copy per
token.

Sliding windows (``AttnConfig.window``, hymba's local layers): a window no
wider than the cache makes the cache a rolling buffer of ``window`` slots
(the ``rolling`` marker, as the reference's ``init_kv_cache``), newest at
the end; a prefill attends its own fresh K/V under the causal and window
masks and seeds the buffer, a decode step attends the last
``min(pos + 1, window)`` slots. A rolling cache takes a host-int position
only. A window wider than the cache only masks.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.distributed import placed
from repro_torch.distributed.context import constrain
from repro_torch.models.layers import (QuantPolicy, apply_rotary,
                                       device_scalar, qdense, qdense_init,
                                       qdense_shared, rms_norm, rotary)

__all__ = ["AttnConfig", "attn_init", "attn_apply", "chunked_attention",
           "KVQuant", "init_kv_cache", "update_kv_cache", "read_kv_cache",
           "mla_init", "mla_apply", "init_mla_cache"]


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    partial_rotary: float = 1.0
    causal: bool = True
    window: Optional[int] = None       # sliding-window width (None = full)
    # MLA
    mla: bool = False
    kv_lora: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    # KV cache quantization: None = a cache in the compute dtype, 8 = int8
    # codes with a float32 scale per (row, position, head)
    kv_bits: Optional[int] = None

    @property
    def rotary_dim(self) -> int:
        return int(self.head_dim * self.partial_rotary)


def _per_row(pos) -> bool:
    return torch.is_tensor(pos) and pos.dim() == 1


def _sdpa_full(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
               causal: bool, q_offset,
               window: Optional[int] = None) -> torch.Tensor:
    """Reference attention: q (B, Sq, H, D), k/v (B, Sk, Hkv, D), GQA by
    head grouping, scores and softmax in float32. ``q_offset`` is the
    position of the first query: a scalar, or a (B,) tensor of per-row
    positions (each row masks the keys beyond its own queries). With
    ``window`` a query also masks the keys ``window`` or more positions
    behind it. Placed inputs (a mesh run) attend per rank
    (:func:`repro_torch.distributed.placed.per_head`)."""
    if placed.is_placed(q):
        return placed.per_head(_sdpa_full, q, k, v, causal=causal,
                               q_offset=q_offset, window=window)
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    rep = h // hkv
    f32 = torch.float32
    qg = q.reshape(b, sq, hkv, rep, d)
    root = device_scalar(math.sqrt(d), q.device)
    scores = torch.einsum("bqgrd,bkgd->bgrqk", qg.to(f32), k.to(f32)) / root
    if causal or window is not None:
        ar = torch.arange(sq, device=q.device)
        kpos = torch.arange(sk, device=q.device)
        if _per_row(q_offset):
            qpos = q_offset[:, None, None] + ar[None, :, None]
            kpos = kpos[None, None, :]
        else:
            qpos = q_offset + ar[:, None]
            kpos = kpos[None, :]
        mask = kpos > qpos if causal else None
        if window is not None:
            outside = kpos <= qpos - window
            mask = outside if mask is None else mask | outside
        if _per_row(q_offset):
            mask = mask[:, None, None]            # (B, 1, 1, Sq, Sk)
        scores = scores.masked_fill(mask, -math.inf)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bgrqk,bkgd->bqgrd", p, v.to(f32))
    return out.reshape(b, sq, h, v.shape[-1]).to(q.dtype)


def _sdpa_rolling(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  filled: int) -> torch.Tensor:
    """Decode attention over a rolling window buffer: the last ``filled``
    slots are valid, all in the causal past of the query; the others are
    masked to -1e30, as the reference masks them."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    rep = h // hkv
    f32 = torch.float32
    qg = q.reshape(b, sq, hkv, rep, d)
    root = device_scalar(math.sqrt(d), q.device)
    scores = torch.einsum("bqgrd,bkgd->bgrqk", qg.to(f32), k.to(f32)) / root
    if filled < sk:
        scores[..., :sk - filled] = -1e30
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bgrqk,bkgd->bqgrd", p, v.to(f32))
    return out.reshape(b, sq, h, v.shape[-1]).to(q.dtype)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: Optional[int] = None,
                      q_offset: int = 0, q_chunk: int = 1024,
                      kv_chunk: int = 1024,
                      skip_masked_blocks: bool = True) -> torch.Tensor:
    """Flash-style online-softmax attention over (q_chunk x kv_chunk)
    blocks, as the reference's: q (B, Sq, H, D), k (B, Sk, Hkv, D), v (B,
    Sk, Hkv, Dv), GQA by head grouping; returns (B, Sq, H, Dv) in q's
    dtype. Both lengths are padded to whole chunks; each block's scores
    are float32, masked to -1e30 (the padded keys, and beyond the causal
    and window masks), and folded into a float32 running max ``m``, sum
    ``l`` and output ``acc``. With ``skip_masked_blocks`` and ``q_offset``
    0 a q-chunk visits only the kv blocks its masks reach (the reference's
    ``lo``/``hi``). A block that no mask reaches is not masked: the
    ``where`` would keep every score. Memory is one score block per head
    group, not (Sq x Sk). Placed inputs (a mesh run) are held to the
    reference's constraints — the batch over the DP axes, the (kv) heads
    over TP — and each rank runs its rows and heads' blocks
    (:func:`repro_torch.distributed.placed.per_head`)."""
    if placed.is_placed(q):
        q, k, v = (constrain(t, "dp", None, "tp", None) for t in (q, k, v))
        return placed.per_head(
            chunked_attention, q, k, v, causal=causal, window=window,
            q_offset=q_offset, q_chunk=q_chunk, kv_chunk=kv_chunk,
            skip_masked_blocks=skip_masked_blocks)
    b, sq, h, d = q.shape
    sk, hkv, dv = k.shape[1], k.shape[2], v.shape[-1]
    rep = h // hkv
    q_offset = int(q_offset)
    q_chunk, kv_chunk = min(q_chunk, sq), min(kv_chunk, sk)
    nq, nk = -(-sq // q_chunk), -(-sk // kv_chunk)
    f32, dev = torch.float32, q.device
    # (B, Hkv, nq, rep, q_chunk, D): a q-chunk's rows of one head group
    # are contiguous, so a block is one batched matmul over B x Hkv
    qg = F.pad(q.to(f32), (0, 0, 0, 0, 0, nq * q_chunk - sq))
    qg = qg.reshape(b, nq, q_chunk, hkv, rep, d).permute(
        0, 3, 1, 4, 2, 5).contiguous()
    kg = F.pad(k.to(f32), (0, 0, 0, 0, 0, nk * kv_chunk - sk)).permute(
        0, 2, 1, 3).contiguous()
    vg = F.pad(v.to(f32), (0, 0, 0, 0, 0, nk * kv_chunk - sk)).permute(
        0, 2, 1, 3).contiguous()
    scale = 1.0 / math.sqrt(d)
    kpos_all = torch.arange(nk * kv_chunk, device=dev)
    ar = torch.arange(q_chunk, device=dev)
    rows = rep * q_chunk
    outs = []
    for qi in range(nq):
        q0 = q_offset + qi * q_chunk
        qt = qg[:, :, qi].reshape(b * hkv, rows, d)
        qpos = (q0 + ar).repeat(rep)[:, None]       # row r * q_chunk + i
        lo, hi = 0, nk
        if skip_masked_blocks and q_offset == 0:
            if causal:
                hi = min(((qi + 1) * q_chunk + kv_chunk - 1) // kv_chunk, nk)
            if window is not None:
                lo = max(0, (qi * q_chunk - window) // kv_chunk)
        m = torch.full((b * hkv, rows), -1e30, dtype=f32, device=dev)
        l = torch.zeros((b * hkv, rows), dtype=f32, device=dev)
        acc = torch.zeros((b * hkv, rows, dv), dtype=f32, device=dev)
        for ki in range(lo, hi):
            k0, k1 = ki * kv_chunk, (ki + 1) * kv_chunk
            kt = kg[:, :, k0:k1].reshape(b * hkv, kv_chunk, d)
            vt = vg[:, :, k0:k1].reshape(b * hkv, kv_chunk, dv)
            s = torch.matmul(qt, kt.transpose(1, 2)) * scale
            masked = (k1 > sk or (causal and k1 - 1 > q0)
                      or (window is not None
                          and k0 <= q0 + q_chunk - 1 - window))
            if masked:
                kpos = kpos_all[None, k0:k1]
                mask = kpos < sk
                if causal:
                    mask = mask & (kpos <= qpos)
                if window is not None:
                    mask = mask & (kpos > qpos - window)
                s = s.masked_fill(~mask, -1e30)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.matmul(p, vt)
            m = m_new
        outs.append(acc / torch.clamp_min(l, 1e-30)[..., None])
    out = torch.stack(outs).reshape(nq, b, hkv, rep, q_chunk, dv)
    out = out.permute(1, 0, 4, 2, 3, 5).reshape(b, nq * q_chunk, h, dv)
    return out[:, :sq].to(q.dtype)


# ------------------------------------------------------------------ KV cache

@dataclasses.dataclass(frozen=True)
class KVQuant:
    bits: int = 8


def init_kv_cache(batch: int, max_len: int, n_kv: int, head_dim: int, *,
                  kv_bits: Optional[int] = None,
                  dtype: torch.dtype = torch.bfloat16, device=None,
                  window: Optional[int] = None) -> dict:
    """Decode cache of ``max_len`` positions: ``k``/``v`` (B, T, Hkv, D)
    in ``dtype`` or, with ``kv_bits=8``, int8 codes ``k_q``/``v_q`` (B, T,
    Hkv, D) and float32 scales ``k_s``/``v_s`` (B, T, Hkv), the
    quantizer applied to the KV stream (half a bf16 cache's bytes, plus
    the scales); and ``len``, the number of positions written: a host int
    while the batch decodes in lockstep, a (B,) tensor once rows are
    written at per-row positions. With a ``window`` no wider than
    ``max_len`` the cache is a rolling buffer of ``window`` slots, marked
    ``rolling``."""
    size = max_len if window is None else min(max_len, window)
    shape = (batch, size, n_kv, head_dim)
    if kv_bits is None:
        cache = {"k": torch.zeros(shape, dtype=dtype, device=device),
                 "v": torch.zeros(shape, dtype=dtype, device=device)}
    else:
        if kv_bits != 8:
            raise ValueError(f"quantized KV cache supports kv_bits=8 only, "
                             f"got {kv_bits}")
        cache = {
            "k_q": torch.zeros(shape, dtype=torch.int8, device=device),
            "v_q": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_s": torch.zeros(shape[:3], dtype=torch.float32,
                               device=device),
            "v_s": torch.zeros(shape[:3], dtype=torch.float32,
                               device=device)}
    cache["len"] = 0
    if window is not None and window <= max_len:
        cache["rolling"] = True
    return cache


#: float32(1 / 127) and float32(1e-9), as the reference's compiled graph
#: holds them
_INV127 = float(np.float32(1.0) / np.float32(127.0))
_EPS = float(np.float32(1e-9))


def _quant_kv(x: torch.Tensor):
    """Per (row, position, head) absmax int8, as the reference computes it
    in its compiled (``jit``) models: the scale ``max|x| / 127 + 1e-9``,
    which XLA turns into a multiply by float32(1/127) fused with the add
    (one FMA, one rounding; here the exact product and the sum in float64,
    then float32), and the codes ``x / scale`` (a true division) rounded
    half to even and clipped to +-127. Returns ``(codes int8, scales
    float32)``."""
    m = torch.amax(torch.abs(x), dim=-1).to(torch.float64)
    s = (m * _INV127 + _EPS).to(torch.float32)
    q = torch.clamp(torch.round(x.to(torch.float32) / s[..., None]),
                    -127, 127)
    return q.to(torch.int8), s


def _roll_insert(buf: torch.Tensor, new: torch.Tensor) -> None:
    """Shift a rolling buffer (B, W, ...) left by the update's length and
    write the update at the end, in place; an update longer than the
    buffer leaves its tail. The shifted buffer is built first and then
    copied: a shift inside one buffer is an overlapping copy."""
    w, s = buf.shape[1], new.shape[1]
    new = new.to(buf.dtype)
    if s >= w:
        buf.copy_(new[:, -w:])
    else:
        buf.copy_(torch.cat([buf[:, s:], new], dim=1))


def _row_index(pos: torch.Tensor, new: torch.Tensor,
               t: int) -> torch.Tensor:
    """The scatter index that writes ``new`` (B, S, ...) into a (B, T, ...)
    cache, row b at positions ``pos[b] .. pos[b] + S - 1``. A start is
    clamped to ``[0, T - S]``, as the reference's ``dynamic_update_slice``
    clamps it; no host read of ``pos``."""
    b, s = new.shape[:2]
    start = torch.clamp(pos.to(torch.int64), 0, t - s)
    idx = start[:, None] + torch.arange(s, device=new.device)[None, :]
    return idx.reshape((b, s) + (1,) * (new.dim() - 2)).expand(new.shape)


def _seq_write(buf: torch.Tensor, new: torch.Tensor, pos,
               idx: Optional[torch.Tensor] = None):
    """Write ``new`` (B, S, ...) into ``buf`` (B, T, ...) at positions
    ``pos .. pos + S - 1``, in place: ``pos`` a host int (a write outside
    the buffer raises) or a (B,) tensor of per-row starts (clamped into
    the buffer, as the reference's ``dynamic_update_slice`` clamps).
    Returns the per-row scatter index (None for a host ``pos``), which a
    write of a same-shaped tensor at the same positions may pass back as
    ``idx``."""
    new = new.to(buf.dtype)
    if _per_row(pos):
        if idx is None:
            idx = _row_index(pos, new, buf.shape[1])
        buf.scatter_(1, idx, new)
        return idx
    pos, s = int(pos), new.shape[1]
    if pos < 0 or pos + s > buf.shape[1]:
        raise ValueError(f"cache write [{pos}, {pos + s}) outside "
                         f"max_len={buf.shape[1]}")
    buf[:, pos:pos + s] = new
    return None


def update_kv_cache(cache: dict, k_new: torch.Tensor, v_new: torch.Tensor,
                    pos) -> dict:
    """Write new K/V at positions ``pos .. pos + S - 1`` (in place) and
    return the cache with ``len = pos + S``. Works for prefill (S > 1) and
    decode (S = 1). ``pos`` is a host int for every row (a write outside
    the cache raises), or a (B,) tensor of per-row positions on the cache's
    device (each start clamped into the cache, as the reference does). A
    rolling cache shifts instead of indexing and takes a host int only.
    An int8 cache stores :func:`_quant_kv`'s codes and scales, the scales
    written as the codes are."""
    rolling = "rolling" in cache
    if rolling and _per_row(pos):
        raise ValueError("a rolling (sliding-window) cache takes one "
                         "host-int position for every row, not per-row "
                         "positions")
    if "k" in cache:
        pairs = (("k", "v", k_new, v_new),)
    else:
        (kq, ks), (vq, vs) = _quant_kv(k_new), _quant_kv(v_new)
        pairs = (("k_q", "v_q", kq, vq), ("k_s", "v_s", ks, vs))
    for kn, vn, kt, vt in pairs:
        if rolling:
            _roll_insert(cache[kn], kt)
            _roll_insert(cache[vn], vt)
        else:
            idx = _seq_write(cache[kn], kt, pos)
            _seq_write(cache[vn], vt, pos, idx)
    upd = dict(cache)
    upd["len"] = (pos if _per_row(pos) else int(pos)) + k_new.shape[1]
    return upd


def read_kv_cache(cache: dict, dtype: Optional[torch.dtype] = None):
    """The cache's K and V (B, T, Hkv, D), in ``dtype`` if given. An int8
    cache is dequantized, codes times scales in float32, then cast to
    ``dtype`` (bf16 when none is given, the reference's default)."""
    if "k" in cache:
        k, v = cache["k"], cache["v"]
        if dtype is not None:
            k, v = k.to(dtype), v.to(dtype)
        return k, v
    dtype = torch.bfloat16 if dtype is None else dtype
    k = cache["k_q"].to(torch.float32) * cache["k_s"][..., None]
    v = cache["v_q"].to(torch.float32) * cache["v_s"][..., None]
    return k.to(dtype), v.to(dtype)


# ------------------------------------------------------------- GQA attention

def attn_init(gen: torch.Generator, cfg: AttnConfig, policy: QuantPolicy, *,
              lead: tuple = ()) -> dict:
    """q/k/v/o projections; q, k and v with a zero bias when
    ``cfg.qkv_bias``, as the reference draws them."""
    h, hkv, dh, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    bias = cfg.qkv_bias
    return {
        "wq": qdense_init(gen, d, h * dh, policy, bias=bias, lead=lead),
        "wk": qdense_init(gen, d, hkv * dh, policy, bias=bias, lead=lead),
        "wv": qdense_init(gen, d, hkv * dh, policy, bias=bias, lead=lead),
        "wo": qdense_init(gen, h * dh, d, policy, lead=lead),
    }


def _host_zero(pos) -> bool:
    """Is ``pos`` the host int 0 (a prefill into an empty cache)? A (B,)
    tensor of per-row positions never is: nothing reads it on the host."""
    return not torch.is_tensor(pos) and int(pos) == 0


def attn_apply(p: dict, x: torch.Tensor, cfg: AttnConfig,
               policy: QuantPolicy, *, positions=None,
               cache: Optional[dict] = None, cache_pos=None,
               use_chunked: bool = False, q_chunk: int = 1024,
               kv_chunk: int = 1024, cross_kv: Optional[tuple] = None):
    """Self-attention over (B, S, D). Returns ``(out, new_cache)``; with a
    cache, the new K/V are written at ``cache_pos`` (a host int, or a (B,)
    tensor of per-row positions) and the queries attend the whole cache
    under the causal (and window) mask. The reference's branch order: a
    prefill (S > 1) into an empty cache (host ``cache_pos`` 0) with
    ``use_chunked`` attends its fresh K/V through
    :func:`chunked_attention`; on a rolling cache a prefill attends its
    fresh K/V from position 0 under the causal and window masks, and a
    decode step the last ``min(cache_pos + 1, window)`` slots. Without a
    cache ``use_chunked`` takes the chunked path too.

    ``cross_kv=(k, v)``, each (B, S_src, Hkv, D), makes it cross-attention
    (an encoder-decoder's decoder): only q is projected, nothing is
    rotated, no cache is written, no mask applies and nothing is chunked,
    as the reference."""
    b, s, _ = x.shape
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if cross_kv is not None:
        q = qdense(p["wq"], x, policy).reshape(b, s, h, dh)
        ck, cv = cross_kv
        if placed.is_placed(ck) and not any(pl.is_shard(2)
                                            for pl in ck.placements):
            out = _every_head(q, ck, cv, window=cfg.window)
        else:
            out = _sdpa_full(q, ck, cv, causal=False, q_offset=0,
                             window=cfg.window)
        return qdense(p["wo"], out.reshape(b, s, h * dh), policy), None
    q, k, v = qdense_shared([p["wq"], p["wk"], p["wv"]], x, policy)
    q = placed.split_heads(q, h, dh)
    k = placed.split_heads(k, hkv, dh)
    v = placed.split_heads(v, hkv, dh)
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    rd = cfg.rotary_dim
    if rd > 0:
        cos, sin = rotary(positions, rd, cfg.rope_theta)
        q = apply_rotary(q, cos, sin, rd)
        k = apply_rotary(k, cos, sin, rd)
    new_cache = None
    chunk = dict(causal=cfg.causal, window=cfg.window, q_chunk=q_chunk,
                 kv_chunk=kv_chunk)
    if cache is not None and placed.is_placed(_a_cache_tensor(cache)):
        out, new_cache = _attend_placed(q, k, v, cache, cache_pos, cfg,
                                        use_chunked, chunk)
    elif cache is not None:
        out, new_cache = _attend_cache(q, k, v, cache, cache_pos, cfg,
                                       use_chunked, chunk)
    elif use_chunked:
        out = chunked_attention(q, k, v, **chunk)
    else:
        out = _sdpa_full(q, k, v, causal=cfg.causal, q_offset=0,
                         window=cfg.window)
    out = qdense(p["wo"], out.reshape(b, s, h * dh), policy)
    return out, new_cache


def _every_head(q, k, v, *, window: Optional[int]):
    """Cross-attention (no mask) of placed ``q`` over placed ``k``/``v``
    whole over the heads (an encoder-decoder's cross K/V in a sharded
    server's cache): every rank attends every head on its rows, ``q``
    gathered whole first — on the card the float32 einsums round
    otherwise on a share of the heads than on all of them — so each
    head's arithmetic is the unsharded one. The output is whole over the
    heads (the row-parallel ``wo`` takes its words of it)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = q.device_mesh
    rows = [Shard(0) if pl.is_shard(0) else Replicate()
            for pl in q.placements]
    ql, kl, vl = (t.redistribute(mesh, rows).to_local() for t in (q, k, v))
    out = _sdpa_full(ql, kl, vl, causal=False, q_offset=0, window=window)
    shape = tuple(q.shape[:3]) + (v.shape[-1],)
    return DTensor.from_local(out.contiguous(), mesh, rows,
                              shape=torch.Size(shape),
                              stride=placed.contiguous_stride(shape))


def _attend_cache(q, k, v, cache: dict, cache_pos, cfg: AttnConfig,
                  use_chunked: bool, chunk: dict, kv_heads=slice(None)):
    """Write the new K/V into ``cache`` at ``cache_pos`` and attend: the
    cache branch of :func:`attn_apply`. ``kv_heads``: the kv heads ``q``'s
    heads attend (a rank's share of a replicated cache), all by default.
    Returns ``(out, new_cache)``."""
    s = q.shape[1]
    new_cache = update_kv_cache(cache, k, v, cache_pos)
    k, v = k[:, :, kv_heads], v[:, :, kv_heads]
    if s > 1 and use_chunked and _host_zero(cache_pos):
        # prefill into an empty cache: the fresh K/V, chunked
        out = chunked_attention(q, k, v, **chunk)
    elif "rolling" in cache and s > 1:
        # windowed prefill: the fresh K/V, as the reference
        out = _sdpa_full(q, k, v, causal=cfg.causal, q_offset=0,
                         window=cfg.window)
    elif "rolling" in cache:
        kc, vc = read_kv_cache(new_cache, q.dtype)
        out = _sdpa_rolling(q, kc[:, :, kv_heads], vc[:, :, kv_heads],
                            min(int(cache_pos) + s, kc.shape[1]))
    else:
        kc, vc = read_kv_cache(new_cache, q.dtype)
        out = _sdpa_full(q, kc[:, :, kv_heads], vc[:, :, kv_heads],
                         causal=cfg.causal, q_offset=cache_pos,
                         window=cfg.window)
    return out, new_cache


def _a_cache_tensor(cache: dict):
    return cache["k"] if "k" in cache else cache.get("k_q")


def _attend_placed(q, k, v, cache: dict, cache_pos, cfg: AttnConfig,
                   use_chunked: bool, chunk: dict):
    """:func:`_attend_cache` over a placed cache (a sharded server), its
    leaves split as ``cache_pspec`` places them: the batch over the DP
    axes and, over ``model``, the kv heads when they divide, else the
    positions. Each rank runs on its own rows.

    * Heads split: q, k and v are taken on the rank's heads (a q head's
      kv head lies on its rank) and the unsharded arithmetic runs on
      them, writing the rank's cache in place: equal to the unsharded
      result bit for bit. An unchunked prefill and a per-row decode step
      write so and then attend every head (:func:`_every_head_cache`): on
      the card the einsums round by their head count.
    * Neither split (a replicated cache: its length does not divide
      either): every rank writes every kv head, and q keeps its split of
      the heads where whole kv groups, or a part of one, fall on each
      rank, which attends only its q heads' kv heads: the same per-head
      arithmetic, bit for bit.
    * Positions split (a 100B config's 8 kv heads on a 16-way ``model``
      axis): q, k and v whole over the heads; each rank writes the new
      positions that fall in its slots, attends its slots (causal and
      window masks on the global positions) to a partial softmax — the
      row maximum, the sum of the exponentials and the weighted values —
      and the ranks are combined by log-sum-exp (an all-reduce of the
      maxima, then of the rescaled sums and values): the unsharded
      softmax with its sums reordered. A chunked prefill into an empty
      cache attends the fresh K/V, whole on every rank, as the unsharded
      branch does: bit for bit.
    * A rolling (sliding-window) buffer whose slots are split (hymba's 5
      kv heads on 4 ranks): the shift moves only the slots that cross
      ranks (:func:`_roll_positions`); a prefill attends its fresh K/V,
      whole on every rank, as the unsharded branch does (bit for bit); a
      decode step attends each rank's filled slots at their global
      positions, combined as above. With the kv heads split, or the
      buffer whole, the rank's buffer runs the unsharded branch.

    ``cache_pos`` may be a (B,) tensor of per-row positions placed like
    the batch (the engine's slot arena): each rank takes its rows of it,
    and nothing reads it on the host. With the heads split or the cache
    whole the rank writes its share as the unsharded per-row branch does
    and attends every head and every row over the cache gathered whole,
    keeping its rows (:func:`_every_head_cache`; an unchunked prefill
    attends every head of its rows): bit for bit; with
    the positions split
    each row's new K/V lands in the slot of its own position on the rank
    that holds it (a masked select, :func:`_write_positions`) and the
    causal mask compares each row's own position with the slots'. A
    rolling buffer takes a host int only and raises for per-row
    positions, as :func:`update_kv_cache` does."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    ref = _a_cache_tensor(cache)
    mesh = ref.device_mesh
    if _per_row(cache_pos) and "rolling" in cache:
        raise ValueError("per-row cache positions on a placed rolling "
                         "(sliding-window) buffer: a rolling cache takes "
                         "one host-int position for every row")
    rows_on = [i for i, p in enumerate(ref.placements) if p.is_shard(0)]
    rows_pos = cache_pos
    if _per_row(cache_pos):
        cache_pos = placed.local_rows(cache_pos, mesh, rows_on)
    seq_on = [i for i, p in enumerate(ref.placements) if p.is_shard(1)]
    heads_on = [i for i, p in enumerate(ref.placements) if p.is_shard(2)]
    pls = [Shard(0) if i in rows_on else Shard(2) if i in heads_on
           else Replicate() for i in range(mesh.ndim)]
    s = q.shape[1]
    if (not seq_on and "rolling" not in cache
            and (_per_row(cache_pos) or s > 1)
            and not (use_chunked and _host_zero(cache_pos))):
        return _every_head_cache(q, k, v, cache, cache_pos, rows_pos, cfg,
                                 pls, rows_on)
    q_pls, kv_heads = pls, slice(None)
    if not seq_on and not heads_on:
        q_pls, kv_heads = _q_heads_split(q, pls, rows_on, k.shape[2])
    ql = q.redistribute(mesh, q_pls).to_local()
    kl, vl = (t.redistribute(mesh, pls).to_local() for t in (k, v))
    local = {n: (t.to_local() if placed.is_placed(t) else t)
             for n, t in cache.items()}
    if not seq_on:
        out, new_local = _attend_cache(ql, kl, vl, local, cache_pos, cfg,
                                       use_chunked, chunk, kv_heads)
    else:
        s, total = q.shape[1], ref.shape[1]
        t0, tn = placed.mesh_offset(mesh, ref.placements, 1, total)
        rolling = "rolling" in cache
        if rolling:
            new_local = _roll_positions(local, kl, vl, int(cache_pos), t0,
                                        total, mesh, ref.placements)
        else:
            new_local = _write_positions(local, kl, vl, cache_pos, t0, total)
        if s > 1 and use_chunked and _host_zero(cache_pos):
            # prefill into an empty cache: the fresh K/V (whole on every
            # rank), chunked, as _attend_cache
            out = chunked_attention(ql, kl, vl, **chunk)
        elif rolling and s > 1:
            # windowed prefill: the fresh K/V, as _attend_cache
            out = _sdpa_full(ql, kl, vl, causal=cfg.causal, q_offset=0,
                             window=cfg.window)
        else:
            kc, vc = read_kv_cache(new_local, q.dtype)
            # a rolling buffer's slot j holds position len - total + j
            kpos = t0 + torch.arange(tn, device=kc.device)
            if rolling:
                kpos = kpos + (int(cache_pos) + s - total)
            out = _combined_attention(ql, kc, vc, cache_pos, kpos, mesh,
                                      seq_on, causal=cfg.causal,
                                      window=cfg.window)
    shape = tuple(q.shape[:3]) + (v.shape[-1],)
    out = DTensor.from_local(out.contiguous(), mesh, q_pls,
                             shape=torch.Size(shape),
                             stride=placed.contiguous_stride(shape))
    return out, dict(cache, len=new_local["len"])


def _every_head_cache(q, k, v, cache: dict, cache_pos, rows_pos,
                      cfg: AttnConfig, pls, rows_on):
    """:func:`_attend_placed`'s prefill (unchunked) and per-row decode
    over a cache whose positions are whole (its kv heads split, or it
    whole): each rank writes its share of the new K/V as the unsharded
    branch does (``update_kv_cache``, per-row scatter included), then
    attends every head over the cache gathered whole over the heads,
    ``q`` gathered alike; a per-row decode step attends every row too
    (``rows_pos`` the placed (B,) positions, ``cache_pos`` the rank's
    rows of them) and keeps its rows. On the card the float32 einsums
    round by their head and their row count, which a code flip carries
    to the logits (a 14-token prompt's prefill 0.41 apart on four cards,
    a token parting on a data axis); so each head's and row's arithmetic
    is the unsharded one. The output is whole over the heads (the
    row-parallel ``wo`` takes its words of it)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = q.device_mesh
    rows = [Shard(0) if i in rows_on else Replicate()
            for i in range(mesh.ndim)]
    kl, vl = (t.redistribute(mesh, pls).to_local() for t in (k, v))
    local = {n: (t.to_local() if placed.is_placed(t) else t)
             for n, t in cache.items()}
    new_local = update_kv_cache(local, kl, vl, cache_pos)
    seen = [Replicate()] * mesh.ndim if _per_row(cache_pos) else rows
    whole = {n: t.redistribute(mesh, seen).to_local()
             for n, t in cache.items() if placed.is_placed(t)}
    kc, vc = read_kv_cache(whole, q.dtype)
    offset = (placed.local_rows(rows_pos, mesh, [])
              if _per_row(cache_pos) else cache_pos)
    out = _sdpa_full(q.redistribute(mesh, seen).to_local(), kc, vc,
                     causal=cfg.causal, q_offset=offset, window=cfg.window)
    if _per_row(cache_pos):             # this rank's rows
        b0, bn = placed.mesh_offset(mesh, rows, 0, q.shape[0])
        out = out[b0:b0 + bn]
    shape = tuple(q.shape[:3]) + (v.shape[-1],)
    out = DTensor.from_local(out.contiguous(), mesh, rows,
                             shape=torch.Size(shape),
                             stride=placed.contiguous_stride(shape))
    return out, dict(cache, len=new_local["len"])


def _q_heads_split(q, pls, rows_on, n_kv: int):
    """Over a replicated cache: ``q``'s placements keeping its split of
    the heads (on the mesh dimensions that split them and not the rows)
    when each rank's q heads are whole kv groups or lie in one group, and
    the slice of kv heads the rank's q heads attend; else ``pls`` (q whole
    over the heads) and every kv head."""
    from torch.distributed.tensor import Shard
    mesh, h = q.device_mesh, q.shape[2]
    on = [i for i, p in enumerate(q.placements)
          if p.is_shard(2) and i not in rows_on]
    n = 1
    for i in on:
        n *= mesh.size(i)
    rep = h // n_kv
    if not on or h % n or not ((h // n) % rep == 0 or rep % (h // n) == 0):
        return pls, slice(None)
    q_pls = [Shard(2) if i in on else p for i, p in enumerate(pls)]
    q0, hq = placed.mesh_offset(mesh, q_pls, 2, h)
    g0 = q0 // rep
    return q_pls, slice(g0, g0 + max(1, hq // rep))


def _write_positions(cache: dict, k_new, v_new, pos, t0: int,
                     total: int) -> dict:
    """Write the new K/V (global positions ``pos ..``) into a rank's slots
    ``t0 .. t0 + T_local - 1`` of a position-split cache, the positions
    that fall there only; ``len`` becomes ``pos + S``. ``pos`` is a host
    int, or the rank's rows of per-row positions
    (:func:`_select_write`)."""
    s = k_new.shape[1]
    if _per_row(pos):
        for name, new in _entries(cache, k_new, v_new):
            _select_write(cache[name], new, pos, t0, total)
        return dict(cache, len=pos + s)
    tn = _a_cache_tensor(cache).shape[1]
    if pos < 0 or pos + s > total:
        raise ValueError(f"cache write [{pos}, {pos + s}) outside "
                         f"max_len={total}")
    a, e = max(pos, t0), min(pos + s, t0 + tn)
    if a < e:
        for name, new in _entries(cache, k_new, v_new):
            cache[name][:, a - t0:e - t0] = new[:, a - pos:e - pos].to(
                cache[name].dtype)
    return dict(cache, len=pos + s)


def _select_write(buf: torch.Tensor, new: torch.Tensor, pos: torch.Tensor,
                  t0: int, total: int) -> None:
    """Write ``new`` (B, S, ...) into a rank's slots ``t0 ..`` (of
    ``total`` positions) ``buf`` (B, T_local, ...), row b at positions
    ``pos[b] ..`` (each start clamped into the cache, as
    :func:`_seq_write` clamps it), in place: a slot takes the new value
    where it holds its row's position and keeps its own elsewhere, a
    select with no host read."""
    s = new.shape[1]
    start = torch.clamp(pos.to(torch.int64), 0, total - s)
    slots = t0 + torch.arange(buf.shape[1], device=buf.device)
    new = new.to(buf.dtype)
    for i in range(s):
        hit = slots[None, :] == (start + i)[:, None]             # (B, Tl)
        hit = hit.reshape(tuple(hit.shape) + (1,) * (buf.dim() - 2))
        buf.copy_(torch.where(hit, new[:, i:i + 1], buf))


def _entries(cache: dict, k_new, v_new):
    """``(cache leaf, new values)`` of a K/V update: ``k``/``v``, or an
    int8 cache's codes and scales (:func:`_quant_kv`)."""
    if "k" in cache:
        return (("k", k_new), ("v", v_new))
    (kq, ks), (vq, vs) = _quant_kv(k_new), _quant_kv(v_new)
    return (("k_q", kq), ("v_q", vq), ("k_s", ks), ("v_s", vs))


def _roll_positions(cache: dict, k_new, v_new, pos: int, t0: int,
                    total: int, mesh, placements) -> dict:
    """:func:`_roll_insert` on a rank's slots ``t0 .. t0 + T_local - 1`` of
    a rolling buffer of ``total`` slots placed by ``placements`` (the
    rows over the DP axes, the slots split), in place: the buffer shifts
    left by the update's length ``s`` and the update enters at the end.
    With ``s`` below a rank's slots, a rank keeps its own slots from ``s``
    on and takes the next rank's first ``s`` (the last rank: the update);
    only those slots move, each rank's first ``s`` all-gathered over the
    mesh dimensions that split the slots. A prefill into the empty buffer
    (``pos`` 0) takes the last ``min(s, total)`` positions of the update
    where they fall, locally. ``len`` becomes ``pos + s``; a longer
    update into a filled buffer raises."""
    from torch.distributed.tensor import DTensor, Replicate
    s = k_new.shape[1]
    gathered = [Replicate() if pl.is_shard(1) else pl for pl in placements]
    tn = _a_cache_tensor(cache).shape[1]
    if s >= tn and pos != 0:
        raise NotImplementedError(
            f"a write of {s} positions into a filled rolling buffer of "
            f"{tn} slots a rank: only a prefill into the empty buffer "
            "moves more than a rank's slots")
    for name, new in _entries(cache, k_new, v_new):
        buf, new = cache[name], new.to(cache[name].dtype)
        if s < tn:
            heads = DTensor.from_local(buf[:, :s].contiguous(), mesh,
                                       placements).redistribute(
                mesh, gathered).to_local()
            nxt = t0 + tn
            nxt = (new if nxt == total
                   else heads[:, nxt // tn * s:(nxt // tn + 1) * s])
            buf.copy_(torch.cat([buf[:, s:], nxt], dim=1))
        else:
            # the empty buffer's zeros, then the update, cut to the slots
            lo, hi = max(0, t0 + s - total), max(0, t0 + tn + s - total)
            buf.zero_()
            buf[:, tn - (hi - lo):] = new[:, lo:hi]
    return dict(cache, len=pos + s)


def _combined_attention(q, k, v, q_offset, kpos: torch.Tensor, mesh,
                        seq_on, *, causal: bool,
                        window: Optional[int] = None):
    """Attention of q (B, Sq, H, D), the first query at ``q_offset`` (a
    host int, or a (B,) tensor: each row's own), over
    a rank's slots k/v (B, Tl, Hkv, D*), slot j at global position
    ``kpos[j]`` (negative: an unfilled rolling slot, masked), under the
    causal and window masks, combined over the mesh dimensions ``seq_on``
    that split the positions: each rank's partial softmax (max, sum of
    exponentials, weighted values; an all-masked row, a rank with no
    filled slot among them, gives a zero sum and weight) merged by
    log-sum-exp. Float32 inside, as :func:`_sdpa_full`."""
    from torch.distributed import _functional_collectives as funcol
    b, sq, h, d = q.shape
    hkv = k.shape[2]
    f32 = torch.float32
    qg = q.reshape(b, sq, hkv, h // hkv, d)
    root = device_scalar(math.sqrt(d), q.device)
    scores = torch.einsum("bqgrd,bkgd->bgrqk", qg.to(f32), k.to(f32)) / root
    ar = torch.arange(sq, device=q.device)
    if _per_row(q_offset):
        qpos = q_offset.to(torch.int64)[:, None, None] + ar[None, :, None]
        kp = kpos[None, None, :]
    else:
        qpos = q_offset + ar[:, None]
        kp = kpos[None, :]
    mask = kp < 0
    if causal:
        mask = mask | (kp > qpos)
    if window is not None:
        mask = mask | (kp <= qpos - window)
    if _per_row(q_offset):
        mask = mask[:, None, None]            # (B, 1, 1, Sq, Tl)
    scores = scores.masked_fill(mask, -math.inf)
    m = torch.amax(scores, dim=-1)
    m0 = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(scores - m0[..., None])
    l = torch.sum(p, dim=-1)
    o = torch.einsum("bgrqk,bkgd->bgrqd", p, v.to(f32))
    mg = m
    for i in seq_on:
        mg = funcol.all_reduce(mg, "max", (mesh, i))
    w = torch.where(torch.isfinite(m), torch.exp(m - mg),
                    torch.zeros_like(m))
    l, o = l * w, o * w[..., None]
    for i in seq_on:
        l = funcol.all_reduce(l, "sum", (mesh, i))
        o = funcol.all_reduce(o, "sum", (mesh, i))
    out = (o / l[..., None]).permute(0, 3, 1, 2, 4)      # b q g r d
    return out.reshape(b, sq, h, v.shape[-1]).to(q.dtype)


# ------------------------------------------------------------------- MLA

def mla_init(gen: torch.Generator, cfg: AttnConfig, policy: QuantPolicy, *,
             lead: tuple = ()) -> dict:
    d, h = cfg.d_model, cfg.n_heads
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    lora = cfg.kv_lora
    return {
        "wq": qdense_init(gen, d, h * (dn + dr), policy, lead=lead),
        "w_dkv": qdense_init(gen, d, lora + dr, policy, lead=lead),
        "w_uk": qdense_init(gen, lora, h * dn, policy, lead=lead),
        "w_uv": qdense_init(gen, lora, h * dv, policy, lead=lead),
        "wo": qdense_init(gen, h * dv, d, policy, lead=lead),
        "kv_norm": torch.ones(lead + (lora,), device=gen.device),
    }


def init_mla_cache(batch: int, max_len: int, cfg: AttnConfig, *,
                   dtype: torch.dtype = torch.bfloat16, device=None) -> dict:
    """MLA's decode cache: the latent ``c`` (B, T, kv_lora), the rotary
    key part ``k_rope`` (B, T, qk_rope_dim) and ``len``."""
    return {
        "c": torch.zeros((batch, max_len, cfg.kv_lora), dtype=dtype,
                         device=device),
        "k_rope": torch.zeros((batch, max_len, cfg.qk_rope_dim), dtype=dtype,
                              device=device),
        "len": 0,
    }


def mla_apply(p: dict, x: torch.Tensor, cfg: AttnConfig,
              policy: QuantPolicy, *, positions=None,
              cache: Optional[dict] = None, cache_pos=None,
              use_chunked: bool = False, q_chunk: int = 1024,
              kv_chunk: int = 1024):
    """DeepSeek MLA over (B, S, D). Returns ``(out, new_cache)``.

    A prefill (a cache, S > 1, host ``cache_pos`` 0) seeds the latent
    cache and attends through per-head K and V materialized by
    ``qdense(w_uk)``/``qdense(w_uv)``; a decode (any other call with a
    cache) writes ``c``/``k_rope`` at ``cache_pos`` (a host int, or a (B,)
    tensor of per-row positions) and attends in the absorbed float32 form:
    queries into latent space through the raw ``w_uk``, the context out
    through the raw ``w_uv``, masked to -1e30 beyond each query. With
    ``use_chunked`` the prefill and training path attends through
    :func:`chunked_attention`, ``v`` padded to the q/k width and the
    output cut back, as the reference. ``cfg.kv_bits`` does not apply to
    the latent cache, in the reference either. A placed cache (a sharded
    server) takes :func:`_mla_placed`."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    q, ckv = qdense_shared([p["wq"], p["w_dkv"]], x, policy)
    chunk = dict(use_chunked=use_chunked, q_chunk=q_chunk, kv_chunk=kv_chunk)
    if cache is not None and placed.is_placed(cache["c"]):
        return _mla_placed(p, q, ckv, cfg, policy, positions, cache,
                           cache_pos, chunk)
    upd = None
    if cache is not None:
        upd = dict(cache)
        upd["len"] = (cache_pos if _per_row(cache_pos)
                      else int(cache_pos)) + s

        def latent(c, k_rope):
            _seq_write(cache["c"], c, cache_pos)
            _seq_write(cache["k_rope"], k_rope, cache_pos)
            return cache["c"], cache["k_rope"]
    else:
        latent = None
    out = _mla_heads(p, q, ckv, cfg, policy, positions, cfg.n_heads,
                     latent, cache_pos, **chunk)
    return qdense(p["wo"], out, policy), upd


def _mla_heads(p: dict, q, ckv, cfg: AttnConfig, policy: QuantPolicy,
               positions, n_heads: int, latent, cache_pos, *,
               use_chunked: bool, q_chunk: int, kv_chunk: int):
    """The body of :func:`mla_apply` for ``n_heads`` heads, on plain
    tensors: ``q`` (B, S, n_heads·(dn + dr)) those heads' queries,
    ``ckv`` (B, S, kv_lora + dr) the down-projected kv, whole; ``p``'s
    ``w_uk``/``w_uv`` hold those heads' columns. ``latent(c, k_rope)``
    writes the new latents into the cache and returns the cache's ``(c,
    k_rope)`` to attend (None: no cache). Returns the heads' context (B,
    S, n_heads·dv) in ``q``'s dtype, for ``wo``."""
    b, s = q.shape[:2]
    h = n_heads
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    lora = cfg.kv_lora
    f32, dev = torch.float32, q.device
    q = q.reshape(b, s, h, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    c, k_rope = ckv[..., :lora], ckv[..., lora:]
    c = rms_norm(c, p["kv_norm"])
    cos, sin = rotary(positions, dr, cfg.rope_theta)
    q_rope = apply_rotary(q_rope, cos, sin, dr)
    k_rope = apply_rotary(k_rope[..., None, :], cos, sin, dr)[..., 0, :]

    prefill = latent is not None and s > 1 and _host_zero(cache_pos)
    if latent is not None:
        c_cache, kr_cache = latent(c, k_rope)

    if latent is not None and not prefill:
        # decode: absorbed form over the latent cache
        c_all, kr_all = c_cache.to(f32), kr_cache.to(f32)
        wuk = p["w_uk"]["w"].reshape(lora, h, dn).to(f32)
        q_c = torch.einsum("bshd,lhd->bshl", q_nope.to(f32), wuk)
        scores = (torch.einsum("bshl,btl->bhst", q_c, c_all)
                  + torch.einsum("bshd,btd->bhst", q_rope.to(f32), kr_all))
        scores = scores / device_scalar(math.sqrt(dn + dr), dev)
        kpos = torch.arange(c_all.shape[1], device=dev)
        ar = torch.arange(s, device=dev)
        if _per_row(cache_pos):
            qpos = cache_pos[:, None, None] + ar[None, :, None]
            mask = (kpos[None, None, :] <= qpos)[:, None]   # (B,1,s,T)
        else:
            qpos = int(cache_pos) + ar[:, None]
            mask = (kpos[None, :] <= qpos)[None, None]      # (1,1,s,T)
        scores = scores.masked_fill(~mask, -1e30)
        pattn = torch.softmax(scores, dim=-1)
        ctx_c = torch.einsum("bhst,btl->bshl", pattn, c_all)
        wuv = p["w_uv"]["w"].reshape(lora, h, dv).to(f32)
        out_v = torch.einsum("bshl,lhv->bshv", ctx_c, wuv)
        return out_v.reshape(b, s, h * dv).to(q.dtype)

    # train / prefill: materialize per-head K, V from the latent
    k_nope = qdense(p["w_uk"], c, policy).reshape(b, s, h, dn)
    vfull = qdense(p["w_uv"], c, policy).reshape(b, s, h, dv)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, s, h, dr)],
                  dim=-1)
    qfull = torch.cat([q_nope, q_rope], dim=-1)
    if use_chunked:
        vpad = F.pad(vfull, (0, dn + dr - dv))
        out = chunked_attention(qfull, k, vpad, causal=True, q_chunk=q_chunk,
                                kv_chunk=kv_chunk)[..., :dv]
    else:
        out = _sdpa_full(qfull, k, vfull, causal=True, q_offset=0)
    return out.reshape(b, s, h * dv)


def _mla_placed(p: dict, q, ckv, cfg: AttnConfig, policy: QuantPolicy,
                positions, cache: dict, cache_pos, chunk: dict):
    """:func:`mla_apply` over a placed latent cache (a sharded server),
    ``q`` and ``ckv`` the placed projections. The cache keeps
    ``cache_pspec``'s placement: the batch over the DP axes, ``c``'s
    latent dim over ``model`` when it divides (else its positions),
    ``k_rope``'s positions. Each rank runs :func:`_mla_heads` on its rows,
    with ``ckv`` made whole first (its columns straddle the ``c``/``k_rope``
    boundary, and the norm takes the whole latent), and writes the new
    latents that fall in its shards of the cache. A prefill attends every
    head over the fresh latents; a decode step gathers the layer's ``c``
    and ``k_rope`` whole over ``model`` (per rank, (B_local, T, kv_lora +
    dr) elements) and attends every head: on the card the float32
    einsums round otherwise on a subset of the heads than on all of them,
    which a bf16 cast or an activation code can carry to the logits (the
    absorbed decode's on four cards, and GQA's prefill). So each head's
    arithmetic is the unsharded one at the rank's rows: equal to it bit
    for bit. The contexts go to the row-parallel ``wo``, which
    takes its words of them. Per-row positions (a (B,) ``cache_pos``, the
    engine's arena; ``positions`` then (B, 1)) are a decode step: each
    rank takes its rows of both, writes each row's latent at its own
    position into the shards that hold it (a masked select, no host
    read) and attends every head, the unsharded per-row arithmetic."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.models.layers import _local_range
    mesh = cache["c"].device_mesh
    b, s = q.shape[:2]
    h = cfg.n_heads
    rows_on = [i for i, pl in enumerate(q.placements) if pl.is_shard(0)]
    if _per_row(cache_pos):
        pos = placed.local_rows(cache_pos, mesh, rows_on)
        positions = placed.local_rows(positions, mesh, rows_on)
        prefill = False
    else:
        pos = int(cache_pos)
        prefill = s > 1 and pos == 0
    pls = [Shard(0) if i in rows_on else Replicate()
           for i in range(mesh.ndim)]

    def whole(t):
        """This rank's rows of a placed (..., n) tensor, whole in n."""
        if t.ndim == 0:
            return placed.local_of(t)
        return _local_range(t, [], t.shape[-1], 0, t.shape[-1])

    lp = {"kv_norm": placed.local_of(p["kv_norm"]),
          "w_uk": {k: whole(v) for k, v in p["w_uk"].items()},
          "w_uv": {k: whole(v) for k, v in p["w_uv"].items()}}
    ql, ckv_l = whole(q), whole(ckv)

    def latent(c, k_rope):
        for name, new in (("c", c), ("k_rope", k_rope)):
            _write_latent(cache[name], new, pos)
        if prefill:                     # attends the fresh latents
            return None, None
        return tuple(_whole_latent(cache[n]) for n in ("c", "k_rope"))

    out = _mla_heads(lp, ql, ckv_l, cfg, policy, positions, h, latent,
                     pos, **chunk)
    shape = torch.Size((b, s, h * cfg.v_head_dim))
    out = DTensor.from_local(out.contiguous(), mesh, pls,
                             shape=shape, stride=placed.contiguous_stride(
                                 shape))
    return qdense(p["wo"], out, policy), dict(cache, len=pos + s)


def _write_latent(dst, new: torch.Tensor, pos) -> None:
    """Write ``new`` (B_local, S, n), this rank's rows, at global
    positions ``pos ..`` into its shard of the placed latent cache
    ``dst`` (B, T, n), in place: the positions and the columns that fall
    in its shard. ``pos`` is a host int or the rank's rows of per-row
    positions (:func:`_select_write`)."""
    mesh, total = dst.device_mesh, dst.shape[1]
    s = new.shape[1]
    t0, tn = placed.mesh_offset(mesh, dst.placements, 1, total)
    c0, cn = placed.mesh_offset(mesh, dst.placements, 2, dst.shape[2])
    if _per_row(pos):
        _select_write(dst.to_local(), new[..., c0:c0 + cn], pos, t0, total)
        return
    if pos < 0 or pos + s > total:
        raise ValueError(f"cache write [{pos}, {pos + s}) outside "
                         f"max_len={total}")
    a, e = max(pos, t0), min(pos + s, t0 + tn)
    if a < e:
        loc = dst.to_local()
        loc[:, a - t0:e - t0] = new[:, a - pos:e - pos, c0:c0 + cn].to(
            loc.dtype)


def _whole_latent(t) -> torch.Tensor:
    """This rank's rows of a placed latent cache, its positions and
    columns gathered whole."""
    from torch.distributed.tensor import Replicate
    pls = [pl if pl.is_shard(0) else Replicate() for pl in t.placements]
    if pls != list(t.placements):
        t = t.redistribute(t.device_mesh, pls)
    return t.to_local()
