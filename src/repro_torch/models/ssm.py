"""Mamba-2 SSD (state-space duality) layer, chunked matmul formulation.

Counterpart of ``repro/models/ssm.py``. The recurrence per head (state N,
head dim P):

    h_t = a_t * h_{t-1} + (dt_t * B_t) x_t^T        (N x P outer product)
    y_t = C_t^T h_t + D * x_t

with ``a_t = exp(dt_t * A)``. :func:`ssd_chunked` is the SSD chunked
algorithm (Dao & Gu 2024): within a chunk an attention-like masked
product, between chunks a carried state — a Python loop over the chunks
where the reference runs ``lax.scan``. The recurrence, the depthwise causal
conv and the gating stay plain float32 torch, as the reference computes
them in XLA outside any Pallas kernel; the in and out projections are
:func:`~repro_torch.models.layers.qdense`, so in deployment they run
through the bit-serial kernels (K1 + K3, or K4).

Dtypes follow the reference: the scan runs in float32 and casts back to
the input's dtype; ``dt + dt_bias`` promotes to float32. The conv and the
scan run in the profiler ranges ``ssm.conv`` and ``ssm.scan``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from repro_torch.distributed import placed
from repro_torch.models.layers import QuantPolicy, qdense, qdense_init, rms_norm

__all__ = ["SSMConfig", "ssm_init", "ssm_apply", "ssd_scan_ref",
           "ssd_chunked", "init_ssm_cache", "ssm_decode_step"]


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_model: int
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 128

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim


def ssm_init(gen: torch.Generator, cfg: SSMConfig,
             policy: QuantPolicy) -> dict:
    """One layer's float parameters, drawn on ``gen.device`` in the
    reference's layout and scales."""
    d, di, n, g, h = (cfg.d_model, cfg.d_inner, cfg.d_state, cfg.n_groups,
                      cfg.n_heads)
    dev = gen.device
    proj_out = 2 * di + 2 * g * n + h  # z, x, B, C, dt
    return {
        "in_proj": qdense_init(gen, d, proj_out, policy),
        "out_proj": qdense_init(gen, di, d, policy),
        "conv_w": torch.randn((cfg.d_conv, di + 2 * g * n), generator=gen,
                              device=dev) * 0.2,
        "conv_b": torch.zeros((di + 2 * g * n,), device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, h, device=dev)),
        "D": torch.ones((h,), device=dev),
        "dt_bias": torch.full((h,), math.log(math.e - 1), device=dev),
        "norm": torch.ones((di,), device=dev),
    }


def _split_proj(zxbcdt: torch.Tensor, cfg: SSMConfig):
    di, n, g = cfg.d_inner, cfg.d_state, cfg.n_groups
    z = zxbcdt[..., :di]
    x = zxbcdt[..., di:2 * di]
    bb = zxbcdt[..., 2 * di:2 * di + g * n]
    cc = zxbcdt[..., 2 * di + g * n:2 * di + 2 * g * n]
    dt = zxbcdt[..., 2 * di + 2 * g * n:]
    return z, x, bb, cc, dt


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv over (B, S, C); ``state`` (B, d_conv-1, C) for
    decode. Returns ``(out, new_state)``."""
    kw = w.shape[0]
    w = w.to(x.dtype)
    b = b.to(x.dtype)
    if state is None:
        pad = torch.zeros((x.shape[0], kw - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    out = sum(xp[:, i:i + x.shape[1]] * w[i][None, None] for i in range(kw))
    new_state = xp[:, -(kw - 1):] if kw > 1 else None
    return out + b[None, None], new_state


def _head_group(h: int, g: int, device) -> torch.Tensor:
    """The group of each head: head ``i`` reads B/C group ``i // (h/g)``."""
    return torch.arange(h, device=device) // (h // g)


def ssd_chunked(x, dt, a_log, b, c, d_skip, cfg: SSMConfig, h0=None):
    """Chunked SSD. x (B, S, H, P); dt (B, S, H) post-softplus; b, c
    (B, S, G, N); ``h0`` (B, H, N, P) float32 or None (zeros).

    Returns ``(y (B, S, H, P) in x's dtype, h_final (B, H, N, P)
    float32)``. The sequence is zero-padded to a whole chunk: dt = 0 gives
    a = 1 (the state unchanged) and zero B/C/x contributions, and the
    padded outputs are cut off."""
    bsz, s, h, pdim = x.shape
    g = b.shape[2]
    f32 = torch.float32
    lc = min(cfg.chunk, s)
    s_orig = s
    pad = (-s) % lc
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, 0, 0, pad))
        s = s + pad
    nc = s // lc
    hsel = _head_group(h, g, x.device)
    A = -torch.exp(a_log)                                  # (H,) negative
    loga = dt * A[None, None, :]                           # (B,S,H) log a_t
    xc = x.reshape(bsz, nc, lc, h, pdim).to(f32)
    dtc = dt.reshape(bsz, nc, lc, h)
    bc_ = b.reshape(bsz, nc, lc, g, -1).to(f32)
    cc_ = c.reshape(bsz, nc, lc, g, -1).to(f32)

    # intra-chunk cumulative log decay; decay tau -> t is exp(cum_t -
    # cum_tau) for tau <= t
    cum = torch.cumsum(loga.reshape(bsz, nc, lc, h), dim=2)  # (B,nc,lc,H)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]    # (B,nc,t,tau,H)
    tri = torch.ones((lc, lc), dtype=torch.bool, device=x.device).tril()
    # mask BEFORE exp: the upper triangle of seg is positive and would
    # overflow
    decay = torch.exp(seg.masked_fill(~tri[None, None, :, :, None], -1e30))

    # scores(t, tau) = (C_t . B_tau) * decay * dt_tau, per group then head
    cb = torch.einsum("bztgn,bzrgn->bzgtr", cc_, bc_)      # (B,nc,G,t,tau)
    cb = cb[:, :, hsel]                                    # (B,nc,H,t,tau)
    scores = cb * decay.permute(0, 1, 4, 2, 3) * dtc.permute(
        0, 1, 3, 2)[:, :, :, None, :]
    y_intra = torch.einsum("bzhtr,bzrhp->bzthp", scores, xc)

    # the chunk's state: h_out = exp(cum_L) h_in + sum_tau exp(cum_L -
    # cum_tau) dt_tau B_tau x_tau^T; its output y_inter[t] = C_t . (exp(
    # cum_t) h_in)
    decay_out = torch.exp(cum[:, :, -1:, :] - cum)         # (B,nc,lc,H)
    bx = torch.einsum("bzrhn,bzrhp->bzhnp",
                      bc_[:, :, :, hsel] * (dtc * decay_out)[..., None], xc)
    chunk_decay = torch.exp(cum[:, :, -1, :])              # (B,nc,H)
    hprev = (torch.zeros((bsz, h, bc_.shape[-1], pdim), dtype=f32,
                         device=x.device) if h0 is None else h0)
    hins = []
    for z in range(nc):
        hins.append(hprev)
        hprev = hprev * chunk_decay[:, z, :, None, None] + bx[:, z]
    hins = torch.stack(hins, dim=1)                        # (B,nc,H,N,P)
    cfull = cc_[:, :, :, hsel] * torch.exp(cum)[..., None]  # (B,nc,lc,H,N)
    y_inter = torch.einsum("bzthn,bzhnp->bzthp", cfull, hins)
    y = (y_intra + y_inter).reshape(bsz, s, h, pdim)
    y = y + d_skip[None, None, :, None] * x.to(f32)
    return y[:, :s_orig].to(x.dtype), hprev


def ssd_scan_ref(x, dt, a_log, b, c, d_skip, h0=None):
    """Step-by-step recurrence oracle (tests). Returns ``(y in x's dtype,
    h_final float32)``."""
    bsz, s, h, pdim = x.shape
    g, n = b.shape[2], b.shape[3]
    f32 = torch.float32
    hsel = _head_group(h, g, x.device)
    A = -torch.exp(a_log)
    hcur = (torch.zeros((bsz, h, n, pdim), dtype=f32, device=x.device)
            if h0 is None else h0)
    ys = []
    for t in range(s):
        a_t = torch.exp(dt[:, t] * A[None])                # (B,H)
        bth = b[:, t].to(f32)[:, hsel]                     # (B,H,N)
        cth = c[:, t].to(f32)[:, hsel]
        xt = x[:, t].to(f32)                               # (B,H,P)
        hcur = (hcur * a_t[..., None, None]
                + (dt[:, t][..., None, None] * bth[..., None])
                * xt[:, :, None, :])
        ys.append(torch.einsum("bhn,bhnp->bhp", cth, hcur)
                  + d_skip[None, :, None] * xt)
    return torch.stack(ys, dim=1).to(x.dtype), hcur


def ssm_apply(p: dict, x: torch.Tensor, cfg: SSMConfig, policy: QuantPolicy,
              cache: Optional[dict] = None):
    """Full-sequence forward over (B, S, D). Returns ``(out, new_cache)``:
    with a cache (its ``h`` and ``conv`` as the initial state), a new
    ``{"h", "conv", "len"}``; the caller stores it."""
    bsz, s, _ = x.shape
    zxbcdt = qdense(p["in_proj"], x, policy)
    z, xs, bb, cc, dt = _split_proj(zxbcdt, cfg)
    with record_function("ssm.conv"):
        conv_out, conv_state = _causal_conv(
            torch.cat([xs, bb, cc], dim=-1), p["conv_w"], p["conv_b"],
            None if cache is None else cache["conv"])
        conv_out = F.silu(conv_out)
    di, g, n = cfg.d_inner, cfg.n_groups, cfg.d_state
    xs = conv_out[..., :di].reshape(bsz, s, cfg.n_heads, cfg.head_dim)
    bb = conv_out[..., di:di + g * n].reshape(bsz, s, g, n)
    cc = conv_out[..., di + g * n:].reshape(bsz, s, g, n)
    dtv = placed.elementwise(F.softplus,
                             dt + p["dt_bias"][None, None])  # float32
    h0 = None if cache is None else cache["h"]
    with record_function("ssm.scan"):
        y, hfin = ssd_chunked(xs, dtv, p["A_log"], bb, cc, p["D"], cfg,
                              h0=h0)
    y = y.reshape(bsz, s, di)
    y = rms_norm(y * F.silu(z), p["norm"])
    out = qdense(p["out_proj"], y, policy)
    new_cache = None
    if cache is not None:
        new_cache = {"h": hfin, "conv": conv_state,
                     "len": cache["len"] + s}
    return out, new_cache


def init_ssm_cache(batch: int, cfg: SSMConfig, *,
                   dtype: torch.dtype = torch.float32, device=None) -> dict:
    """The decode state: ``h`` (B, H, N, P) float32, the conv's last
    ``d_conv - 1`` inputs ``conv`` (B, d_conv-1, d_inner + 2GN) in
    ``dtype``, and ``len``. Constant in the context length."""
    return {
        "h": torch.zeros((batch, cfg.n_heads, cfg.d_state, cfg.head_dim),
                         dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.d_conv - 1, cfg.d_inner
                             + 2 * cfg.n_groups * cfg.d_state), dtype=dtype,
                            device=device),
        "len": 0,
    }


def ssm_decode_step(p: dict, x: torch.Tensor, cfg: SSMConfig,
                    policy: QuantPolicy, cache: dict):
    """Single-token decode over (B, 1, D): an O(1) state update. Returns
    ``(out, new_cache)``; the caller stores it."""
    bsz = x.shape[0]
    f32 = torch.float32
    zxbcdt = qdense(p["in_proj"], x, policy)               # (B,1,proj)
    z, xs, bb, cc, dt = _split_proj(zxbcdt, cfg)
    with record_function("ssm.conv"):
        conv_out, conv_state = _causal_conv(
            torch.cat([xs, bb, cc], dim=-1), p["conv_w"], p["conv_b"],
            cache["conv"])
        conv_out = F.silu(conv_out)
    di, g, n, h = cfg.d_inner, cfg.n_groups, cfg.d_state, cfg.n_heads
    hsel = _head_group(h, g, x.device)
    xs = conv_out[..., :di].reshape(bsz, h, cfg.head_dim)
    bb = conv_out[..., di:di + g * n].reshape(bsz, g, n)
    cc = conv_out[..., di + g * n:].reshape(bsz, g, n)
    with record_function("ssm.scan"):
        dtv = F.softplus(dt[:, 0] + p["dt_bias"][None])   # (B,H) float32
        a_t = torch.exp(dtv * -torch.exp(p["A_log"])[None])
        bth = bb[:, hsel].to(f32)
        cth = cc[:, hsel].to(f32)
        xf = xs.to(f32)
        hnew = (cache["h"] * a_t[..., None, None]
                + (dtv[..., None, None] * bth[..., None]) * xf[:, :, None, :])
        y = (torch.einsum("bhn,bhnp->bhp", cth, hnew)
             + p["D"][None, :, None] * xf)
    y = y.reshape(bsz, 1, di).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["norm"])
    out = qdense(p["out_proj"], y, policy)
    return out, {"h": hnew, "conv": conv_state, "len": cache["len"] + 1}
