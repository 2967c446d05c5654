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

On a sharded server's placed packed params (a mesh run) both entry points
take :func:`_ssm_placed`: each rank convolves its channels and runs the
scan on every head, in the unsharded arithmetic, keeping its heads of the
state.
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
    if _packed_placed(p):
        return _ssm_placed(p, x, cfg, policy, cache, decode=False)
    zxbcdt = qdense(p["in_proj"], x, policy)
    z, xs, bb, cc, dt = _split_proj(zxbcdt, cfg)
    with record_function("ssm.conv"):
        conv_out, conv_state = _causal_conv(
            torch.cat([xs, bb, cc], dim=-1), p["conv_w"], p["conv_b"],
            None if cache is None else cache["conv"])
        conv_out = F.silu(conv_out)
    y, hfin = _scan_gate(p, conv_out, z, dt, cfg,
                         None if cache is None else cache["h"], decode=False)
    out = qdense(p["out_proj"], y, policy)
    new_cache = None
    if cache is not None:
        new_cache = {"h": hfin, "conv": conv_state,
                     "len": cache["len"] + x.shape[1]}
    return out, new_cache


def _scan_gate(p: dict, conv_out, z, dt, cfg: SSMConfig, h0, decode: bool):
    """The SSD scan (``decode``: the one-token state update) over the
    conv's output (B, S, d_inner + 2GN), every head, from the state
    ``h0`` (None: zeros), then the gated norm ``rms_norm(y * silu(z),
    norm)``; ``p`` holds ``A_log``, ``D``, ``dt_bias`` and ``norm``.
    Returns ``(y (B, S, d_inner) in z's dtype, h_final float32)``."""
    bsz, s = conv_out.shape[:2]
    di, g, n, h = cfg.d_inner, cfg.n_groups, cfg.d_state, cfg.n_heads
    if decode:
        f32 = torch.float32
        hsel = _head_group(h, g, conv_out.device)
        xs = conv_out[..., :di].reshape(bsz, h, cfg.head_dim)
        bb = conv_out[..., di:di + g * n].reshape(bsz, g, n)
        cc = conv_out[..., di + g * n:].reshape(bsz, g, n)
        with record_function("ssm.scan"):
            dtv = F.softplus(dt[:, 0] + p["dt_bias"][None])  # (B,H) float32
            a_t = torch.exp(dtv * -torch.exp(p["A_log"])[None])
            bth = bb[:, hsel].to(f32)
            cth = cc[:, hsel].to(f32)
            xf = xs.to(f32)
            hfin = (h0 * a_t[..., None, None]
                    + (dtv[..., None, None] * bth[..., None])
                    * xf[:, :, None, :])
            y = (torch.einsum("bhn,bhnp->bhp", cth, hfin)
                 + p["D"][None, :, None] * xf)
        y = y.reshape(bsz, 1, di).to(z.dtype)
    else:
        xs = conv_out[..., :di].reshape(bsz, s, h, cfg.head_dim)
        bb = conv_out[..., di:di + g * n].reshape(bsz, s, g, n)
        cc = conv_out[..., di + g * n:].reshape(bsz, s, g, n)
        dtv = placed.elementwise(F.softplus,
                                 dt + p["dt_bias"][None, None])  # float32
        with record_function("ssm.scan"):
            y, hfin = ssd_chunked(xs, dtv, p["A_log"], bb, cc, p["D"], cfg,
                                  h0=h0)
        y = y.reshape(bsz, s, di)
    return rms_norm(y * F.silu(z), p["norm"]), hfin


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
    if _packed_placed(p):
        return _ssm_placed(p, x, cfg, policy, cache, decode=True)
    zxbcdt = qdense(p["in_proj"], x, policy)               # (B,1,proj)
    z, xs, bb, cc, dt = _split_proj(zxbcdt, cfg)
    with record_function("ssm.conv"):
        conv_out, conv_state = _causal_conv(
            torch.cat([xs, bb, cc], dim=-1), p["conv_w"], p["conv_b"],
            cache["conv"])
        conv_out = F.silu(conv_out)
    y, hnew = _scan_gate(p, conv_out, z, dt, cfg, cache["h"], decode=True)
    out = qdense(p["out_proj"], y, policy)
    return out, {"h": hnew, "conv": conv_state, "len": cache["len"] + 1}


def _packed_placed(p: dict) -> bool:
    """Whether ``p`` is a sharded server's layer: packed planes, placed."""
    w = p["in_proj"].get("w_packed")
    return w is not None and placed.is_placed(w)


def _split_on(t, dim: int) -> list:
    """The mesh dimensions that split dimension ``dim`` of placed ``t``."""
    return [i for i, pl in enumerate(t.placements) if pl.is_shard(dim)]


def _whole_cols(t: torch.Tensor, mesh, rows_on: list, cols_on: list):
    """A rank's local (rows, ..., its column range) gathered whole in its
    last dimension over the mesh dimensions ``cols_on`` (its rows kept:
    split over ``rows_on``)."""
    if not cols_on:
        return t
    from torch.distributed.tensor import DTensor, Replicate, Shard
    split = [Shard(0) if i in rows_on else Shard(t.ndim - 1) if i in cols_on
             else Replicate() for i in range(mesh.ndim)]
    return placed.whole_dim(DTensor.from_local(t, mesh, split),
                            -1).to_local()


def _ssm_placed(p: dict, x, cfg: SSMConfig, policy: QuantPolicy,
                cache: Optional[dict], decode: bool):
    """:func:`ssm_apply` (``decode``: :func:`ssm_decode_step`) on a
    sharded server's placed packed params and placed cache, each rank on
    its rows; the cache is written in place.

    * ``in_proj`` (column-parallel) is made whole over the mesh first: its
      column split straddles the fused z | x | B | C | dt.
    * The depthwise conv runs on the rank's channels (``conv_w``,
      ``conv_b`` and the ``conv`` state are split alike) against its own
      state, and its output is gathered whole.
    * The scan and the gated norm run on every head (:func:`_scan_gate`),
      the state ``h`` (split by heads where they divide) gathered whole
      for it; each rank writes back its heads of the new state. On the
      card the scan's float32 einsums round otherwise on a share of the
      heads than on all of them, so every rank runs them at the
      unsharded shapes; ``A_log``, ``D``, ``dt_bias`` and the norm's
      ``norm`` are whole (a server holds them whole), so the norm's sum
      of squares runs over the whole ``d_inner`` in the unsharded order.
    * ``out_proj`` is row-parallel.

    Every rank's arithmetic is the unsharded one on its rows, its conv on
    its channels. Returns ``(out, new_cache)`` as the unsharded functions
    do."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.models.layers import _local_range
    zx = qdense(p["in_proj"], x, policy)
    mesh = zx.device_mesh
    rows_on = _split_on(zx, 0)
    zl = _local_range(zx, [], zx.shape[-1], 0, zx.shape[-1])
    z, xs, bb, cc, dt = _split_proj(zl, cfg)
    w = p["conv_w"]
    c_on = _split_on(w, w.ndim - 1)
    c0, cn = placed.mesh_offset(mesh, w.placements, w.ndim - 1, w.shape[-1])
    with record_function("ssm.conv"):
        conv_l, conv_state = _causal_conv(
            torch.cat([xs, bb, cc], dim=-1)[..., c0:c0 + cn],
            w.to_local(), _local_range(p["conv_b"], c_on, w.shape[-1], c0,
                                       c0 + cn),
            None if cache is None else cache["conv"].to_local())
        conv_out = _whole_cols(F.silu(conv_l), mesh, rows_on, c_on)
    whole = {k: _local_range(p[k], [], p[k].shape[-1], 0, p[k].shape[-1])
             for k in ("A_log", "D", "dt_bias", "norm")}
    h_all = (None if cache is None
             else placed.whole_dim(cache["h"], 1).to_local())
    y, hfin = _scan_gate(whole, conv_out, z, dt, cfg, h_all, decode)
    y = DTensor.from_local(y, mesh, [Shard(0) if i in rows_on else Replicate()
                                     for i in range(mesh.ndim)])
    out = qdense(p["out_proj"], y, policy)
    if cache is None:
        return out, None
    h0, hn = placed.mesh_offset(mesh, cache["h"].placements, 1, cfg.n_heads)
    cache["h"].to_local().copy_(hfin[:, h0:h0 + hn])
    cache["conv"].to_local().copy_(conv_state)
    return out, {"h": cache["h"], "conv": cache["conv"],
                 "len": cache["len"] + zl.shape[1]}
