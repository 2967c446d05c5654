"""Mixture-of-Experts with capacity-based scatter dispatch.

Counterpart of ``repro/models/moe.py``. Tokens are routed by a float32
softmax router to their top-k experts, ranked within each expert by a
cumulative count over the token axis, dropped beyond the capacity C,
scattered into an ``(E, C, d)`` buffer (row ``E * C`` is the drop bin),
run through the experts' FFNs and gathered back weighted by their gate
values — line for line the reference's dispatch, so a token's result
depends on the other tokens of its call (the capacity couples them).

Dispatch is **group-local**, as the reference's: the T tokens split into
``n_groups`` groups of T/G (by default the bound ``"dp"`` axis size of
:mod:`repro_torch.distributed.context`, 1 when unbound or when it does not
divide T), each with its own capacity and its own ``(E * C_g + 1, d)``
buffer. The experts are SwiGLU (``w_gate``, ``w_up``, ``w_down``) or a
two-matrix ``relu2``/``gelu`` FFN (``w_up``, ``w_down``; GELU is the tanh
approximation, ``jax.nn.gelu``'s default).

Expert weights are quant-aware: float (``{"w", "alpha_w", "alpha_a"}``,
LSQ fake-quant in mode ``qat``) or packed (``{"w_packed", "scale",
"alpha_a"}`` with a leading expert axis, from
:func:`~repro_torch.models.layers.pack_qdense`). On packed weights each
routed projection quantizes the buffers to int32 codes in float32 and runs
all E experts' bit-serial products, every group's rows together, in one
launch of grouped K4 (:func:`repro_torch.kernels.ops.
serial_matmul_grouped_op`; rows are independent, so one launch over
(E, G * C_g) rows equals G launches bit for bit), then scales the raw
accumulators in torch as the reference does. Shared experts are
:func:`~repro_torch.models.layers.qdense` (K1 + K3).

The dispatch reads nothing on the host (no ``.item()``, no ``nonzero``;
C is fixed by the token count), so a decode step captures as one CUDA
graph. Only the drop bin takes several adds in the scatter, and it is
discarded: every kept row is one exact add to zero, on the card too.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.bitserial import plan_spec
from repro_torch.core.quant import (QuantSpec, lsq_fake_quant, quantize_int,
                                    qrange)
from repro_torch.distributed import placed
from repro_torch.distributed.context import axis_size, constrain
from repro_torch.kernels import ops
from repro_torch.models.layers import (QuantPolicy, qdense, qdense_init,
                                       qdense_shared)

__all__ = ["MoEConfig", "moe_init", "moe_apply", "moe_ref_apply",
           "capacity_for", "dispatch"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff_expert: int
    n_experts: int
    top_k: int
    n_shared: int = 0
    d_ff_shared: int = 0
    capacity_factor: float = 1.25
    norm_topk_prob: bool = True
    act: str = "swiglu"             # 'swiglu' | 'relu2' | 'gelu'


def capacity_for(n_tokens: int, cfg: MoEConfig) -> int:
    """The reference's capacity: ``ceil(T * k / E * capacity_factor)``."""
    return int(np.ceil(n_tokens * cfg.top_k / cfg.n_experts
                       * cfg.capacity_factor))


def _expert_dense_init(gen: torch.Generator, e: int, k: int, n: int,
                       policy: QuantPolicy, lead: tuple) -> dict:
    std = 1.0 / np.sqrt(k)
    dev = gen.device
    p = {"w": torch.randn(lead + (e, k, n), generator=gen, device=dev) * std}
    if policy.mode == "qat":
        _, qpw = qrange(policy.w_bits, policy.w_signed)
        _, qpa = qrange(policy.a_bits, policy.a_signed)
        p["alpha_w"] = torch.full(lead + (e, 1, n),
                                  2.0 * std / np.sqrt(max(qpw, 1)), device=dev)
        p["alpha_a"] = torch.full(lead + (e,), 2.0 / np.sqrt(max(qpa, 1)),
                                  device=dev)
    return p


def moe_init(gen: torch.Generator, cfg: MoEConfig, policy: QuantPolicy, *,
             lead: tuple = ()) -> dict:
    """Float parameters drawn from ``gen`` on its device, in the
    reference's layout and scales; ``lead`` prepends stacking axes. A
    ``relu2``/``gelu`` MoE has no ``w_gate`` and no ``shared_gate``."""
    d, f, e = cfg.d_model, cfg.d_ff_expert, cfg.n_experts
    if cfg.act not in ("swiglu", "relu2", "gelu"):
        raise ValueError(f"unknown MoE act {cfg.act!r}")
    p = {
        "router": torch.randn(lead + (d, e), generator=gen,
                              device=gen.device) * 0.02,
        "w_up": _expert_dense_init(gen, e, d, f, policy, lead),
        "w_down": _expert_dense_init(gen, e, f, d, policy, lead),
    }
    if cfg.act == "swiglu":
        p["w_gate"] = _expert_dense_init(gen, e, d, f, policy, lead)
    if cfg.n_shared:
        fs = cfg.d_ff_shared or f * cfg.n_shared
        p["shared_up"] = qdense_init(gen, d, fs, policy, lead=lead)
        p["shared_down"] = qdense_init(gen, fs, d, policy, lead=lead)
        if cfg.act == "swiglu":
            p["shared_gate"] = qdense_init(gen, d, fs, policy, lead=lead)
    return p


def _expert_matmul(p: dict, x: torch.Tensor, policy: QuantPolicy,
                   parts: int = 1) -> torch.Tensor:
    """Every expert's dense layer at once: x (E, C, K) or (G, E, C, K) @
    w (E, K, N). Packed weights run every group's rows in one grouped K4
    launch, over x permuted to (E, G * C, K). ``x`` is one of ``parts``
    equal parts of the buffer (a rank's groups in a placed run): LSQ's
    step-size gradient is scaled by the whole buffer's count."""
    batched = x.dim() == 4
    aa = p.get("alpha_a")
    if aa is not None:
        aa = aa[None, :, None, None] if batched else aa[:, None, None]
    if "w_packed" in p:
        # codes in float32, as the reference divides x by a float32 step
        codes = quantize_int(x.to(torch.float32), aa,
                             QuantSpec(policy.a_bits, policy.a_signed))
        if batched:
            g, e, c, k = codes.shape
            codes = codes.permute(1, 0, 2, 3).reshape(e, g * c, k)
        acc = ops.serial_matmul_grouped_op(
            codes, p["w_packed"], spec=plan_spec(policy.spec()),
            k=x.shape[-1], plain=policy.plain)
        if batched:
            acc = acc.reshape(e, g, c, -1).permute(1, 0, 2, 3)
            scale = p["scale"][None, :, None, :]
        else:
            scale = p["scale"][:, None, :]
        return acc.to(x.dtype) * (scale * aa).to(x.dtype)
    w = p["w"]
    if policy.mode == "qat" and "alpha_w" in p:
        wspec = QuantSpec(policy.w_bits, policy.w_signed, per_channel=True)
        aspec = QuantSpec(policy.a_bits, policy.a_signed)
        w = lsq_fake_quant(w, p["alpha_w"].to(w.dtype), wspec)
        x = lsq_fake_quant(x, aa.to(x.dtype), aspec,
                           numel=None if parts == 1 else x.numel() * parts)
    return torch.matmul(x, w.to(x.dtype))


def _act(h, g, kind):
    """The expert nonlinearity: SwiGLU ``silu(g) * h``, the squared ReLU
    or GELU's tanh approximation (``jax.nn.gelu``'s default)."""
    if kind == "swiglu":
        return F.silu(g) * h
    if kind == "relu2":
        r = torch.clamp_min(h, 0)
        return r * r
    return F.gelu(h, approximate="tanh")


def _route(p: dict, xt: torch.Tensor, cfg: MoEConfig):
    """Router probabilities (T, E) and each token's top-k gate values and
    experts (T, k), renormalized when ``norm_topk_prob``."""
    logits = torch.matmul(xt.to(torch.float32),
                          p["router"].to(torch.float32))
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.topk(probs, cfg.top_k, dim=-1)
    if cfg.norm_topk_prob:
        gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)
    return probs, gate_vals, expert_idx


def dispatch(expert_idx: torch.Tensor, n_experts: int, capacity: int):
    """Each (token, slot)'s place: ``keep`` and ``flat`` (..., T, k), its
    row in its group's (E * C + 1)-row buffer (``E * C``, the drop bin,
    when it is beyond its expert's capacity); leading axes are groups. The
    rank within an expert counts earlier slots of the same token (a k x k
    comparison) and earlier tokens of the group (a cumulative count
    gathered at the chosen expert)."""
    t, k = expert_idx.shape[-2:]
    dev = expert_idx.device
    eq = expert_idx[..., :, None] == expert_idx[..., None, :]
    tri = torch.tril(torch.ones((k, k), dtype=torch.bool, device=dev), -1)
    slot_in_token = torch.sum(eq & tri, dim=-1)
    counts = torch.zeros(tuple(expert_idx.shape[:-1]) + (n_experts,),
                         dtype=torch.int64, device=dev)
    counts.scatter_add_(-1, expert_idx, torch.ones_like(expert_idx))
    prior = torch.cumsum(counts, dim=-2) - counts
    pos = torch.gather(prior, -1, expert_idx) + slot_in_token
    keep = pos < capacity
    flat = torch.where(keep, expert_idx * capacity + pos,
                       torch.full_like(pos, n_experts * capacity))
    return keep, flat


def moe_apply(p: dict, x: torch.Tensor, cfg: MoEConfig, policy: QuantPolicy,
              capacity: Optional[int] = None,
              n_groups: Optional[int] = None):
    """x: (..., T, d), the token axes flattened. Returns ``(out, aux)``:
    ``aux`` holds the Switch load-balance loss ``lb_loss`` and
    ``drop_frac``, the share of (token, slot) pairs beyond capacity (0-d
    tensors on x's device).

    Dispatch is group-local: the tokens split into ``n_groups`` groups
    (default: the bound ``"dp"`` axis size, 1 when it does not divide T),
    each dispatching into its own ``(E, C_g, d)`` buffer with C_g from the
    group's T/G tokens."""
    lead, d = tuple(x.shape[:-1]), x.shape[-1]
    xt = x.reshape(-1, d)
    t = xt.shape[0]
    e, k = cfg.n_experts, cfg.top_k
    if n_groups is None:
        n_groups = axis_size("dp")
        if n_groups <= 0 or t % n_groups != 0:
            n_groups = 1
    g = n_groups
    tg = t // g
    if capacity is None:
        capacity = capacity_for(tg, cfg)

    if placed.is_placed(p["router"]):
        return _moe_apply_placed(p, x, cfg, policy, capacity, g)

    xg = constrain(xt.reshape(g, tg, d), "dp", None, None)
    probs, gate_vals, expert_idx = _route(p, xt, cfg)
    keep, flat = dispatch(expert_idx.reshape(g, tg, k), e, capacity)
    hbuf = constrain(_scatter(xg, flat, e, capacity), "dp", "tp", None,
                     None)
    if g == 1:
        hbuf = hbuf[0]                                     # (E, C, d)
    out_buf = _experts(p, hbuf, cfg, policy)
    out = _combine(out_buf, flat, gate_vals, keep, g, e, capacity)

    if cfg.n_shared:
        out = out + _shared(p, xt, cfg, policy)

    me = torch.mean(probs, dim=0)
    ce = torch.mean(F.one_hot(expert_idx[:, 0], e).to(torch.float32), dim=0)
    aux = {"lb_loss": e * torch.sum(me * ce),
           "drop_frac": 1.0 - torch.mean(keep.to(torch.float32))}
    return out.reshape(lead + (d,)), aux


def _scatter(xg: torch.Tensor, flat: torch.Tensor, e: int,
             capacity: int) -> torch.Tensor:
    """Each group's tokens (G, T/G, d) scattered into its own (E*C + 1, d)
    rows of one buffer (each group's last row its drop bin); returns the
    (G, E, C, d) rows without the bins."""
    g, tg, d = xg.shape
    k = flat.shape[-1]
    rows = e * capacity + 1
    at = flat + torch.arange(g, device=xg.device)[:, None, None] * rows
    buf = torch.zeros((g * rows, d), dtype=xg.dtype, device=xg.device)
    buf.index_add_(0, at.reshape(-1),
                   xg.reshape(g * tg, d)[:, None, :].expand(
                       g * tg, k, d).reshape(-1, d))
    return buf.reshape(g, rows, d)[:, :-1].reshape(g, e, capacity, d)


def _experts(p: dict, hbuf: torch.Tensor, cfg: MoEConfig,
             policy: QuantPolicy, parts: int = 1) -> torch.Tensor:
    """The routed experts' FFN over their buffers ((E, C, d) or (G, E, C,
    d)), every expert at once; ``parts`` as :func:`_expert_matmul`'s."""
    kw = {} if parts == 1 else {"parts": parts}
    up = _expert_matmul(p["w_up"], hbuf, policy, **kw)
    gate = (_expert_matmul(p["w_gate"], hbuf, policy, **kw)
            if cfg.act == "swiglu" else None)
    return _expert_matmul(p["w_down"], _act(up, gate, cfg.act), policy, **kw)


def _combine(out_buf: torch.Tensor, flat: torch.Tensor,
             gate_vals: torch.Tensor, keep: torch.Tensor, g: int, e: int,
             capacity: int) -> torch.Tensor:
    """Gather each kept (token, slot)'s expert row and weight it by its
    gate value: (G * T/G, d)."""
    d = out_buf.shape[-1]
    rows = e * capacity + 1
    t, k = gate_vals.shape
    at = flat + torch.arange(g, device=flat.device)[:, None, None] * rows
    out_flat = torch.cat([out_buf.reshape(g, e * capacity, d),
                          torch.zeros((g, 1, d), dtype=out_buf.dtype,
                                      device=out_buf.device)], dim=1)
    picked = out_flat.reshape(g * rows, d)[at.reshape(-1)].reshape(t, k, d)
    w = (gate_vals * keep.reshape(t, k)).to(picked.dtype)
    return torch.einsum("tkd,tk->td", picked, w)


def _shared(p: dict, xt: torch.Tensor, cfg: MoEConfig,
            policy: QuantPolicy) -> torch.Tensor:
    """The shared experts over every token (K1 + K3 when packed)."""
    if cfg.act == "swiglu":
        sg, su = qdense_shared([p["shared_gate"], p["shared_up"]], xt, policy)
    else:
        sg, su = None, qdense(p["shared_up"], xt, policy)
    return qdense(p["shared_down"], _act(su, sg, cfg.act), policy)


def _moe_apply_placed(p: dict, x, cfg: MoEConfig, policy: QuantPolicy,
                      capacity: int, g: int):
    """:func:`moe_apply` on placed params (DTensors; ``x`` one too): the
    routing and dispatch of each rank's groups run on its local tensors
    (DTensor has no strategy for the capacity ranks or the scatter), the
    groups split over the DP axes (the constraint the reference puts on
    ``xg``). The experts are split over ``model`` (EP, when it divides E):
    each rank takes its experts' rows of the (G, E, C, d) buffer (the
    reference's ``("dp", "tp")`` constraint on it), runs them, and their
    rows are gathered back over ``model`` for the combine, which every
    ``model`` rank computes whole. The shared experts and the statistics
    run as in :func:`moe_apply`; ``lb_loss`` and ``drop_frac`` average
    over every group."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    d, e, k = x.shape[-1], cfg.n_experts, cfg.top_k
    tg = x.numel() // d // g
    mesh = p["router"].device_mesh
    ep_on = [i for i, n in enumerate(mesh.mesh_dim_names)
             if n == "model" and mesh.size(i) > 1 and e % mesh.size(i) == 0]
    # the rows over the DP axes (the reference's constraint on the groups)
    # when each rank's rows are whole groups, else whole on every rank;
    # the groups are local tensors (no DTensor reshape in autograd)
    xs = constrain(x, "dp", *([None] * (x.ndim - 1)))
    grp = [pl if pl.is_shard(0) and i not in ep_on else Replicate()
           for i, pl in enumerate(xs.placements)]
    data_on = [i for i, pl in enumerate(grp) if pl.is_shard()]
    if g % math.prod(mesh.size(i) for i in data_on):
        grp, data_on = [Replicate()] * mesh.ndim, []
    xs = x.redistribute(mesh, grp)
    xl = placed.local_of(xs).reshape(-1, tg, d)   # this rank's groups
    gl = xl.shape[0]
    router = placed.local_of(p["router"], grad_partial=data_on)
    probs, gate_vals, expert_idx = _route({"router": router},
                                          xl.reshape(-1, d), cfg)
    keep, flat = dispatch(expert_idx.reshape(gl, tg, k), e, capacity)
    hbuf = _scatter(xl, flat, e, capacity)               # (G_l, E, C, d)
    ep = [Shard(1) if i in ep_on else pl for i, pl in enumerate(grp)]
    if ep_on:                           # this rank's experts' rows
        shape = (g,) + tuple(hbuf.shape[1:])
        hbuf = DTensor.from_local(
            hbuf, mesh, grp, shape=torch.Size(shape),
            stride=placed.contiguous_stride(shape)).redistribute(
                mesh, ep).to_local()
    ep_params = {
        name: {kk: placed.local_of(
            v.redistribute(mesh, [Shard(0) if i in ep_on else Replicate()
                                  for i in range(mesh.ndim)]),
            grad_partial=data_on) for kk, v in p[name].items()}
        for name in ("w_up", "w_gate", "w_down") if name in p}
    out_buf = _experts(ep_params, hbuf[0] if gl == 1 else hbuf, cfg, policy,
                       parts=g // gl)
    if gl == 1:
        out_buf = out_buf[None]
    if ep_on:                           # every expert's rows, gathered
        shape = (g, e) + tuple(out_buf.shape[2:])
        out_buf = DTensor.from_local(
            out_buf, mesh, ep, shape=torch.Size(shape),
            stride=placed.contiguous_stride(shape)).redistribute(
                mesh, grp).to_local()
    out_l = _combine(out_buf, flat, gate_vals, keep, gl, e, capacity)
    out = DTensor.from_local(
        out_l.reshape(tuple(xs.to_local().shape)).contiguous(), mesh, grp,
        shape=x.shape, stride=placed.contiguous_stride(tuple(x.shape)))
    if cfg.n_shared:
        out = out + _shared(p, x, cfg, policy)

    # the statistics over every group: each rank's share of the mean
    n_data = 1
    for i in data_on:
        n_data *= mesh.size(i)

    def mean_all(local):
        if n_data == 1:
            return DTensor.from_local(local, mesh, [Replicate()] * mesh.ndim)
        pls = [Partial() if i in data_on else Replicate()
               for i in range(mesh.ndim)]
        return DTensor.from_local(local / n_data, mesh, pls).redistribute(
            mesh, [Replicate()] * mesh.ndim)

    me = mean_all(torch.mean(probs, dim=0))
    ce = mean_all(torch.mean(
        F.one_hot(expert_idx[:, 0], e).to(torch.float32), dim=0))
    aux = {"lb_loss": e * torch.sum(me * ce),
           "drop_frac": 1.0 - mean_all(torch.mean(keep.to(torch.float32)))}
    return out, aux


def moe_ref_apply(p: dict, x: torch.Tensor, cfg: MoEConfig,
                  policy: QuantPolicy) -> torch.Tensor:
    """Dense loop-over-experts oracle on float params (no capacity drops),
    for tests: every token through every chosen expert, unquantized."""
    lead, d = tuple(x.shape[:-1]), x.shape[-1]
    xt = x.reshape(-1, d)
    _, gate_vals, expert_idx = _route(p, xt, cfg)
    out = torch.zeros_like(xt)
    for ei in range(cfg.n_experts):
        up = xt @ p["w_up"]["w"][ei]
        gate = (xt @ p["w_gate"]["w"][ei] if cfg.act == "swiglu"
                else None)
        oe = _act(up, gate, cfg.act) @ p["w_down"]["w"][ei]
        wsel = torch.sum(torch.where(expert_idx == ei, gate_vals,
                                     torch.zeros_like(gate_vals)), dim=-1)
        out = out + oe * wsel[:, None].to(oe.dtype)
    if cfg.n_shared:
        su = qdense(p["shared_up"], xt, policy)
        sg = (qdense(p["shared_gate"], xt, policy) if cfg.act == "swiglu"
              else None)
        out = out + qdense(p["shared_down"], _act(su, sg, cfg.act), policy)
    return out.reshape(lead + (d,))
