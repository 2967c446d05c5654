"""Mixture-of-Experts with capacity-based scatter dispatch.

Counterpart of ``repro/models/moe.py`` on one card (one dispatch group:
``distributed/`` is not ported). Tokens are routed by a float32 softmax
router to their top-k experts, ranked within each expert by a cumulative
count over the token axis, dropped beyond the capacity C, scattered into
an ``(E, C, d)`` buffer (row ``E * C`` is the drop bin), run through the
experts' FFNs and gathered back weighted by their gate values — line for
line the reference's dispatch, so a token's result depends on the other
tokens of its call (the capacity couples them).

Expert weights are quant-aware: float (``{"w", "alpha_w", "alpha_a"}``,
LSQ fake-quant in mode ``qat``) or packed (``{"w_packed", "scale",
"alpha_a"}`` with a leading expert axis, from
:func:`~repro_torch.models.layers.pack_qdense`). On packed weights each
routed projection quantizes the buffer to int32 codes in float32 and runs
all E experts' bit-serial products in one launch of grouped K4
(:func:`repro_torch.kernels.ops.serial_matmul_grouped_op`), then scales
the raw accumulators in torch as the reference does. Shared experts are
:func:`~repro_torch.models.layers.qdense` (K1 + K3).

The dispatch reads nothing on the host (no ``.item()``, no ``nonzero``;
C is fixed by the token count), so a decode step captures as one CUDA
graph. Only the drop bin takes several adds in the scatter, and it is
discarded: every kept row is one exact add to zero, on the card too.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.bitserial import plan_spec
from repro_torch.core.quant import (QuantSpec, lsq_fake_quant, quantize_int,
                                    qrange)
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
    act: str = "swiglu"             # only 'swiglu' is ported


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
    reference's layout and scales; ``lead`` prepends stacking axes."""
    d, f, e = cfg.d_model, cfg.d_ff_expert, cfg.n_experts
    if cfg.act != "swiglu":
        raise NotImplementedError(f"MoE act {cfg.act!r} is not ported "
                                  "(SwiGLU only)")
    p = {
        "router": torch.randn(lead + (d, e), generator=gen,
                              device=gen.device) * 0.02,
        "w_up": _expert_dense_init(gen, e, d, f, policy, lead),
        "w_down": _expert_dense_init(gen, e, f, d, policy, lead),
        "w_gate": _expert_dense_init(gen, e, d, f, policy, lead),
    }
    if cfg.n_shared:
        fs = cfg.d_ff_shared or f * cfg.n_shared
        p["shared_up"] = qdense_init(gen, d, fs, policy, lead=lead)
        p["shared_down"] = qdense_init(gen, fs, d, policy, lead=lead)
        p["shared_gate"] = qdense_init(gen, d, fs, policy, lead=lead)
    return p


def _expert_matmul(p: dict, x: torch.Tensor,
                   policy: QuantPolicy) -> torch.Tensor:
    """Every expert's dense layer at once: x (E, C, K) @ w (E, K, N)."""
    aa = p.get("alpha_a")
    if aa is not None:
        aa = aa[:, None, None]
    if "w_packed" in p:
        # codes in float32, as the reference divides x by a float32 step
        codes = quantize_int(x.to(torch.float32), aa,
                             QuantSpec(policy.a_bits, policy.a_signed))
        acc = ops.serial_matmul_grouped_op(
            codes, p["w_packed"], spec=plan_spec(policy.spec()),
            k=x.shape[-1], plain=policy.plain)
        scale = p["scale"][:, None, :]
        return acc.to(x.dtype) * (scale * aa).to(x.dtype)
    w = p["w"]
    if policy.mode == "qat" and "alpha_w" in p:
        wspec = QuantSpec(policy.w_bits, policy.w_signed, per_channel=True)
        aspec = QuantSpec(policy.a_bits, policy.a_signed)
        w = lsq_fake_quant(w, p["alpha_w"].to(w.dtype), wspec)
        x = lsq_fake_quant(x, aa.to(x.dtype), aspec)
    return torch.matmul(x, w.to(x.dtype))


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
    """Each (token, slot)'s place: ``keep`` (T, k) and ``flat`` (T, k),
    its row in the (E * C + 1)-row buffer (``E * C``, the drop bin, when
    it is beyond its expert's capacity). The rank within an expert counts
    earlier slots of the same token (a k x k comparison) and earlier
    tokens (a cumulative count gathered at the chosen expert)."""
    t, k = expert_idx.shape
    dev = expert_idx.device
    eq = expert_idx[:, :, None] == expert_idx[:, None, :]
    tri = torch.tril(torch.ones((k, k), dtype=torch.bool, device=dev), -1)
    slot_in_token = torch.sum(eq & tri, dim=-1)
    counts = torch.zeros((t, n_experts), dtype=torch.int64, device=dev)
    counts.scatter_add_(1, expert_idx, torch.ones_like(expert_idx))
    prior = torch.cumsum(counts, dim=0) - counts
    pos = torch.gather(prior, 1, expert_idx) + slot_in_token
    keep = pos < capacity
    flat = torch.where(keep, expert_idx * capacity + pos,
                       torch.full_like(pos, n_experts * capacity))
    return keep, flat


def moe_apply(p: dict, x: torch.Tensor, cfg: MoEConfig, policy: QuantPolicy,
              capacity: Optional[int] = None):
    """x: (..., T, d), the token axes flattened. Returns ``(out, aux)``:
    ``aux`` holds the Switch load-balance loss ``lb_loss`` and
    ``drop_frac``, the share of (token, slot) pairs beyond capacity (0-d
    tensors on x's device)."""
    lead, d = tuple(x.shape[:-1]), x.shape[-1]
    xt = x.reshape(-1, d)
    t = xt.shape[0]
    e, k = cfg.n_experts, cfg.top_k
    if capacity is None:
        capacity = capacity_for(t, cfg)

    probs, gate_vals, expert_idx = _route(p, xt, cfg)
    keep, flat = dispatch(expert_idx, e, capacity)

    # dispatch: scatter into (E*C + 1, d); the last row is the drop bin
    buf = torch.zeros((e * capacity + 1, d), dtype=xt.dtype, device=x.device)
    buf.index_add_(0, flat.reshape(-1),
                   xt[:, None, :].expand(t, k, d).reshape(-1, d))
    hbuf = buf[:-1].reshape(e, capacity, d)

    up = _expert_matmul(p["w_up"], hbuf, policy)
    gate = _expert_matmul(p["w_gate"], hbuf, policy)
    out_buf = _expert_matmul(p["w_down"], F.silu(gate) * up, policy)

    # combine: gather each kept slot, weight by its gate value
    out_flat = torch.cat([out_buf.reshape(e * capacity, d),
                          torch.zeros((1, d), dtype=out_buf.dtype,
                                      device=x.device)], dim=0)
    picked = out_flat[flat.reshape(-1)].reshape(t, k, d)
    w = (gate_vals * keep).to(picked.dtype)
    out = torch.einsum("tkd,tk->td", picked, w)

    if cfg.n_shared:
        sg, su = qdense_shared([p["shared_gate"], p["shared_up"]], xt,
                               policy)
        out = out + qdense(p["shared_down"], F.silu(sg) * su, policy)

    me = torch.mean(probs, dim=0)
    ce = torch.mean(F.one_hot(expert_idx[:, 0], e).to(torch.float32), dim=0)
    aux = {"lb_loss": e * torch.sum(me * ce),
           "drop_frac": 1.0 - torch.mean(keep.to(torch.float32))}
    return out.reshape(lead + (d,)), aux


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
        h = F.silu(xt @ p["w_gate"]["w"][ei]) * up
        oe = h @ p["w_down"]["w"][ei]
        wsel = torch.sum(torch.where(expert_idx == ei, gate_vals,
                                     torch.zeros_like(gate_vals)), dim=-1)
        out = out + oe * wsel[:, None].to(oe.dtype)
    if cfg.n_shared:
        su = qdense(p["shared_up"], xt, policy)
        sh = F.silu(qdense(p["shared_gate"], xt, policy)) * su
        out = out + qdense(p["shared_down"], sh, policy)
    return out.reshape(lead + (d,))
