"""Plain reference of a dense pre-norm decoder LM served at W4A8: the
inputs the benchmark makes for it, and its forward pass in plain torch.

It imports nothing of the program and takes nothing the program made: the
benchmark makes the float weights and step sizes here, from the seed,
hands the same to the program (which packs them) and to this forward
(which quantizes them again). Written from the published description of
StableLM 2 (hf:stabilityai/stablelm-2-1_6b: LayerNorm, partial rotary,
SwiGLU, q/k/v biases) and the serving precision the configuration states,
after ``src/repro_torch/models/{transformer,attention,layers}.py`` at
commit b3e1625 where the description leaves a choice:

* rotary on interleaved channel pairs of the first ``partial_rotary``
  share of each head (the published model pairs channel i with i + rd/2:
  with random weights a fixed permutation of q and k channels);
* a bf16 residual stream and bf16 K/V, norms and attention in float32;
* every projection W4A8: weights quantized per output column by their
  LSQ step, activations per tensor by theirs (round half to even, clip),
  the integer product exact (float32 products of integers below 2**24,
  TF32 off), then one fused multiply-add of the two steps and the bias,
  cast to bf16;
* the head in float32 over the bf16-cast weights.

``a_bits`` below 8 runs the control: the same activations at fewer bits,
their step widened by the bits dropped (the same range, a coarser step).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from portbench import seeds
from portbench.reference import tf32

__all__ = ["dims", "make_params", "calibrate_alpha_a", "forward_rows",
           "PROJ"]

#: a layer's projections: (group, name, input it quantizes)
PROJ = (("attn", "wq", "h1"), ("attn", "wk", "h1"), ("attn", "wv", "h1"),
        ("attn", "wo", "attn"), ("mlp", "w_gate", "h2"),
        ("mlp", "w_up", "h2"), ("mlp", "w_down", "act"))


def dims(cfg: Dict) -> Dict:
    d, h = int(cfg["hidden_size"]), int(cfg["num_attention_heads"])
    return {"d": d, "h": h, "hkv": int(cfg["num_key_value_heads"]),
            "dh": d // h, "f": int(cfg["intermediate_size"]),
            "layers": int(cfg["num_hidden_layers"]),
            "vocab": int(cfg["vocab_size"]),
            "rd": int((d // h) * float(cfg["partial_rotary_factor"])),
            "theta": float(cfg["rope_theta"]),
            "eps": float(cfg["layer_norm_eps"]),
            "bias": bool(cfg["use_qkv_bias"])}


def make_params(cfg: Dict, seed: int, device) -> Dict:
    """Float32 weights from ``seed`` on ``device``, one draw per stacked
    leaf, in the layout the program takes (a layer stack's leaves carry a
    leading (L, ...) axis): projections N(0, 1/K), the embedding N(0,
    0.02²), the head N(0, 1/D), norm weights 1 + N(0, 0.05²) and biases
    N(0, 0.05²), q/k/v biases N(0, 0.1²); each projection's weight step
    ``alpha_w`` LSQ's initialization per column (2·mean|w| / sqrt(Qp)).
    The activation steps ``alpha_a`` are zero until
    :func:`calibrate_alpha_a` sets them."""
    g = dims(cfg)
    L, d, f = g["layers"], g["d"], g["f"]
    hd, kvd = g["h"] * g["dh"], g["hkv"] * g["dh"]
    gen = torch.Generator(device=device).manual_seed(
        seeds.derive(seed, "lm.weights"))
    qp_w = 2 ** (int(cfg["serving"]["w_bits"]) - 1) - 1

    def normal(shape, std):
        return torch.randn(shape, generator=gen, device=device).mul_(std)

    def dense(k, n, bias=False):
        w = normal((L, k, n), 1.0 / math.sqrt(k))
        p = {"w": w,
             "alpha_w": 2.0 * w.abs().mean(dim=-2, keepdim=True)
             / math.sqrt(qp_w),
             "alpha_a": torch.zeros((L,), device=device)}
        if bias:
            p["b"] = normal((L, n), 0.1)
        return p

    layer = {
        "norm1": normal((L, d), 0.05).add_(1.0),
        "norm1_b": normal((L, d), 0.05),
        "attn": {"wq": dense(d, hd, g["bias"]), "wk": dense(d, kvd, g["bias"]),
                 "wv": dense(d, kvd, g["bias"]), "wo": dense(hd, d)},
        "norm2": normal((L, d), 0.05).add_(1.0),
        "norm2_b": normal((L, d), 0.05),
        "mlp": {"w_gate": dense(d, f), "w_up": dense(d, f),
                "w_down": dense(f, d)},
    }
    return {"embed": normal((g["vocab"], d), 0.02),
            "final_norm": normal((d,), 0.05).add_(1.0),
            "final_norm_b": normal((d,), 0.05),
            "groups": [layer],
            "head": {"w": normal((d, g["vocab"]), 1.0 / math.sqrt(d))}}


# ---------------------------------------------------------------- pieces

def _ln(x: torch.Tensor, w, b, eps: float) -> torch.Tensor:
    return F.layer_norm(x.float(), (x.shape[-1],), w.float(), b.float(),
                        eps)


def _rotary(x: torch.Tensor, g: Dict, positions: torch.Tensor):
    """(T, H, Dh) → float32: interleaved pairs of the first ``rd``
    channels rotated at each position, in float32."""
    rd = g["rd"]
    expo = torch.arange(0, rd, 2, dtype=torch.float32, device=x.device) / rd
    theta = torch.tensor(g["theta"], dtype=torch.float32, device=x.device)
    ang = positions.float()[:, None] * (1.0 / theta ** expo)
    c, s = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    xr = x[..., :rd].float()
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    out = torch.stack([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return torch.cat([out.reshape(xr.shape), x[..., rd:].float()], dim=-1)


class _Proj:
    """One projection of one layer, its weight codes made once."""

    def __init__(self, p: Dict, layer: int, w_bits: int, a_bits: int):
        self.alpha_w = p["alpha_w"][layer].abs().clamp_min(1e-8)  # (1, N)
        qn, qp = -(2 ** (w_bits - 1)), 2 ** (w_bits - 1) - 1
        self.wq = torch.clamp(torch.round(p["w"][layer] / self.alpha_w),
                              qn, qp)
        self.alpha_a = p["alpha_a"][layer].float()
        self.a_bits = a_bits
        self.bias = p["b"][layer] if "b" in p else None

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """(T, K) bf16 → (T, N) bf16."""
        drop = 8 - self.a_bits       # the control's coarser step
        step = self.alpha_a * (2 ** drop)
        qn, qp = -(2 ** (self.a_bits - 1)), 2 ** (self.a_bits - 1) - 1
        codes = torch.clamp(torch.round(x.float() / step), qn, qp)
        acc = codes @ self.wq                                  # exact
        scale = (self.alpha_w[0] * self.alpha_a).float() * (2 ** drop)
        out = acc.double() * scale.double()
        if self.bias is not None:
            out = out + self.bias.double()
        return out.float().to(torch.bfloat16)


def _attention(q, k, v, block: int = 512) -> torch.Tensor:
    """Causal attention of (T, H, Dh) bf16 in float32, query rows in
    blocks; → (T, H·Dh) bf16."""
    t, h, dh = q.shape
    kf, vf = k.float(), v.float()
    out = torch.empty((t, h, dh), dtype=torch.bfloat16, device=q.device)
    kpos = torch.arange(t, device=q.device)
    for s in range(0, t, block):
        e = min(t, s + block)
        sc = torch.einsum("qhd,khd->hqk", q[s:e].float(), kf) / math.sqrt(dh)
        mask = kpos[None, :] > torch.arange(s, e, device=q.device)[:, None]
        sc = sc.masked_fill(mask[None], -math.inf)
        p = torch.softmax(sc, dim=-1)
        out[s:e] = torch.einsum("hqk,khd->qhd", p, vf).to(torch.bfloat16)
    return out.reshape(t, h * dh)


# --------------------------------------------------------------- forward

def _layer(x: torch.Tensor, lp: Dict, projs: Dict, g: Dict,
           quantized: bool, record: Optional[Dict] = None) -> torch.Tensor:
    """One block over (T, D); ``record`` (a dict) collects each
    projection input's mean |x| (the float calibration pass)."""
    t = x.shape[0]
    dt = torch.bfloat16 if quantized else torch.float32

    def proj(name, inp):
        if quantized:
            return projs[name](inp)
        if record is not None:
            record.setdefault(name, inp.abs().mean())
        p = projs[name]
        out = inp @ p["w"]
        return out + p["b"] if "b" in p else out

    h1 = _ln(x, lp["norm1"], lp["norm1_b"], g["eps"]).to(dt)
    q = proj("wq", h1).reshape(t, g["h"], g["dh"])
    k = proj("wk", h1).reshape(t, g["hkv"], g["dh"])
    v = proj("wv", h1).reshape(t, g["hkv"], g["dh"])
    pos = torch.arange(t, device=x.device)
    q, k = _rotary(q, g, pos).to(dt), _rotary(k, g, pos).to(dt)
    if g["hkv"] != g["h"]:
        rep = g["h"] // g["hkv"]
        k, v = k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1)
    a = _attention(q, k, v).to(dt)
    x = x + proj("wo", a)
    h2 = _ln(x, lp["norm2"], lp["norm2_b"], g["eps"]).to(dt)
    act = F.silu(proj("w_gate", h2)) * proj("w_up", h2)
    return x + proj("w_down", act)


def _layer_params(params: Dict, layer: int) -> Dict:
    grp = params["groups"][0]
    return {k: grp[k][layer] for k in ("norm1", "norm1_b", "norm2",
                                        "norm2_b")}


def calibrate_alpha_a(params: Dict, cfg: Dict, tokens: torch.Tensor) -> None:
    """LSQ's initialization of every activation step, 2·mean|x| /
    sqrt(Qp), from the float model's forward over ``tokens`` (one seeded
    prompt); written into ``params`` in place."""
    g = dims(cfg)
    qp = 2 ** (int(cfg["serving"]["a_bits"]) - 1) - 1
    grp = params["groups"][0]
    with torch.no_grad(), tf32(False):
        x = params["embed"][tokens].float()
        for layer in range(g["layers"]):
            projs = {n: {k: v[layer] for k, v in grp[gr][n].items()
                         if k in ("w", "b")} for gr, n, _ in PROJ}
            rec: Dict = {}
            x = _layer(x, _layer_params(params, layer), projs, g, False, rec)
            for gr, n, _ in PROJ:
                grp[gr][n]["alpha_a"][layer] = 2.0 * rec[n] / math.sqrt(qp)


def forward_rows(params: Dict, cfg: Dict, seqs: Sequence[torch.Tensor],
                 rows: Sequence[torch.Tensor], *, a_bits: int = 8
                 ) -> List[torch.Tensor]:
    """The served model over each token sequence of ``seqs`` (1-D int64 on
    the device), layer by layer over all of them (each layer's weight
    codes made once): float32 logits at the positions ``rows[i]`` of
    sequence i. ``a_bits`` below 8 is the control."""
    g = dims(cfg)
    w_bits = int(cfg["serving"]["w_bits"])
    grp = params["groups"][0]
    with torch.no_grad(), tf32(False):
        xs = [params["embed"][s].to(torch.bfloat16) for s in seqs]
        for layer in range(g["layers"]):
            projs = {n: _Proj(grp[gr][n], layer, w_bits, a_bits)
                     for gr, n, _ in PROJ}
            lp = _layer_params(params, layer)
            xs = [_layer(x, lp, projs, g, True) for x in xs]
            del projs
        head = params["head"]["w"].to(torch.bfloat16).float()
        out = []
        for x, r in zip(xs, rows):
            h = _ln(x[r], params["final_norm"], params["final_norm_b"],
                    g["eps"]).to(torch.bfloat16)
            out.append(h.float() @ head)
        return out
