"""Logical work and bytes of a dense decoder LM, from its configuration's
sizes alone.

Rewritten from ``src/repro_torch/launch/hlo_analysis.py`` (``gemm_flops``:
``flops_logical`` = 2·M·N·K per product, whatever its digits) at commit
b3e1625, and frozen here: the count never follows what implements a layer
(digit planes, padding to a bucket, tiles), so a rewrite of the kernels
cannot make it stale.

* A projection call of M rows, (K, N) weights: 2·M·N·K operations; bytes
  are the packed weights at ``w_bits``, the packed activations at
  ``a_bits``, the float32 output and the per-column scale (and bias), each
  read or written once.
* A token at context ``c`` (itself and the ``c - 1`` positions before it):
  every projection, 4·H·Dh·c for QKᵀ and PV over its true context, and,
  where the model emits logits for it, 2·D·V for the head.

``cfg`` is a configuration file's dict (Hugging Face key names).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

__all__ = ["dims", "projections", "proj_call", "token_flops",
           "prefill_flops", "request_flops"]


def dims(cfg: Dict) -> Dict[str, int]:
    d = int(cfg["hidden_size"])
    h = int(cfg["num_attention_heads"])
    return {"d": d, "h": h, "hkv": int(cfg["num_key_value_heads"]),
            "dh": d // h, "f": int(cfg["intermediate_size"]),
            "layers": int(cfg["num_hidden_layers"]),
            "vocab": int(cfg["vocab_size"])}


def projections(cfg: Dict) -> List[Tuple[str, int, int, bool]]:
    """One layer's packed projections, in the order a layer runs them:
    ``(name, K, N, has_bias)``."""
    g = dims(cfg)
    d, f = g["d"], g["f"]
    qkv_bias = bool(cfg.get("use_qkv_bias", False))
    return [("q", d, g["h"] * g["dh"], qkv_bias),
            ("k", d, g["hkv"] * g["dh"], qkv_bias),
            ("v", d, g["hkv"] * g["dh"], qkv_bias),
            ("o", g["h"] * g["dh"], d, False),
            ("gate", d, f, False),
            ("up", d, f, False),
            ("down", f, d, False)]


def proj_call(m: int, k: int, n: int, w_bits: int, a_bits: int,
              bias: bool = False) -> Tuple[float, float]:
    """``(operations, bytes)`` of one packed projection of ``m`` rows."""
    ops = 2.0 * m * n * k
    nbytes = (k * n * w_bits / 8.0 + m * k * a_bits / 8.0 + 4.0 * m * n
              + 4.0 * n * (2 if bias else 1))
    return ops, nbytes


def _proj_macs(cfg: Dict) -> int:
    return sum(k * n for _, k, n, _ in projections(cfg))


def token_flops(cfg: Dict, ctx: int, head: bool) -> float:
    """Logical operations of one token at context ``ctx``."""
    g = dims(cfg)
    per_layer = 2.0 * _proj_macs(cfg) + 4.0 * g["h"] * g["dh"] * ctx
    return g["layers"] * per_layer + (2.0 * g["d"] * g["vocab"] if head
                                      else 0.0)


def prefill_flops(cfg: Dict, prompt: int) -> float:
    """A prompt of ``prompt`` tokens: every position over its causal
    context, the head once (the prefill's logits are its last
    position's)."""
    g = dims(cfg)
    proj = 2.0 * _proj_macs(cfg) * prompt
    attn = 4.0 * g["h"] * g["dh"] * prompt * (prompt + 1) / 2.0
    return g["layers"] * (proj + attn) + 2.0 * g["d"] * g["vocab"]


def request_flops(cfg: Dict, prompt: int, output: int) -> float:
    """A request that served ``output`` tokens after ``prompt``: its
    prefill (which gives the first token), then one decode position for
    each later token, each at its context, each with the head."""
    g = dims(cfg)
    total = prefill_flops(cfg, prompt)
    n = max(0, output - 1)
    if n:
        # contexts prompt + 1 .. prompt + n
        ctx_sum = n * prompt + n * (n + 1) / 2.0
        total += n * (g["layers"] * 2.0 * _proj_macs(cfg)
                      + 2.0 * g["d"] * g["vocab"])
        total += g["layers"] * 4.0 * g["h"] * g["dh"] * ctx_sum
    return total
