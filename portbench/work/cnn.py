"""Logical work and bytes of the ResNet9 plain CNN, from its
configuration's layer table alone.

Rewritten from ``src/repro_torch/launch/hlo_analysis.py`` (``gemm_flops``:
2·M·N·K per product, whatever its digits) and the geometry of
``src/repro_torch/models/resnet.py`` ``resnet9_cost_layers`` at commit
b3e1625, and frozen here.

A packed conv of an (N, H, W, Ci) map to (N, Ho, Wo, Co) with 3x3
filters: 2·N·Ho·Wo·Co·9·Ci operations; bytes are the packed weights at
``w_bits``, the packed input at ``a_bits``, the output at the dtype the
call asks for (packed codes at the next layer's ``a_bits``, int8 codes
before a pool, float32 for the last) and the per-channel scale and bias,
each read or written once.
"""

from __future__ import annotations

from typing import Dict, List

__all__ = ["conv_calls", "conv_call_work", "image_flops"]


def _out_hw(h: int, stride: int) -> int:
    return (h + 2 - 3) // stride + 1


def conv_calls(cfg: Dict, batch: int) -> List[Dict]:
    """The packed convs of one forward of ``batch`` images, in order, each
    with its geometry and output kind."""
    h = int(cfg["input_hw"])
    layers = cfg["layers"]
    calls = []
    for i, (name, ci, co, stride, pool) in enumerate(layers):
        ho = _out_hw(h, stride)
        out = ("float" if i == len(layers) - 1 else
               "codes" if pool else "packed")
        calls.append({"name": name, "n": batch, "h": h, "ci": ci, "co": co,
                      "stride": stride, "ho": ho, "out": out})
        h = ho // 2 if pool else ho
    return calls


def conv_call_work(call: Dict, w_bits: int, a_bits: int) -> tuple:
    """``(operations, bytes)`` of one packed conv call."""
    n, h, ci, co, ho = (call[k] for k in ("n", "h", "ci", "co", "ho"))
    pixels = n * ho * ho
    ops = 2.0 * pixels * co * 9 * ci
    out_bytes = {"packed": a_bits / 8.0, "codes": 1.0, "float": 4.0}[
        call["out"]] * pixels * co
    nbytes = (9 * ci * co * w_bits / 8.0 + n * h * h * ci * a_bits / 8.0
              + out_bytes + 8.0 * co)
    return ops, nbytes


def image_flops(cfg: Dict) -> float:
    """Logical operations of one image's forward: the host conv0, the
    packed convs and the host fc."""
    hw, c0 = int(cfg["input_hw"]), int(cfg["stem_channels"])
    total = 2.0 * hw * hw * c0 * 9 * int(cfg["in_channels"])
    total += sum(conv_call_work(c, 1, 1)[0] for c in conv_calls(cfg, 1))
    total += 2.0 * cfg["layers"][-1][2] * int(cfg["num_classes"])
    return total
