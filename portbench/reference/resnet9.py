"""Plain reference of the ResNet9 plain CNN served at W2A2: the inputs
the benchmark makes for it, its calibration and its forward pass in plain
torch.

It imports nothing of the program and takes nothing the program made: the
benchmark makes the float weights and images here, from the seed, and
hands the same to the program (which calibrates, quantizes and packs
them) and to this module (which does all of that again). Written from
BARVINN's ResNet9/CIFAR10 flow (github.com/hossein1387/BARVINN: conv0 and
the fc on the host in float, eight 3x3 convs at low precision, ReLU, two
2x2 max-pools, a global average pool), after
``src/repro_torch/compiler/lower.py`` ``_calibrate`` and
``src/repro_torch/models/resnet.py`` at commit b3e1625 where the flow
leaves a choice:

* calibration on the seeded calibration images: each conv's input step
  is LSQ's initialization 2·mean|x| / sqrt(Qp) over its float input on
  those images, each weight step the same per output channel;
* serving: each conv quantizes its input with its step (round half to
  even, clip), the integer conv is exact (float32 products of integers
  below 2**24, TF32 off), then the scaler (input step x weight step x
  scale) and bias in one fused multiply-add, ReLU, a max-pool where the
  table says so;
* conv0 and the fc in float32 with TF32 off, as the configuration states.

``host_tf32=True`` runs the control: conv0 and the fc at TF32's
precision, their operands rounded to TF32's 10-bit mantissa (round half
to even) and the products summed in float32, as a TF32 tensor core sums
them; on any device, so the control reads the same on the CPU.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from portbench import seeds
from portbench.reference import tf32

__all__ = ["make_params", "make_images", "calibrate", "forward",
           "tf32_round"]


def make_params(cfg: Dict, seed: int, device) -> Dict:
    """Float32 weights from ``seed`` on ``device``: conv0 N(0, 0.1²) (HWIO),
    each conv N(0, 1/(9 Ci)) with a per-channel scale 1 + N(0, 0.05²) and
    bias N(0, 0.05²), the fc N(0, 0.05²)."""
    gen = torch.Generator(device=device).manual_seed(
        seeds.derive(seed, "cnn.weights"))

    def normal(shape, std):
        return torch.randn(shape, generator=gen, device=device).mul_(std)

    c0 = int(cfg["stem_channels"])
    p = {"conv0": {"w": normal((3, 3, int(cfg["in_channels"]), c0), 0.1)}}
    for name, ci, co, _, _ in cfg["layers"]:
        p[name] = {"w": normal((3, 3, ci, co), 1.0 / math.sqrt(9 * ci)),
                   "scale": normal((co,), 0.05).add_(1.0),
                   "bias": normal((co,), 0.05)}
    p["fc"] = {"w": normal((cfg["layers"][-1][2], int(cfg["num_classes"])),
                           0.05)}
    return p


def make_images(cfg: Dict, seed: int, tag: str, n: int, device):
    """``n`` images (N, H, W, C) uniform in [0, 1), float32, from
    ``seed`` and ``tag``, made on ``device`` in one draw."""
    gen = torch.Generator(device=device).manual_seed(seeds.derive(seed, tag))
    hw, c = int(cfg["input_hw"]), int(cfg["in_channels"])
    return torch.rand((n, hw, hw, c), generator=gen, device=device)


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int) -> torch.Tensor:
    """NHWC x HWIO → NHWC, padding 1."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                 stride=stride, padding=1)
    return y.permute(0, 2, 3, 1)


def _pool(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


def _lsq_init(x: torch.Tensor, bits: int, dims=None) -> torch.Tensor:
    qp = 2 ** (bits - 1) - 1
    m = x.abs().mean() if dims is None else x.abs().mean(dim=dims)
    return 2.0 * m / math.sqrt(max(qp, 1)) + 1e-8


def _quant(x: torch.Tensor, step: torch.Tensor, bits: int) -> torch.Tensor:
    qn, qp = -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
    return torch.clamp(torch.round(x / step), qn, qp)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32's 10-bit mantissa, half to even."""
    bits = x.float().contiguous().view(torch.int32)
    low = bits & 0x1FFF
    keep = bits & ~0x1FFF
    half = 0x1000
    odd = (keep >> 13) & 1
    up = (low > half) | ((low == half) & (odd == 1))
    return torch.where(up, keep + 0x2000, keep).view(torch.float32)


def _host(x: torch.Tensor, host_tf32: bool) -> torch.Tensor:
    return tf32_round(x) if host_tf32 else x


def _stem(p: Dict, images: torch.Tensor, host_tf32: bool) -> torch.Tensor:
    return torch.relu(_conv(_host(images, host_tf32),
                            _host(p["conv0"]["w"], host_tf32), 1))


def calibrate(p: Dict, cfg: Dict, calib_images: torch.Tensor) -> Dict:
    """Every conv's weight codes and steps, and its input step from the
    calibration images: ``{name: {"wq", "alpha_w", "alpha_a"}}``."""
    wb, ab = int(cfg["w_bits"]), int(cfg["a_bits"])
    out = {}
    with torch.no_grad(), tf32(False):
        x = _stem(p, calib_images, False)
        for name, ci, co, stride, pool in cfg["layers"]:
            w = p[name]["w"]
            aw = _lsq_init(w, wb, dims=(0, 1, 2))
            ax = _lsq_init(x, ab)
            wq = _quant(w, aw, wb)
            out[name] = {"wq": wq, "alpha_w": aw, "alpha_a": ax}
            x = _layer(x, p[name], out[name], stride, pool, ab, fused=False)
    return out


def _layer(x, lp, q, stride, pool, a_bits, fused=True):
    """One conv stage: quantize the input by its step, the exact integer
    conv, the scaler and bias (in one rounding when serving, as a fused
    multiply-add; in two on the calibration pass, as the flow's float
    replay computes them), ReLU, the pool."""
    xq = _quant(x, q["alpha_a"], a_bits)
    acc = _conv(xq, q["wq"], stride)
    folded = q["alpha_a"] * q["alpha_w"] * lp["scale"]
    if fused:
        y = (acc.double() * folded.double() + lp["bias"].double()).float()
    else:
        y = acc * folded + lp["bias"]
    y = torch.relu(y)
    return _pool(y) if pool else y


def forward(p: Dict, cfg: Dict, q: Dict, images: torch.Tensor, *,
            host_tf32: bool = False, block: int = 256) -> torch.Tensor:
    """float32 logits (N, classes) of ``images``, ``block`` at a time."""
    ab = int(cfg["a_bits"])
    outs = []
    with torch.no_grad(), tf32(False):
        for s in range(0, images.shape[0], block):
            x = _stem(p, images[s:s + block], host_tf32)
            for name, ci, co, stride, pool in cfg["layers"]:
                x = _layer(x, p[name], q[name], stride, pool, ab)
            x = x.mean(dim=(1, 2))
            outs.append(_host(x, host_tf32) @ _host(p["fc"]["w"], host_tf32))
    return torch.cat(outs)
