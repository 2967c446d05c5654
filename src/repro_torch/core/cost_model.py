"""BARVINN cycle cost model — reproduces the paper's performance tables.

The MVU computes one 64x64 tile MAC per cycle at 1-bit/1-bit, and a
``b_a``-bit x ``b_w``-bit tile in ``b_a*b_w`` cycles (paper §3.1.1). Layer
cost = tiles walked by the AGU loop nest x ``b_a*b_w``. Three edge-handling
variants are provided because the paper's Table 3 itself mixes them (its
stride-1 rows follow ``(H-2)*W`` positions, its downsampling rows ``(H-1)*W``
— see benchmarks/table3 for the per-row reconciliation):

* ``dense``     — every output position counts (upper bound),
* ``pad_skip``  — AGU skips kernel rows falling in vertical zero padding
                  (the hardware's documented behaviour, §3.1.3),
* ``paper_edge``— only rows with full vertical kernel support (``H-2`` rows
                  for 3x3 pad-1), which matches most of Table 3.

Execution modes (paper §3.1.6): **pipelined** throughput = freq / bottleneck
stage cycles (one layer per MVU, crossbar streaming); **distributed** latency
= sum of layer cycles / MVU count (each layer split across all MVUs).

The port's copy of the barrel-controller half of ``repro/core/cost_model.py``
(pure Python, no torch). The reference's other half, the TPU kernel cost
model (``TPUConfig``, the VMEM budget, ``kernel_cost``), has no meaning on
the H100 and waits for a Hopper tile model.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence

from repro_torch.core.mvu import LANES, MVU_COUNT

__all__ = ["HWConfig", "ConvLayer", "LinearLayer", "layer_cycles",
           "pipelined_fps", "distributed_fps", "network_cycles",
           "RESNET9_CIFAR10", "CNV_CIFAR10", "resnet50_layers"]


@dataclasses.dataclass(frozen=True)
class HWConfig:
    """The paper's Alveo U250 base configuration."""

    freq_hz: float = 250e6
    mvus: int = MVU_COUNT
    lanes: int = LANES
    power_w: float = 21.504  # Table 4 overall dynamic power

    @property
    def peak_macs(self) -> float:
        """1-bit MAC/s: 8 MVUs x 64x64 lanes x freq = 8.2 TMAC/s (abstract)."""
        return self.mvus * self.lanes * self.lanes * self.freq_hz


@dataclasses.dataclass(frozen=True)
class ConvLayer:
    name: str
    c_in: int
    c_out: int
    h: int            # input spatial height (= width assumed square)
    w: int
    fh: int = 3
    fw: int = 3
    stride: int = 1
    padding: int = 1
    on_host: bool = False  # first/last layers stay full precision on host


@dataclasses.dataclass(frozen=True)
class LinearLayer:
    name: str
    k: int
    n: int
    on_host: bool = False


def _tiles(n: int, lanes: int) -> int:
    return max(1, math.ceil(n / lanes))


def _conv_positions(l: ConvLayer, edge: str) -> int:
    ho = (l.h + 2 * l.padding - l.fh) // l.stride + 1
    wo = (l.w + 2 * l.padding - l.fw) // l.stride + 1
    if edge == "dense":
        return ho * wo * l.fh * l.fw
    if edge == "pad_skip":
        total = 0
        for oy in range(ho):
            iy0 = oy * l.stride - l.padding
            valid = sum(1 for f in range(l.fh) if 0 <= iy0 + f < l.h)
            total += valid
        return total * wo * l.fw
    if edge == "paper_edge":
        # Reverse-engineered from Table 3: stride-1 pad-1 layers count H-2
        # full rows (both vertical-padding rows elided); strided layers count
        # H_out-1 rows (only the top padding row elided).
        if l.padding == 0:
            rows = ho
        elif l.stride == 1:
            rows = max(1, ho - 2)
        else:
            rows = max(1, ho - 1)
        return rows * wo * l.fh * l.fw
    raise ValueError(edge)


def layer_cycles(layer, a_bits: int, w_bits: int, *, lanes: int = LANES,
                 edge: str = "pad_skip") -> int:
    """Cycles for one layer on ONE MVU."""
    if getattr(layer, "on_host", False):
        return 0
    bb = a_bits * w_bits
    if isinstance(layer, ConvLayer):
        cit = _tiles(layer.c_in, lanes)
        cot = _tiles(layer.c_out, lanes)
        return bb * cit * cot * _conv_positions(layer, edge)
    if isinstance(layer, LinearLayer):
        return bb * _tiles(layer.k, lanes) * _tiles(layer.n, lanes)
    raise TypeError(type(layer))


def network_cycles(layers: Sequence, a_bits: int, w_bits: int,
                   edge: str = "pad_skip") -> List[int]:
    return [layer_cycles(l, a_bits, w_bits, edge=edge) for l in layers]


def pipelined_fps(layers: Sequence, a_bits: int, w_bits: int,
                  hw: HWConfig = HWConfig(), edge: str = "pad_skip") -> float:
    """Pipelined mode: layer i on MVU i; throughput set by the bottleneck
    stage. Layers beyond ``hw.mvus`` wrap around (subset laps, §3.1.6):
    stages executing k layers cost the sum of those layers."""
    cyc = [c for c in network_cycles(layers, a_bits, w_bits, edge) if c > 0]
    if not cyc:
        return float("inf")
    stages = [0] * hw.mvus
    for i, c in enumerate(cyc):
        stages[i % hw.mvus] += c
    return hw.freq_hz / max(stages)


def distributed_fps(layers: Sequence, a_bits: int, w_bits: int,
                    hw: HWConfig = HWConfig(), edge: str = "pad_skip") -> float:
    """Distributed mode: every layer split across all MVUs; latency-optimal.
    Ideal split (the user copies shared input regions, §3.1.6)."""
    total = sum(network_cycles(layers, a_bits, w_bits, edge))
    if total == 0:
        return float("inf")
    return hw.freq_hz / (total / hw.mvus)


# --------------------------------------------------------------------------
# Paper model zoo
# --------------------------------------------------------------------------

#: ResNet9 (plain-CNN, residual-distilled) for CIFAR10 — paper Table 3.
RESNET9_CIFAR10: List = [
    ConvLayer("conv0", 3, 64, 32, 32, on_host=True),      # <64 input ch
    ConvLayer("conv1", 64, 64, 32, 32),
    ConvLayer("conv2", 64, 64, 32, 32),
    ConvLayer("conv3", 64, 128, 32, 32, stride=2),        # table out 16x16
    ConvLayer("conv4", 128, 128, 16, 16),                 # table in 16x16
    ConvLayer("conv5", 128, 256, 16, 16, stride=2),       # table out 8x8
    ConvLayer("conv6", 256, 256, 8, 8),
    ConvLayer("conv7", 256, 512, 8, 8, stride=2),         # table out 4x4
    ConvLayer("conv8", 512, 512, 4, 4),
    LinearLayer("fc", 512, 10, on_host=True),             # last layer on host
]

#: paper Table 3 reference cycle counts (as printed, incl. its edge quirks).
RESNET9_PAPER_CYCLES = {
    "conv1": 34560, "conv2": 34560, "conv3": 17280, "conv4": 32256,
    "conv5": 16128, "conv6": 27648, "conv7": 13824, "conv8": 18432,
}
RESNET9_PAPER_TOTAL = 194688

#: FINN CNV topology (CIFAR10) — paper Table 5. 3x3 VALID convs, 2x2 pools.
CNV_CIFAR10: List = [
    ConvLayer("conv1", 3, 64, 32, 32, padding=0, on_host=True),
    ConvLayer("conv2", 64, 64, 30, 30, padding=0),
    ConvLayer("conv3", 64, 128, 14, 14, padding=0),
    ConvLayer("conv4", 128, 128, 12, 12, padding=0),
    ConvLayer("conv5", 128, 256, 5, 5, padding=0),
    ConvLayer("conv6", 256, 256, 3, 3, padding=0),
    LinearLayer("fc1", 256, 512),
    LinearLayer("fc2", 512, 512),
    LinearLayer("fc3", 512, 10),
]

CNV_PAPER_FPS = {(1, 1): 61035, (1, 2): 30517, (2, 2): 15258}
RESNET50_PAPER = {"fps": 2296, "fps_per_watt": 106.8, "bits": (1, 2)}


def resnet50_layers() -> List:
    """ResNet-50 (ImageNet 224x224) conv stack; first conv + fc on host."""
    layers: List = [ConvLayer("conv1", 3, 64, 224, 224, fh=7, fw=7, stride=2,
                              padding=3, on_host=True)]
    # (blocks, c_in of stage, bottleneck width, stride of first block, H in)
    cfg = [(3, 64, 64, 1, 56), (4, 256, 128, 2, 56),
           (6, 512, 256, 2, 28), (3, 1024, 512, 2, 14)]
    for si, (blocks, c_in, width, stride, h) in enumerate(cfg):
        for b in range(blocks):
            s = stride if b == 0 else 1
            cin = c_in if b == 0 else width * 4
            hh = h if b == 0 else h // stride
            layers += [
                ConvLayer(f"s{si}b{b}_1x1a", cin, width, hh, hh, fh=1, fw=1,
                          stride=s, padding=0),
                ConvLayer(f"s{si}b{b}_3x3", width, width, hh // s, hh // s),
                ConvLayer(f"s{si}b{b}_1x1b", width, width * 4, hh // s,
                          hh // s, fh=1, fw=1, padding=0),
            ]
            if b == 0:
                layers.append(ConvLayer(f"s{si}b{b}_proj", cin, width * 4,
                                        hh, hh, fh=1, fw=1, stride=s,
                                        padding=0))
    layers.append(LinearLayer("fc", 2048, 1000, on_host=True))
    return layers
