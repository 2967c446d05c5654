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
(pure Python, no torch). The reference's other half, its TPU kernel cost
model (``TPUConfig``, ``vmem_budget_bytes``, ``kernel_cost``,
``conv_kernel_cost`` and their VMEM working sets), becomes the H100's tile
model of the int8 tensor-core kernels K2, K3 and K4
(``kernels/csrc/digits.cuh``): :class:`H100Config`,
:func:`smem_budget_bytes`, :func:`kernel_cost`, :func:`kernel_smem_bytes`,
:func:`conv_kernel_cost` and :func:`conv_kernel_smem_bytes`, which rank the
tiles :mod:`repro_torch.kernels.tuning` chooses from.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence

from repro_torch.core.mvu import LANES, MVU_COUNT

__all__ = ["HWConfig", "ConvLayer", "LinearLayer", "layer_cycles",
           "pipelined_fps", "distributed_fps", "network_cycles",
           "RESNET9_CIFAR10", "CNV_CIFAR10", "resnet50_layers",
           "H100Config", "smem_budget_bytes", "kernel_digits", "fixed_plans",
           "max_warps", "launch_bound_threads", "kernel_smem_bytes",
           "kernel_cost", "conv_live_words", "conv_kernel_smem_bytes",
           "conv_kernel_cost"]


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
# H100 tile model of the int8 tensor-core kernels (kernels/csrc/digits.cuh)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class H100Config:
    """What the tile model knows of one NVIDIA H100 SXM (NVIDIA's data
    sheet; the launch floor as ``PERF.md`` measured it on the card), and
    the per-word cycle counts and cache sizes it charges, fitted to a sweep
    of every tile at the main paths' shapes on the card
    (``kernels/tile_sweep.py --fit``). The tuner ranks tiles by it; its
    absolute seconds are a model's."""

    sms: int = 132
    hbm_bw: float = 3.35e12               # bytes/s
    int8_ops: float = 1.979e15            # dense int8 tensor-core ops/s
    smem_per_block: int = 227 * 1024      # shared memory a block may use
    regs_per_sm: int = 65536
    threads_per_sm: int = 2048
    blocks_per_sm: int = 32
    launch_s: float = 4.8e-6              # one launch's floor
    clock_hz: float = 1.98e9
    schedulers: int = 4                   # warp schedulers an SM
    l2_bytes: int = 50 * 2 ** 20
    # fitted to a sweep of every tile at the main paths' shapes on an
    # NVIDIA H100 80GB HBM3 at 700 W (kernels/tile_sweep.py --fit):
    # log-RMS error 0.159 over 416 tiles
    word_cycles: float = 1580.0    # one K word's dependent chain in a warp
    issue_word: float = 211.0      # a warp's issue per K word: fixed part,
    issue_w_plane: float = 3.6     # per weight plane and fragment column,
    issue_a_plane: float = 29.5    # per activation plane and row tile,
    issue_code: float = 88.8       # per code digit and row tile (K4)
    block_cycles: float = 3525.0   # a block's start, zeroing and fold
    row_cycles: float = 992.0      # one staged row's epilogue, a warp
    l2_bw: float = 3.31e12         # bytes/s from L2 to the SMs
    l1_bytes: int = 192 * 1024     # L1 an SM keeps activation lines in


def smem_budget_bytes(h100: "H100Config" = None) -> int:
    """The shared memory a tuned tile must fit under: the single budget
    the tuner enumerates with (:mod:`repro_torch.kernels.tuning`) and the
    program verifier re-checks (``tile-budget``,
    :mod:`repro_torch.analysis.verify_ir`)."""
    h100 = h100 or H100Config()
    return int(h100.smem_per_block)


# digits.cuh's constants that a tile's size and launch depend on
ROW_STRIDE = 36        # uint32 words per staged tile row (kRowStride)
_MAX_WARPS = {1: 32, 2: 16, 4: 4}   # fixed planes: max_warps<..., NT>()
_MAX_WARPS_ANY = 8
_MIN_BLOCKS_NT4 = 4    # kMinBlocksNT4: the NT = 4 launch bound's blocks


def kernel_digits(bits: int, signed: bool) -> int:
    """The int8 digits the kernels split an operand into: one for a
    signed operand of at most 8 bits, else radix 7 (the port's
    ``core/bitops.kernel_digits``, kept here without torch)."""
    return 1 if signed and bits <= 8 else max(1, -(-bits // 7))


def fixed_plans(a_bits: int, w_bits: int, a_signed: bool,
                w_signed: bool) -> bool:
    """Whether the plans get a fixed-plane instantiation (W2A2, A8W4, all
    signed: the main paths'); any other plan runs ``Any``."""
    return (a_signed and w_signed
            and (a_bits, w_bits) in ((2, 2), (8, 4)))


def max_warps(fixed: bool, nt: int) -> int:
    """The most K-split warps a block of the instantiation takes (its
    launch bound); raises for an NT it does not have (``Any``: 1 only)."""
    table = _MAX_WARPS if fixed else {1: _MAX_WARPS_ANY}
    if nt not in table:
        raise ValueError(f"no {'fixed-plane' if fixed else 'Any'} "
                         f"instantiation has NT={nt}")
    return table[nt]


def launch_bound_threads(fixed: bool, nt: int) -> int:
    """Threads a block of the instantiation may have (``__launch_bounds__``)."""
    return 32 * max_warps(fixed, nt)


def _regs_per_thread(fixed: bool, nt: int, h100: H100Config) -> int:
    """Registers the launch bound lets ptxas give a thread, allocated in
    eights (at most 255, rounded up to 256)."""
    blocks = _MIN_BLOCKS_NT4 if nt == 4 else 1
    regs = min(255, h100.regs_per_sm // (launch_bound_threads(fixed, nt)
                                         * blocks))
    return -(-regs // 8) * 8


def kernel_smem_bytes(nt: int) -> int:
    """Static shared memory of one block: the staged uint32 tile
    ``red[8 NT][ROW_STRIDE]`` (``digits.cuh``'s ``tile``)."""
    return 8 * nt * ROW_STRIDE * 4


def conv_kernel_smem_bytes(nt: int) -> int:
    """K2's block: the same staged tile (8 NT output pixels)."""
    return kernel_smem_bytes(nt)


def _residency(fixed: bool, nt: int, warps: int, h100: H100Config) -> int:
    """Blocks of the tile an SM holds at once: threads, registers (as the
    launch bound allots them), shared memory and the block limit."""
    threads = 32 * warps
    regs = _regs_per_thread(fixed, nt, h100)
    return max(1, min(h100.blocks_per_sm,
                      h100.threads_per_sm // threads,
                      h100.regs_per_sm // (regs * threads),
                      (h100.smem_per_block + 1024) // kernel_smem_bytes(nt)))


def _word_issue(a_planes: int, w_planes: int, nd_a: int, nt: int,
                codes: bool, h100: H100Config) -> float:
    """Issue cycles one warp spends on one K word: a fixed part, the
    weights' loads and expansion (4 fragment columns a lane), and the
    activations' (NT row tiles: planes for K2/K3, K4's codes per digit)."""
    act = h100.issue_code * nd_a if codes else h100.issue_a_plane * a_planes
    return h100.issue_word + 4 * w_planes * h100.issue_w_plane + nt * act


def _tile_seconds(rows: int, cols: int, words: int, live_words: int, *,
                  a_bits: int, w_bits: int, a_signed: bool, w_signed: bool,
                  nt: int, warps: int, codes: bool, in_bytes: int,
                  out_bytes: int, h100: H100Config) -> float:
    """Modeled seconds of one launch of the shared tile (see
    :func:`kernel_cost`)."""
    fixed = fixed_plans(a_bits, w_bits, a_signed, w_signed)
    most = max_warps(fixed, nt)
    if not 1 <= warps <= most:
        raise ValueError(f"{warps} warps: the NT={nt} instantiation takes "
                         f"1..{most}")
    nd_a, nd_w = kernel_digits(a_bits, a_signed), kernel_digits(w_bits,
                                                                 w_signed)
    a_planes = a_bits if fixed else 16
    row_blocks, col_blocks = -(-rows // (8 * nt)), -(-cols // 32)
    res = _residency(fixed, nt, warps, h100)
    # the busiest SM's blocks, in waves of `res` at once
    per_sm = -(-row_blocks * col_blocks // h100.sms)
    walk = -(-live_words // warps)          # K words of the busiest warp
    issue = _word_issue(a_planes, w_bits if fixed else 16, nd_a, nt, codes,
                        h100)
    tail = h100.block_cycles + -(-8 * nt // warps) * h100.row_cycles

    def wave(now):              # cycles of a wave of `now` blocks
        return max(walk * h100.word_cycles,
                   now * warps * walk * issue / h100.schedulers) + tail
    full, part = divmod(per_sm, res)
    compute = (full * wave(res) + (wave(part) if part else 0.0)) / h100.clock_hz
    # bytes: each operand once from HBM; the weights again per row block
    # and the activations per column block from L2, or from HBM when they
    # do not fit it. Plane words are 4 bytes of a 32-byte sector: when the
    # SM's resident row tiles' lines do not stay in L1, each warp's word
    # fetches its sector anew.
    w_bytes = w_bits * words * cols * 4
    fetch = in_bytes
    if not codes and res * 8 * nt * a_planes * 128 > h100.l1_bytes:
        fetch *= 8 / min(warps, 8)
    again = (row_blocks - 1) * w_bytes + (col_blocks - 1) * fetch
    hbm = w_bytes + in_bytes + out_bytes
    if in_bytes > h100.l2_bytes:
        hbm += (col_blocks - 1) * in_bytes
    memory = max(hbm / h100.hbm_bw, again / h100.l2_bw)
    ops = 2.0 * nd_a * nd_w * rows * words * 32 * cols
    return h100.launch_s + max(compute, memory, ops / h100.int8_ops)


def _out_bytes(rows: int, cols: int, out_bits: Optional[int]) -> int:
    return (out_bits * rows * (-(-cols // 32)) * 4 if out_bits
            else rows * cols * 4)


def kernel_cost(m: int, k: int, n: int, *, a_bits: int, w_bits: int,
                a_signed: bool = True, w_signed: bool = True, nt: int,
                warps: int, codes: bool = False,
                out_bits: Optional[int] = None,
                h100: H100Config = H100Config()) -> float:
    """Modeled seconds of one K3 launch (K4's with ``codes``) at tile
    (``nt`` row tiles of 8 rows, ``warps`` K-split warps) on an (m, k) x
    (k, n) product.

    Blocks = ceil(m / 8 NT) x ceil(n / 32); the busiest SM runs its share
    in waves of the blocks it holds at once (threads, and the registers
    the instantiation's launch bound allots). A wave takes the longer of
    its busiest warp's chain of K words (ceil(W / warps), one dependent
    memory round trip, expansion and mma each) and the SM's issue of every
    resident warp's words (the weights' 4 fragment columns and NT row
    tiles' loads and expansion, the mma per digit pair), plus each block's
    start, fold and epilogue rows. Against it stand the bytes (each
    operand once, the weights again per row block and the activations per
    column block, from L2), the int8 peak, and the launch floor."""
    words = -(-k // 32)
    in_bytes = m * k * 4 if codes else a_bits * m * words * 4
    return _tile_seconds(m, n, words, words, a_bits=a_bits, w_bits=w_bits,
                         a_signed=a_signed, w_signed=w_signed, nt=nt,
                         warps=warps, codes=codes, in_bytes=in_bytes,
                         out_bytes=_out_bytes(m, n, out_bits), h100=h100)


def conv_live_words(h: int, w: int, ci: int, *, fh: int, fw: int,
                    stride: int, padding: int) -> int:
    """K words (tap x channel word) that are real for some output pixel:
    a tap in the padding for every pixel is skipped by every warp (a
    1 x 1 map's 3 x 3 conv reads only its centre tap)."""
    ho = (h + 2 * padding - fh) // stride + 1
    wo = (w + 2 * padding - fw) // stride + 1

    def taps(size, out, f):
        return sum(1 for r in range(f)
                   if any(0 <= o * stride - padding + r < size
                          for o in range(out)))
    return taps(h, ho, fh) * taps(w, wo, fw) * (-(-ci // 32))


def conv_kernel_cost(n: int, h: int, w: int, ci: int, co: int, *, fh: int,
                     fw: int, stride: int, padding: int, a_bits: int,
                     w_bits: int, a_signed: bool = True,
                     w_signed: bool = True, nt: int, warps: int,
                     out_bits: Optional[int] = None,
                     h100: H100Config = H100Config()) -> float:
    """Modeled seconds of one K2 launch: :func:`kernel_cost`'s tile over
    rows = the N Ho Wo output pixels, columns = Co and K words = FH FW
    ceil(Ci/32), of which only :func:`conv_live_words` are walked."""
    ho = (h + 2 * padding - fh) // stride + 1
    wo = (w + 2 * padding - fw) // stride + 1
    words = fh * fw * (-(-ci // 32))
    live = conv_live_words(h, w, ci, fh=fh, fw=fw, stride=stride,
                           padding=padding)
    rows = n * ho * wo
    return _tile_seconds(rows, co, words, live, a_bits=a_bits, w_bits=w_bits,
                         a_signed=a_signed, w_signed=w_signed, nt=nt,
                         warps=warps, codes=False,
                         in_bytes=a_bits * n * h * w * (-(-ci // 32)) * 4,
                         out_bytes=_out_bytes(rows, co, out_bits), h100=h100)


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
