"""MVU job model: AGU loop nests and CSR-style job configuration (paper
§3.1.3 / §3.2).

The FPGA MVU is programmed through 74 CSRs: operand precisions, base
addresses, AGU loop lengths/jumps (up to five nested loops per RAM), and
pipeline-module selects. We keep those semantics as plain dataclasses — they
drive the cycle model:

* :mod:`repro_torch.core.cost_model` — cycle counts (paper Table 3/5/6),
* :mod:`repro_torch.core.codegen`   — the command stream emitted for the
  controller, which :mod:`repro_torch.runtime.controller` simulates.

The port's copy of ``repro/core/mvu.py`` (pure Python, no torch).
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Optional, Sequence, Tuple

__all__ = ["OpKind", "AGULoop", "AGUConfig", "MVUJob", "gemv_job", "conv2d_job",
           "LANES", "MVU_COUNT"]

#: vector width of one MVU (64 input lanes x 64 VVPs on the FPGA).
LANES = 64
#: MVUs in the base configuration.
MVU_COUNT = 8


class OpKind(str, enum.Enum):
    GEMV = "gemv"
    CONV2D = "conv2d"
    MAXPOOL = "maxpool"
    RELU = "relu"
    REQUANT = "requant"
    XFER = "xfer"          # interconnect send to another MVU
    HOST = "host"          # first/last layer computed on host/controller


@dataclasses.dataclass(frozen=True)
class AGULoop:
    """One level of an address-generation loop: iteration count + the signed
    word jump applied on every iteration (paper: 'small accumulators ...
    forward or backward address jumps')."""

    length: int
    jump: int = 1


@dataclasses.dataclass(frozen=True)
class AGUConfig:
    """Up to five nested loops driving one RAM port."""

    loops: Tuple[AGULoop, ...]
    base: int = 0

    def __post_init__(self):
        if len(self.loops) > 5:
            raise ValueError("AGU supports at most 5 nested loops")

    @property
    def total_iters(self) -> int:
        n = 1
        for l in self.loops:
            n *= max(1, l.length)
        return n

    def addresses(self, limit: Optional[int] = None):
        """Generate the walked address sequence (for layout tests)."""
        seq = []

        def rec(level: int, addr: int):
            if limit is not None and len(seq) >= limit:
                return addr
            if level == len(self.loops):
                seq.append(addr)
                return addr
            loop = self.loops[level]
            for i in range(loop.length):
                addr = rec(level + 1, addr)
                if i != loop.length - 1:
                    addr += loop.jump
            return addr

        rec(0, self.base)
        return seq


@dataclasses.dataclass(frozen=True)
class MVUJob:
    """One command-stream job — the CSR image written by a hart before it
    triggers the MVU and waits for the completion interrupt."""

    op: OpKind
    mvu: int                       # target MVU / executor id
    a_bits: int = 8
    w_bits: int = 8
    a_signed: bool = True
    w_signed: bool = True
    out_bits: int = 8
    # logical tensor geometry (used by the cost model)
    m_tiles: int = 1               # output-channel (row) tile count
    k_tiles: int = 1               # reduction tile count per output element
    n_outputs: int = 1             # output elements computed (per lane group)
    agu_act: Optional[AGUConfig] = None
    agu_wgt: Optional[AGUConfig] = None
    use_scaler: bool = True
    use_pool: bool = False
    use_relu: bool = True
    dest_mvu: Optional[int] = None  # interconnect destination (None = self)
    tag: str = ""                  # layer name for traceability
    depends_on: Tuple[int, ...] = ()

    @property
    def tile_ops(self) -> int:
        """64x64 tile MACs issued by this job."""
        return self.m_tiles * self.k_tiles * self.n_outputs

    @property
    def cycles(self) -> int:
        """MVU cycles: b_a*b_w per tile (paper §3.1.1), fully pipelined."""
        if self.op in (OpKind.HOST, OpKind.XFER):
            return 0
        return self.a_bits * self.w_bits * self.tile_ops


def _tiles(n: int, lanes: int = LANES) -> int:
    return max(1, math.ceil(n / lanes))


def gemv_job(mvu: int, k: int, n: int, a_bits: int, w_bits: int,
             tag: str = "", lanes: int = LANES, **kw) -> MVUJob:
    """GEMV job: weights (K, N) walked as 64x64 tiles — two nested AGU loops
    (paper §3.1.3)."""
    kt, nt = _tiles(k, lanes), _tiles(n, lanes)
    agu_w = AGUConfig(loops=(AGULoop(nt, kt * w_bits), AGULoop(kt * w_bits, 1)))
    agu_a = AGUConfig(loops=(AGULoop(nt, -(kt * a_bits - 1) if kt * a_bits > 1 else 0),
                             AGULoop(kt * a_bits, 1)))
    return MVUJob(op=OpKind.GEMV, mvu=mvu, a_bits=a_bits, w_bits=w_bits,
                  m_tiles=nt, k_tiles=kt, n_outputs=1,
                  agu_act=agu_a, agu_wgt=agu_w, tag=tag, **kw)


def conv2d_job(mvu: int, h: int, w: int, c_in: int, c_out: int,
               fh: int, fw: int, a_bits: int, w_bits: int, stride: int = 1,
               padding: int = 1, tag: str = "", lanes: int = LANES,
               pad_skip: bool = True, **kw) -> MVUJob:
    """Conv2D job: one output row per job on the FPGA; we fold all rows into
    one job and keep the row structure in the AGU loops (4 nested loops).

    ``pad_skip``: the AGU skips kernel rows that fall entirely into vertical
    zero padding (the scheme that makes the paper's Table 3 counts come in
    under the dense product — see benchmarks/table3).
    """
    ho = (h + 2 * padding - fh) // stride + 1
    wo = (w + 2 * padding - fw) // stride + 1
    cit, cot = _tiles(c_in, lanes), _tiles(c_out, lanes)
    # kernel-row iterations over the output map, with vertical-padding skip
    if pad_skip and padding > 0:
        row_iters = 0
        for oy in range(ho):
            iy0 = oy * stride - padding
            valid = sum(1 for f in range(fh) if 0 <= iy0 + f < h)
            row_iters += valid
        fh_eff_total = row_iters  # sum over output rows of valid kernel rows
    else:
        fh_eff_total = ho * fh
    n_out = fh_eff_total * wo * fw  # horizontal padding is zero-stuffed, not skipped
    agu_w = AGUConfig(loops=(AGULoop(cot, 1), AGULoop(fh, 1), AGULoop(fw, 1),
                             AGULoop(cit * w_bits, 1)))
    agu_a = AGUConfig(loops=(AGULoop(ho, w), AGULoop(fh, w), AGULoop(fw, 1),
                             AGULoop(cit * a_bits, 1)))
    return MVUJob(op=OpKind.CONV2D, mvu=mvu, a_bits=a_bits, w_bits=w_bits,
                  m_tiles=cot, k_tiles=cit, n_outputs=n_out,
                  agu_act=agu_a, agu_wgt=agu_w, tag=tag, **kw)
