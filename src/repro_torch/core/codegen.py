"""Code generator: layer graph → controller command stream (paper §3.3).

The FPGA flow is ONNX → RISC-V binary. Our flow is a small layer-graph IR →
:class:`CommandStream` of :class:`~repro_torch.core.mvu.MVUJob` CSR images,
plus a bit-transposed weight export. The stream is simulated by
:mod:`repro_torch.runtime.controller`, costed by
:mod:`repro_torch.core.cost_model` and checked by
:mod:`repro_torch.analysis.verify_stream`; the serving scheduler books one
per batch and the continuous LM engine one per decode step.

The port's copy of ``repro/core/codegen.py``. ``export_weights`` packs
through the port's own :func:`~repro_torch.core.quant.pack_weights`
(int32 words holding the reference's uint32 bits).

Supported ops match the paper: GEMV/GEMM, Conv2D, MaxPool, ReLU, requantize.
Mapping modes (§3.1.6):

* ``pipelined``   — layer *i* → MVU ``i % 8``; output streamed to the next
  MVU over the interconnect (XFER job). Throughput-optimal.
* ``distributed`` — every layer split into 8 row-regions, one per MVU, all
  sharing the same weights; a barrier joins the regions. Latency-optimal.

Like the paper's current generator, graph-level optimizations are not
applied; unlike it, both execution modes are emitted (the paper's generator
supports pipelined only).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.cost_model import ConvLayer, LinearLayer
from repro_torch.core.mvu import (MVUJob, OpKind, conv2d_job, gemv_job,
                                  MVU_COUNT)
from repro_torch.core.quant import QuantSpec, pack_weights

__all__ = ["CommandStream", "generate", "export_weights"]


@dataclasses.dataclass
class CommandStream:
    """The executable artifact: ordered jobs + exported weight images."""

    jobs: List[MVUJob]
    mode: str
    weights: Dict[str, object] = dataclasses.field(default_factory=dict)

    @property
    def per_mvu_cycles(self) -> List[int]:
        out = [0] * MVU_COUNT
        for j in self.jobs:
            out[j.mvu % MVU_COUNT] += j.cycles
        return out

    def total_cycles_pipelined(self) -> int:
        return max(self.per_mvu_cycles)

    def total_cycles_distributed(self) -> int:
        return max(self.per_mvu_cycles)  # balanced split -> same expression

    def summary(self) -> str:
        lines = [f"mode={self.mode} jobs={len(self.jobs)}"]
        for j in self.jobs:
            lines.append(
                f"  mvu{j.mvu} {j.op.value:8s} {j.tag:12s} "
                f"A{j.a_bits}/W{j.w_bits} tiles={j.tile_ops} cyc={j.cycles}")
        return "\n".join(lines)

    def verify(self, **kw):
        """Hazard/resource check this stream (see
        :func:`repro_torch.analysis.verify_stream.verify_stream`); returns
        the reconciliation :class:`~repro_torch.runtime.controller.SimReport`."""
        from repro_torch.analysis.verify_stream import verify_stream
        return verify_stream(self, **kw)


def _layer_job(layer, mvu: int, a_bits: int, w_bits: int,
               job_id: int, deps: Tuple[int, ...]) -> MVUJob:
    # Duck-typed so lowered compiler nodes (a LoweredConv / LoweredGemm of
    # the compiler) map too: a fused conv+relu+requant epilogue is ONE
    # CONV2D job with the scaler/ReLU/QuantSer pipeline modules enabled —
    # the epilogue is free on the MVU (paper §3.1.4), not a separate op.
    kind = getattr(layer, "kind", None)
    if isinstance(layer, ConvLayer) or kind == "conv2d":
        return conv2d_job(mvu, layer.h, layer.w, layer.c_in, layer.c_out,
                          layer.fh, layer.fw, a_bits, w_bits,
                          stride=layer.stride, padding=layer.padding,
                          tag=layer.name, depends_on=deps,
                          use_relu=bool(getattr(layer, "relu", True)))
    if isinstance(layer, LinearLayer) or kind == "gemm":
        return gemv_job(mvu, layer.k, layer.n, a_bits, w_bits,
                        tag=layer.name, depends_on=deps,
                        use_relu=bool(getattr(layer, "relu", True)))
    raise TypeError(type(layer))


def generate(layers: Sequence, *, mode: str = "pipelined",
             a_bits: int = 2, w_bits: int = 2,
             per_layer_bits: Optional[Dict[str, Tuple[int, int]]] = None,
             ) -> CommandStream:
    """Emit the command stream for a sequential CNN/MLP graph.

    ``layers`` is a sequence of cost-model layers (:class:`ConvLayer` /
    :class:`LinearLayer`), a sequence of lowered compiler nodes, or a
    compiled Program directly (one that carries ``cost_nodes``) — a Program
    contributes its ``cost_nodes`` and its per-node precision annotations
    (explicit ``per_layer_bits`` entries still override).

    ``per_layer_bits``: optional {layer_name: (a_bits, w_bits)} mixed
    precision map — each MVU is configured independently (paper §3.1.1).
    """
    cost_nodes = getattr(layers, "cost_nodes", None)
    if cost_nodes is not None:  # a compiled Program
        per_layer_bits = {**getattr(layers, "per_layer_bits", {}),
                          **(per_layer_bits or {})}
        layers = cost_nodes
    jobs: List[MVUJob] = []
    per_layer_bits = per_layer_bits or {}

    def bits_for(name: str) -> Tuple[int, int]:
        return per_layer_bits.get(name, (a_bits, w_bits))

    prev_ids: Tuple[int, ...] = ()
    mvu_cursor = 0
    for layer in layers:
        ab, wb = bits_for(layer.name)
        if getattr(layer, "on_host", False):
            jobs.append(MVUJob(op=OpKind.HOST, mvu=-1, tag=layer.name,
                               depends_on=prev_ids))
            prev_ids = (len(jobs) - 1,)
            continue
        if mode == "pipelined":
            mvu = mvu_cursor % MVU_COUNT
            mvu_cursor += 1
            j = _layer_job(layer, mvu, ab, wb, len(jobs), prev_ids)
            jobs.append(j)
            # stream results to the next MVU via the crossbar
            jobs.append(MVUJob(op=OpKind.XFER, mvu=mvu,
                               dest_mvu=mvu_cursor % MVU_COUNT,
                               tag=f"{layer.name}->next",
                               depends_on=(len(jobs) - 1,)))
            prev_ids = (len(jobs) - 1,)
        elif mode == "distributed":
            # split the layer's output rows into MVU_COUNT regions
            region_ids = []
            for r in range(MVU_COUNT):
                j = _layer_job(layer, r, ab, wb, len(jobs), prev_ids)
                # each region does ~1/8 of the positions
                j = dataclasses.replace(
                    j, n_outputs=max(1, j.n_outputs // MVU_COUNT),
                    tag=f"{layer.name}@r{r}")
                jobs.append(j)
                region_ids.append(len(jobs) - 1)
            prev_ids = tuple(region_ids)  # barrier
        else:
            raise ValueError(mode)
    return CommandStream(jobs=jobs, mode=mode)


def export_weights(params: Dict[str, torch.Tensor], *, w_bits: int = 2,
                   per_layer_bits: Optional[Dict[str, int]] = None
                   ) -> Dict[str, object]:
    """Toolchain weight export: float weights → bit-transposed packed images
    (64x64-tile padded), as loaded into the weight RAMs. Conv weights are
    reshaped to (Ci*FH*FW, Co) GEMM layout first (C_o,s F_H F_W C_b, §3.1.2).
    """
    per_layer_bits = per_layer_bits or {}
    out = {}
    for name, w in params.items():
        bits = per_layer_bits.get(name, w_bits)
        w = torch.as_tensor(w)
        if w.dim() == 4:  # (FH, FW, Ci, Co) -> (Ci, FH, FW, Co) -> (K, Co)
            fh, fw, ci, co = w.shape
            w = w.permute(2, 0, 1, 3).reshape(ci * fh * fw, co)
        spec = QuantSpec(bits, True, per_channel=True)
        out[name] = pack_weights(w, spec)
    return out
