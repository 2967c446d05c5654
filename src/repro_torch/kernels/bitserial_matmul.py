"""K3 and K4: bit-serial GEMMs over bit-transposed packed weights, with the
fused scaler → bias → ReLU → requant (→ pack) epilogue.

Counterpart of ``repro/kernels/bitserial_matmul.py``. One CUDA source
(``csrc/bitserial_matmul.cu``) holds both kernels, one int8 tensor-core
tile (``csrc/digits.cuh``, shared with K2) fed by two activation sources:

* K3 replaces ``bitserial_matmul_v2_pallas``: packed activations
  ``(a_bits, M, ceil(K/32))`` × packed weights ``(w_bits, ceil(K/32), N)``
  → float32 ``(M, N)``, codes ``clip(round(out / rs))`` (int8 for
  ``requant.bits <= 8``, else int32), or, with ``emit_packed``, the codes'
  planes ``(requant.bits, M, ceil(N/32))`` — the next layer's input. The
  kernel expands the activation planes into int8 digits in registers.
  Plain version :func:`bitserial_matmul_v2_ref` (the reference's XLA
  oracle ``serial_matmul_packed_acts`` + ``_epilogue_xla``).
* K4 replaces ``bitserial_matmul_pallas``: int32 codes ``(M, K)`` × the
  same packed weights. The kernel reads each code straight into an int8
  digit (masked to ``a_bits`` and sign-extended as the reference does; at
  A8 the code's low byte), with no planes packed. ``scale`` folds any
  requant step, so requant is ``clip(round(out))`` with no divide; its
  codes are int8 when ``requant.bits <= 8`` and otherwise ``out_dtype``
  (the reference kernel's output type, ``bitserial_matmul.py:218``). A
  float output is float32 cast once to ``out_dtype``. Plain version
  :func:`bitserial_matmul_ref`. Its C entry keeps the name
  ``bitserial_matmul_v1``, under which its launches are counted.

* Grouped K4 replaces the routed experts' product of
  ``repro/models/moe.py::_expert_matmul``, which the reference computes as
  ``serial_matmul_packed`` under ``vmap`` over experts, outside any Pallas
  kernel: (E, C, K) int32 codes × (E, w_bits, ceil(K/32), N) packed
  weights → (E, C, N) raw int32 accumulators, one launch for all E experts.
  A kernel of its own (``csrc/grouped_matmul.cu``, :data:`GROUPED`): one
  block per (expert, row tile, 128-column tile), the tile's codes staged
  once as digits, the weights streamed through a shared-memory ring, and
  a row tile whose codes are all zero (an expert the dispatch left empty)
  reading no weight. No epilogue: the caller scales in torch, as the
  reference does. Plain version :func:`bitserial_matmul_grouped_ref`,
  ``serial_matmul_packed`` per expert. C entry
  ``bitserial_matmul_v1_grouped``.

:func:`bitserial_matmul_v2`, :func:`bitserial_matmul` and
:func:`bitserial_matmul_grouped` dispatch on the tensor's device: the
plain version for a CPU tensor, the kernel for a CUDA tensor, the kernel
wrapper's checks and output shape for a ``meta`` tensor (no launch).
K3 and K4 take ``tile=`` (rows per block and K-split warps,
:mod:`repro_torch.kernels.tuning`); None is the kernel's own heuristic.
With ``raw_acc=True`` they skip the epilogue (the epilogue's ``kAcc``
mode, which grouped K4 always runs) and return the raw (M, N) int32
accumulator; ``scale`` is then None and no bias, ReLU or requant is
given. A row-parallel projection on a mesh sums those accumulators over
its ranks and runs the epilogue once (``models/layers.py``).
Each counts as one op of an active
:class:`~repro_torch.launch.hlo_analysis.CostMode`, with its work:
2·M·N·K times both operands' ``kernel_digits`` integer FLOPs. Both
epilogues are one FMA, as the reference's are under ``jit`` and in its
Pallas kernels (interpreted too).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import bitops
from repro_torch.core.bitserial import (SerialSpec, serial_matmul_packed,
                                        serial_matmul_packed_acts)
from repro_torch.core.quant import QuantSpec, qrange
from repro_torch.kernels._build import I, Kernel, P
from repro_torch.kernels.tuning import launch_args
from repro_torch.launch import hlo_analysis as cost
from repro_torch.kernels.epilogue import (ACC, CODES8, CODES32, FLOAT,
                                          PACKED, check_operand,
                                          check_raw_acc, codes_dtype,
                                          epilogue, per_channel,
                                          requant_scale_tensor)

__all__ = ["KERNEL", "GROUPED", "bitserial_matmul_v2",
           "bitserial_matmul_v2_ref", "bitserial_matmul_v2_cuda",
           "bitserial_matmul",
           "bitserial_matmul_ref", "bitserial_matmul_cuda",
           "bitserial_matmul_grouped", "bitserial_matmul_grouped_ref",
           "bitserial_matmul_grouped_cuda"]

KERNEL = Kernel("bitserial_matmul", {
    "bitserial_matmul_v2": (P,) * 6 + (I,) * 16 + (P,),
    "bitserial_matmul_v1": (P,) * 5 + (I,) * 16 + (P,),
})
GROUPED = Kernel("grouped_matmul", {
    "bitserial_matmul_v1_grouped": (P,) * 3 + (I,) * 10 + (P,),
})


def _k_words(k: int) -> int:
    return -(-k // 32)


def bitserial_matmul_v2_ref(x_packed: torch.Tensor, w_packed: torch.Tensor,
                            scale: torch.Tensor,
                            bias: Optional[torch.Tensor] = None, *,
                            spec: SerialSpec, k: int, relu: bool = False,
                            requant: Optional[QuantSpec] = None,
                            requant_scale=None,
                            emit_packed: bool = False,
                            tile=None, raw_acc: bool = False) -> torch.Tensor:
    """Plain version of K3, on any device; ``tile`` is ignored (the result
    does not depend on it). ``raw_acc``: the accumulator it computes,
    with no epilogue."""
    if raw_acc:
        check_raw_acc("bitserial_matmul_v2", scale, bias, relu, requant,
                      emit_packed)
    if emit_packed and requant is None:
        raise ValueError("emit_packed requires requant")
    acc = serial_matmul_packed_acts(x_packed, w_packed, spec=spec, k=k)
    if raw_acc:
        return acc
    return epilogue(acc, scale, bias, relu=relu, requant=requant,
                    requant_scale=requant_scale, emit_packed=emit_packed)


def bitserial_matmul_ref(x: torch.Tensor, w_packed: torch.Tensor,
                         scale: torch.Tensor,
                         bias: Optional[torch.Tensor] = None, *,
                         spec: SerialSpec, k: int, relu: bool = False,
                         out_dtype: torch.dtype = torch.float32,
                         requant: Optional[QuantSpec] = None,
                         tile=None, raw_acc: bool = False) -> torch.Tensor:
    """Plain version of K4, on any device; ``tile`` is ignored.
    ``raw_acc``: the accumulator it computes, with no epilogue."""
    if raw_acc:
        check_raw_acc("bitserial_matmul", scale, bias, relu, requant)
    if x.shape[-1] != k:
        raise ValueError(f"x has K={x.shape[-1]}, caller declared k={k}")
    acc = serial_matmul_packed(x.to(torch.int32), w_packed, spec=spec, k=k)
    if raw_acc:
        return acc
    out = epilogue(acc, scale, bias, relu=relu, requant=requant, divide=False)
    if requant is not None and requant.bits <= 8:
        return out
    return out.to(out_dtype)


def bitserial_matmul_grouped_ref(x: torch.Tensor, w_packed: torch.Tensor,
                                 *, spec: SerialSpec, k: int) -> torch.Tensor:
    """Plain version of grouped K4, on any device: ``serial_matmul_packed``
    of each expert's (C, K) codes against its packed weights, stacked to
    (E, C, N) int32."""
    if x.dim() != 3 or w_packed.dim() != 4 or x.shape[0] != w_packed.shape[0]:
        raise ValueError(f"grouped: x {tuple(x.shape)} and w_packed "
                         f"{tuple(w_packed.shape)} are not (E, C, K) and "
                         "(E, w_bits, ceil(K/32), N)")
    if x.shape[-1] != k:
        raise ValueError(f"x has K={x.shape[-1]}, caller declared k={k}")
    return torch.stack([
        serial_matmul_packed(x[e].to(torch.int32), w_packed[e], spec=spec,
                             k=k) for e in range(x.shape[0])])


def _check_weights(fn: str, w_packed: torch.Tensor, spec: SerialSpec, k: int,
                   dev: torch.device) -> int:
    check_operand(fn, "w_packed", w_packed, torch.int32, 3, dev)
    bw, kw, n = w_packed.shape
    if bw != spec.w_bits:
        raise ValueError(f"{fn}: w_packed carries {bw} bit-planes, spec wants "
                         f"w_bits={spec.w_bits}")
    if kw != _k_words(k):
        raise ValueError(f"{fn}: K-word mismatch: w {kw}, ceil(k/32)="
                         f"{_k_words(k)}")
    return n


def _scale_bias(fn: str, scale, bias, n: int, dev: torch.device):
    if scale is None:            # raw_acc: no epilogue reads them
        return None, None
    scale = per_channel(fn, "scale", scale, n, dev)
    bias = None if bias is None else per_channel(fn, "bias", bias, n, dev)
    return scale, bias


def bitserial_matmul_v2_cuda(x_packed: torch.Tensor, w_packed: torch.Tensor,
                             scale: torch.Tensor,
                             bias: Optional[torch.Tensor] = None, *,
                             spec: SerialSpec, k: int, relu: bool = False,
                             requant: Optional[QuantSpec] = None,
                             requant_scale=None,
                             emit_packed: bool = False,
                             tile=None, raw_acc: bool = False) -> torch.Tensor:
    """Launch K3 on CUDA tensors (same contract as the plain version).

    ``tile``: a :class:`~repro_torch.kernels.tuning.TileConfig` (rows per
    block and K-split warps), or None for the kernel's own heuristic; a
    tile the instantiation does not take raises at launch."""
    fn = "bitserial_matmul_v2"
    if raw_acc:
        check_raw_acc(fn, scale, bias, relu, requant, emit_packed)
    elif scale is None:
        raise ValueError(f"{fn}: scale is None without raw_acc")
    if emit_packed and requant is None:
        raise ValueError("emit_packed requires requant")
    dev = x_packed.device
    check_operand(fn, "x_packed", x_packed, torch.int32, 3, dev)
    ba, m, kw = x_packed.shape
    if ba != spec.a_bits:
        raise ValueError(f"{fn}: x_packed carries {ba} bit-planes, spec "
                         f"wants a_bits={spec.a_bits}")
    if kw != _k_words(k):
        raise ValueError(f"{fn}: K-word mismatch: x {kw}, ceil(k/32)="
                         f"{_k_words(k)}")
    n = _check_weights(fn, w_packed, spec, k, dev)
    scale, bias = _scale_bias(fn, scale, bias, n, dev)
    qn = qp = rq_bits = 0
    rs = None
    if raw_acc:
        mode = ACC
        out = torch.empty((m, n), dtype=torch.int32, device=dev)
    elif requant is None:
        mode = FLOAT
        out = torch.empty((m, n), dtype=torch.float32, device=dev)
    else:
        rq_bits = requant.bits
        qn, qp = qrange(requant.bits, requant.signed)
        rs = requant_scale_tensor(requant_scale, dev)
        if rs.numel() != 1:
            raise ValueError(f"{fn}: requant_scale must be scalar")
        if emit_packed:
            mode = PACKED
            out = torch.empty((rq_bits, m, -(-n // 32)), dtype=torch.int32,
                              device=dev)
        else:
            dt = codes_dtype(requant)
            mode = CODES8 if dt == torch.int8 else CODES32
            out = torch.empty((m, n), dtype=dt, device=dev)
    if dev.type == "meta":
        return out
    stream = torch.cuda.current_stream(dev).cuda_stream
    KERNEL.launch(
        "bitserial_matmul_v2", x_packed.data_ptr(), w_packed.data_ptr(),
        None if scale is None else scale.data_ptr(),
        None if bias is None else bias.data_ptr(),
        None if rs is None else rs.data_ptr(), out.data_ptr(), m, k, n,
        spec.a_bits, spec.w_bits, int(spec.a_signed), int(spec.w_signed),
        bitops.kernel_digits(spec.a_bits, spec.a_signed),
        bitops.kernel_digits(spec.w_bits, spec.w_signed),
        int(relu), mode, rq_bits, qn, qp, *launch_args(tile), stream)
    return out


def bitserial_matmul_cuda(x: torch.Tensor, w_packed: torch.Tensor,
                          scale: torch.Tensor,
                          bias: Optional[torch.Tensor] = None, *,
                          spec: SerialSpec, k: int, relu: bool = False,
                          out_dtype: torch.dtype = torch.float32,
                          requant: Optional[QuantSpec] = None,
                          tile=None, raw_acc: bool = False) -> torch.Tensor:
    """Launch K4 on a CUDA ``(M, K)`` int32 code tensor (same contract as
    the plain version; ``tile`` as K3's)."""
    fn = "bitserial_matmul"
    if raw_acc:
        check_raw_acc(fn, scale, bias, relu, requant)
    elif scale is None:
        raise ValueError(f"{fn}: scale is None without raw_acc")
    dev = x.device
    check_operand(fn, "x", x, torch.int32, 2, dev)
    m, kx = x.shape
    if kx != k:
        raise ValueError(f"{fn}: x has K={kx}, caller declared k={k}")
    n = _check_weights(fn, w_packed, spec, k, dev)
    scale, bias = _scale_bias(fn, scale, bias, n, dev)
    qn = qp = rq_bits = 0
    if raw_acc:
        mode = ACC
        out = torch.empty((m, n), dtype=torch.int32, device=dev)
    elif requant is None:
        mode = FLOAT
        out = torch.empty((m, n), dtype=torch.float32, device=dev)
    else:
        rq_bits = requant.bits
        qn, qp = qrange(requant.bits, requant.signed)
        dt = codes_dtype(requant)
        mode = CODES8 if dt == torch.int8 else CODES32
        out = torch.empty((m, n), dtype=dt, device=dev)
    if dev.type != "meta":
        stream = torch.cuda.current_stream(dev).cuda_stream
        KERNEL.launch(
            "bitserial_matmul_v1", x.data_ptr(), w_packed.data_ptr(),
            None if scale is None else scale.data_ptr(),
            None if bias is None else bias.data_ptr(),
            out.data_ptr(), m, k, n, spec.a_bits, spec.w_bits,
            int(spec.a_signed), int(spec.w_signed),
            bitops.kernel_digits(spec.a_bits, spec.a_signed),
            bitops.kernel_digits(spec.w_bits, spec.w_signed),
            int(relu), mode, rq_bits, qn, qp, *launch_args(tile), stream)
    if raw_acc or (requant is not None and requant.bits <= 8):
        return out
    return out.to(out_dtype)


def bitserial_matmul_grouped_cuda(x: torch.Tensor, w_packed: torch.Tensor,
                                  *, spec: SerialSpec, k: int) -> torch.Tensor:
    """Launch grouped K4 on CUDA tensors: (E, C, K) int32 codes × (E,
    w_bits, ceil(K/32), N) packed weights → (E, C, N) int32 accumulators,
    one launch."""
    fn = "bitserial_matmul_grouped"
    dev = x.device
    check_operand(fn, "x", x, torch.int32, 3, dev)
    check_operand(fn, "w_packed", w_packed, torch.int32, 4, dev)
    e, c, kx = x.shape
    ew, bw, kw, n = w_packed.shape
    if kx != k:
        raise ValueError(f"{fn}: x has K={kx}, caller declared k={k}")
    if ew != e:
        raise ValueError(f"{fn}: x has {e} groups, w_packed {ew}")
    if not 1 <= e <= 65535:
        raise ValueError(f"{fn}: {e} groups, the grid takes 1..65535")
    if bw != spec.w_bits:
        raise ValueError(f"{fn}: w_packed carries {bw} bit-planes, spec wants "
                         f"w_bits={spec.w_bits}")
    if kw != _k_words(k):
        raise ValueError(f"{fn}: K-word mismatch: w {kw}, ceil(k/32)="
                         f"{_k_words(k)}")
    out = torch.empty((e, c, n), dtype=torch.int32, device=dev)
    if dev.type == "meta":
        return out
    stream = torch.cuda.current_stream(dev).cuda_stream
    GROUPED.launch(
        "bitserial_matmul_v1_grouped", x.data_ptr(), w_packed.data_ptr(),
        out.data_ptr(), e, c, k, n, spec.a_bits, spec.w_bits,
        int(spec.a_signed), int(spec.w_signed),
        bitops.kernel_digits(spec.a_bits, spec.a_signed),
        bitops.kernel_digits(spec.w_bits, spec.w_signed), stream)
    return out


def _flops(m: int, n: int, k: int, spec: SerialSpec) -> tuple:
    """K2-K4's ``(flops_int, flops_logical)``: the digit products the
    int8 tensor cores issue, and 2·M·N·K."""
    return cost.gemm_flops(m, n, k,
                           bitops.kernel_digits(spec.a_bits, spec.a_signed),
                           bitops.kernel_digits(spec.w_bits, spec.w_signed))


def bitserial_matmul_v2(x_packed: torch.Tensor, w_packed: torch.Tensor,
                        scale: torch.Tensor,
                        bias: Optional[torch.Tensor] = None,
                        **kw) -> torch.Tensor:
    """K3 on CUDA tensors (its output's shape on ``meta``), its plain
    version on CPU tensors; one op of an active
    :class:`~repro_torch.launch.hlo_analysis.CostMode`."""
    if cost.ACTIVE.mode is not None:
        return cost.ACTIVE.mode.kernel(
            "K3", bitserial_matmul_v2, (x_packed, w_packed, scale, bias), kw,
            *_flops(x_packed.shape[1], w_packed.shape[-1], kw["k"],
                    kw["spec"]))
    if x_packed.is_cuda or x_packed.is_meta:
        return bitserial_matmul_v2_cuda(x_packed, w_packed, scale, bias, **kw)
    return bitserial_matmul_v2_ref(x_packed, w_packed, scale, bias, **kw)


def bitserial_matmul(x: torch.Tensor, w_packed: torch.Tensor,
                     scale: torch.Tensor, bias: Optional[torch.Tensor] = None,
                     **kw) -> torch.Tensor:
    """K4 on CUDA tensors (its output's shape on ``meta``), its plain
    version on CPU tensors; one op of an active ``CostMode``."""
    if cost.ACTIVE.mode is not None:
        return cost.ACTIVE.mode.kernel(
            "K4", bitserial_matmul, (x, w_packed, scale, bias), kw,
            *_flops(x.shape[0], w_packed.shape[-1], kw["k"], kw["spec"]))
    if x.is_cuda or x.is_meta:
        return bitserial_matmul_cuda(x, w_packed, scale, bias, **kw)
    return bitserial_matmul_ref(x, w_packed, scale, bias, **kw)


def bitserial_matmul_grouped(x: torch.Tensor, w_packed: torch.Tensor, *,
                             spec: SerialSpec, k: int) -> torch.Tensor:
    """Grouped K4 on CUDA tensors (its output's shape on ``meta``), its
    plain version on CPU tensors; one op of an active ``CostMode``."""
    if cost.ACTIVE.mode is not None:
        return cost.ACTIVE.mode.kernel(
            "K4g", bitserial_matmul_grouped, (x, w_packed),
            {"spec": spec, "k": k},
            *_flops(x.shape[0] * x.shape[1], w_packed.shape[-1], k, spec))
    if x.is_cuda or x.is_meta:
        return bitserial_matmul_grouped_cuda(x, w_packed, spec=spec, k=k)
    return bitserial_matmul_grouped_ref(x, w_packed, spec=spec, k=k)
