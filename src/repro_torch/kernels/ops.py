"""Dispatch wrappers around the packed kernels.

Counterpart of ``repro/kernels/ops.py``. Where the reference selects a
backend by name (``"xla"`` oracle or ``"pallas_v2"`` kernel), the port
selects by device: every function here runs the CUDA kernel for a tensor
on the card and the kernel's plain version for a tensor on the CPU (on
``meta``, the kernel's output shape). A CUDA tensor never reaches a plain
version through these functions; a kernel that does not build or launch
raises.

* :func:`pack_activations` — (..., K) integer codes → (a_bits, ...,
  ceil(K/32)) words (K1's codes entry);
* :func:`quantize_pack_activations` — (..., K) floats and a step size →
  the same planes (K1);
* :func:`quantize_pack_activations_multi` — (..., K) floats and G step
  sizes → (G, bits, ..., ceil(K/32)), one launch of K1;
* :func:`serial_conv2d_packed_op` — the fused packed conv (K2);
* :func:`serial_matmul_packed_op` — the fused GEMM over packed
  activations (K3), any leading dims;
* :func:`serial_matmul_op` — the fused GEMM over integer codes (K4);
* :func:`quantized_linear` — the deployment linear: float activations →
  integer codes → K4 → the dequant scaler/bias;
* :func:`serial_matmul_grouped_op` — E experts' code GEMMs in one launch,
  raw int32 accumulators (grouped K4);
* :func:`launch_counts` — the kernels' launch counts.

Tiles (:mod:`repro_torch.kernels.tuning`): K2 and K3 take ``tile=``, a
tuned tile or :data:`~repro_torch.kernels.tuning.HEURISTIC` (the kernel's
own choice); with none given they consult the tuner for the call's own
shape, as the reference's ops do, so the choice is memoized (and, with a
persistent store attached, persisted). K4 takes a tile only when given
one; without, the kernel's heuristic, as the reference's v1 keeps its
fixed blocks. The result does not depend on the tile.

The plain epilogue is :func:`repro_torch.kernels.epilogue.epilogue`, one
FMA where the reference's jitted ``_epilogue_xla`` contracts to one. K3's
and K4's ops take ``raw_acc=True`` (``scale`` None): the raw int32
accumulator, no epilogue; the tuner picks its tile as for a float output
(the same 4 bytes an element).
``plain=True`` (the GEMMs and the quantizer) runs the kernel's plain
version whatever the device: the yardstick a kernel is held against, the
counterpart of the reference's ``backend="xla"``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from repro_torch.core.bitserial import SerialSpec, plan_spec
from repro_torch.core.quant import QuantizedWeight, QuantSpec, quantize_int
from repro_torch.kernels import (bitserial_conv, bitserial_matmul,
                                 quantize_pack, tuning)

__all__ = ["pack_activations", "quantize_pack_activations",
           "quantize_pack_activations_multi", "over_rows",
           "serial_conv2d_packed_op", "serial_matmul_packed_op",
           "serial_matmul_op", "serial_matmul_grouped_op",
           "quantized_linear", "launch_counts"]


def launch_counts() -> Dict[str, int]:
    """The kernel wrappers' launch counts: K1, K2, K3, K4 and grouped K4
    (``K4g``); a wrapper counts its Python calls, so a CUDA graph's replay
    adds nothing."""
    mm = bitserial_matmul.KERNEL.entry_launches
    return {"K1": quantize_pack.KERNEL.launches,
            "K2": bitserial_conv.KERNEL.launches,
            "K3": mm["bitserial_matmul_v2"], "K4": mm["bitserial_matmul_v1"],
            "K4g": bitserial_matmul.GROUPED.entry_launches[
                "bitserial_matmul_v1_grouped"]}


def over_rows(fn, x: torch.Tensor, *head: int) -> torch.Tensor:
    """Run a row packer ``fn`` ((R, K) → (*head, R, W)) over (..., K) and
    restore the leading dims: (*head, ..., W)."""
    lead = tuple(x.shape[:-1])
    out = fn(x.reshape(-1, x.shape[-1]).contiguous())
    return out.reshape(head + lead + (out.shape[-1],))


def pack_activations(codes: torch.Tensor, a_bits: int) -> torch.Tensor:
    """Bit-transpose-pack integer codes: (..., K) → (a_bits, ...,
    ceil(K/32)) int32 words."""
    return over_rows(lambda r: quantize_pack.pack_codes(r, a_bits),
                     codes.to(torch.int32), a_bits)


def quantize_pack_activations(x: torch.Tensor, alpha: torch.Tensor,
                              spec: QuantSpec, *,
                              plain: bool = False) -> torch.Tensor:
    """Quantize (..., K) floats with step ``alpha`` and pack the codes:
    (spec.bits, ..., ceil(K/32)) int32 words."""
    return quantize_pack_activations_multi(x, [alpha], spec, plain=plain)[0]


def quantize_pack_activations_multi(x: torch.Tensor,
                                    alphas: Sequence[torch.Tensor],
                                    spec: QuantSpec, *,
                                    plain: bool = False) -> torch.Tensor:
    """Quantize (..., K) floats once for each step in ``alphas`` (1..4) and
    pack the codes, in one launch: (G, spec.bits, ..., ceil(K/32)); slice g
    equals ``quantize_pack_activations(x, alphas[g], spec)``."""
    fn = (quantize_pack.quantize_pack_multi_ref if plain
          else quantize_pack.quantize_pack_multi)
    return over_rows(lambda r: fn(r, alphas, spec), x, len(alphas),
                     spec.bits)


def serial_conv2d_packed_op(x_packed: torch.Tensor, w_packed: torch.Tensor,
                            scale: torch.Tensor,
                            bias: Optional[torch.Tensor] = None, *,
                            spec: SerialSpec, ci: int, stride: int = 1,
                            padding: int = 1, relu: bool = False,
                            requant: Optional[QuantSpec] = None,
                            requant_scale=None,
                            emit_packed: bool = False,
                            tile=None) -> torch.Tensor:
    """Fused implicit-GEMM serial conv2d over bit-packed activations
    (see :mod:`repro_torch.kernels.bitserial_conv` for the formats).

    ``tile``: a :class:`~repro_torch.kernels.tuning.ConvTileConfig` or
    :data:`~repro_torch.kernels.tuning.HEURISTIC`; with none,
    :func:`~repro_torch.kernels.tuning.choose_conv_tile` for this
    shape."""
    if tile is None:
        _, n, h, w_in, _ = x_packed.shape
        _, fh, fw, _, co = w_packed.shape
        tile = tuning.choose_conv_tile(
            n, h, w_in, ci, co, fh=fh, fw=fw, stride=stride,
            padding=padding, spec=spec,
            out_bits=requant.bits if (requant and emit_packed) else None)
    return bitserial_conv.bitserial_conv2d(
        x_packed, w_packed, scale, bias, spec=spec, ci=ci, stride=stride,
        padding=padding, relu=relu, requant=requant,
        requant_scale=requant_scale, emit_packed=emit_packed, tile=tile)


def serial_matmul_packed_op(x_packed: torch.Tensor, w_packed: torch.Tensor,
                            scale: torch.Tensor,
                            bias: Optional[torch.Tensor] = None, *,
                            spec: SerialSpec, k: int, relu: bool = False,
                            requant: Optional[QuantSpec] = None,
                            requant_scale=None, emit_packed: bool = False,
                            plain: bool = False, tile=None,
                            raw_acc: bool = False) -> torch.Tensor:
    """Fused serial matmul over bit-packed activations (K3).

    ``x_packed``: (a_bits, ..., ceil(K/32)) words, any leading dims;
    ``w_packed``: (w_bits, ceil(K/32), N). Returns float32 (..., N), codes
    (..., N), or with ``requant`` + ``emit_packed`` the planes
    (requant.bits, ..., ceil(N/32)) the next layer consumes. ``tile``: a
    :class:`~repro_torch.kernels.tuning.TileConfig` or
    :data:`~repro_torch.kernels.tuning.HEURISTIC`; with none (and not
    ``plain``), :func:`~repro_torch.kernels.tuning.choose_tile` for the
    call's (M, K, N).
    """
    if emit_packed and requant is None:
        raise ValueError("emit_packed requires requant")
    lead = tuple(x_packed.shape[1:-1])
    x2 = x_packed.reshape(x_packed.shape[0], -1,
                          x_packed.shape[-1]).contiguous()
    if plain:
        fn = bitserial_matmul.bitserial_matmul_v2_ref
    else:
        fn = bitserial_matmul.bitserial_matmul_v2
        if tile is None:
            tile = tuning.choose_tile(
                x2.shape[1], k, w_packed.shape[-1], spec,
                out_bits=requant.bits if (requant and emit_packed) else None)
    out = fn(x2, w_packed, scale, bias, spec=spec, k=k, relu=relu,
             requant=requant, requant_scale=requant_scale,
             emit_packed=emit_packed, tile=tile, raw_acc=raw_acc)
    if emit_packed:
        return out.reshape((requant.bits,) + lead + (out.shape[-1],))
    return out.reshape(lead + (out.shape[-1],))


def serial_matmul_op(x: torch.Tensor, w_packed: torch.Tensor,
                     scale: torch.Tensor, bias: Optional[torch.Tensor] = None,
                     *, spec: SerialSpec, k: int, relu: bool = False,
                     out_dtype: torch.dtype = torch.float32,
                     requant: Optional[QuantSpec] = None,
                     plain: bool = False, tile=None,
                     raw_acc: bool = False) -> torch.Tensor:
    """Fused serial matmul of (..., K) integer codes against packed weights
    (K4); ``scale`` folds any requant step. ``tile``: a
    :class:`~repro_torch.kernels.tuning.TileConfig`, or None for the
    kernel's heuristic (no tuner call)."""
    lead = tuple(x.shape[:-1])
    x2 = x.reshape(-1, x.shape[-1]).to(torch.int32).contiguous()
    fn = (bitserial_matmul.bitserial_matmul_ref if plain
          else bitserial_matmul.bitserial_matmul)
    out = fn(x2, w_packed, scale, bias, spec=spec, k=k, relu=relu,
             out_dtype=out_dtype, requant=requant, tile=tile,
             raw_acc=raw_acc)
    return out.reshape(lead + (out.shape[-1],))


def quantized_linear(x: torch.Tensor, qw: QuantizedWeight,
                     act_alpha, *, a_bits: int = 8, a_signed: bool = True,
                     radix_bits: int = 7, bias: Optional[torch.Tensor] = None,
                     relu: bool = False,
                     out_dtype: torch.dtype = torch.float32,
                     plain: bool = False) -> torch.Tensor:
    """Full deployment linear: float activations → integer codes → serial
    matmul (K4) → dequant. ``scale`` folds ``act_alpha * w_scale`` per
    output channel (the scaler RAM's contents). The digit plan is
    re-selected per spec (:func:`~repro_torch.core.bitserial.plan_spec`);
    the integer result does not depend on it."""
    aspec = QuantSpec(a_bits, a_signed)
    alpha = torch.as_tensor(act_alpha, dtype=torch.float32, device=x.device)
    codes = quantize_int(x, alpha, aspec)
    spec = plan_spec(SerialSpec(a_bits=a_bits, w_bits=qw.bits,
                                a_signed=a_signed, w_signed=qw.signed,
                                radix_bits=radix_bits))
    scale = alpha * qw.scale.to(torch.float32)
    return serial_matmul_op(codes, qw.packed, scale, bias, spec=spec, k=qw.k,
                            relu=relu, out_dtype=out_dtype, plain=plain)


def serial_matmul_grouped_op(x: torch.Tensor, w_packed: torch.Tensor, *,
                             spec: SerialSpec, k: int,
                             plain: bool = False) -> torch.Tensor:
    """E experts' serial matmuls in one launch (grouped K4): (E, C, K)
    integer codes against (E, w_bits, ceil(K/32), N) packed weights → (E,
    C, N) int32 accumulators."""
    fn = (bitserial_matmul.bitserial_matmul_grouped_ref if plain
          else bitserial_matmul.bitserial_matmul_grouped)
    return fn(x.to(torch.int32).contiguous(), w_packed, spec=spec, k=k)
