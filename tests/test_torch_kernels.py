"""The port's kernel modules on the CPU — K1 (quantize_pack) and K2
(bitserial_conv2d) through their plain versions — against the JAX package:
``quantize_pack_ref`` / ``quantize_pack_pallas(interpret=True)`` and
``serial_conv2d_packed_op(backend="xla")``, plus one ``pallas_v2`` case in
interpret mode. K1's grouped launch (one activation, G step sizes) is held
against the reference run once per step size, in float32 and bf16 (the
same bf16 values on both sides). The conv sweep follows
``test_conv_v2.py``: stride 1/2, pad 0/1, 1x1/3x3/5x5 filters, ragged
Ci/Co, every output mode.

The reference's XLA epilogue is run under ``jax.jit``, as its executor runs
it: there ``acc * scale + bias`` is one FMA, which the port reproduces.
Codes and words are compared with ``array_equal``; so is the float
epilogue output (the same FMA of the same accumulator).

The CUDA wrappers themselves run only on the card (``chip_smoke.py``,
``tests/test_torch_cuda.py``); here they must refuse CPU tensors and build
nothing.
"""

import _torch_threads  # noqa: F401  (first: caps torch's threads under xdist)

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitops as jb
from repro.core.bitserial import SerialSpec as JSpec
from repro.core.quant import QuantSpec as JQuant
from repro.kernels.ops import pack_activations as j_pack_activations
from repro.kernels.ops import serial_conv2d_packed_op as j_conv_op
from repro.kernels.quantize_pack import (quantize_pack_pallas,
                                         quantize_pack_ref as j_qp_ref)

from repro_torch.core.bitserial import SerialSpec
from repro_torch.core.quant import QuantSpec, qrange
from repro_torch.kernels import _build, bitserial_conv, ops, quantize_pack


def _t(a):
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a, order="C"))


def _np(t: torch.Tensor, like) -> np.ndarray:
    a = t.numpy()
    return a.view(np.uint32) if np.asarray(like).dtype == np.uint32 else a


# ---------------------------------------------------------------- K1

@pytest.mark.parametrize("bits,signed,r,l,br,bl", [
    (2, True, 16, 64, 8, 32),
    (4, True, 32, 128, 16, 64),
    (8, True, 16, 96, 8, 32),
    (1, False, 8, 32, 8, 32),
    (7, False, 8, 64, 8, 32),
    (4, True, 13, 70, 8, 32),   # ragged -> padding path
    (16, True, 5, 33, 8, 32),
])
def test_quantize_pack_plain_matches_reference(bits, signed, r, l, br, bl):
    rng = np.random.default_rng(bits * 100 + r)
    x = rng.standard_normal((r, l)).astype(np.float32)
    if not signed:
        x = np.abs(x)
    x[0, :8] = (np.arange(8) - 4 + 0.5).astype(np.float32) * 0.1  # ties
    scale = np.float32(0.1)
    ref = np.asarray(j_qp_ref(jnp.asarray(x), jnp.asarray(scale),
                              JQuant(bits, signed)))
    out = quantize_pack.quantize_pack(_t(x), torch.tensor(scale),
                                      QuantSpec(bits, signed))
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(_np(out, ref), ref)
    if bits in (2, 7) or l % 32:  # the Pallas kernel itself, interpreted
        pl_out = quantize_pack_pallas(jnp.asarray(x), jnp.asarray(scale),
                                      JQuant(bits, signed), block_r=br,
                                      block_l=bl, interpret=True)
        np.testing.assert_array_equal(_np(out, ref), np.asarray(pl_out))


@pytest.mark.parametrize("bits,shape", [(2, (4, 8, 8, 128)), (2, (3, 2, 2, 256)),
                                        (3, (7, 70)), (8, (2, 5, 33))])
def test_pack_codes_plain_matches_reference(bits, shape):
    rng = np.random.default_rng(bits)
    lo, hi = qrange(bits, True)
    codes = rng.integers(lo, hi + 1, shape).astype(np.int32)
    ref = np.asarray(j_pack_activations(jnp.asarray(codes), bits))
    out = ops.pack_activations(_t(codes), bits)
    np.testing.assert_array_equal(_np(out, ref), ref)
    # int8 codes (a conv step's codes output) pack the same
    out8 = ops.pack_activations(_t(codes.astype(np.int8)), bits)
    np.testing.assert_array_equal(_np(out8, ref), ref)


def test_quantize_pack_activations_leading_dims():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 5, 40)).astype(np.float32)
    alpha = np.float32(0.3)
    out = ops.quantize_pack_activations(_t(x), torch.tensor(alpha),
                                        QuantSpec(2, True))
    from repro.core.quant import quantize_int
    ref = np.asarray(j_pack_activations(
        quantize_int(jnp.asarray(x), jnp.asarray(alpha), JQuant(2, True)), 2))
    assert tuple(out.shape) == ref.shape == (2, 2, 5, 5, 2)
    np.testing.assert_array_equal(_np(out, ref), ref)


# the grouped K1: one (13, 70) activation (ragged: 3 words, the last one
# partly padding) and four step sizes; the first step puts exact .5 ties
# into row 0 (representable in bf16 too)
MULTI_STEPS = (0.125, 0.37, 0.05, 1.3)


def _multi_input(signed, dtype):
    x = (np.random.default_rng(15).standard_normal((13, 70)) * 3).astype(
        np.float32)
    x[0, :8] = (np.arange(8) - 4 + 0.5) * MULTI_STEPS[0]
    if not signed:
        x = np.abs(x)
    # round to bf16 once, so both packages read the same values
    return torch.from_numpy(x).to(getattr(torch, dtype)).float().numpy()


@functools.lru_cache(maxsize=None)
def _jax_multi(bits, signed, dtype, g):
    """The reference's planes for step ``g``: (quantize_pack_ref,
    quantize_pack_pallas(interpret=True)), as int32 views."""
    x = jnp.asarray(_multi_input(signed, dtype), getattr(jnp, dtype))
    step = jnp.asarray(np.float32(MULTI_STEPS[g]))
    spec = JQuant(bits, signed)
    ref = np.asarray(j_qp_ref(x, step, spec)).view(np.int32)
    pal = np.asarray(quantize_pack_pallas(x, step, spec, block_r=16,
                                          block_l=128, interpret=True))
    return ref, pal.view(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits,signed", [(2, True), (4, True), (8, True),
                                         (2, False), (4, False), (8, False)])
@pytest.mark.parametrize("groups", [1, 2, 3, 4])
def test_quantize_pack_multi_plain_matches_reference(groups, bits, signed,
                                                     dtype):
    x = torch.from_numpy(_multi_input(signed, dtype)).to(
        getattr(torch, dtype))
    steps = [torch.tensor(np.float32(a)) for a in MULTI_STEPS[:groups]]
    spec = QuantSpec(bits, signed)
    out = quantize_pack.quantize_pack_multi(x, steps, spec)
    assert out.dtype == torch.int32
    assert tuple(out.shape) == (groups, bits, 13, 3)
    for g in range(groups):
        ref, pal = _jax_multi(bits, signed, dtype, g)
        np.testing.assert_array_equal(out[g].numpy(), ref)
        np.testing.assert_array_equal(out[g].numpy(), pal)
        # slice g is the single-step launch's output
        assert torch.equal(out[g], quantize_pack.quantize_pack(x, steps[g],
                                                               spec))


def test_quantize_pack_activations_multi_leading_dims():
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, 3, 70)).astype(
        np.float32)).to(torch.bfloat16)
    steps = [torch.tensor(0.2), torch.tensor(0.07), torch.tensor(0.5)]
    spec = QuantSpec(8, True)
    out = ops.quantize_pack_activations_multi(x, steps, spec)
    assert tuple(out.shape) == (3, 8, 2, 3, 3)
    for g, a in enumerate(steps):
        assert torch.equal(out[g], ops.quantize_pack_activations(x, a, spec))
    plain = ops.quantize_pack_activations_multi(x, steps, spec, plain=True)
    assert torch.equal(out, plain)


# ---------------------------------------------------------------- K2

def _case(rng, ba, bw, sa, sw, n, h, w, ci, co, fs=3):
    la, ha = qrange(ba, sa)
    lw, hw = qrange(bw, sw)
    x = rng.integers(la, ha + 1, (n, h, w, ci)).astype(np.int32)
    wt = rng.integers(lw, hw + 1, (fs, fs, ci, co)).astype(np.int32)
    xp = j_pack_activations(jnp.asarray(x), ba)
    wp = jb.pack_bitplanes(jb.pad_to(jb.to_bitplanes(jnp.asarray(wt), bw), 32,
                                     axis=3), axis=3)
    scale = (rng.random(co) * 0.05 + 0.01).astype(np.float32)
    bias = (rng.standard_normal(co) * 0.2).astype(np.float32)
    return np.asarray(xp), np.asarray(wp), scale, bias


def _both(xp, wp, scale, bias, *, spec, ci, stride, padding, relu, out,
          rq_bits=2, rq_signed=True, rs=0.3):
    """Run the reference (jitted XLA oracle) and the port's plain K2."""
    jspec = JSpec(spec.a_bits, spec.w_bits, spec.a_signed, spec.w_signed,
                  spec.radix_bits)
    req = None if out == "float" else (rq_bits, rq_signed)
    packed = out == "packed"

    def ref_fn(xp, wp, scale, bias, rs):
        return j_conv_op(xp, wp, scale, bias, spec=jspec, ci=ci, stride=stride,
                         padding=padding, relu=relu,
                         requant=None if req is None else JQuant(*req),
                         requant_scale=None if req is None else rs,
                         emit_packed=packed, backend="xla")

    ref = np.asarray(jax.jit(ref_fn)(xp, wp, scale, bias, np.float32(rs)))
    got = ops.serial_conv2d_packed_op(
        _t(xp), _t(wp), _t(scale), None if bias is None else _t(bias),
        spec=spec, ci=ci, stride=stride, padding=padding, relu=relu,
        requant=None if req is None else QuantSpec(*req),
        requant_scale=None if req is None else torch.tensor(np.float32(rs)),
        emit_packed=packed)
    return _np(got, ref), ref


SWEEP = [
    # radix, ba, bw, signed, stride, padding, fs, n, h, w, ci, co, out
    (7, 2, 2, True, 1, 1, 3, 2, 6, 6, 64, 64, "packed"),   # conv1/conv2
    (7, 2, 2, True, 2, 1, 3, 1, 7, 7, 64, 128, "packed"),  # conv3-like
    (7, 2, 2, True, 1, 1, 3, 1, 3, 3, 512, 40, "float"),   # conv8-like
    (1, 2, 2, True, 2, 1, 3, 3, 9, 9, 48, 40, "codes"),    # ragged ci/co
    (1, 4, 4, True, 2, 0, 1, 2, 6, 6, 32, 16, "float"),    # 1x1 stride 2
    (7, 4, 4, True, 1, 2, 5, 1, 6, 6, 32, 16, "packed"),   # 5x5
    (8, 8, 4, True, 1, 0, 3, 1, 5, 6, 33, 8, "float"),     # W4A8, pad 0
    (8, 8, 8, True, 2, 1, 3, 1, 7, 7, 40, 24, "codes"),    # W8A8
    (1, 3, 5, False, 1, 1, 3, 1, 5, 5, 32, 16, "float"),   # unsigned acts
    (7, 16, 16, True, 1, 1, 3, 1, 4, 4, 64, 8, "packed"),  # int32 wrap
]
CONV_CASES = SWEEP


@pytest.mark.parametrize(
    "radix,ba,bw,signed,stride,padding,fs,n,h,w,ci,co,out", CONV_CASES)
def test_conv_plain_matches_reference(radix, ba, bw, signed, stride, padding,
                                      fs, n, h, w, ci, co, out):
    rng = np.random.default_rng(ba * 31 + bw * 7 + ci + co + stride)
    xp, wp, scale, bias = _case(rng, ba, bw, signed, signed, n, h, w, ci, co,
                                fs)
    spec = SerialSpec(ba, bw, signed, signed, radix)
    got, ref = _both(xp, wp, scale, bias, spec=spec, ci=ci, stride=stride,
                     padding=padding, relu=out != "float" or signed, out=out)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("rq_bits,rq_signed,relu,with_bias", [
    (4, True, False, True), (3, False, True, False), (8, True, True, True)])
def test_conv_epilogue_modes(rq_bits, rq_signed, relu, with_bias):
    """Requant widths/signedness and no-bias/no-ReLU epilogues."""
    rng = np.random.default_rng(rq_bits * 3 + rq_signed)
    xp, wp, scale, bias = _case(rng, 4, 4, True, True, 1, 5, 5, 33, 40)
    spec = SerialSpec(4, 4, True, True, 8)
    b = bias if with_bias else None
    for out in ("float", "codes", "packed"):
        got, ref = _both(xp, wp, scale, b, spec=spec, ci=33, stride=1,
                         padding=1, relu=relu, out=out, rq_bits=rq_bits,
                         rq_signed=rq_signed, rs=0.4)
        np.testing.assert_array_equal(got, ref, err_msg=f"{out} bias={b is not None}")


def test_conv_plain_matches_pallas_v2_interpret():
    """One case through the TPU kernel itself, interpreted on the CPU."""
    rng = np.random.default_rng(21)
    xp, wp, scale, bias = _case(rng, 2, 2, True, True, 2, 5, 5, 40, 40)
    spec = SerialSpec(2, 2, True, True, 7)
    ref = np.asarray(j_conv_op(
        jnp.asarray(xp), jnp.asarray(wp), scale, bias,
        spec=JSpec(2, 2, True, True, 7), ci=40, stride=1, padding=1,
        relu=True, requant=JQuant(2, True), requant_scale=np.float32(0.3),
        emit_packed=True, backend="pallas_v2", interpret=True, block_co=32,
        block_nb=1))
    got = bitserial_conv.bitserial_conv2d(
        _t(xp), _t(wp), _t(scale), _t(bias), spec=spec, ci=40, stride=1,
        padding=1, relu=True, requant=QuantSpec(2, True),
        requant_scale=torch.tensor(np.float32(0.3)), emit_packed=True)
    np.testing.assert_array_equal(_np(got, ref), ref)


# ------------------------------------------------- CUDA wrappers, on the CPU

def test_cuda_wrappers_refuse_cpu_tensors():
    before = (quantize_pack.KERNEL.launches, bitserial_conv.KERNEL.launches)
    x = torch.zeros((4, 32))
    with pytest.raises(ValueError, match="on the card"):
        quantize_pack.quantize_pack_cuda(x, torch.tensor(1.0), QuantSpec(2))
    with pytest.raises(ValueError, match="on the card"):
        quantize_pack.quantize_pack_multi_cuda(
            x.to(torch.bfloat16), [torch.tensor(0.5), torch.tensor(0.25)],
            QuantSpec(4))
    with pytest.raises(ValueError, match="on the card"):
        quantize_pack.pack_codes_cuda(torch.zeros((4, 32), dtype=torch.int32),
                                      2)
    xp = torch.zeros((2, 1, 4, 4, 1), dtype=torch.int32)
    wp = torch.zeros((2, 3, 3, 1, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="must be on"):
        bitserial_conv.bitserial_conv2d_cuda(
            xp, wp, torch.ones(8), spec=SerialSpec(2, 2, True, True, 7), ci=8)
    assert (quantize_pack.KERNEL.launches,
            bitserial_conv.KERNEL.launches) == before
    assert quantize_pack.KERNEL._lib is None and bitserial_conv.KERNEL._lib is None


def test_build_names_library_by_source_hash():
    k = quantize_pack.KERNEL
    p = k.library_path()
    assert p.parent == _build.BUILD_DIR and p.name.startswith("quantize_pack-")
    assert p == k.library_path()
    assert k.source.exists() and bitserial_conv.KERNEL.source.exists()
    flags = " ".join(_build.NVCC_FLAGS)
    assert "sm_90a" in flags and "--fmad=false" in flags
    assert "use_fast_math" not in flags


def test_gemm_packed_op_names_k3():
    """The packed GEMM op runs K3 — its plain version for CPU tensors."""
    from repro_torch.kernels import bitserial_matmul
    rng = np.random.default_rng(6)
    spec = SerialSpec(2, 2, True, True, 7)
    xp = _t(rng.integers(-2**31, 2**31, (2, 3, 2), dtype=np.int64).astype(
        np.int32))
    wp = _t(rng.integers(-2**31, 2**31, (2, 2, 8), dtype=np.int64).astype(
        np.int32))
    scale = torch.ones(8)
    out = ops.serial_matmul_packed_op(xp, wp, scale, spec=spec, k=64)
    ref = bitserial_matmul.bitserial_matmul_v2_ref(xp, wp, scale, spec=spec,
                                                   k=64)
    assert torch.equal(out, ref)


def test_tensor_core_kernels_share_the_digit_header():
    """K2 and K3 include csrc/digits.cuh, and the library name hashes it."""
    header = _build.CSRC / "digits.cuh"
    assert header.exists()
    from repro_torch.kernels import bitserial_matmul
    for kern in (bitserial_conv.KERNEL, bitserial_matmul.KERNEL):
        assert '#include "digits.cuh"' in kern.source.read_text()
    text = header.read_text()
    assert "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32" in text
    # the conv and GEMM entries take the digit counts after the signs, and
    # the tile (nt, warps) before the stream
    assert len(bitserial_conv.KERNEL.entries["bitserial_conv2d"]) == 31
    assert len(bitserial_matmul.KERNEL.entries["bitserial_matmul_v2"]) == 23
