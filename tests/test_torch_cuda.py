"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: every test skips (with its reason) where no CUDA device is
present, and the card is looked for inside a fixture, never at import. On a
machine with the card, from the root of the checkout:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The first test to need a kernel builds it with ``nvcc`` (seconds). Every
comparison is exact (``torch.equal``): the kernels compute the same integer
arithmetic and the same single-rounding epilogue as the plain versions.
"""

import _torch_threads  # noqa: F401  (first: caps torch's threads under xdist)

import itertools

import numpy as np
import pytest
import torch

from repro_torch.core.bitserial import SerialSpec
from repro_torch.core.quant import QuantSpec, qrange
from repro_torch.kernels import bitserial_conv as k2
from repro_torch.kernels import quantize_pack as k1

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda", 0)


def _codes(rng, bits, signed, shape, dev):
    lo, hi = qrange(bits, signed)
    return torch.from_numpy(rng.integers(lo, hi + 1, shape).astype(np.int32)
                            ).to(dev)


@pytest.mark.parametrize("bits,signed,rows,length", [
    (1, False, 7, 32), (2, True, 1000, 64), (3, False, 9, 70),
    (4, True, 5, 31), (8, True, 33, 130), (16, True, 3, 97)])
def test_quantize_pack_kernel_equals_plain(dev, bits, signed, rows, length):
    rng = np.random.default_rng(bits * 7 + rows)
    x = torch.from_numpy((rng.standard_normal((rows, length)) * 3).astype(
        np.float32)).to(dev)
    x[0, : min(16, length)] = (torch.arange(min(16, length), device=dev)
                               - 8 + 0.5) * 0.25   # exact ties
    alpha = torch.tensor(0.25, device=dev)
    spec = QuantSpec(bits, signed)
    before = k1.KERNEL.launches
    out = k1.quantize_pack_cuda(x, alpha, spec)
    assert k1.KERNEL.launches == before + 1
    assert torch.equal(out, k1.quantize_pack_ref(x, alpha, spec))
    c = _codes(rng, bits, signed, (rows, length), dev)
    assert torch.equal(k1.pack_codes_cuda(c, bits), k1.pack_codes_ref(c, bits))


# the LM's activation shapes (decode M = 4, prefill M = 64; d_model and
# d_ff of stablelm-1.6b) and a ragged one
K1_SHAPES = [(4, 2048), (64, 2048), (4, 5632), (64, 5632), (13, 70)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("groups", [1, 2, 3, 4])
@pytest.mark.parametrize("shape", K1_SHAPES)
def test_quantize_pack_multi_kernel_equals_plain(dev, shape, groups, dtype):
    rng = np.random.default_rng(groups * 31 + shape[1])
    x = torch.from_numpy((rng.standard_normal(shape) * 4).astype(
        np.float32)).to(dev).to(dtype)
    steps = [torch.tensor(a, device=dev)
             for a in (0.125, 0.0371, 0.5, 0.0098)[:groups]]
    x[0, :16] = ((torch.arange(16, device=dev) - 8 + 0.5) * 0.125).to(dtype)
    spec = QuantSpec(8, True)
    before = k1.KERNEL.launches
    out = k1.quantize_pack_multi_cuda(x, steps, spec)
    assert k1.KERNEL.launches == before + 1
    assert torch.equal(out, k1.quantize_pack_multi_ref(x, steps, spec))
    # a step that is a view into a stacked per-layer leaf, as the LM passes
    stack = torch.tensor([0.3, 0.07, 0.011], device=dev)
    views = [stack[i] for i in range(min(groups, 3))]
    assert torch.equal(k1.quantize_pack_multi_cuda(x, views, spec),
                       k1.quantize_pack_multi_ref(x, views, spec))


def test_quantize_pack_multi_rejects_bad_inputs(dev):
    x = torch.zeros((4, 64), device=dev)
    a = torch.tensor(0.5, device=dev)
    spec = QuantSpec(4, True)
    bad = [
        (ValueError, x, []), (ValueError, x, [a] * 5),
        (TypeError, x.half(), [a]), (TypeError, x.int(), [a]),
        (ValueError, x, [a.double()]),
        (ValueError, x, [torch.tensor([0.5, 0.5], device=dev)]),
        (ValueError, x, [torch.tensor(0.5)]),
        (ValueError, x.t(), [a]), (ValueError, x[None], [a]),
    ]
    before = k1.KERNEL.launches
    for err, xx, steps in bad:
        with pytest.raises(err):
            k1.quantize_pack_multi_cuda(xx, steps, spec)
    assert k1.KERNEL.launches == before


CONV = list(itertools.product(
    [(1, 1, False, False), (2, 2, True, True), (4, 2, False, True),
     (8, 8, True, True), (12, 3, True, False)],
    [(1, 1, 3), (2, 1, 3), (1, 0, 3), (2, 0, 1), (1, 2, 5)]))


@pytest.mark.parametrize("bits,geom", CONV)
def test_conv_kernel_equals_plain(dev, bits, geom):
    ba, bw, sa, sw = bits
    stride, pad, fs = geom
    spec = SerialSpec(ba, bw, sa, sw, 7)
    rng = np.random.default_rng(ba * 100 + bw * 10 + stride + fs)
    n, h, w, ci, co = 2, 7, 6, 45, 37
    xc = _codes(rng, ba, sa, (n * h * w, ci), dev)
    wc = _codes(rng, bw, sw, (fs * fs * co, ci), dev)
    xp = k1.pack_codes_ref(xc, ba).reshape(ba, n, h, w, -1).contiguous()
    wp = k1.pack_codes_ref(wc, bw).reshape(bw, fs, fs, co, -1).permute(
        0, 1, 2, 4, 3).contiguous()
    scale = torch.from_numpy((rng.random(co) * 0.05).astype(np.float32)).to(dev)
    bias = torch.from_numpy(rng.standard_normal(co).astype(np.float32)).to(dev)
    rs = torch.tensor(0.4, device=dev)
    for b, (out, rq) in itertools.product(
            (bias, None), (("float", None), ("codes", QuantSpec(3, True)),
                           ("packed", QuantSpec(2, False)),
                           ("codes", QuantSpec(12, True)))):
        kw = dict(spec=spec, ci=ci, stride=stride, padding=pad,
                  relu=rq is not None and not rq.signed, requant=rq,
                  requant_scale=None if rq is None else rs,
                  emit_packed=out == "packed")
        got = k2.bitserial_conv2d_cuda(xp, wp, scale, b, **kw)
        ref = k2.bitserial_conv2d_ref(xp, wp, scale, b, **kw)
        assert got.dtype == ref.dtype and torch.equal(got, ref), (out, rq, b)


def test_conv_kernel_rejects_bad_inputs(dev):
    spec = SerialSpec(2, 2, True, True, 7)
    xp = torch.zeros((2, 1, 4, 4, 1), dtype=torch.int32, device=dev)
    wp = torch.zeros((2, 3, 3, 1, 8), dtype=torch.int32, device=dev)
    ones = torch.ones(8, device=dev)
    with pytest.raises(ValueError, match="channel-word"):
        k2.bitserial_conv2d_cuda(xp, wp, ones, spec=spec, ci=33)
    with pytest.raises(TypeError):
        k2.bitserial_conv2d_cuda(xp.float(), wp, ones, spec=spec, ci=8)
    with pytest.raises(ValueError, match="contiguous"):
        k2.bitserial_conv2d_cuda(xp.transpose(2, 3), wp, ones, spec=spec,
                                 ci=8)
    with pytest.raises(ValueError, match="emit_packed requires requant"):
        k2.bitserial_conv2d_cuda(xp, wp, ones, spec=spec, ci=8,
                                 emit_packed=True)


# --------------------------------------------------- K3 / K4 packed GEMMs

def _gemm_operands(rng, spec, m, k, n, dev):
    from repro_torch.core import bitops
    xc = _codes(rng, spec.a_bits, spec.a_signed, (m, k), dev)
    wc = _codes(rng, spec.w_bits, spec.w_signed, (k, n), dev)
    xp = k1.pack_codes_ref(xc, spec.a_bits)
    planes = bitops.pad_to(bitops.to_bitplanes(wc, spec.w_bits), 32, axis=1)
    wp = bitops.pack_bitplanes(planes, axis=1)
    scale = torch.from_numpy((rng.random(n) * 0.01 + 1e-3).astype(
        np.float32)).to(dev)
    bias = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(dev)
    return xc, xp, wp, scale, bias


GEMM = [((8, 4, True, True, 7), (4, 2048, 2048)),      # W4A8 decode shape
        ((8, 4, True, True, 7), (64, 5632, 2048)),     # W4A8 prefill, down
        ((2, 2, True, True, 7), (5, 100, 70)),         # ragged M/K/N
        ((1, 1, True, True, 1), (9, 65, 33)),          # radix 1
        ((8, 8, False, True, 7), (7, 96, 40)),         # unsigned acts
        ((16, 16, True, True, 7), (3, 700, 64))]       # int32 wrap


@pytest.mark.parametrize("sp,shape", GEMM)
def test_gemm_kernels_equal_plain(dev, sp, shape):
    from repro_torch.kernels import bitserial_matmul as km
    spec = SerialSpec(*sp)
    m, k, n = shape
    rng = np.random.default_rng(m * 7 + k + n)
    xc, xp, wp, scale, bias = _gemm_operands(rng, spec, m, k, n, dev)
    rs = torch.tensor(0.37, device=dev)
    for b, (out, rq) in itertools.product(
            (bias, None), (("float", None), ("codes", QuantSpec(8, True)),
                           ("packed", QuantSpec(3, False)),
                           ("codes", QuantSpec(12, True)))):
        kw = dict(spec=spec, k=k, relu=rq is not None and not rq.signed,
                  requant=rq, requant_scale=None if rq is None else rs,
                  emit_packed=out == "packed")
        before = km.KERNEL.launches
        got = km.bitserial_matmul_v2_cuda(xp, wp, scale, b, **kw)
        assert km.KERNEL.launches == before + 1
        ref = km.bitserial_matmul_v2_ref(xp, wp, scale, b, **kw)
        assert got.dtype == ref.dtype and torch.equal(got, ref), (out, rq, b)
        if out == "packed":
            continue
        kw4 = dict(spec=spec, k=k, relu=kw["relu"], requant=rq,
                   out_dtype=torch.bfloat16)
        got = km.bitserial_matmul_cuda(xc, wp, scale, b, **kw4)
        ref = km.bitserial_matmul_ref(xc, wp, scale, b, **kw4)
        assert got.dtype == ref.dtype and torch.equal(got, ref), (out, rq, b)


@pytest.mark.parametrize("sp,shape", GEMM)
def test_gemm_kernels_accumulator_mode_equals_plain(dev, sp, shape):
    """K3 and K4 with ``raw_acc`` (the epilogue's accumulator mode): the
    raw int32 accumulator, equal to the plain versions' (which return the
    accumulator they compute), one launch each; summed over two K word
    ranges and put through the plain epilogue it equals the fused whole
    output (what a row-parallel projection on a mesh computes)."""
    from repro_torch.kernels import bitserial_matmul as km
    from repro_torch.kernels.epilogue import epilogue
    spec = SerialSpec(*sp)
    m, k, n = shape
    rng = np.random.default_rng(m * 5 + k + n)
    xc, xp, wp, scale, bias = _gemm_operands(rng, spec, m, k, n, dev)
    for fk, fr, x in ((km.bitserial_matmul_v2_cuda,
                       km.bitserial_matmul_v2_ref, xp),
                      (km.bitserial_matmul_cuda, km.bitserial_matmul_ref,
                       xc)):
        before = km.KERNEL.launches
        got = fk(x, wp, None, spec=spec, k=k, raw_acc=True)
        assert km.KERNEL.launches == before + 1
        ref = fr(x, wp, None, spec=spec, k=k, raw_acc=True)
        assert got.dtype == torch.int32 and torch.equal(got, ref)
    kw_ = -(-k // 32)
    if kw_ < 2:
        return
    cut = 32 * (kw_ // 2)
    parts = [(xc[:, :cut], wp[:, :kw_ // 2]), (xc[:, cut:], wp[:, kw_ // 2:])]
    acc = sum(km.bitserial_matmul_v2_cuda(
        k1.pack_codes_ref(c.contiguous(), spec.a_bits), w.contiguous(), None,
        spec=spec, k=c.shape[1], raw_acc=True) for c, w in parts)
    whole = km.bitserial_matmul_v2_cuda(xp, wp, scale, bias, spec=spec, k=k)
    assert torch.equal(epilogue(acc, scale, bias, relu=False, requant=None),
                       whole)


def test_accumulator_mode_refuses_an_epilogue(dev):
    """``raw_acc`` takes no scale, bias, ReLU or requant; without it a
    scale is required. Each raises before any launch."""
    from repro_torch.kernels import bitserial_matmul as km
    spec = SerialSpec(2, 2, True, True, 7)
    xp = torch.zeros((2, 4, 1), dtype=torch.int32, device=dev)
    wp = torch.zeros((2, 1, 8), dtype=torch.int32, device=dev)
    ones = torch.ones(8, device=dev)
    before = km.KERNEL.launches
    for kw in (dict(relu=True), dict(requant=QuantSpec(8, True))):
        with pytest.raises(ValueError, match="raw_acc"):
            km.bitserial_matmul_v2_cuda(xp, wp, None, spec=spec, k=8,
                                        raw_acc=True, **kw)
    with pytest.raises(ValueError, match="raw_acc"):
        km.bitserial_matmul_v2_cuda(xp, wp, ones, spec=spec, k=8,
                                    raw_acc=True)
    with pytest.raises(ValueError, match="scale is None"):
        km.bitserial_matmul_cuda(torch.zeros((4, 8), dtype=torch.int32,
                                             device=dev), wp, None,
                                 spec=spec, k=8)
    assert km.KERNEL.launches == before


def test_gemm_kernels_mask_out_of_range_codes(dev):
    # K4 masks codes to a_bits and sign-extends them, as the reference does
    from repro_torch.kernels import bitserial_matmul as km
    spec = SerialSpec(4, 4, True, True, 7)
    rng = np.random.default_rng(5)
    _, _, wp, scale, bias = _gemm_operands(rng, spec, 6, 80, 50, dev)
    xc = torch.from_numpy(rng.integers(-300, 300, (6, 80)).astype(
        np.int32)).to(dev)
    got = km.bitserial_matmul_cuda(xc, wp, scale, bias, spec=spec, k=80)
    ref = km.bitserial_matmul_ref(xc, wp, scale, bias, spec=spec, k=80)
    assert torch.equal(got, ref)


def test_code_gemm_reads_codes_off_the_16_byte_grid(dev):
    # K4 loads a lane's codes as 16-byte vectors only when K % 4 == 0 and
    # the codes start on a 16-byte boundary; elsewhere one by one
    from repro_torch.kernels import bitserial_matmul as km
    spec = SerialSpec(8, 4, True, True, 8)
    m, k, n = 5, 96, 40
    rng = np.random.default_rng(11)
    xc, _, wp, scale, bias = _gemm_operands(rng, spec, m, k, n, dev)
    buf = torch.zeros(m * k + 1, dtype=torch.int32, device=dev)
    shifted = buf[1:].view(m, k)
    shifted.copy_(xc)
    assert shifted.data_ptr() % 16 != 0
    got = km.bitserial_matmul_cuda(shifted, wp, scale, bias, spec=spec, k=k)
    ref = km.bitserial_matmul_ref(xc, wp, scale, bias, spec=spec, k=k)
    assert torch.equal(got, ref)


def test_gemm_kernels_reject_bad_inputs(dev):
    from repro_torch.kernels import bitserial_matmul as km
    spec = SerialSpec(2, 2, True, True, 7)
    xp = torch.zeros((2, 4, 1), dtype=torch.int32, device=dev)
    wp = torch.zeros((2, 1, 8), dtype=torch.int32, device=dev)
    ones = torch.ones(8, device=dev)
    with pytest.raises(ValueError, match="K-word"):
        km.bitserial_matmul_v2_cuda(xp, wp, ones, spec=spec, k=33)
    with pytest.raises(TypeError):
        km.bitserial_matmul_v2_cuda(xp.float(), wp, ones, spec=spec, k=8)
    with pytest.raises(ValueError, match="bit-planes"):
        km.bitserial_matmul_v2_cuda(xp, wp, ones,
                                    spec=SerialSpec(3, 2, True, True, 7), k=8)
    with pytest.raises(ValueError, match="emit_packed requires requant"):
        km.bitserial_matmul_v2_cuda(xp, wp, ones, spec=spec, k=8,
                                    emit_packed=True)
    with pytest.raises(ValueError, match="caller declared"):
        km.bitserial_matmul_cuda(torch.zeros((4, 9), dtype=torch.int32,
                                             device=dev), wp, ones,
                                 spec=spec, k=8)


# ------------------------------- tile edges of the tensor-core designs (v2)

_MODES = (("float", None), ("codes", QuantSpec(3, True)),
          ("codes", QuantSpec(12, True)), ("packed", QuantSpec(2, False)))


@pytest.mark.parametrize("sp", [(2, 2, True, True, 7), (8, 4, True, True, 8),
                                (16, 16, True, True, 7)])
@pytest.mark.parametrize("n,h,ci,co,stride", [
    (1, 9, 33, 40, 2),      # batch 1, stride 2, Ci one word + 1 channel
    (1, 5, 600, 70, 1),     # Ci = 600: 19 words per tap
    (3, 5, 33, 100, 2),     # pixels and Co off the 32 x 8 NT tile
    (2, 11, 70, 33, 1)])
def test_conv_kernel_tile_edges(dev, sp, n, h, ci, co, stride):
    spec = SerialSpec(*sp)
    rng = np.random.default_rng(n * 1000 + h * 100 + ci + co + stride)
    xc = _codes(rng, spec.a_bits, spec.a_signed, (n * h * h, ci), dev)
    wc = _codes(rng, spec.w_bits, spec.w_signed, (9 * co, ci), dev)
    xp = k1.pack_codes_ref(xc, spec.a_bits).reshape(
        spec.a_bits, n, h, h, -1).contiguous()
    wp = k1.pack_codes_ref(wc, spec.w_bits).reshape(
        spec.w_bits, 3, 3, co, -1).permute(0, 1, 2, 4, 3).contiguous()
    scale = torch.from_numpy((rng.random(co) * 1e-3).astype(np.float32)
                             ).to(dev)
    bias = torch.from_numpy(rng.standard_normal(co).astype(np.float32)).to(dev)
    rs = torch.tensor(0.3, device=dev)
    for out, rq in _MODES:
        kw = dict(spec=spec, ci=ci, stride=stride, padding=1, relu=False,
                  requant=rq, requant_scale=None if rq is None else rs,
                  emit_packed=out == "packed")
        before = k2.KERNEL.launches
        got = k2.bitserial_conv2d_cuda(xp, wp, scale, bias, **kw)
        assert k2.KERNEL.launches == before + 1
        ref = k2.bitserial_conv2d_ref(xp, wp, scale, bias, **kw)
        assert got.dtype == ref.dtype and torch.equal(got, ref), (out, rq)


@pytest.mark.parametrize("sp", [(8, 4, True, True, 8), (2, 2, True, True, 1),
                                (16, 16, True, True, 7),
                                (8, 8, False, True, 7)])
@pytest.mark.parametrize("m", [1, 4, 5, 17, 64])
@pytest.mark.parametrize("kernel", ["K3", "K4"])
def test_gemm_v2_tile_edges(dev, kernel, sp, m):
    # K3 and K4 share the tile; K4 has no packed output and no divide
    from repro_torch.kernels import bitserial_matmul as km
    spec = SerialSpec(*sp)
    k, n = 100, 70
    rng = np.random.default_rng(m * 31 + sp[0] * 3 + sp[1])
    xc, xp, wp, scale, bias = _gemm_operands(rng, spec, m, k, n, dev)
    rs = torch.tensor(0.37, device=dev)
    for out, rq in _MODES:
        if kernel == "K3":
            kw = dict(spec=spec, k=k, relu=False, requant=rq,
                      requant_scale=None if rq is None else rs,
                      emit_packed=out == "packed")
            got = km.bitserial_matmul_v2_cuda(xp, wp, scale, bias, **kw)
            ref = km.bitserial_matmul_v2_ref(xp, wp, scale, bias, **kw)
        elif out == "packed":
            continue
        else:
            kw = dict(spec=spec, k=k, relu=False, requant=rq,
                      out_dtype=torch.bfloat16)
            before = km.KERNEL.entry_launches["bitserial_matmul_v1"]
            got = km.bitserial_matmul_cuda(xc, wp, scale, bias, **kw)
            assert km.KERNEL.entry_launches["bitserial_matmul_v1"] == before + 1
            ref = km.bitserial_matmul_ref(xc, wp, scale, bias, **kw)
        assert got.dtype == ref.dtype and torch.equal(got, ref), (out, rq)


# ---------------------------------------- every tile the kernels take

# W2A2 and A8W4 run fixed-plane instantiations (NT 1, 2, 4 with up to 32,
# 16, 4 K-split warps), W3A3 runs Any (NT 1, up to 8 warps)
_TILE_PLANS = [(2, 2, True, True, 7), (8, 4, True, True, 8),
               (3, 3, True, True, 7)]


def _every_tile(spec, conv):
    from repro_torch.core import cost_model
    from repro_torch.kernels import tuning
    fixed = cost_model.fixed_plans(spec.a_bits, spec.w_bits, spec.a_signed,
                                   spec.w_signed)
    cls = tuning.ConvTileConfig if conv else tuning.TileConfig
    return [cls(8 * nt, w) for nt in ((1, 2, 4) if fixed else (1,))
            for w in range(1, cost_model.max_warps(fixed, nt) + 1)]


@pytest.mark.parametrize("sp", _TILE_PLANS)
@pytest.mark.parametrize("n,h,ci,co,stride", [
    (1, 9, 33, 40, 2), (1, 5, 600, 70, 1), (3, 5, 33, 100, 2),
    (2, 11, 70, 33, 1)])
def test_conv_every_tile_equals_plain(dev, sp, n, h, ci, co, stride):
    spec = SerialSpec(*sp)
    rng = np.random.default_rng(n * 1000 + h * 100 + ci + co + stride + 7)
    xc = _codes(rng, spec.a_bits, spec.a_signed, (n * h * h, ci), dev)
    wc = _codes(rng, spec.w_bits, spec.w_signed, (9 * co, ci), dev)
    xp = k1.pack_codes_ref(xc, spec.a_bits).reshape(
        spec.a_bits, n, h, h, -1).contiguous()
    wp = k1.pack_codes_ref(wc, spec.w_bits).reshape(
        spec.w_bits, 3, 3, co, -1).permute(0, 1, 2, 4, 3).contiguous()
    scale = torch.from_numpy((rng.random(co) * 1e-3).astype(np.float32)
                             ).to(dev)
    rs = torch.tensor(0.3, device=dev)
    for out, rq in (("float", None), ("packed", QuantSpec(2, False))):
        kw = dict(spec=spec, ci=ci, stride=stride, padding=1, relu=False,
                  requant=rq, requant_scale=None if rq is None else rs,
                  emit_packed=out == "packed")
        ref = k2.bitserial_conv2d_ref(xp, wp, scale, **kw)
        for tile in _every_tile(spec, conv=True):
            got = k2.bitserial_conv2d_cuda(xp, wp, scale, tile=tile, **kw)
            assert torch.equal(got, ref), (out, tile)


@pytest.mark.parametrize("sp", _TILE_PLANS)
@pytest.mark.parametrize("m", [1, 4, 5, 17, 64])
@pytest.mark.parametrize("kernel", ["K3", "K4"])
def test_gemm_every_tile_equals_plain(dev, kernel, sp, m):
    from repro_torch.kernels import bitserial_matmul as km
    spec = SerialSpec(*sp)
    k, n = 100, 70
    rng = np.random.default_rng(m * 31 + sp[0] * 3 + sp[1] + 11)
    xc, xp, wp, scale, bias = _gemm_operands(rng, spec, m, k, n, dev)
    kw = dict(spec=spec, k=k, requant=QuantSpec(3, True))
    if kernel == "K3":
        kw["requant_scale"] = torch.tensor(0.37, device=dev)
        fn, ref = km.bitserial_matmul_v2_cuda, km.bitserial_matmul_v2_ref
        x = xp
    else:
        fn, ref = km.bitserial_matmul_cuda, km.bitserial_matmul_ref
        x = xc
    want = ref(x, wp, scale, bias, **kw)
    for tile in _every_tile(spec, conv=False):
        assert torch.equal(fn(x, wp, scale, bias, tile=tile, **kw), want), \
            tile


def test_a_tile_no_instantiation_takes_raises(dev):
    from repro_torch.kernels import tile_sweep
    seen = tile_sweep.bad_tiles_raise(dev)
    assert len(seen) == 9 and all("CUDA error" in s for s in seen)


# ------------------------------------------------- the continuous LM engine

def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def _engine_load(seed, n=8, max_len=32):
    """Mixed prompt lengths and budgets within ``max_len``."""
    from repro_torch.launch.serve import GenRequest
    rng = np.random.RandomState(seed)
    reqs = []
    for _ in range(n):
        p = int(rng.randint(1, 13))
        reqs.append(GenRequest(rng.randint(0, 512, (p,)).astype(np.int32),
                               int(rng.randint(1, max_len - p + 1))))
    return reqs


@pytest.mark.parametrize("pack_acts", [True, False])
def test_graphed_engine_equals_cpu_engine(dev, pack_acts):
    """The smoke config's engine on the card (decode step captured once,
    replayed) gives the CPU plain engine's tokens, and the plain versions'
    engine on the card gives them too; the capture counted one decode
    step's launches (2 layers: 8 K1 + 14 K3, or 14 K4)."""
    from repro_torch.configs import get_arch
    from repro_torch.serving import ContinuousLMEngine
    cfg = get_arch("stablelm-1.6b").smoke
    gpu = ContinuousLMEngine(cfg, batch_slots=3, max_len=32, seed=0,
                             pack_acts=pack_acts)
    cpu = ContinuousLMEngine(cfg, _to(gpu.params, "cpu"), batch_slots=3,
                             max_len=32, pack_acts=pack_acts, device="cpu")
    gpu.warmup()
    got = [r.out_tokens for r in gpu.serve(_engine_load(1))]
    assert got == [r.out_tokens for r in cpu.serve(_engine_load(1))]
    st = gpu.stats()
    assert st["cuda_graph"] and st["compiles"]["decode"] == 1
    assert st["recompiles_after_warmup"] == 0
    n = cfg.n_layers
    assert st["step_launches"] == ({"K1": 4 * n, "K3": 7 * n, "K4": 0,
                                    "K4g": 0}
                                   if pack_acts else
                                   {"K1": 0, "K3": 0, "K4": 7 * n, "K4g": 0})
    plain = ContinuousLMEngine(cfg, gpu.params, batch_slots=3, max_len=32,
                               pack_acts=pack_acts, plain=True)
    assert [r.out_tokens for r in plain.serve(_engine_load(1))] == got
    assert plain.stats()["step_launches"] == {"K1": 0, "K3": 0, "K4": 0,
                                              "K4g": 0}


def test_replayed_arena_serves_like_a_fresh_engine(dev):
    """A second load, inserted into an arena whose captured step has been
    replayed (rows hold the first load's caches and positions), gives a
    fresh engine's tokens: inserts rewrite the captured buffers in place."""
    from repro_torch.configs import get_arch
    from repro_torch.serving import ContinuousLMEngine
    cfg = get_arch("stablelm-1.6b").smoke
    used = ContinuousLMEngine(cfg, batch_slots=3, max_len=32, seed=0)
    used.serve(_engine_load(1))
    again = [r.out_tokens for r in used.serve(_engine_load(2))]
    fresh = ContinuousLMEngine(cfg, used.params, batch_slots=3, max_len=32)
    assert [r.out_tokens for r in fresh.serve(_engine_load(2))] == again
    assert used.stats()["compiles"]["decode"] == 1
    assert used.stats()["calls"]["decode"] == used.decode_steps > 0



# ---------------------------------- the bucketed runner's graph per bucket

def _tiny_cnn_graph():
    """conv(8->16, 8x8) + relu + gap + fc (the reference serving tests'
    ``tiny_cnn_graph``) and its calibration batch."""
    from repro_torch.compiler.ir import Graph, Node
    rng = np.random.RandomState(0)
    g = Graph("tiny_cnn", {"x": (None, 8, 8, 8)}, ["y"],
              [Node("c1", "conv2d", ["x", "c1.w"], "c1.y",
                    {"stride": 1, "padding": 1}),
               Node("c1.relu", "relu", ["c1.y"], "c1.r"),
               Node("gap", "global_avg_pool", ["c1.r"], "pooled"),
               Node("fc", "gemm", ["pooled", "fc.w"], "y")],
              {"c1.w": (rng.randn(3, 3, 8, 16) * 0.2).astype(np.float32),
               "fc.w": (rng.randn(16, 10) * 0.2).astype(np.float32)})
    return g, np.random.RandomState(42).rand(4, 8, 8, 8).astype(np.float32)


def _policy(a_bits):
    from repro_torch.models.layers import QuantPolicy
    return QuantPolicy(mode="serial", w_bits=2, a_bits=a_bits, radix_bits=7)


def _tiny_cnn_program(dev):
    """tiny_cnn at W2A2 on the card: per forward K1 twice (the conv's and
    the fc's input), K2 once, K3 once."""
    from repro_torch.compiler.lower import compile_graph
    g, calib = _tiny_cnn_graph()
    return compile_graph(g, calib, policy=_policy(2), device=dev)


def _eager_at_bucket(prog, x, b, plain=False):
    from repro_torch.compiler import executor
    pad = torch.zeros((b,) + tuple(x.shape[1:]), device=x.device)
    pad[:len(x)] = x
    run = executor.make_plain_runner if plain else executor.make_runner
    return run(prog)(prog.params, pad)[:len(x)]


@pytest.mark.parametrize("plain", [False, True])
def test_captured_bucket_equals_eager_forward(dev, plain):
    """Warmup captures one graph per bucket and nothing after; each replay
    equals the eager forward at its bucket bit for bit; a capture counts
    one forward's launches (none for the plain versions) and a replay
    calls no wrapper."""
    from repro_torch.compiler import executor
    from repro_torch.kernels import ops
    prog = _tiny_cnn_program(dev)
    runner = executor.make_bucketed_runner(prog, max_batch=8, plain=plain)
    assert runner.warmup() == 4
    want = ({"K1": 0, "K2": 0, "K3": 0, "K4": 0, "K4g": 0} if plain else
            {"K1": 2, "K2": 1, "K3": 1, "K4": 0, "K4g": 0})
    assert runner.capture_launches == {(0, b): want for b in (1, 2, 4, 8)}
    xs = torch.rand((8, 8, 8, 8), generator=torch.Generator().manual_seed(1))
    for n in (1, 3, 5, 8, 3):
        before = ops.launch_counts()
        got = runner(xs[:n])
        assert ops.launch_counts() == before
        b = executor.bucket_for(n, 8)
        assert torch.equal(got, _eager_at_bucket(prog, xs[:n].to(dev), b,
                                                 plain=plain))
    st = runner.stats()
    assert st["compiles"] == 4 and st["cuda_graphs"] == 4
    # one replay per bucket at warmup, then buckets 1, 4, 8, 8, 4
    assert st["replays"] == {(0, 1): 2, (0, 2): 1, (0, 4): 3, (0, 8): 3}


def test_capture_beside_a_busy_thread(dev):
    """Captures run in thread-local error mode on their own side stream:
    another thread allocating and launching on the card meanwhile does not
    break them, whether the capture happens in warmup on this thread or
    lazily on the service's worker. (The other thread draws no random
    numbers on the card: torch's CUDA generator is process-wide and
    refuses to advance outside a capture while one is underway.)"""
    import threading
    from repro_torch.compiler import executor
    from repro_torch.serving import InferenceService, ModelRegistry
    stop = threading.Event()
    errs = []

    def busy():
        try:
            a = torch.full((512, 512), 0.5, device=dev)
            while not stop.is_set():
                b = torch.empty((512, 512), device=dev).fill_(0.25)
                a = torch.tanh(a @ a.T / 512) + b
        except Exception as e:  # noqa: BLE001 — reported below
            errs.append(e)

    t = threading.Thread(target=busy)
    t.start()
    try:
        prog = _tiny_cnn_program(dev)
        runner = executor.make_bucketed_runner(prog, max_batch=8)
        assert runner.warmup() == 4
        reg = ModelRegistry(device=dev)
        key = reg.register_program("tiny", prog, precision="W2A2")
        xs = np.random.RandomState(2).rand(7, 8, 8, 8).astype(np.float32)
        with InferenceService(reg, max_batch=8, max_wait_s=0.0) as svc:
            futs = svc.submit_many(key, list(xs))
            got = np.stack([f.result(timeout=120) for f in futs])
            st = svc.metrics()["bucket_caches"][str(key)]
            spans = svc.tracer.spans()
    finally:
        stop.set()
        t.join(timeout=60)
    assert not t.is_alive() and not errs, errs
    assert st["compiles"] == st["cuda_graphs"] >= 1
    # every micro-batch the worker ran (captured lazily there) equals this
    # thread's warmed runner on the same rows, at the same bucket
    batches = {}
    for sp in spans:
        if sp.name == "execute":
            batches.setdefault((sp.t0_ns, sp.t1_ns), []).append(sp.trace_id)
    assert sorted(i for ids in batches.values() for i in ids) == \
        list(range(1, 8))
    for ids in batches.values():
        rows = [i - 1 for i in sorted(ids)]
        want = runner(torch.from_numpy(xs[rows])).cpu().numpy()
        np.testing.assert_array_equal(got[rows], want)


def test_captured_graph_survives_a_shared_plane_swap(dev):
    """Registering a captured Program in a registry that already holds an
    equal plane swaps the Program's ``w_packed`` for the shared one; the
    graph keeps the plane it was captured over alive, so a replay after the
    swap (and after the allocator has handed out fresh memory) still equals
    the eager forward, which now reads the shared plane."""
    import gc
    import weakref
    from repro_torch.compiler import executor
    from repro_torch.serving import ModelRegistry
    prog = _tiny_cnn_program(dev)
    runner = executor.make_bucketed_runner(prog, max_batch=4)
    assert runner.warmup() == 3
    packed = {n: p["w_packed"] for n, p in prog.params.items()
              if "w_packed" in p}
    assert len(packed) == 2
    old = {n: weakref.ref(t) for n, t in packed.items()}
    reg = ModelRegistry(device=dev)
    reg.register_program("tiny", _tiny_cnn_program(dev), precision="A")
    reg.register_program("tiny", prog, precision="B")
    assert reg.stats()["shared_arrays"] == 2
    assert all(prog.params[n]["w_packed"] is not t
               and torch.equal(prog.params[n]["w_packed"], t)
               for n, t in packed.items())
    del packed
    gc.collect()
    assert all(r() is not None for r in old.values())
    # hand the freed blocks of a plane, were there any, to garbage
    junk = [torch.full((1 << 16,), -1, dtype=torch.int32, device=dev)
            for _ in range(64)]
    xs = torch.rand((4, 8, 8, 8), generator=torch.Generator().manual_seed(4))
    for n in (1, 3, 4):
        got = runner(xs[:n])
        b = executor.bucket_for(n, 4)
        assert torch.equal(got, _eager_at_bucket(prog, xs[:n].to(dev), b))
    del runner, junk
    gc.collect()
    assert all(r() is None for r in old.values())


def test_eviction_frees_the_captured_graphs(dev):
    """When the registry evicts a variant the service drops its runner, and
    with it the graphs captured over the evicted Program's parameters."""
    import gc
    import weakref
    from repro_torch.serving import InferenceService, ModelRegistry
    g, calib = _tiny_cnn_graph()
    reg = ModelRegistry(device=dev, max_programs=1)
    ka = reg.register_graph("tiny", g, calib, _policy(2))
    kb = reg.register_graph("tiny", g, calib, _policy(4))
    x = np.random.RandomState(3).rand(8, 8, 8).astype(np.float32)
    with InferenceService(reg, max_batch=4, max_wait_s=0.0) as svc:
        ya = svc.submit(ka, x).result(timeout=120)
        graphs = [weakref.ref(bg.graph)
                  for bg in svc._runners[ka]._graphs.values()]
        outs = [weakref.ref(bg.out)
                for bg in svc._runners[ka]._graphs.values()]
        assert len(graphs) == 1 and graphs[0]() is not None
        svc.submit(kb, x).result(timeout=120)      # evicts ka
        assert reg.resident_program(ka) is None
        assert ka not in svc._runners
        gc.collect()
        assert all(r() is None for r in graphs + outs)
        np.testing.assert_array_equal(svc.submit(ka, x).result(timeout=120),
                                      ya)


# the routed experts' shapes of deepseek-v2-lite (E = 64; C = 1 at a
# batch-4 decode step, 2 at a 16-token prefill bucket, 8 at a 4 x 16
# prefill; (K, N) of up/gate and of down) and a ragged one
GROUPED = [(64, c, 2048, 1408) for c in (1, 2, 8)] + [
    (64, 1, 1408, 2048), (64, 8, 1408, 2048), (3, 5, 100, 70)]
# rows that are all zero (the kernel reads no weight for a row tile of
# them) and the edges of its tiles: experts the dispatch left empty at a
# decode shape, a zero row inside a nonzero 16-row tile, an all-zero input,
# N off the 128-column tile (a multiple of 4: 16-byte copies; and not),
# K off 32 and off 4 (codes loaded one by one), E = 1, K past one staged
# segment, C past one row tile
GROUPED_EDGES = [((64, 1, 2048, 1408), "experts"), ((3, 12, 100, 70), "row"),
                 ((64, 2, 1408, 2048), "all"), ((4, 3, 256, 200), None),
                 ((4, 3, 256, 130), None), ((2, 4, 1001, 256), None),
                 ((1, 5, 300, 140), None), ((2, 2, 5000, 64), None),
                 ((2, 20, 96, 64), "row")]


def _grouped(dev, sp, e, c, k, n, seed, zeros=None):
    from repro_torch.core import bitops
    spec = SerialSpec(*sp)
    rng = np.random.default_rng(seed)
    x = _codes(rng, spec.a_bits, spec.a_signed, (e, c, k), dev)
    if zeros == "experts":
        x[torch.arange(e, device=dev) % 3 != 1] = 0
    elif zeros == "row":
        x[:, c // 2] = 0
    elif zeros == "all":
        x.zero_()
    w = _codes(rng, spec.w_bits, spec.w_signed, (e, k, n), dev)
    planes = bitops.pad_to(bitops.to_bitplanes(w, spec.w_bits), 32, axis=-2)
    wp = bitops.pack_bitplanes(planes, axis=-2).movedim(0, 1).contiguous()
    return spec, x, wp


# W4A8 (the model's plan) at every shape; W2A2 and unsigned W8A8 at a
# decode shape and the ragged one; every edge at all three plans
PLANS = ((8, 4, True, True, 8), (2, 2, True, True, 1), (8, 8, False, True, 7))
GROUPED_CASES = [(PLANS[0], s, None) for s in GROUPED] + [
    (sp, s, None) for sp in PLANS[1:] for s in (GROUPED[0], GROUPED[-1])] + [
    (sp, s, z) for sp in PLANS for s, z in GROUPED_EDGES]


@pytest.mark.parametrize("sp,shape,zeros", GROUPED_CASES)
def test_grouped_code_gemm_equals_plain(dev, sp, shape, zeros):
    """Grouped K4: all E experts' (C, K) x (K, N) in one launch, raw int32
    accumulators equal to ``serial_matmul_packed`` per expert."""
    from repro_torch.kernels import bitserial_matmul as km
    e, c, k, n = shape
    spec, x, wp = _grouped(dev, sp, e, c, k, n, e * c + k, zeros)
    before = km.GROUPED.entry_launches["bitserial_matmul_v1_grouped"]
    got = km.bitserial_matmul_grouped_cuda(x, wp, spec=spec, k=k)
    assert km.GROUPED.entry_launches["bitserial_matmul_v1_grouped"] == \
        before + 1
    torch.cuda.synchronize()
    assert got.shape == (e, c, n) and got.dtype == torch.int32
    assert torch.equal(got, km.bitserial_matmul_grouped_ref(x, wp, spec=spec,
                                                            k=k))


def test_grouped_code_gemm_rejects_bad_inputs(dev):
    from repro_torch.kernels import bitserial_matmul as km
    spec, x, wp = _grouped(dev, (8, 4, True, True, 8), 3, 2, 64, 40, 0)
    with pytest.raises(ValueError, match="groups"):
        km.bitserial_matmul_grouped_cuda(x[:2].contiguous(), wp, spec=spec,
                                         k=64)
    with pytest.raises(ValueError, match="caller declared"):
        km.bitserial_matmul_grouped_cuda(x, wp, spec=spec, k=60)
    with pytest.raises(ValueError, match="bit-planes"):
        km.bitserial_matmul_grouped_cuda(x, wp, spec=SerialSpec(8, 2), k=64)
    with pytest.raises(TypeError):
        km.bitserial_matmul_grouped_cuda(x.float(), wp, spec=spec, k=64)
    with pytest.raises(ValueError, match="contiguous"):
        km.bitserial_matmul_grouped_cuda(x.transpose(1, 2), wp, spec=spec,
                                         k=64)


@pytest.mark.parametrize("pack_acts", [True, False])
def test_graphed_moe_engine_equals_cpu_engine(dev, pack_acts):
    """deepseek-v2-lite's smoke config on the card: the captured decode
    step (MLA latent cache, MoE dispatch, grouped K4) gives the CPU plain
    engine's tokens; one grouped K4 per routed projection of each MoE
    layer is counted at capture (3 layers: one dense, two MoE)."""
    from repro_torch.configs import get_arch
    from repro_torch.serving import ContinuousLMEngine
    cfg = get_arch("deepseek-v2-lite-16b").smoke
    gpu = ContinuousLMEngine(cfg, batch_slots=3, max_len=32, seed=0,
                             pack_acts=pack_acts)
    cpu = ContinuousLMEngine(cfg, _to(gpu.params, "cpu"), batch_slots=3,
                             max_len=32, pack_acts=pack_acts, device="cpu")
    gpu.warmup()
    got = [r.out_tokens for r in gpu.serve(_engine_load(1))]
    assert got == [r.out_tokens for r in cpu.serve(_engine_load(1))]
    st = gpu.stats()
    assert st["cuda_graph"] and st["recompiles_after_warmup"] == 0
    n, n_moe = cfg.n_layers, cfg.n_layers - cfg.n_dense_layers
    assert st["step_launches"] == (
        {"K1": 4 * n, "K3": 6 * n, "K4": 0, "K4g": 3 * n_moe} if pack_acts
        else {"K1": 0, "K3": 0, "K4": 6 * n, "K4g": 3 * n_moe})
    # the same routing (the tokens agree); each fraction is a float32 mean
    # that the card's and the CPU's reductions round apart by an ulp
    np.testing.assert_allclose(gpu.drop_fractions(), cpu.drop_fractions(),
                               rtol=0, atol=1e-6)


# ---------------------------------------------- the artifact store on the card

def _stored_tiny_cnn(root):
    """tiny_cnn at W2A2 and W2A8 compiled on the card by a registry with a
    store: returns the two compiled Programs (the store holds both, their
    shared planes once)."""
    from repro_torch.serving import ModelRegistry
    g, calib = _tiny_cnn_graph()
    reg = ModelRegistry(store=root)
    keys = [reg.register_graph("tiny", g, calib, _policy(a)) for a in (2, 8)]
    return [reg.program(k) for k in keys]


def test_loaded_planes_on_the_card_and_shared(dev, tmp_path):
    """A registry on the card loads a store's Programs onto the card; the
    planes the W2A2 and W2A8 variants share are one tensor there."""
    from repro_torch.serving import ModelRegistry
    root = str(tmp_path / "store")
    compiled = _stored_tiny_cnn(root)
    reg = ModelRegistry(store=root)
    keys = [reg.register_artifact("tiny", precision=p)
            for p in ("W2A2", "W2A8")]
    progs = [reg.program(k) for k in keys]
    assert reg.compiles == 0 and reg.artifact_hits == 2
    for p, c in zip(progs, compiled):
        assert p.device.type == "cuda"
        for name, rec in p.params.items():
            for key, t in rec.items():
                assert t.device.type == "cuda", (name, key)
                assert torch.equal(t, c.params[name][key].to(t.device))
    shared = [n for n, rec in progs[0].params.items() if "w_packed" in rec]
    assert shared
    for n in shared:
        assert progs[0].params[n]["w_packed"] is progs[1].params[n]["w_packed"]


def test_warm_boot_captures_over_the_loaded_tensors(dev, tmp_path):
    """The service's warm boot restores both variants with zero compiles
    and captures every bucket over the loaded Programs; every replay
    equals the compiled Program's eager forward at its bucket."""
    from repro_torch.compiler import executor
    from repro_torch.serving import InferenceService, ModelRegistry
    root = str(tmp_path / "store")
    compiled = _stored_tiny_cnn(root)
    reg = ModelRegistry(store=root)
    keys = [reg.register_artifact("tiny", precision=p)
            for p in ("W2A2", "W2A8")]
    xs = np.random.RandomState(5).rand(4, 8, 8, 8).astype(np.float32)
    with InferenceService(reg, max_batch=4, max_wait_s=0.0) as svc:
        report = svc.warm_boot()
        assert report["compiled"] == [] and len(report["restored"]) == 2
        assert report["bucket_compiles"] == 6
        for k, c in zip(keys, compiled):
            run = svc._runners[k]
            assert run.program is reg.program(k)
            held = {id(t) for bg in run._graphs.values() for t in bg.params}
            assert all(id(t) in held for rec in run.program.params.values()
                       for t in rec.values())
            for n in (1, 3, 4):
                got = run(torch.from_numpy(xs[:n]))
                want = _eager_at_bucket(c, torch.from_numpy(xs[:n]).to(dev),
                                        executor.bucket_for(n, 4))
                assert torch.equal(got, want)
            assert run.compiles == 3


def test_profiler_times_on_the_card(dev):
    """Event-timed steps are positive and finite; each step launches its
    kernel once per call (K2 per conv_packed, K1 per quantize_pack, K3
    per gemm_packed) and the host steps launch none."""
    import math
    from repro_torch.obs import calibrate
    from repro_torch.obs.profiler import profile_program
    prog = _tiny_cnn_program(dev)
    prof = profile_program(prog, batch=4, repeats=2)
    assert prof.backend == "cuda"
    want = {"conv_packed": {"K2": 1}, "quantize_pack": {"K1": 1},
            "gemm_packed": {"K3": 1}}
    for s in prof.steps:
        assert math.isfinite(s.wall_ns) and s.wall_ns > 0, s.name
        assert s.launches == want.get(s.kind, {}), s.name
    cal = calibrate.fit(prof)
    assert cal.backend == "cuda" and cal.ns_for("conv_packed") > 0


# ------------------------------------------------------------------ training

def _train_cfg(**kw):
    import dataclasses
    from repro_torch.configs import get_arch
    return dataclasses.replace(get_arch("stablelm-1.6b").smoke, **kw)


@pytest.mark.parametrize("remat", [False, True])
def test_train_step_on_the_card_matches_the_cpu(dev, remat):
    """One smoke-config train step (forward, backward, AdamW) on the card
    against the CPU from the same state and batch. Tolerances: the loss
    1e-5 relative (float32 GEMMs sum in another order on the card, TF32
    off); the grad norm 1e-4 relative; AdamW's moments, ``m`` (0.1 x the
    clipped gradient ``g``) 1e-3 and ``v`` (0.05 x ``g**2``) 2e-3 of each
    leaf's largest element, as the gradients against the reference (an
    activation code that flips at a rounding boundary moves the step
    sizes' gradients). Each param's update ``p_new - p_old`` is held to
    the CPU's within 1e-5 relative, plus two float32 ulps of the param,
    on the elements whose ``|m|`` is at least 1e-2 of the leaf's largest
    (ten times ``m``'s tolerance, so ``g``'s sign is the same on both):
    there the first step moves a weight by ``lr * (g / (|g| + eps) + wd
    * p)``, so a lost decay (``wd * p`` is 1e-3 of the step where
    ``|p|`` is 0.01), a wrong bias correction or a division turned into a multiply
    breaks it. Every param moves by at most 2 x ``lr`` from the CPU's."""
    from repro_torch.core.pipeline_modules import disable_tf32
    from repro_torch.core.tree import tree_leaves
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.train import make_train_step
    from repro_torch.models.transformer import init_params
    from repro_torch.optim import AdamWConfig, adamw_init
    disable_tf32()
    cfg = _train_cfg(remat=remat)
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    params = init_params(torch.Generator().manual_seed(0), cfg)
    state = {"params": params, "opt": adamw_init(params)}
    batch = {k: torch.from_numpy(v).long() for k, v in
             SyntheticLM(cfg.vocab_size, 16, seed=0).batch(0, 4).items()}
    step = make_train_step(cfg, opt)
    cpu, m_cpu = step(state, batch)
    gpu, m_gpu = step(_to(state, dev), _to(batch, dev))
    assert float(m_gpu["loss"]) == pytest.approx(float(m_cpu["loss"]),
                                                 rel=1e-5)
    assert float(m_gpu["grad_norm"]) == pytest.approx(
        float(m_cpu["grad_norm"]), rel=1e-4)
    for key, tol in (("m", 1e-3), ("v", 2e-3)):
        for a, b in zip(tree_leaves(gpu["opt"][key]),
                        tree_leaves(cpu["opt"][key])):
            err = float((a.cpu() - b).abs().max())
            assert err <= tol * float(b.abs().max()), (key, err)
    held = 0
    for a, b, p0, m in zip(tree_leaves(gpu["params"]),
                           tree_leaves(cpu["params"]), tree_leaves(params),
                           tree_leaves(cpu["opt"]["m"])):
        assert a.device.type == "cuda"
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=0,
                                   atol=2 * opt.lr)
        sure = m.abs() >= 1e-2 * m.abs().max()
        d_gpu = (a.cpu() - p0).double()[sure]
        d_cpu = (b - p0).double()[sure]
        ulp = 2 * 2.0 ** -23 * p0.abs().double()[sure]
        assert bool(((d_gpu - d_cpu).abs()
                     <= 1e-5 * d_cpu.abs() + ulp).all())
        held += int(sure.sum())
    assert held > 0


def test_supervised_resume_on_the_card_is_bit_exact(dev, tmp_path):
    """A supervised run on the card (bf16 compute, remat) with a failure
    injected equals an uninterrupted one bit for bit: the embedding's
    backward and every other kernel of the step repeat."""
    from repro_torch.core.tree import tree_leaves
    from repro_torch.launch.train import Trainer
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.fault_tolerance import FailureInjector
    cfg = _train_cfg(remat=True, dtype="bfloat16")
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=6)

    def run(ckpt, inj):
        tr = Trainer(cfg, opt_cfg=opt, ckpt_dir=ckpt, batch_size=4,
                     seq_len=32, save_every=2)
        assert tr.device.type == "cuda"
        return tr.run(6, injector=inj, log_every=100)

    clean, lc = run(None, None)
    faulty, lf = run(str(tmp_path), FailureInjector(fail_at_steps=(3,)))
    assert lf == lc[:3] + lc[2:]
    for a, b in zip(tree_leaves(clean), tree_leaves(faulty)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_float_engine_graph_equals_its_eager_step(dev):
    """``ContinuousLMEngine(quantized=False)`` on the card captures its
    float decode step (LSQ's forward, no kernel of the port) as a CUDA
    graph; the replays give the same engine's tokens stepping eagerly on
    the same load, and the CPU's."""
    from repro_torch.configs import get_arch
    from repro_torch.serving import ContinuousLMEngine
    cfg = get_arch("stablelm-1.6b").smoke
    eng = ContinuousLMEngine(cfg, quantized=False, batch_slots=3,
                             max_len=32, seed=0)
    got = [r.out_tokens for r in eng.serve(_engine_load(1))]
    st = eng.stats()
    assert st["cuda_graph"] and st["step_launches"] == {
        "K1": 0, "K3": 0, "K4": 0, "K4g": 0}
    eng._fresh_arena()
    eng._graph = None
    assert [r.out_tokens for r in eng.serve(_engine_load(1))] == got
    cpu = ContinuousLMEngine(cfg, _to(eng.params, "cpu"), quantized=False,
                             batch_slots=3, max_len=32, device="cpu")
    assert [r.out_tokens for r in cpu.serve(_engine_load(1))] == got


# ---------------------------------- the six remaining architectures' shapes

# (K, N) of qwen1.5-110b's MLP and biased q and k/v, command-r-plus-104b's
# and nemotron-4-15b's MLPs and seamless-m4t-large-v2's
FAMILY_GEMMS = [(8192, 49152), (49152, 8192), (8192, 8192), (8192, 1024),
                (12288, 33792), (33792, 12288), (6144, 24576), (24576, 6144),
                (1024, 8192), (8192, 1024)]


def _packed_codes(gen, spec, k, n, dev):
    """Random (K, N) weight codes, packed."""
    from repro_torch.models.layers import pack_weight_codes
    lo, hi = qrange(spec.w_bits, spec.w_signed)
    return pack_weight_codes(torch.randint(lo, hi + 1, (k, n), generator=gen,
                                           device=dev, dtype=torch.int32),
                             spec.w_bits)


@pytest.mark.parametrize("k,n", FAMILY_GEMMS)
def test_gemm_kernels_equal_plain_with_a_bias_at_family_shapes(dev, k, n):
    """K3 and K4 at W4A8 with a nonzero bias (the epilogue's FMA) at the
    new models' shapes, decode (M = 4) and prefill (M = 64): exact. At K =
    49152 the int32 sums reach 127 x 8 x 49152, under 2^31."""
    from repro_torch.kernels import bitserial_matmul as km
    spec = SerialSpec(8, 4, True, True, 8)
    gen = torch.Generator(device=dev).manual_seed(k + n)
    wp = _packed_codes(gen, spec, k, n, dev)
    scale = torch.rand(n, generator=gen, device=dev) * 2e-3 + 1e-4
    bias = torch.randn(n, generator=gen, device=dev) * 0.1
    lo, hi = qrange(spec.a_bits, spec.a_signed)
    for m in (4, 64):
        xc = torch.randint(lo, hi + 1, (m, k), generator=gen, device=dev,
                           dtype=torch.int32)
        if m == 4:
            xc[0] = hi                       # the largest sums
        xp = k1.pack_codes_ref(xc, spec.a_bits)
        got = km.bitserial_matmul_v2_cuda(xp, wp, scale, bias, spec=spec,
                                          k=k)
        assert torch.equal(got, km.bitserial_matmul_v2_ref(
            xp, wp, scale, bias, spec=spec, k=k)), m
        got = km.bitserial_matmul_cuda(xc, wp, scale, bias, spec=spec, k=k)
        assert torch.equal(got, km.bitserial_matmul_ref(
            xc, wp, scale, bias, spec=spec, k=k)), m


@pytest.mark.parametrize("c", [1, 5])
@pytest.mark.parametrize("k,n", [(4096, 1536), (1536, 4096)])
def test_grouped_code_gemm_at_qwen3_moe_experts(dev, k, n, c):
    """Grouped K4 at qwen3-moe-235b-a22b's 128 experts (C = 1 at a batch-4
    decode step, 5 at a 64-token prefill), every expert's rows nonzero and
    two experts in three empty: exact."""
    from repro_torch.kernels import bitserial_matmul as km
    spec = SerialSpec(8, 4, True, True, 8)
    gen = torch.Generator(device=dev).manual_seed(k * c)
    wp = torch.stack([_packed_codes(gen, spec, k, n, dev)
                      for _ in range(128)])
    lo, hi = qrange(spec.a_bits, spec.a_signed)
    x = torch.randint(lo, hi + 1, (128, c, k), generator=gen, device=dev,
                      dtype=torch.int32)
    for xx in (x, x * (torch.arange(128, device=dev) % 3 == 1)[:, None,
                                                                None]):
        got = km.bitserial_matmul_grouped_cuda(xx.contiguous(), wp,
                                               spec=spec, k=k)
        assert torch.equal(got, km.bitserial_matmul_grouped_ref(
            xx.contiguous(), wp, spec=spec, k=k))


def _seeded_biases(tree, gen):
    if isinstance(tree, dict):
        for key, v in tree.items():
            if key == "b" and torch.is_tensor(v):
                v.copy_(torch.randn(v.shape, generator=gen,
                                    device=v.device) * 0.1)
            else:
                _seeded_biases(v, gen)
    elif isinstance(tree, list):
        for v in tree:
            _seeded_biases(v, gen)


@pytest.mark.parametrize("arch", ["qwen1.5-110b", "nemotron-4-15b",
                                  "qwen3-moe-235b-a22b"])
def test_graphed_engine_on_new_families_equals_cpu_engine(dev, arch):
    """The smoke config's engine on the card (nonzero q/k/v biases for
    qwen1.5, a squared-ReLU MLP, 8 experts without a shared one) gives the
    CPU plain engine's tokens."""
    from repro_torch.configs import get_arch
    from repro_torch.serving import ContinuousLMEngine
    cfg = get_arch(arch).smoke
    gpu = ContinuousLMEngine(cfg, batch_slots=3, max_len=32, seed=0)
    _seeded_biases(gpu.params, torch.Generator(device=dev).manual_seed(3))
    cpu = ContinuousLMEngine(cfg, _to(gpu.params, "cpu"), batch_slots=3,
                             max_len=32, device="cpu")
    gpu.warmup()
    got = [r.out_tokens for r in gpu.serve(_engine_load(2))]
    assert got == [r.out_tokens for r in cpu.serve(_engine_load(2))]
    assert gpu.stats()["cuda_graph"]


@pytest.mark.parametrize("arch", ["internvl2-76b", "seamless-m4t-large-v2"])
def test_frontend_prefill_and_decode_on_the_card_equal_cpu(dev, arch):
    """The VLM with its patch embeddings and the encoder-decoder with its
    source frames, at the smoke config: prefill and three greedy decode
    steps through the kernels give the CPU plain run's tokens."""
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tt
    cfg = tt.serve_policy(get_arch(arch).smoke, pack_acts=True)
    params = tt.init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                            packed=True)
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab_size, (3, 6)).astype(np.int64)
    extra = (("frontend_embeds", (3, cfg.frontend_len, cfg.frontend_dim))
             if cfg.family == "vlm" else ("src_embeds", (3, 5,
                                                         cfg.frontend_dim)))
    emb = rng.standard_normal(extra[1]).astype(np.float32)
    s0 = 6 + (cfg.frontend_len if cfg.family == "vlm" else 0)

    def run(p, device):
        batch = {"tokens": torch.from_numpy(toks).to(device),
                 extra[0]: torch.from_numpy(emb).to(device)}
        out = []
        with torch.inference_mode():
            lg, c = tt.prefill(p, batch, cfg, max_len=s0 + 4)
            for t in range(3):
                tok = torch.argmax(lg, -1)[:, None]
                out.append(tok.cpu())
                lg, c = tt.decode_step(p, c, tok, s0 + t, cfg)
        return torch.cat(out, 1)

    assert torch.equal(run(params, dev), run(_to(params, "cpu"), "cpu"))


# ------------------------------------------------ array scaling on one card

def _shard_forwards(prog, x, n_banks):
    """The eager forward of each bank's shard of ``x``, concatenated."""
    from repro_torch.compiler import executor
    s = len(x) // n_banks
    run = executor.make_runner(prog)
    return torch.cat([run(prog.params, x[i * s:(i + 1) * s])
                      for i in range(n_banks)])


@pytest.mark.parametrize("placement", ["banked", "sharded"])
def test_bank_graphs_on_four_streams_equal_eager_forwards(dev, placement):
    """Four banks are four streams on the card, each with its own graph
    per bucket: warmup captures every (bank, bucket) with one forward's
    launches, nothing is captured after it, and every answer — read on
    the caller's stream right away, twice over — equals the eager forward
    of its rows at the bank's batch."""
    from repro_torch.compiler import executor
    from repro_torch.distributed import program_parallel as pp
    from repro_torch.kernels import ops
    prog = _tiny_cnn_program(dev)
    kw = ({"banks": pp.bank_devices(4)} if placement == "banked"
          else {"mesh": pp.bank_mesh(4)})
    runner = executor.make_bucketed_runner(prog, max_batch=8, **kw)
    assert len({b.stream for b in runner._banks}) == 4
    buckets = executor.bucket_sizes(8, 1 if placement == "banked" else 4)
    assert runner.warmup() == (4 * len(buckets) if placement == "banked"
                               else len(buckets))
    want = {"K1": 2, "K2": 1, "K3": 1, "K4": 0, "K4g": 0}
    assert runner.capture_launches == {(i, b): want for i in range(4)
                                       for b in buckets}
    xs = torch.rand((8, 8, 8, 8), generator=torch.Generator().manual_seed(5))
    for _ in range(2):
        for j, n in enumerate((1, 3, 5, 8, 2, 7)):
            b = executor.bucket_for(n, 8, runner._multiple)
            pad = torch.zeros((b, 8, 8, 8), device=dev)
            pad[:n] = xs[:n].to(dev)
            before = ops.launch_counts()
            if placement == "banked":
                got = runner(xs[:n], bank=j % 4)
                assert ops.launch_counts() == before   # a replay: no wrapper
                ref = _eager_at_bucket(prog, xs[:n].to(dev), b)
            else:
                got = runner(xs[:n])
                assert ops.launch_counts() == before
                ref = _shard_forwards(prog, pad, 4)[:n]
            assert torch.equal(got, ref), (placement, n)
    assert runner.stats()["cuda_graphs"] == 4 * len(buckets)


def test_sharded_pipelined_and_gpipe_on_four_streams(dev):
    """ShardedProgram and PipelinedProgram on four streams of the card
    equal single-bank eager forwards of their shards and microbatches;
    gpipe over four banks equals the sequential float32 stack (TF32 off)
    within the reference test's tolerance."""
    from repro_torch.core.pipeline_modules import disable_tf32
    from repro_torch.distributed import program_parallel as pp
    from repro_torch.distributed.pipeline_parallel import gpipe, stage_stack
    disable_tf32()
    prog = _tiny_cnn_program(dev)
    x = torch.rand((16, 8, 8, 8), generator=torch.Generator().manual_seed(6)
                   ).to(dev)
    sp = pp.ShardedProgram(prog, pp.bank_mesh(4))
    for _ in range(2):
        assert torch.equal(sp(x), _shard_forwards(prog, x, 4))
    for n_stages in (2, 4):
        pl = pp.PipelinedProgram(prog, n_stages=n_stages)
        assert torch.equal(pl(x, n_microbatches=4), _shard_forwards(prog, x,
                                                                    4))
    g = torch.Generator(device=dev).manual_seed(0)
    ws = torch.randn((8, 256, 256), generator=g, device=dev) / 16
    h = torch.randn((32, 256), generator=g, device=dev)
    ref = h
    for w in ws:
        ref = torch.tanh(ref @ w)

    def stage_fn(wstage, t):
        for w in wstage:
            t = torch.tanh(t @ w)
        return t

    y = gpipe(stage_fn, stage_stack(ws, 4), h, banks=pp.bank_devices(4))
    torch.testing.assert_close(y, ref, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("n_groups", [1, 2, 4])
def test_two_matrix_moe_groups_on_the_card(dev, n_groups):
    """A relu2 MoE layer, packed, through grouped K4: two launches a layer
    whatever ``n_groups`` is, and the result equal to the plain versions'
    on the card bit for bit."""
    from repro_torch.kernels import bitserial_matmul as km
    from repro_torch.models import moe
    from repro_torch.models.layers import QuantPolicy
    from repro_torch.models.transformer import _pack_tree
    cfg = moe.MoEConfig(d_model=256, d_ff_expert=128, n_experts=8, top_k=2,
                        act="relu2")
    pol = QuantPolicy(mode="qat", w_bits=4, a_bits=8)
    p = _pack_tree(moe.moe_init(torch.Generator(device=dev).manual_seed(0),
                                cfg, pol), pol)
    x = torch.randn((64, 256), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(1))
    before = km.GROUPED.entry_launches["bitserial_matmul_v1_grouped"]
    got, _ = moe.moe_apply(p, x, cfg, pol, n_groups=n_groups)
    assert (km.GROUPED.entry_launches["bitserial_matmul_v1_grouped"]
            == before + 2)
    ref, _ = moe.moe_apply(p, x, cfg, QuantPolicy(mode="qat", w_bits=4,
                                                  a_bits=8, plain=True),
                           n_groups=n_groups)
    assert torch.equal(got, ref)
