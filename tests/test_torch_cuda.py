"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: every test skips (with its reason) where no CUDA device is
present, and the card is looked for inside a fixture, never at import. On a
machine with the card, from the root of the checkout:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The first test to need a kernel builds it with ``nvcc`` (seconds). Every
comparison is exact (``torch.equal``): the kernels compute the same integer
arithmetic and the same single-rounding epilogue as the plain versions.
"""

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
    assert st["step_launches"] == ({"K1": 4 * n, "K3": 7 * n, "K4": 0}
                                   if pack_acts else
                                   {"K1": 0, "K3": 0, "K4": 7 * n})
    plain = ContinuousLMEngine(cfg, gpu.params, batch_slots=3, max_len=32,
                               pack_acts=pack_acts, plain=True)
    assert [r.out_tokens for r in plain.serve(_engine_load(1))] == got
    assert plain.stats()["step_launches"] == {"K1": 0, "K3": 0, "K4": 0}


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

