"""The port's core numerics (``repro_torch.core``) against the JAX package's
(``repro.core``): the same integer inputs, made with numpy from a seed, go
through both.

Every integer result (bit planes, packed words, digits, codes, serial
matmul/conv accumulators) is compared exactly. Float results state their
tolerance where they have one.
"""

import _torch_threads  # noqa: F401  (first: caps torch's threads under xdist)

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitops as jb
from repro.core import bitserial as jbs
from repro.core import pipeline_modules as jpm
from repro.core import quant as jq

from repro_torch.core import bitops as tb
from repro_torch.core import bitserial as tbs
from repro_torch.core import pipeline_modules as tpm
from repro_torch.core import quant as tq

BITS = [(b, s) for b in (1, 2, 3, 4, 5, 7, 8, 12, 16) for s in (True, False)]


def _ints(rng, bits, signed, shape):
    lo, hi = jq.qrange(bits, signed)
    return rng.integers(lo, hi + 1, shape).astype(np.int32)


def _t(a):
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a, order="C"))


def _words(t):
    """The port's int32 words as the reference's uint32."""
    return t.numpy().view(np.uint32)


# ------------------------------------------------------------------ bitops

@pytest.mark.parametrize("bits,signed", BITS)
def test_bitplanes_pack_unpack_match(bits, signed):
    rng = np.random.default_rng(bits * 2 + signed)
    x = _ints(rng, bits, signed, (5, 70))
    tp = tb.to_bitplanes(_t(x), bits)
    jp = jb.to_bitplanes(jnp.asarray(x), bits)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tb.from_bitplanes(tp, signed).numpy(), x)
    tw = tb.pack_bitplanes(tb.pad_to(tp, 32), axis=-1)
    jw = jb.pack_bitplanes(jb.pad_to(jp, 32), axis=-1)
    assert tw.dtype == torch.int32
    np.testing.assert_array_equal(_words(tw), np.asarray(jw))
    back = tb.unpack_bitplanes(tw, 70)
    np.testing.assert_array_equal(back.numpy(), tp.numpy())


def test_bit31_lane():
    """Lane 31 lands in bit 31: the word's sign bit in int32."""
    planes = torch.zeros((1, 2, 32), dtype=torch.int8)
    planes[0, 0, 31] = 1
    planes[0, 1, :] = 1
    words = tb.pack_bitplanes(planes)
    assert words[0, 0].item() == -(1 << 31) and words[0, 1].item() == -1
    np.testing.assert_array_equal(
        _words(words), np.asarray(jb.pack_bitplanes(jnp.asarray(planes.numpy()))))
    # the word -1 unpacks to 32 ones under the arithmetic shift
    assert tb.unpack_bitplanes(words, 32)[0, 1].sum().item() == 32
    assert tb.unpack_bitplanes(words, 32)[0, 0, 31].item() == 1


def test_pack_axis_and_errors():
    rng = np.random.default_rng(1)
    planes = rng.integers(0, 2, (2, 64, 3)).astype(np.int8)
    np.testing.assert_array_equal(
        _words(tb.pack_bitplanes(_t(planes), axis=1)),
        np.asarray(jb.pack_bitplanes(jnp.asarray(planes), axis=1)))
    with pytest.raises(ValueError):
        tb.pack_bitplanes(torch.zeros((2, 33), dtype=torch.int8))


@pytest.mark.parametrize("radix", range(1, 9))
@pytest.mark.parametrize("bits,signed", [(1, True), (2, True), (4, False),
                                         (8, True), (8, False), (13, True),
                                         (16, False)])
def test_digits_match(bits, signed, radix):
    if radix == 8 and not (signed and bits <= 8):
        with pytest.raises(ValueError):
            tb.num_digits(bits, radix, signed)
        return
    assert tb.num_digits(bits, radix, signed) == jb.num_digits(bits, radix,
                                                               signed)
    rng = np.random.default_rng(bits * 17 + radix)
    x = _ints(rng, bits, signed, (40,))
    td = tb.to_digits(_t(x), bits, radix, signed)
    np.testing.assert_array_equal(
        td.numpy(), np.asarray(jb.to_digits(jnp.asarray(x), bits, radix,
                                            signed)))
    np.testing.assert_array_equal(
        jb.from_digits(jnp.asarray(td.numpy()), bits, radix, signed), x)
    planes = tb.to_bitplanes(_t(x), bits)
    np.testing.assert_array_equal(
        tbs.digits_from_planes(planes, bits, radix, signed).numpy(),
        np.asarray(jbs.digits_from_planes(jnp.asarray(planes.numpy()), bits,
                                          radix, signed)))


@pytest.mark.parametrize("bits,signed", [(1, False), (2, True), (4, True),
                                         (8, True), (8, False), (9, True),
                                         (16, True), (16, False)])
def test_kernel_digits_round_trip(bits, signed):
    """The tensor-core kernels' digit count: one signed int8 digit for a
    signed operand of <= 8 bits, else radix-7 digits; the reference's
    digits at that radix rebuild the operand."""
    radix = 8 if signed and bits <= 8 else 7
    n = tb.kernel_digits(bits, signed)
    assert n == (1 if signed and bits <= 8 else -(-bits // 7))
    assert n == jb.num_digits(bits, radix, signed)
    x = _ints(np.random.default_rng(bits), bits, signed, (64,))
    td = tb.to_digits(_t(x), bits, radix, signed)
    assert td.shape[0] == n
    np.testing.assert_array_equal(
        jb.from_digits(jnp.asarray(td.numpy()), bits, radix, signed), x)


def test_wrap_int32():
    v = torch.tensor([0, (1 << 31) - 1, 1 << 31, (1 << 32) + 5, -(1 << 31) - 1],
                     dtype=torch.int64)
    assert tb.wrap_int32(v).tolist() == [0, (1 << 31) - 1, -(1 << 31), 5,
                                         (1 << 31) - 1]


# ------------------------------------------------------------------- quant

@pytest.mark.parametrize("bits,signed", [(2, True), (4, True), (8, True),
                                         (3, False), (1, False), (16, True)])
def test_quantize_int_matches(bits, signed):
    rng = np.random.default_rng(bits)
    x = (rng.standard_normal((64, 33)) * 3).astype(np.float32)
    # exact half-steps: round half to even on both sides
    x[0, :16] = (np.arange(16) - 8 + 0.5).astype(np.float32) * 0.25
    alpha = np.float32(0.25)
    spec_t, spec_j = tq.QuantSpec(bits, signed), jq.QuantSpec(bits, signed)
    assert tq.qrange(bits, signed) == jq.qrange(bits, signed)
    np.testing.assert_array_equal(
        tq.quantize_int(_t(x), torch.tensor(alpha), spec_t).numpy(),
        np.asarray(jq.quantize_int(jnp.asarray(x), jnp.asarray(alpha), spec_j)))


def test_init_alpha_close():
    """A float32 mean of up to 36,864 terms summed in another order than
    XLA's: rtol 1e-5."""
    rng = np.random.default_rng(3)
    w = rng.standard_normal((3, 3, 64, 32)).astype(np.float32)
    for spec_args, axis in (((2, True, True), (0, 1, 2)), ((4, True), None)):
        a = tq.init_alpha(_t(w), tq.QuantSpec(*spec_args), axis=axis)
        b = jq.init_alpha(jnp.asarray(w), jq.QuantSpec(*spec_args), axis=axis)
        assert tuple(a.shape) == tuple(np.shape(b))
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5)


@pytest.mark.parametrize("bits,signed", [(2, True), (3, False)])
def test_pack_weights_match(bits, signed):
    rng = np.random.default_rng(bits + 10)
    w = rng.standard_normal((3, 3, 40, 24)).astype(np.float32)
    alpha = (np.abs(rng.standard_normal((1, 1, 1, 24))) * 0.3 + 0.1).astype(
        np.float32)
    t = tq.pack_conv_weights(_t(w), tq.QuantSpec(bits, signed, True), _t(alpha))
    j = jq.pack_conv_weights(jnp.asarray(w), jq.QuantSpec(bits, signed, True),
                             jnp.asarray(alpha))
    assert t.ci == j.ci == 40 and t.out_channels == 24
    assert (t.fh, t.fw) == (j.fh, j.fw) == (3, 3)
    np.testing.assert_array_equal(_words(t.packed), np.asarray(j.packed))
    w2 = rng.standard_normal((70, 24)).astype(np.float32)
    a2 = alpha.reshape(1, 24)
    t2 = tq.pack_weights(_t(w2), tq.QuantSpec(bits, signed, True), _t(a2))
    j2 = jq.pack_weights(jnp.asarray(w2), jq.QuantSpec(bits, signed, True),
                         jnp.asarray(a2))
    assert t2.k == j2.k == 70
    assert t2.out_features == j2.out_features == 24
    np.testing.assert_array_equal(_words(t2.packed), np.asarray(j2.packed))


# --------------------------------------------------------------- bitserial

SPECS = [
    (2, 2, True, True, 7), (2, 2, True, True, 1), (8, 4, True, True, 8),
    (8, 4, True, True, 7), (3, 5, False, True, 1), (4, 4, False, False, 7),
    (8, 8, True, True, 8), (16, 16, True, True, 7), (12, 5, True, False, 1),
]


@pytest.mark.parametrize("ab,wb,sa,sw,radix", SPECS)
def test_serial_matmul_match(ab, wb, sa, sw, radix):
    rng = np.random.default_rng(ab * 31 + wb * 7 + radix)
    x = _ints(rng, ab, sa, (6, 75))
    w = _ints(rng, wb, sw, (75, 9))
    ts = tbs.SerialSpec(ab, wb, sa, sw, radix)
    js = jbs.SerialSpec(ab, wb, sa, sw, radix)
    assert tbs.plan_spec(ts).radix_bits == jbs.plan_spec(js).radix_bits
    assert ts.cycles_per_tile == js.cycles_per_tile == ab * wb
    out = tbs.serial_matmul(_t(x), _t(w), ts)
    ref = np.asarray(jbs.serial_matmul(jnp.asarray(x), jnp.asarray(w), js))
    np.testing.assert_array_equal(out.numpy(), ref)
    # exact modulo 2^32 against int64 numpy
    wrapped = ((x.astype(np.int64) @ w.astype(np.int64) + (1 << 31))
               % (1 << 32)) - (1 << 31)
    np.testing.assert_array_equal(out.numpy(), wrapped)


def test_serial_matmul_wraps_like_int32():
    """16-bit operands with a long reduction overflow int32: both packages
    wrap modulo 2^32."""
    rng = np.random.default_rng(11)
    x = _ints(rng, 16, True, (4, 4096))
    w = _ints(rng, 16, True, (4096, 3))
    x[0], w[:, 0] = -(1 << 15), -(1 << 15)     # 4096 * 2^30 overflows
    ts = tbs.SerialSpec(16, 16, True, True, 7)
    out = tbs.serial_matmul(_t(x), _t(w), ts).numpy()
    ref = np.asarray(jbs.serial_matmul(jnp.asarray(x), jnp.asarray(w),
                                       jbs.SerialSpec(16, 16, True, True, 7)))
    np.testing.assert_array_equal(out, ref)
    assert out[0, 0] == 0   # 2^42 mod 2^32


@pytest.mark.parametrize("stride,padding,fs", [(1, 1, 3), (2, 0, 1), (1, 2, 5)])
def test_serial_conv2d_match(stride, padding, fs):
    rng = np.random.default_rng(stride * 10 + padding + fs)
    x = _ints(rng, 4, True, (1, 5, 4, 33))
    w = _ints(rng, 3, True, (fs, fs, 33, 10))
    ts = tbs.SerialSpec(4, 3, True, True, 7)
    out = tbs.serial_conv2d(_t(x), _t(w), ts, stride=stride, padding=padding)
    ref = jbs.serial_conv2d(jnp.asarray(x), jnp.asarray(w),
                            jbs.SerialSpec(4, 3, True, True, 7),
                            stride=stride, padding=padding)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert tbs.conv_out_hw(5, 4, fs, fs, stride, padding) == \
        jbs.conv_out_hw(5, 4, fs, fs, stride, padding)


@pytest.mark.parametrize("ab,wb,sa,sw,radix,stride", [(2, 2, True, True, 7, 1),
                                                      (3, 5, False, True, 1, 2)])
def test_serial_conv2d_packed_acts_match(ab, wb, sa, sw, radix, stride):
    rng = np.random.default_rng(ab * 5 + wb)
    x = _ints(rng, ab, sa, (1, 5, 4, 40))
    w = _ints(rng, wb, sw, (3, 3, 40, 12))
    xp = jb.pack_bitplanes(jb.pad_to(jb.to_bitplanes(jnp.asarray(x), ab), 32))
    wp = jb.pack_bitplanes(jb.pad_to(jb.to_bitplanes(jnp.asarray(w), wb), 32,
                                     axis=3), axis=3)
    out = tbs.serial_conv2d_packed_acts(
        _t(xp), _t(wp), spec=tbs.SerialSpec(ab, wb, sa, sw, radix), ci=40,
        stride=stride, padding=1)
    ref = jbs.serial_conv2d_packed_acts(
        xp, wp, spec=jbs.SerialSpec(ab, wb, sa, sw, radix), ci=40,
        stride=stride, padding=1)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


# -------------------------------------------------------- pipeline modules

def test_fma_matches_jitted_reference_epilogue():
    """The jitted reference ``acc * scale + bias`` is one FMA; fma_f32
    reproduces it bit for bit (a separate multiply and add would not)."""
    rng = np.random.default_rng(5)
    n = 200_000
    acc = rng.integers(-(1 << 31), (1 << 31) - 1, n).astype(np.int32)
    acc[: n // 2] = rng.integers(-3000, 3000, n // 2)
    s = (rng.random(n) * 0.01).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    ref = np.asarray(jax.jit(lambda a, s, b: a.astype(jnp.float32) * s + b)(
        acc, s, b))
    got = tpm.scaler_bias(_t(acc), _t(s), _t(b)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert np.any((acc.astype(np.float32) * s + b) != ref)
    # torch.addcmul on the CPU is an FMA too
    np.testing.assert_array_equal(
        torch.addcmul(_t(b), _t(acc).float(), _t(s)).numpy(), got)
    np.testing.assert_array_equal(
        tpm.scaler_bias(_t(acc), _t(s)).numpy(), acc.astype(np.float32) * s)


@pytest.mark.parametrize("window,stride,with_relu",
                         [(2, None, True), (2, None, False), (3, 2, False)])
def test_maxpool_relu_match(window, stride, with_relu):
    rng = np.random.default_rng(window)
    xf = rng.standard_normal((2, 8, 7, 5)).astype(np.float32)
    xi = rng.integers(-2, 2, (2, 8, 7, 5)).astype(np.int32)
    for x in (xf, xi):
        out = tpm.maxpool_relu(_t(x), window, stride, with_relu=with_relu)
        ref = jpm.maxpool_relu(jnp.asarray(x), window, stride,
                               with_relu=with_relu)
        assert out.dtype == _t(x).dtype
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(tpm.relu(_t(xf)).numpy(),
                                  np.asarray(jpm.relu(jnp.asarray(xf))))


def test_host_conv2d_close():
    """float32 sums in another order than XLA's: rtol/atol 1e-5."""
    rng = np.random.default_rng(9)
    x = rng.random((2, 9, 9, 3)).astype(np.float32)
    w = rng.standard_normal((3, 3, 3, 16)).astype(np.float32)
    for stride, pad in itertools.product((1, 2), (0, 1)):
        out = tpm.host_conv2d(_t(x), _t(w), stride, pad)
        ref = jax.lax.conv_general_dilated(
            jnp.asarray(x), jnp.asarray(w), (stride, stride),
            [(pad, pad)] * 2, dimension_numbers=("NHWC", "HWIO", "NHWC"))
        assert out.is_contiguous()
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-5)


# ------------------------------------- bit transposition and fixed point

@pytest.mark.parametrize("bits,signed,shape",
                         [(1, False, (70,)), (2, True, (3, 33)),
                          (4, True, (2, 3, 64)), (5, False, (3, 33)),
                          (8, True, (70,)), (16, True, (2, 3, 64))])
def test_bit_transpose_round_trip_matches(bits, signed, shape):
    """``bit_transpose``: the words (lane axis last, padded to 32), the
    logical shape, ``nbytes``, ``unpack``/``bit_untranspose`` and
    ``packed_nbytes`` equal the reference's; values round-trip."""
    rng = np.random.default_rng(bits * 7 + signed + len(shape))
    x = _ints(rng, bits, signed, shape)
    tt_ = tb.bit_transpose(_t(x), bits, signed)
    jt_ = jb.bit_transpose(jnp.asarray(x), bits, signed)
    assert tt_.packed.dtype == torch.int32
    np.testing.assert_array_equal(_words(tt_.packed), np.asarray(jt_.packed))
    assert tt_.shape == tuple(jt_.shape) and tt_.bits == jt_.bits
    assert tt_.nbytes == jt_.nbytes == tb.packed_nbytes(shape, bits) \
        == jb.packed_nbytes(shape, bits)
    np.testing.assert_array_equal(tb.bit_untranspose(tt_).numpy(), x)
    np.testing.assert_array_equal(tt_.unpack().numpy(),
                                  np.asarray(jb.bit_untranspose(jt_)))


@pytest.mark.parametrize("bits,signed,radix", [(2, True, 1), (8, True, 8),
                                               (5, False, 2), (12, True, 7)])
def test_digit_coeffs_from_digits_match(bits, signed, radix):
    """``digit_coeffs`` equals the reference's; ``from_digits`` inverts
    ``to_digits`` and ``BitTransposed.digits`` equals the reference's
    digit planes."""
    rng = np.random.default_rng(bits * 3 + radix)
    x = _ints(rng, bits, signed, (4, 40))
    np.testing.assert_array_equal(tb.digit_coeffs(bits, radix, signed),
                                  jb.digit_coeffs(bits, radix, signed))
    d = tb.to_digits(_t(x), bits, radix, signed)
    got = tb.from_digits(d, bits, radix, signed)
    want = jb.from_digits(jnp.asarray(np.asarray(d)), bits, radix, signed)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), x)
    np.testing.assert_array_equal(
        tb.bit_transpose(_t(x), bits, signed).digits(radix).numpy(),
        np.asarray(jb.bit_transpose(jnp.asarray(x), bits,
                                    signed).digits(radix)))


@pytest.mark.parametrize("shift", range(17))
def test_scaler_bias_fixed_matches(shift):
    """The fixed-point scaler at shifts 0-16: accumulators over int32's
    whole range (products that wrap in 32 bits, as the reference's do),
    scales beyond int16 (clipped), biases near the int32 limits: equal to
    the reference's bit for bit."""
    rng = np.random.default_rng(shift)
    acc = rng.integers(-2**31, 2**31, 200).astype(np.int32)
    acc[:4] = [2**31 - 1, -2**31, 0, 1]
    scale = rng.integers(-40000, 40000, 200).astype(np.int32)
    bias = rng.integers(-2**31, 2**31, 200).astype(np.int32)
    cfg_t = tpm.ScalerConfig(shift=shift)
    cfg_j = jpm.ScalerConfig(shift=shift)
    got = tpm.scaler_bias_fixed(_t(acc), _t(scale), _t(bias), cfg_t)
    want = jpm.scaler_bias_fixed(jnp.asarray(acc), jnp.asarray(scale),
                                 jnp.asarray(bias), cfg_j)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("out_bits,signed,msb_pos",
                         [(8, True, 15), (4, True, 10), (2, False, 3),
                          (8, True, 3), (12, True, 20), (1, False, 0)])
def test_quantize_serialize_then_transpose_matches(out_bits, signed,
                                                   msb_pos):
    """``quantize_serialize`` (right shifts, and a left shift that wraps
    when ``msb_pos + 1 < out_bits``) equals the reference's codes, and
    ``bit_transpose`` of them equals the reference's words."""
    rng = np.random.default_rng(out_bits * 31 + msb_pos)
    acc = rng.integers(-2**31, 2**31, (3, 50)).astype(np.int32)
    acc[0, :4] = [2**31 - 1, -2**31, 2**30, -1]
    ct = tpm.QuantSerConfig(out_bits, signed, msb_pos)
    cj = jpm.QuantSerConfig(out_bits, signed, msb_pos)
    got = tpm.quantize_serialize(_t(acc), ct)
    want = np.asarray(jpm.quantize_serialize(jnp.asarray(acc), cj))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        _words(tb.bit_transpose(got, out_bits, signed).packed),
        np.asarray(jb.bit_transpose(jnp.asarray(want), out_bits,
                                    signed).packed))


def test_default_policy_matches():
    """``layers.DEFAULT_POLICY`` is the reference's default policy."""
    from repro.models.layers import DEFAULT_POLICY as J
    from repro_torch.models.layers import DEFAULT_POLICY as T
    for f in ("mode", "w_bits", "a_bits", "w_signed", "a_signed",
              "radix_bits", "pack_acts"):
        assert getattr(T, f) == getattr(J, f), f
