"""The port's packed GEMMs on the CPU — K3 (``bitserial_matmul_v2``) and K4
(``bitserial_matmul``) through their plain versions — against the JAX
package: the TPU kernels themselves in interpret mode
(``bitserial_matmul_v2_pallas`` with blocks (8, 32, 32), and
``bitserial_matmul_pallas``), the XLA oracle ``serial_matmul_packed_op(
backend="xla")`` under ``jax.jit``, and the compiled ``gemm_packed`` step
of the reference's ``tiny_mixed_cnn`` carried across with
``program_from_numpy``.

Every comparison is exact (``array_equal``): words and codes because the
integer path is exact, float outputs because both sides compute the same
single-rounding FMA ``acc * scale + bias`` of the same accumulator — the
reference's epilogue is one FMA under ``jit`` and in its Pallas kernels
(interpreted too), and the port's plain epilogue emulates ``fmaf``.
"""

import _torch_threads  # noqa: F401  (first: caps torch's threads under xdist)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compiler import bench_graphs as jgraphs
from repro.compiler import lower as jlower
from repro.core import bitops as jb
from repro.core.bitserial import SerialSpec as JSpec
from repro.core.quant import QuantSpec as JQuant
from repro.kernels.bitserial_matmul import (bitserial_matmul_pallas,
                                            bitserial_matmul_v2_pallas)
from repro.kernels.ops import pack_activations as j_pack_activations
from repro.kernels.ops import serial_matmul_packed_op as j_packed_op
from repro.models.layers import QuantPolicy as JPolicy

from repro_torch.compiler import bench_graphs, executor
from repro_torch.compiler.lower import compile_graph, program_from_numpy
from repro_torch.core.bitserial import SerialSpec
from repro_torch.core.quant import QuantSpec, qrange
from repro_torch.kernels import bitserial_matmul as km
from repro_torch.kernels import ops
from repro_torch.models.layers import QuantPolicy


def _record(prog):
    """A live JAX Program as the numpy record ``program_from_numpy`` reads
    (the artifact manifest's layout, arrays in place of blob digests)."""
    from repro.compiler.artifact import _enc
    return {
        "graph_name": prog.graph_name, "input_name": prog.input_name,
        "output_name": prog.output_name,
        "steps": [{"name": s.name, "kind": s.kind, "inputs": list(s.inputs),
                   "output": s.output, "attrs": _enc(dict(s.attrs))}
                  for s in prog.steps],
        "params": {k: {n: np.asarray(a) for n, a in p.items()}
                   for k, p in prog.params.items()},
        "meta": _enc(dict(prog.meta)),
    }


def _t(a):
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a, order="C"))


def _np(t: torch.Tensor, like) -> np.ndarray:
    a = t.numpy()
    return a.view(np.uint32) if np.asarray(like).dtype == np.uint32 else a


def _operands(rng, spec, m, k, n):
    """Integer codes x (m, k), packed acts, packed weights, scale, bias."""
    la, ha = qrange(spec.a_bits, spec.a_signed)
    lw, hw = qrange(spec.w_bits, spec.w_signed)
    x = rng.integers(la, ha + 1, (m, k)).astype(np.int32)
    w = rng.integers(lw, hw + 1, (k, n)).astype(np.int32)
    xp = np.asarray(j_pack_activations(jnp.asarray(x), spec.a_bits))
    wp = np.asarray(jb.pack_bitplanes(jb.pad_to(
        jb.to_bitplanes(jnp.asarray(w), spec.w_bits), 32, axis=1), axis=1))
    scale = (rng.random(n) * 0.02 + 1e-3).astype(np.float32)
    bias = rng.standard_normal(n).astype(np.float32)
    return x, xp, wp, scale, bias


def _jspec(spec):
    return JSpec(spec.a_bits, spec.w_bits, spec.a_signed, spec.w_signed,
                 spec.radix_bits)


# spec (a_bits, w_bits, a_signed, w_signed, radix), (M, K, N)
SPECS = [((2, 2, True, True, 7), (9, 70, 40)),     # W2A2, ragged M/K/N
         ((8, 4, True, True, 8), (8, 64, 32)),     # W4A8 (the LM's)
         ((1, 1, True, True, 1), (5, 33, 36)),     # W1A1, radix 1
         ((8, 8, False, True, 7), (7, 96, 64))]    # W8A8, unsigned acts


@pytest.mark.parametrize("out", ["float", "codes", "packed"])
@pytest.mark.parametrize("sp,shape", SPECS)
def test_k3_plain_matches_pallas_v2_interpret(sp, shape, out):
    spec = SerialSpec(*sp)
    m, k, n = shape
    rng = np.random.default_rng(sum(sp[:2]) * 13 + m + k + n)
    _, xp, wp, scale, bias = _operands(rng, spec, m, k, n)
    rq = None if out == "float" else JQuant(3, False)
    rs = np.float32(0.25)
    ref = np.asarray(bitserial_matmul_v2_pallas(
        jnp.asarray(xp), jnp.asarray(wp), scale, bias, spec=_jspec(spec),
        k=k, block_m=8, block_n=32, block_k=32, relu=out != "float",
        requant=rq, requant_scale=None if rq is None else rs,
        emit_packed=out == "packed", interpret=True))
    got = km.bitserial_matmul_v2(
        _t(xp), _t(wp), _t(scale), _t(bias), spec=spec, k=k,
        relu=out != "float", requant=None if rq is None else QuantSpec(3, False),
        requant_scale=None if rq is None else torch.tensor(rs),
        emit_packed=out == "packed")
    assert got.shape == ref.shape
    np.testing.assert_array_equal(_np(got, ref), ref)


@pytest.mark.parametrize("rq", [None, (6, True), (12, True)])
@pytest.mark.parametrize("sp,shape", SPECS[:3])
def test_k4_plain_matches_pallas_interpret(sp, shape, rq):
    """Float output, requant codes at <= 8 bits (int8) and at > 8 bits
    (codes in ``out_dtype``, the reference kernel's type)."""
    spec = SerialSpec(*sp)
    m, k, n = shape
    rng = np.random.default_rng(sum(sp[:2]) * 17 + m + k + n)
    x, _, wp, scale, bias = _operands(rng, spec, m, k, n)
    scale = scale * 40  # requant codes span their range
    ref = np.asarray(bitserial_matmul_pallas(
        jnp.asarray(x), jnp.asarray(wp), scale, bias, spec=_jspec(spec), k=k,
        block_m=8, block_n=128, block_k=64,
        relu=rq is None, requant=None if rq is None else JQuant(*rq),
        interpret=True))
    got = km.bitserial_matmul(
        _t(x), _t(wp), _t(scale), _t(bias), spec=spec, k=k,
        relu=rq is None, requant=None if rq is None else QuantSpec(*rq))
    assert got.shape == ref.shape and str(got.dtype)[6:] == str(ref.dtype)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_k4_masks_out_of_range_codes_like_the_reference():
    """Codes wider than ``a_bits`` are truncated and sign-extended."""
    spec = SerialSpec(4, 4, True, True, 7)
    rng = np.random.default_rng(8)
    _, _, wp, scale, bias = _operands(rng, spec, 6, 40, 16)
    x = rng.integers(-200, 200, (6, 40)).astype(np.int32)
    ref = np.asarray(bitserial_matmul_pallas(
        jnp.asarray(x), jnp.asarray(wp), scale, bias, spec=_jspec(spec), k=40,
        block_m=8, block_n=128, block_k=64, interpret=True))
    got = km.bitserial_matmul(_t(x), _t(wp), _t(scale), _t(bias), spec=spec,
                              k=40)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("out,with_bias", [("float", True), ("codes", False),
                                           ("packed", True)])
def test_packed_op_leading_dims_matches_xla(out, with_bias):
    """(a_bits, 2, 3, W) activations through ``ops.serial_matmul_packed_op``
    against the reference's jitted XLA oracle."""
    spec = SerialSpec(8, 4, True, True, 8)
    rng = np.random.default_rng(3)
    x, _, wp, scale, bias = _operands(rng, spec, 6, 100, 70)
    xp = np.asarray(j_pack_activations(jnp.asarray(x.reshape(2, 3, 100)), 8))
    b = bias if with_bias else None
    rq = None if out == "float" else JQuant(4, True)
    rs = np.float32(0.3)

    def ref_fn(xp, wp, scale, b, rs):
        return j_packed_op(xp, wp, scale, b, spec=_jspec(spec), k=100,
                           relu=False, requant=rq,
                           requant_scale=None if rq is None else rs,
                           emit_packed=out == "packed", backend="xla")

    ref = np.asarray(jax.jit(ref_fn)(xp, wp, scale, b, rs))
    got = ops.serial_matmul_packed_op(
        _t(xp), _t(wp), _t(scale), None if b is None else _t(b), spec=spec,
        k=100, requant=None if rq is None else QuantSpec(4, True),
        requant_scale=None if rq is None else torch.tensor(rs),
        emit_packed=out == "packed")
    assert got.shape == ref.shape
    np.testing.assert_array_equal(_np(got, ref), ref)


def test_serial_matmul_op_leading_dims():
    spec = SerialSpec(8, 4, True, True, 8)
    rng = np.random.default_rng(4)
    x, _, wp, scale, bias = _operands(rng, spec, 6, 64, 40)
    flat = km.bitserial_matmul(_t(x), _t(wp), _t(scale), _t(bias), spec=spec,
                               k=64)
    lead = ops.serial_matmul_op(_t(x.reshape(2, 3, 64)), _t(wp), _t(scale),
                                _t(bias), spec=spec, k=64)
    assert tuple(lead.shape) == (2, 3, 40)
    assert torch.equal(lead.reshape(6, 40), flat)
    plain = ops.serial_matmul_op(_t(x), _t(wp), _t(scale), _t(bias),
                                 spec=spec, k=64, plain=True)
    assert torch.equal(plain, flat)


# ------------------------------------------------ the compiled gemm_packed

@pytest.fixture(scope="module")
def tiny():
    """The reference's compiled ``tiny_mixed_cnn``, an input batch and its
    logits ``prog(x)``."""
    g, calib = jgraphs.tiny_mixed_cnn()
    prog = jlower.compile_graph(g, calib, policy=JPolicy(
        mode="serial", w_bits=2, a_bits=2))
    x = np.random.RandomState(1).rand(3, 8, 8, 8).astype(np.float32)
    return prog, x, np.asarray(prog(x))


def test_gemm_packed_step_runs_carried_program(tiny):
    """The reference's Program, whose last step (``fc``) is a
    ``gemm_packed`` emitting the logits, runs on the port and equals
    ``prog(x)``; so does the plain runner."""
    prog, x, ref = tiny
    assert [s.kind for s in prog.steps] == [
        "quantize_pack", "conv_packed", "conv_packed", "global_pool",
        "quantize_pack", "gemm_packed"]
    tp = program_from_numpy(_record(prog), device="cpu")
    np.testing.assert_array_equal(tp(torch.from_numpy(x)).numpy(), ref)
    plain = executor.make_plain_runner(tp)(tp.params, torch.from_numpy(x))
    np.testing.assert_array_equal(plain.numpy(), ref)


def test_program_run_equals_reference_run(tiny):
    """``Program.run``, the eager path, on the carried Program equals the
    reference's ``Program.run`` (its un-jitted runner, XLA backend) bit
    for bit; a stage of it (``steps``/``output_name``, the keywords the
    two share) too."""
    prog, x, ref = tiny
    tp = program_from_numpy(_record(prog), device="cpu")
    want = np.asarray(prog.run(jnp.asarray(x), backend="xla"))
    np.testing.assert_array_equal(want, ref)
    np.testing.assert_array_equal(tp.run(torch.from_numpy(x)).numpy(), want)
    stage = dict(steps=tp.steps[:2], output_name=tp.steps[1].output)
    j_stage = dict(steps=prog.steps[:2], output_name=prog.steps[1].output)
    np.testing.assert_array_equal(
        tp.run(torch.from_numpy(x), **stage).numpy(),
        np.asarray(prog.run(jnp.asarray(x), backend="xla", **j_stage)))


def test_port_compiles_tiny_mixed_cnn(tiny):
    """The port's own copy of the graph compiles to the same steps; its
    logits agree with the reference's Program within 1e-5 of their largest
    magnitude (the calibration means sum in another order)."""
    prog, x, ref = tiny
    g, calib = bench_graphs.tiny_mixed_cnn()
    own = compile_graph(g, calib, policy=QuantPolicy(
        mode="serial", w_bits=2, a_bits=2), device="cpu")
    assert [s.kind for s in own.steps] == [s.kind for s in prog.steps]
    got = own(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


# ------------------------------------------------- CUDA wrappers, on the CPU

def test_gemm_cuda_wrappers_refuse_cpu_tensors():
    before = km.KERNEL.launches
    spec = SerialSpec(2, 2, True, True, 7)
    wp = torch.zeros((2, 1, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="must be on"):
        km.bitserial_matmul_v2_cuda(torch.zeros((2, 4, 1), dtype=torch.int32),
                                    wp, torch.ones(8), spec=spec, k=8)
    with pytest.raises(ValueError, match="must be on"):
        km.bitserial_matmul_cuda(torch.zeros((4, 8), dtype=torch.int32), wp,
                                 torch.ones(8), spec=spec, k=8)
    assert km.KERNEL.launches == before and km.KERNEL._lib is None
    assert km.KERNEL.library_path().name.startswith("bitserial_matmul-")


# ------------------------------------------- the digit plan of K2 and K3

@pytest.mark.parametrize("a_signed,w_signed", [(True, True), (False, True),
                                               (True, False), (False, False)])
@pytest.mark.parametrize("a_bits", range(1, 17))
def test_digit_plan_folds_to_the_serial_product(a_bits, a_signed, w_signed):
    """The plan the CUDA kernels expand the planes into (one signed int8
    digit for a signed operand of <= 8 bits, else radix-7 digits), each
    pair weighed 2^(7 (i + j)) and folded magnitude-major in wrapped int32,
    is the bit-serial product modulo 2^32 for every width, sums that wrap
    included."""
    from repro_torch.core import bitops
    from repro_torch.core.bitserial import (_digit_combine,
                                            digits_from_planes,
                                            serial_matmul_packed_acts)
    for w_bits in range(1, 17):
        spec = SerialSpec(a_bits, w_bits, a_signed, w_signed, 1)
        rng = np.random.default_rng(a_bits * 64 + w_bits * 4 + 2 * a_signed
                                    + w_signed)
        m, k, n = 3, 70, 5
        la, ha = qrange(a_bits, a_signed)
        lw, hw = qrange(w_bits, w_signed)
        x = torch.from_numpy(rng.integers(la, ha + 1, (m, k)).astype(np.int32))
        w = torch.from_numpy(rng.integers(lw, hw + 1, (k, n)).astype(np.int32))
        x[0] = la if a_signed else ha   # the extreme codes: with 16-bit
        w[:, 0] = lw if w_signed else hw  # operands the sums wrap int32
        xp = bitops.pack_bitplanes(bitops.pad_to(
            bitops.to_bitplanes(x, a_bits), 32, axis=-1), axis=-1)
        wp = bitops.pack_bitplanes(bitops.pad_to(
            bitops.to_bitplanes(w, w_bits), 32, axis=1), axis=1)
        na = bitops.kernel_digits(a_bits, a_signed)
        nw = bitops.kernel_digits(w_bits, w_signed)
        assert na == (1 if a_signed and a_bits <= 8 else -(-a_bits // 7))
        assert nw == (1 if w_signed and w_bits <= 8 else -(-w_bits // 7))
        ra = 8 if na == 1 and a_signed else 7   # one signed digit: radix 8
        rw = 8 if nw == 1 and w_signed else 7
        xd = digits_from_planes(bitops.unpack_bitplanes(xp, k, axis=-1),
                                a_bits, ra, a_signed)
        wd = digits_from_planes(bitops.unpack_bitplanes(wp, k, axis=1),
                                w_bits, rw, w_signed)
        # a one-digit operand only has index 0: the shift is the other's
        got = _digit_combine(xd, wd, 7 if max(na, nw) > 1 else 8)
        ref = serial_matmul_packed_acts(xp, wp, spec=spec, k=k)
        assert torch.equal(got, ref), (a_bits, w_bits, a_signed, w_signed)
        exact = torch.from_numpy(x.numpy().astype(np.int64)
                                 @ w.numpy().astype(np.int64))
        assert torch.equal(got, bitops.wrap_int32(exact)), (a_bits, w_bits)
