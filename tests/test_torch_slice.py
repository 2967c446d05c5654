"""The port's first slice against the JAX package: the compiled ResNet9
W2A2 serving path (graph → compile → Program → executor → CNNServer).

The full-width ResNet9 Program that the reference's ``compile_graph`` lowers
(batch 2, as in ``test_compiler_exec.py``) is carried across with
``program_from_numpy`` and run by the port on the CPU, where every packed
step takes its kernel's plain version.

Tolerances, each with its reason:

* Every integer step (quantize_pack, conv_packed, maxpool, pack_codes) and
  conv8's float epilogue: exact. Same inputs, same integer arithmetic, and
  the epilogue is the same single-rounding FMA.
* host_conv (conv0), global_pool, host_gemm (fc): float32 sums taken in
  another order than XLA's — rtol/atol 1e-5 relative to the tensor's scale.
* Logits from the images: conv0's float differences can move a rare
  activation code across a rounding boundary of the first quantizer, so
  the logits agree within 2% of their largest magnitude, argmax equal.
* The port's own compile: alphas are float means summed in another order.
  conv1's differ by a few 1e-6; each later one is a mean over activations
  computed with the earlier alphas, so the differences grow down the chain
  (6.6e-5 at conv7 in the run this bound was set from): rtol 1e-4. A weight
  code may flip at a rounding boundary (1 bit of 9.6 M there; bounded at
  1e-6 of the bits). Logits agree within 1e-3 of their largest magnitude.
"""

import _torch_threads  # noqa: F401  (first: caps torch's threads under xdist)

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compiler import executor as jexec
from repro.compiler.artifact import _enc, _encode_job
from repro.models import resnet as jresnet
from repro.runtime.controller import BarrelController as JController

from repro_torch.compiler import HAS_ONNX, UnsupportedOpError, import_onnx
from repro_torch.compiler import executor as texec
from repro_torch.compiler.lower import compile_graph, program_from_numpy
from repro_torch.launch.serve import CNNServer
from repro_torch.models import resnet as tresnet
from repro_torch.models.layers import QuantPolicy
from repro_torch.runtime.controller import BarrelController

INTEGER_KINDS = ("quantize_pack", "conv_packed", "maxpool", "pack_codes")
SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
#: the reference's command stream of full-width ResNet9 W2A2 (pipelined),
#: as ``stream_record`` writes it; ``chip_smoke.py`` holds the card's
#: Program to it, and ``test_carried_program_lowers_to_reference_stream``
#: re-derives it from the reference
STREAM_FILE = os.path.join(os.path.dirname(__file__), "data",
                           "resnet9_w2a2_stream.json")


def _record(prog):
    """A live JAX Program as the numpy record ``program_from_numpy`` reads
    (the artifact manifest's layout, arrays in place of blob digests)."""
    return {
        "graph_name": prog.graph_name,
        "input_name": prog.input_name,
        "output_name": prog.output_name,
        "steps": [{"name": s.name, "kind": s.kind, "inputs": list(s.inputs),
                   "output": s.output, "attrs": _enc(dict(s.attrs))}
                  for s in prog.steps],
        "params": {k: {n: np.asarray(a) for n, a in p.items()}
                   for k, p in prog.params.items()},
        "meta": _enc(dict(prog.meta)),
    }


def _to_torch(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a, order="C"))


def _to_np(t: torch.Tensor, like) -> np.ndarray:
    a = t.numpy()
    if np.asarray(like).dtype == np.uint32:
        a = a.view(np.uint32)
    return a


def _scale(a) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64)))) + 1e-30


@pytest.fixture(scope="module")
def carried():
    cfg = jresnet.ResNet9Config()
    params = tresnet.resnet9_init(0, tresnet.ResNet9Config())
    images = np.random.RandomState(0).rand(2, 32, 32, 3).astype(np.float32)
    jprog = jresnet.resnet9_compile(params, jnp.asarray(images), cfg,
                                    backend="xla")
    # every intermediate of the reference, each step jitted as the whole
    # Program is (XLA contracts the conv epilogue into an FMA under jit)
    env = {jprog.input_name: jnp.asarray(images)}
    for st in jprog.steps:
        fn = jax.jit(jexec.make_step_runner(jprog, st, backend="xla"))
        env[st.output] = fn(jprog.params, *[env[i] for i in st.inputs])
    tprog = program_from_numpy(_record(jprog), device="cpu")
    return params, images, jprog, env, tprog


def test_carried_program_structure(carried):
    _, _, jprog, _, tprog = carried
    kinds = [s.kind for s in tprog.steps]
    assert kinds == [s.kind for s in jprog.steps]
    assert kinds.count("conv_packed") == 8
    assert kinds.count("quantize_pack") == 1 and kinds.count("pack_codes") == 2
    for s in tprog.steps:
        assert "tile" not in s.attrs    # TPU VMEM tiling is not carried
        if s.kind == "conv_packed":
            assert (s.attrs["spec"].a_bits, s.attrs["spec"].w_bits) == (2, 2)
    w = tprog.params["conv1"]["w_packed"]
    assert w.dtype == torch.int32 and tuple(w.shape) == (2, 3, 3, 2, 64)


def test_step_parity_on_reference_inputs(carried):
    """Each port step fed the reference step's own input."""
    _, _, jprog, env, tprog = carried
    for jst, tst in zip(jprog.steps, tprog.steps):
        ins = [_to_torch(env[i]) for i in jst.inputs]
        out = texec.make_step_runner(tprog, tst)(tprog.params, *ins)
        ref = np.asarray(env[jst.output])
        got = _to_np(out, ref)
        assert got.shape == ref.shape, tst.name
        if tst.kind in INTEGER_KINDS:
            assert got.dtype == ref.dtype, tst.name
            np.testing.assert_array_equal(got, ref, err_msg=tst.name)
        else:
            np.testing.assert_allclose(got, ref, rtol=1e-5,
                                       atol=1e-5 * _scale(ref),
                                       err_msg=tst.name)


def stream_record(stream):
    """A command stream as plain JSON: its summary and every job's fields
    (the reference artifact's job record) with tile count and cycles."""
    return {"mode": stream.mode, "summary": stream.summary(),
            "jobs": [dict(_encode_job(j), tile_ops=j.tile_ops,
                          cycles=j.cycles) for j in stream.jobs]}


def _sim(rep):
    return (rep.makespan_cycles, rep.per_job_start, rep.per_job_end,
            rep.per_mvu_busy, rep.hart_free, rep.hpm.snapshot())


def test_carried_program_lowers_to_reference_stream(carried):
    """Carried across with its codegen nodes, the full-width ResNet9
    Program lowers to the reference's stream job for job in both mapping
    modes; the barrel controller books it as the reference's does (idle,
    seeded with the last ``hart_free``, scaled by batch), HPM counters
    included; and the committed stream file is the reference's."""
    _, _, jprog, _, _ = carried
    tprog = program_from_numpy(
        dict(_record(jprog), cost_nodes=_enc(list(jprog.cost_nodes))),
        device="cpu")
    for mode in ("pipelined", "distributed"):
        ts, js = tprog.to_command_stream(mode), jprog.to_command_stream(mode)
        assert stream_record(ts) == stream_record(js)
        tc, jc = BarrelController(), JController()
        a, b = tc.simulate(ts, cycle_scale=32), jc.simulate(js, cycle_scale=32)
        assert _sim(a) == _sim(b)
        assert _sim(tc.simulate(ts, hart_free=a.hart_free, cycle_scale=3)) \
            == _sim(jc.simulate(js, hart_free=b.hart_free, cycle_scale=3))
    with open(STREAM_FILE) as f:
        assert json.load(f) == stream_record(jprog.to_command_stream())


def test_chain_from_conv0_output_is_exact(carried):
    """From conv0's reference output onward the port's chain reproduces
    every integer stage (and conv8's float epilogue) bit for bit."""
    _, _, jprog, env, tprog = carried
    first = tprog.steps[0]
    assert first.kind == "host_conv"
    x = _to_torch(env[first.output])
    got = {first.output: x}
    for st in tprog.steps[1:]:
        got[st.output] = texec.make_step_runner(tprog, st)(
            tprog.params, *[got[i] for i in st.inputs])
    for st in tprog.steps[1:]:
        ref = np.asarray(env[st.output])
        if st.kind in INTEGER_KINDS:
            np.testing.assert_array_equal(_to_np(got[st.output], ref), ref,
                                          err_msg=st.name)
    logits = got[tprog.output_name].numpy()
    ref = np.asarray(env[jprog.output_name])
    np.testing.assert_allclose(logits, ref, rtol=1e-5,
                               atol=1e-5 * _scale(ref))


def test_logits_from_images(carried):
    params, images, jprog, env, tprog = carried
    logits = tprog(torch.from_numpy(images)).numpy()
    ref = np.asarray(jprog(jnp.asarray(images)))
    assert logits.shape == ref.shape == (2, 10)
    assert np.all(np.isfinite(logits))
    np.testing.assert_allclose(logits, ref, rtol=0, atol=0.02 * _scale(ref))
    assert np.array_equal(np.argmax(logits, -1), np.argmax(ref, -1))


def test_own_compile_against_reference(carried):
    params, images, jprog, _, tprog = carried
    cfg = tresnet.ResNet9Config()
    own = tresnet.resnet9_compile(params, images, cfg, device="cpu")
    assert [s.kind for s in own.steps] == [s.kind for s in tprog.steps]
    flipped = total = 0
    for st in own.steps:
        p, q = own.params[st.name], tprog.params[st.name]
        assert set(p) == set(q), st.name
        for key in ("act_alpha", "requant_scale", "scale"):
            if key in p:
                assert p[key].shape == q[key].shape, (st.name, key)
                np.testing.assert_allclose(p[key].numpy(), q[key].numpy(),
                                           rtol=1e-4, err_msg=st.name)
        if "w_packed" in p:
            a = p["w_packed"].numpy().view(np.uint32)
            b = q["w_packed"].numpy().view(np.uint32)
            flipped += int(np.unpackbits((a ^ b).view(np.uint8)).sum())
            total += a.size * 32
    # weight bits that differ (a flipped 2-bit code flips 1 or 2 of them)
    print(f"weight bits differing from the reference's compile: "
          f"{flipped} of {total}")
    assert flipped <= 1e-6 * total
    x = torch.from_numpy(images)
    a, b = own(x).numpy(), tprog(x).numpy()
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-3 * _scale(b))


def test_graph_and_passes_match_reference():
    """The port's IR copy and passes produce the reference's graph: the
    same native dict, before and after the pass pipeline."""
    from repro.compiler import ir as jir
    from repro.compiler import passes as jpasses
    from repro.models.layers import QuantPolicy as JPolicy
    from repro_torch.compiler import ir as tir
    from repro_torch.compiler import passes as tpasses

    params = tresnet.resnet9_init(4)
    jg = jresnet.resnet9_graph(params)
    tg = tresnet.resnet9_graph(params)
    jd, td = jir.graph_to_dict(jg), tir.graph_to_dict(tg)
    assert td == jd
    assert tir.graph_to_dict(tir.graph_from_dict(td)) == jd
    assert tpasses.infer_shapes(tg) == jpasses.infer_shapes(jg)
    jpasses.run_pipeline(jg, JPolicy(mode="serial", w_bits=2, a_bits=2),
                         per_layer={"conv5": (4, 2)})
    tpasses.run_pipeline(tg, QuantPolicy(mode="serial", w_bits=2, a_bits=2),
                         per_layer={"conv5": (4, 2)})
    assert tir.graph_to_dict(tg) == jir.graph_to_dict(jg)
    assert tg.node("conv5").attrs["precision"]["a_bits"] == 4
    with pytest.raises(tir.GraphError):
        tpasses.annotate_precision(tg, QuantPolicy(mode="serial"),
                                   per_layer={"nope": (2, 2)})


def test_forward_paths_small_config():
    """Reference quantized and float forwards at three narrow layers."""

    class Small(tresnet.ResNet9Config):
        layers = (("conv1", 64, 32, 1, False),
                  ("conv2", 32, 32, 2, False),
                  ("conv3", 32, 48, 1, True))

    class JSmall(jresnet.ResNet9Config):
        layers = Small.layers

    params = tresnet.resnet9_init(1, Small())
    images = np.random.RandomState(0).rand(2, 16, 16, 3).astype(np.float32)
    x = torch.from_numpy(images)
    jq = np.asarray(jresnet.resnet9_forward(params, jnp.asarray(images),
                                            JSmall()))
    tq = tresnet.resnet9_forward(params, x, Small()).numpy()
    np.testing.assert_allclose(tq, jq, rtol=0, atol=0.02 * _scale(jq))
    jf = np.asarray(jresnet.resnet9_forward_float(params, jnp.asarray(images),
                                                  JSmall()))
    tf = tresnet.resnet9_forward_float(params, x, Small()).numpy()
    np.testing.assert_allclose(tf, jf, rtol=1e-5, atol=1e-5 * _scale(jf))
    # the compiled small program runs and agrees with its plain runner
    prog = tresnet.resnet9_compile(params, images, Small(), device="cpu",
                                   input_hw=16)
    out = prog(x)
    plain = texec.make_plain_runner(prog)(prog.params, x)
    assert torch.equal(out, plain)


def test_cnn_server_buckets_cpu():
    """CNNServer classifies through the serving runtime: warmup runs every
    bucket once, traffic adds hits only, and the cycle report is the
    reference's stream."""
    server = CNNServer(seed=0, calib_batch=2, max_batch=8, device="cpu")
    assert server.service.warmup() == 4
    rng = np.random.default_rng(5)
    images = rng.random((5, 32, 32, 3), dtype=np.float32)
    for n in (1, 3, 5):
        logits = server.classify(images[:n])
        assert logits.shape == (n, 10)
        assert np.all(np.isfinite(logits))
    m = server.metrics()
    st = m["bucket_caches"][str(server.key)]
    assert st["buckets"] == [1, 2, 4, 8] and st["compiles"] == 4
    assert st["hits"] == m["batches"] and m["completed"] == 9
    # padding rows do not leak into real rows: the first image's logits
    # agree in a bucket of 1 and a bucket of 8 (to the last few ulps only:
    # the host fc's float matmul takes another BLAS path at another batch)
    runner = texec.make_bucketed_runner(server.program, max_batch=8)
    one, eight = runner(images[:1])[0], runner(images)[0]
    np.testing.assert_allclose(one.numpy(), eight.numpy(), rtol=1e-6,
                               atol=1e-6 * _scale(eight.numpy()))
    assert runner.stats()["buckets"] == [1, 8]
    with open(STREAM_FILE) as f:
        assert server.cycle_report() == json.load(f)["summary"]
    server.close()


def test_cnn_server_needs_a_device_or_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CNNServer(calib_batch=1)


def test_gemm_packed_names_missing_kernel():
    g = tresnet.resnet9_graph(tresnet.resnet9_init(2))
    g.node("fc").attrs.pop("host")
    prog = compile_graph(g, np.zeros((1, 32, 32, 3), np.float32),
                         policy=QuantPolicy(mode="serial", w_bits=2,
                                            a_bits=2),
                         device="cpu")
    assert prog.steps[-1].kind == "gemm_packed"
    # the step runs K3 (its plain version on the CPU) and agrees with the
    # plain runner
    x = torch.from_numpy(np.random.default_rng(0).random(
        (1, 32, 32, 3), dtype=np.float32))
    out = prog(x)
    assert out.shape == (1, 10) and torch.isfinite(out).all()
    assert torch.equal(out, texec.make_plain_runner(prog)(prog.params, x))


def test_port_imports_no_jax_and_no_reference():
    code = (
        "import sys, numpy as np\n"
        "import repro_torch, repro_torch.core.bitops, repro_torch.core.quant\n"
        "import repro_torch.core.bitserial, repro_torch.core.pipeline_modules\n"
        "import repro_torch.kernels.ops, repro_torch.kernels._build\n"
        "import repro_torch.compiler.executor, repro_torch.compiler.passes\n"
        "import repro_torch.kernels.bitserial_matmul, repro_torch.configs\n"
        "import repro_torch.models.attention, repro_torch.models.transformer\n"
        "import repro_torch.compiler.bench_graphs\n"
        "import repro_torch.core.mvu, repro_torch.core.cost_model\n"
        "import repro_torch.core.codegen, repro_torch.obs\n"
        "import repro_torch.runtime.straggler, repro_torch.serving\n"
        "from repro_torch.launch.serve import CNNServer, GenRequest, Server\n"
        "from repro_torch.serving import ContinuousLMEngine\n"
        "s = CNNServer(calib_batch=1, max_batch=1, device='cpu')\n"
        "s.classify(np.zeros((1, 32, 32, 3), np.float32))\n"
        "cfg = repro_torch.configs.get_arch('stablelm-1.6b').smoke\n"
        "for pa in (True, False):\n"
        "    lm = Server(cfg, max_len=16, pack_acts=pa, device='cpu')\n"
        "    lm.generate([GenRequest(np.arange(4, dtype=np.int32), 2)])\n"
        "    eng = ContinuousLMEngine(cfg, max_len=16, pack_acts=pa,\n"
        "                             device='cpu')\n"
        "    eng.serve([GenRequest(np.arange(4, dtype=np.int32), 3)])\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or\n"
        "             m.startswith('jax.') or m == 'repro' or\n"
        "             m.startswith('repro.'))\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_port_sources_name_no_jax_or_reference():
    root = os.path.dirname(SRC)
    files = [os.path.join(root, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(SRC, "repro_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    for f in files:
        with open(f) as fh:
            for line in fh:
                s = line.strip()
                assert not (s.startswith(("import jax", "from jax"))
                            or s.startswith(("import repro ", "import repro.",
                                             "from repro ", "from repro."))), \
                    f"{f}: {s}"


# ------------------------------------------------------------ ONNX importer

def test_compiler_exports_the_references_names():
    """``repro_torch.compiler`` exports every name ``repro.compiler`` does
    (the ONNX importer's among them) and ``SUPPORTED_ONNX_OPS`` besides,
    the same op subset; ``HAS_ONNX`` agrees with the reference's."""
    import repro.compiler as jcomp
    import repro.compiler.onnx_import as jonnx
    import repro_torch.compiler as tcomp
    assert set(jcomp.__all__) <= set(tcomp.__all__)
    assert all(hasattr(tcomp, n) for n in tcomp.__all__)
    assert tcomp.SUPPORTED_ONNX_OPS == jonnx.SUPPORTED_ONNX_OPS
    assert tcomp.HAS_ONNX == jcomp.HAS_ONNX
    assert issubclass(tcomp.UnsupportedOpError, tcomp.GraphError)


def test_onnx_importer_absent_raises_descriptive_error():
    if HAS_ONNX:
        pytest.skip("onnx installed — absence branch not reachable")
    with pytest.raises(ImportError, match="optional 'onnx' package"):
        import_onnx("whatever.onnx")


@pytest.mark.skipif(not HAS_ONNX, reason="optional onnx not installed")
def test_onnx_importer_subset_and_rejection():
    """The reference's subset-and-rejection test on the port's importer:
    NCHW -> NHWC inputs, OIHW -> HWIO weights, an op outside the subset
    and the geometry attributes refused, a tied weight transposed once."""
    import onnx
    from onnx import helper, numpy_helper
    rng = np.random.RandomState(0)
    w = rng.randn(4, 3, 3, 3).astype(np.float32)         # OIHW

    def value(name, shape):
        return helper.make_tensor_value_info(name, onnx.TensorProto.FLOAT,
                                             shape)

    model = helper.make_model(helper.make_graph(
        [helper.make_node("Conv", ["x", "w"], ["c"], strides=[1, 1],
                          pads=[1, 1, 1, 1]),
         helper.make_node("Relu", ["c"], ["y"])],
        "t", [value("x", [1, 3, 8, 8])], [value("y", [1, 4, 8, 8])],
        [numpy_helper.from_array(w, "w")]))
    g = import_onnx(model)
    assert [n.op for n in g.nodes] == ["conv2d", "relu"]
    assert g.inputs["x"] == (1, 8, 8, 3)                 # NCHW -> NHWC
    assert g.initializers["w"].shape == (3, 3, 3, 4)     # OIHW -> HWIO
    bad = helper.make_model(helper.make_graph(
        [helper.make_node("Softmax", ["x"], ["y"])], "b",
        [value("x", [1, 4])], [value("y", [1, 4])], []))
    with pytest.raises(UnsupportedOpError, match="Softmax"):
        import_onnx(bad)
    for kw, msg in ((dict(strides=[1, 1], auto_pad="SAME_UPPER"),
                     "auto_pad"),
                    (dict(strides=[1, 1], pads=[1, 1, 1, 1],
                          dilations=[2, 2]), "dilations")):
        m = helper.make_model(helper.make_graph(
            [helper.make_node("Conv", ["x", "w"], ["y"], **kw)], "g",
            [value("x", [1, 3, 8, 8])], [value("y", [1, 4, 8, 8])],
            [numpy_helper.from_array(w, "w")]))
        with pytest.raises(UnsupportedOpError, match=msg):
            import_onnx(m)
    w_tied = rng.randn(3, 3, 3, 3).astype(np.float32)      # OIHW, Ci == Co
    shared = helper.make_model(helper.make_graph(
        [helper.make_node("Conv", ["x", "w"], ["a"], strides=[1, 1],
                          pads=[1, 1, 1, 1]),
         helper.make_node("Relu", ["a"], ["ar"]),
         helper.make_node("Conv", ["ar", "w"], ["y"], strides=[1, 1],
                          pads=[1, 1, 1, 1])], "tied",
        [value("x", [1, 3, 8, 8])], [value("y", [1, 3, 8, 8])],
        [numpy_helper.from_array(w_tied, "w")]))
    np.testing.assert_array_equal(
        import_onnx(shared).initializers["w"],
        np.transpose(w_tied, (2, 3, 1, 0)))  # once, not twice
