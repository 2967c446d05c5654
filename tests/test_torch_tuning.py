"""The port's tile autotuner (``kernels/tuning.py``) and the H100 tile
model (``core/cost_model.py``) against the reference's tuner contracts,
and the tiles carried through lowering, the executor's buckets, the
artifact store and the verifier; the hand-written ResNet9 deployment path
and ``quantized_linear`` against the reference's.

Inputs are made from seeds with numpy. Tolerances, each with its reason:

* Tuner contracts, tile records, persisted decisions, the executor's
  choice of tile: exact (pure arithmetic, deterministic).
* A port-lowered Program against the reference's lowering of the same
  graph and calibration batch: every integer output exact on the
  reference step's own input (codes and planes; both calibrate with the
  same float32 expressions); float outputs rtol/atol 1e-5 of the tensor's
  scale (float32 sums in another order; a packed step's float epilogue
  uses the port's own folded scaler, an ulp from the reference's).
* ``resnet9_forward_packed`` against the reference's (``backend="xla"``):
  the packed planes exact; every layer's folded scaler rtol 1e-5 (the
  calibration's float32 forward sums in another order); logits within 2% of their largest
  magnitude and argmax equal (conv0 and the average pool are float32 sums
  in another order, and a code at a rounding edge may flip), as
  ``tests/test_torch_slice.py`` states them.
* ``quantized_linear`` against the reference's: the integer product is
  exact; the epilogue rtol 1e-6 / atol 1e-6 of the output's scale (one
  fused multiply-add in the port where the eager reference rounds the
  scaler and the bias apart).
"""

import _torch_threads  # noqa: F401  (first: caps torch's threads under xdist)

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compiler import compile_graph as j_compile_graph
from repro.compiler import executor as jexec
from repro.compiler.bench_graphs import tiny_mixed_cnn as j_tiny_mixed_cnn
from repro.core.quant import QuantSpec as JQuantSpec
from repro.core.quant import pack_weights as j_pack_weights
from repro.kernels import ops as jops
from repro.models import resnet as jresnet

from repro_torch.analysis.verify_ir import VerifyError, verify_program
from repro_torch.compiler import (ArtifactStore, compile_graph, load_program,
                                  save_program)
from repro_torch.compiler import executor as texec
from repro_torch.compiler.bench_graphs import tiny_mixed_cnn
from repro_torch.core import cost_model
from repro_torch.core.bitserial import SerialSpec
from repro_torch.core.quant import QuantSpec, pack_weights
from repro_torch.kernels import bitserial_conv, ops, tuning
from repro_torch.models import resnet as tresnet

W2A2 = SerialSpec(2, 2, True, True, 7)
W4A8 = SerialSpec(8, 4, True, True, 8)
W3A3 = SerialSpec(3, 3, True, True, 7)
CONV = dict(fh=3, fw=3, stride=1, padding=1)
INTEGER_KINDS = ("quantize_pack", "conv_packed", "gemm_packed", "maxpool",
                 "pack_codes")


@pytest.fixture(autouse=True)
def fresh_tuner():
    """Each test starts from an empty L1 and no L2, and leaves them so."""
    old = tuning.set_persistent_store(None)
    tuning.clear_cache()
    yield
    tuning.set_persistent_store(old)
    tuning.clear_cache()


def _scale(a) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64)))) + 1e-30


def _point(tile):
    return tuple(tile.kernel_kwargs().values())


# ------------------------------------------------------ the tuner's contracts

@pytest.mark.parametrize("spec", [W2A2, W4A8, W3A3], ids=str)
@pytest.mark.parametrize("m,k,n", [(4, 2048, 2048), (256, 5632, 2048),
                                   (32768, 2048, 5632), (13, 100, 70)])
def test_tuner_respects_budget_and_launch_bound(spec, m, k, n):
    fixed = cost_model.fixed_plans(spec.a_bits, spec.w_bits, spec.a_signed,
                                   spec.w_signed)
    cands = tuning.tile_candidates(m, k, n, spec)
    heur = tuning.heuristic_tile(m, k, n, spec)
    assert heur in [_point(c) for c in cands]     # always a candidate
    for c in cands:
        nt, w = _point(c)
        assert c.smem_bytes == 8 * nt * 36 * 4
        assert c.smem_bytes <= cost_model.smem_budget_bytes()
        assert 1 <= 32 * w <= cost_model.launch_bound_threads(fixed, nt)
        assert nt in ((1, 2, 4) if fixed else (1,))
        assert c.cost > 0
    tc = tuning.choose_tile(m, k, n, spec)
    assert tc == cands[0]
    assert tuning.choose_tile(m, k, n, spec) is tc        # an L1 hit
    assert tuning.cache_info()["hits"] == 1


def test_heuristic_mirror_matches_the_kernels_choices():
    """The C entry's nt_for/warps_for, as the card's sweep recorded them
    (PERF.md §6)."""
    kw = dict(CONV, spec=W2A2)
    assert tuning.heuristic_conv_tile(1, 32, 32, 64, 64, **kw) == (1, 5)
    assert tuning.heuristic_conv_tile(32, 32, 32, 64, 64, **kw) == (4, 4)
    assert tuning.heuristic_conv_tile(32, 8, 8, 128, 256, fh=3, fw=3,
                                      stride=2, padding=1,
                                      spec=W2A2) == (1, 9)
    assert tuning.heuristic_tile(4, 5632, 2048, W4A8) == (1, 32)
    assert tuning.heuristic_tile(256, 2048, 2048, W4A8) == (4, 4)
    assert tuning.heuristic_tile(256, 2048, 2048, W3A3) == (1, 8)


def test_conv_tuner_caches_and_pins_axes():
    kw = dict(CONV, spec=W2A2)
    a = tuning.choose_conv_tile(8, 32, 32, 64, 128, **kw)
    assert tuning.choose_conv_tile(8, 32, 32, 64, 128, **kw) == a
    tc = tuning.choose_conv_tile(8, 32, 32, 64, 128, fix_bp=16, **kw)
    assert tc.block_p == 16 and 1 <= tc.warps <= 16
    tc = tuning.choose_conv_tile(8, 32, 32, 64, 128, fix_warps=2, **kw)
    assert tc.warps == 2 and tc.block_p in (8, 16, 32)
    with pytest.raises(ValueError):      # NT = 3 is no instantiation
        tuning.choose_conv_tile(8, 32, 32, 64, 128, fix_bp=24, **kw)
    with pytest.raises(ValueError):      # no instantiation takes 64 warps
        tuning.choose_conv_tile(8, 32, 32, 64, 128, fix_warps=64, **kw)
    with pytest.raises(ValueError):      # Any has NT = 1 only
        tuning.choose_conv_tile(8, 32, 32, 64, 128, fix_bp=16,
                                **dict(CONV, spec=W3A3))


def test_keep_margin_keeps_the_heuristic_unless_a_clear_gain():
    """The analytic choice is the heuristic's tile unless modeled at least
    KEEP_MARGIN cheaper."""
    for m, k, n in ((4, 2048, 2048), (256, 2048, 5632), (32768, 5632, 2048),
                    (64, 2048, 2048)):
        cands = tuning.tile_candidates(m, k, n, W4A8)
        heur = [c for c in cands
                if _point(c) == tuning.heuristic_tile(m, k, n, W4A8)][0]
        best = min(cands, key=lambda c: c.cost)
        if best.cost > heur.cost * (1 - tuning.KEEP_MARGIN):
            assert cands[0] == heur
        else:
            assert cands[0] == best


@pytest.mark.parametrize("kind", ["gemm", "conv"])
def test_measured_rerank_never_slower_than_analytic(kind):
    calls = []

    def measure(cfg):              # a fake clock: ties with the analytic
        calls.append(cfg)          # best, one tile strictly faster
        return 1.0 if len(calls) != 3 else 0.5

    if kind == "gemm":
        cands = tuning.tile_candidates(256, 2048, 2048, W4A8)
        got = tuning.choose_tile_measured(256, 2048, 2048, W4A8,
                                          measure=measure, top_k=4)
    else:
        cands = tuning.conv_tile_candidates(32, 32, 32, 64, 64, spec=W2A2,
                                            **CONV)
        got = tuning.choose_conv_tile_measured(32, 32, 32, 64, 64,
                                               spec=W2A2, measure=measure,
                                               top_k=4, **CONV)
    assert calls == cands[:4]
    assert got == cands[2] and measure(got) <= measure(cands[0])
    calls.clear()

    def flat(cfg):
        calls.append(cfg)
        return 1.0
    again = (tuning.choose_tile_measured(64, 2048, 2048, W4A8, measure=flat)
             if kind == "gemm" else tuning.choose_conv_tile_measured(
                 8, 32, 32, 64, 64, spec=W2A2, measure=flat, **CONV))
    assert again == calls[0]               # ties keep the analytic best


def test_tuning_cache_bounded_lru_eviction_and_retune():
    old = tuning.set_cache_limit(4)
    try:
        shapes = [(64 * (i + 1), 128, 64) for i in range(6)]
        first = [tuning.choose_tile(*s, W2A2) for s in shapes]
        info = tuning.cache_info()
        assert info["entries"] == 4 and info["limit"] == 4
        assert info["evictions"] == 2                # 6 inserts, cap 4
        assert tuning.choose_tile(*shapes[0], W2A2) == first[0]
        assert tuning.cache_info()["misses"] == 7    # 6 cold + 1 re-tune
        tuning.choose_tile(*shapes[0], W2A2)
        assert tuning.cache_info()["hits"] == 1
        with pytest.raises(ValueError):
            tuning.set_cache_limit(0)
    finally:
        tuning.set_cache_limit(old)


def test_decisions_persist_across_restart_and_corrupt_records_retune(
        tmp_path):
    store = ArtifactStore(str(tmp_path / "tstore"))
    tuning.set_persistent_store(store)
    cfg = tuning.choose_tile(192, 320, 192, W3A3)
    conv = tuning.choose_conv_tile(2, 8, 8, 8, 16, spec=W3A3, **CONV)
    meas = tuning.choose_tile_measured(64, 2048, 2048, W4A8,
                                       measure=lambda c: c.warps)
    info = tuning.cache_info()
    assert info["enumerations"] == 3 and info["persist_hits"] == 0
    kinds = sorted(__import__("json").load(open(tmp_path / "tstore" /
                                                "tuning" / f))["kind"]
                   for f in os.listdir(tmp_path / "tstore" / "tuning"))
    assert kinds == ["conv_tile", "tile", "tile_measured"]
    tuning.clear_cache()                           # a restarted process
    assert tuning.choose_tile(192, 320, 192, W3A3) == cfg
    assert tuning.choose_conv_tile(2, 8, 8, 8, 16, spec=W3A3, **CONV) == conv
    assert tuning.choose_tile_measured(
        64, 2048, 2048, W4A8, measure=lambda c: 1 / 0) == meas  # no re-measure
    info = tuning.cache_info()
    assert info["enumerations"] == 0 and info["persist_hits"] == 3
    for name in os.listdir(tmp_path / "tstore" / "tuning"):
        (tmp_path / "tstore" / "tuning" / name).write_bytes(b"{broken")
    tuning.clear_cache()
    assert tuning.choose_tile(192, 320, 192, W3A3) == cfg   # re-tuned
    assert tuning.cache_info()["enumerations"] == 1


# ------------------------------------------ lowering, executor, store, verifier

@pytest.fixture(scope="module")
def lowered():
    """tiny_mixed_cnn lowered by the reference and by the port on the same
    calibration batch."""
    jg, calib = j_tiny_mixed_cnn()
    g, calib_t = tiny_mixed_cnn()
    jprog = j_compile_graph(jg, calib)
    prog = compile_graph(g, calib_t, device="cpu")
    x = np.random.RandomState(2).rand(2, 8, 8, 8).astype(np.float32)
    return jprog, prog, np.asarray(calib), x


def test_lowered_program_carries_tiles(lowered):
    _, prog, calib, _ = lowered
    packed = [s for s in prog.steps if s.kind in ("conv_packed",
                                                  "gemm_packed")]
    assert {s.kind for s in packed} == {"conv_packed", "gemm_packed"}
    n = calib.shape[0]
    for s in packed:
        tile = s.attrs["tile"]
        assert prog.meta["tiles"][s.name] == tile
        if s.kind == "conv_packed":
            node = [c for c in prog.cost_nodes if c.name == s.name][0]
            out_bits = s.attrs["requant_bits"] if s.attrs["out"] == "packed" \
                else None
            assert tile == tuning.choose_conv_tile(
                n, node.h, node.w, node.c_in, node.c_out, fh=node.fh,
                fw=node.fw, stride=node.stride, padding=node.padding,
                spec=s.attrs["spec"], out_bits=out_bits)
        else:
            assert isinstance(tile, tuning.TileConfig)
    verify_program(prog)


def test_port_lowering_equals_reference_at_every_integer_step(lowered):
    jprog, prog, _, x = lowered
    assert [s.kind for s in prog.steps] == [s.kind for s in jprog.steps]
    env = {jprog.input_name: jnp.asarray(x)}
    for jst, st in zip(jprog.steps, prog.steps):
        env[jst.output] = jexec.make_step_runner(jprog, jst, backend="xla")(
            jprog.params, *[env[i] for i in jst.inputs])
        ins = []
        for i in jst.inputs:
            a = np.asarray(env[i])
            ins.append(torch.from_numpy(np.array(
                a.view(np.int32) if a.dtype == np.uint32 else a)))
        got = texec.make_step_runner(prog, st)(prog.params, *ins).numpy()
        ref = np.asarray(env[jst.output])
        if ref.dtype == np.uint32:
            got = got.view(np.uint32)
        assert got.shape == ref.shape, st.name
        if st.kind in INTEGER_KINDS and not np.issubdtype(ref.dtype,
                                                          np.floating):
            np.testing.assert_array_equal(got, ref, err_msg=st.name)
        else:
            np.testing.assert_allclose(got, ref, rtol=1e-5,
                                       atol=1e-5 * _scale(ref),
                                       err_msg=st.name)
    assert any(s.kind == "conv_packed" and s.attrs["out"] == "packed"
               for s in prog.steps)     # an integer-output packed step


def test_tiles_round_trip_through_a_store(lowered, tmp_path):
    _, prog, _, x = lowered
    store = ArtifactStore(str(tmp_path / "s"))
    back = load_program(save_program(prog, store), store, device="cpu")
    assert back.meta["tiles"] == prog.meta["tiles"]
    for a, b in zip(prog.steps, back.steps):
        assert a.attrs.get("tile") == b.attrs.get("tile"), a.name
    xt = torch.from_numpy(x)
    assert torch.equal(back(xt), prog(xt))


def _recorded_tiles(monkeypatch):
    seen = []
    real = bitserial_conv.bitserial_conv2d

    def spy(*a, **kw):
        seen.append((a[0].shape[1], kw["tile"]))
        return real(*a, **kw)
    monkeypatch.setattr(bitserial_conv, "bitserial_conv2d", spy)
    return seen


def test_buckets_launch_their_own_shapes_tile(lowered, monkeypatch):
    """A tuned step launches, at each padding bucket, the tuner's choice
    for that bucket's shape (decided in the bucket's first pass, then an
    L1 hit); a step with no tile launches the kernels' heuristic."""
    _, prog, _, _ = lowered
    seen = _recorded_tiles(monkeypatch)
    runner = texec.BucketedRunner(prog, max_batch=8)
    assert runner.warmup() == 4
    conv = [s for s in prog.steps if s.kind == "conv_packed"][0]
    node = [c for c in prog.cost_nodes if c.name == conv.name][0]
    for b in (1, 2, 4, 8):
        want = tuning.choose_conv_tile(
            b, node.h, node.w, node.c_in, node.c_out, fh=node.fh, fw=node.fw,
            stride=node.stride, padding=node.padding,
            spec=conv.attrs["spec"],
            out_bits=(conv.attrs["requant_bits"]
                      if conv.attrs["out"] == "packed" else None))
        assert (b, want) in seen
    seen.clear()
    untiled = dataclasses.replace(prog, steps=tuple(
        dataclasses.replace(s, attrs={k: v for k, v in s.attrs.items()
                                      if k != "tile"}) for s in prog.steps))
    untiled(torch.zeros((3,) + prog.meta["input_shape"]))
    assert seen and all(t is tuning.HEURISTIC for _, t in seen)


def test_verify_program_tile_budget(lowered):
    _, prog, _, _ = lowered
    i = next(i for i, s in enumerate(prog.steps) if s.kind == "conv_packed")

    def with_attrs(**attrs):
        steps = list(prog.steps)
        a = {k: v for k, v in steps[i].attrs.items() if k != "tile"}
        a.update(attrs)
        steps[i] = dataclasses.replace(steps[i], attrs=a)
        return dataclasses.replace(prog, steps=tuple(steps))

    bad = (tuning.ConvTileConfig(32, 16),     # 512 threads, bound 128
           tuning.ConvTileConfig(24, 4),      # NT = 3
           tuning.HEURISTIC)                  # not a tuned tile
    for tile in bad:
        with pytest.raises(VerifyError) as e:
            verify_program(with_attrs(tile=tile))
        assert e.value.check == "tile-budget"
        assert e.value.blame == prog.steps[i].name
    with pytest.raises(VerifyError) as e:      # tiled Program, one untiled
        verify_program(with_attrs())
    assert e.value.check == "tile-budget"
    no_node = dataclasses.replace(prog, cost_nodes=[
        c for c in prog.cost_nodes if c.name != prog.steps[i].name])
    with pytest.raises(VerifyError, match="cost-node"):
        verify_program(no_node)


# ---------------------------------------- ResNet9's hand-written deployment

class _Small(tresnet.ResNet9Config):
    """Three narrow layers: packed into the next, a pool stage through
    codes, the float end."""
    layers = (("conv1", 64, 32, 2, False), ("conv2", 32, 48, 1, True),
              ("conv3", 48, 40, 1, False))


class _JSmall(jresnet.ResNet9Config):
    layers = _Small.layers


def test_resnet9_forward_packed_against_reference():
    params = tresnet.resnet9_init(5, _Small())
    images = np.random.RandomState(3).rand(2, 16, 16, 3).astype(np.float32)
    jpacked = jresnet.resnet9_pack(params, jnp.asarray(images), _JSmall())
    tpacked = tresnet.resnet9_pack(params, torch.from_numpy(images),
                                   _Small())
    for name, *_ in _Small.layers:
        j, t = jpacked["layers"][name], tpacked["layers"][name]
        np.testing.assert_array_equal(
            t["w_packed"].numpy().view(np.uint32), np.asarray(j["w_packed"]))
        np.testing.assert_allclose(t["scale"].numpy(),
                                   np.asarray(j["scale"]), rtol=1e-5)
    ref = np.asarray(jresnet.resnet9_forward_packed(
        jpacked, jnp.asarray(images), _JSmall(), backend="xla"))
    got = tresnet.resnet9_forward_packed(tpacked, torch.from_numpy(images),
                                         _Small()).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=0.02 * _scale(ref))
    assert np.array_equal(got.argmax(-1), ref.argmax(-1))
    quant = tresnet.resnet9_forward(params, torch.from_numpy(images),
                                    _Small()).numpy()
    np.testing.assert_allclose(got, quant, rtol=0, atol=0.02 * _scale(quant))
    layers = tresnet.resnet9_cost_layers()
    assert [(l.name, getattr(l, "h", None)) for l in layers] == [
        (l.name, getattr(l, "h", None)) for l in jresnet.resnet9_cost_layers()]


def test_quantized_linear_against_reference():
    rng = np.random.RandomState(7)
    x = rng.randn(5, 100).astype(np.float32)
    w = (rng.randn(100, 70) * 0.1).astype(np.float32)
    bias = (rng.randn(70) * 0.1).astype(np.float32)
    jqw = j_pack_weights(jnp.asarray(w), JQuantSpec(4, True,
                                                    per_channel=True))
    tqw = pack_weights(torch.from_numpy(w), QuantSpec(4, True,
                                                      per_channel=True))
    np.testing.assert_array_equal(tqw.packed.numpy().view(np.uint32),
                                  np.asarray(jqw.packed))
    ref = np.asarray(jops.quantized_linear(
        jnp.asarray(x), jqw, jnp.float32(0.05), a_bits=8,
        bias=jnp.asarray(bias), relu=True, backend="xla"))
    got = ops.quantized_linear(torch.from_numpy(x), tqw, 0.05, a_bits=8,
                               bias=torch.from_numpy(bias), relu=True)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6,
                               atol=1e-6 * _scale(ref))
