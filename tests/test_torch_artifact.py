"""The port's artifact store against the JAX package: a store the
reference writes loads in the port and runs as the reference's Program
does; the port's own saves round-trip; both packages name a plane by one
digest; every integrity failure raises; the registry warm-boots,
registers artifacts by name, re-admits evicted variants by a load and
collects garbage as the reference's does; the service and the CLI's
``compile`` and ``profile`` run from a store.

Inputs are made from seeds with numpy. Tolerances, each with its reason:

* A reference Program loaded from the reference's store: every integer
  step (quantize_pack, conv_packed, gemm_packed, maxpool, pack_codes)
  exact, each step fed the reference step's own input; float steps
  rtol/atol 1e-5 of the tensor's scale (float32 sums in another order);
  logits from the images within 2% of their largest magnitude, argmax
  equal — all as ``tests/test_torch_slice.py`` states them.
* The port's own save → load, the registry's and the service's answers:
  exact at equal shapes (the same Program on the same tensors).
"""

import _torch_threads  # noqa: F401  (first: caps torch's threads under xdist)

import hashlib
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compiler import ArtifactStore as JStore
from repro.compiler import array_digest as j_array_digest
from repro.compiler import compile_graph as j_compile_graph
from repro.compiler import executor as jexec
from repro.compiler import save_program as j_save_program
from repro.compiler.bench_graphs import tiny_mixed_cnn as j_tiny_mixed_cnn
from repro.models import resnet as jresnet

from repro_torch.analysis.verify_ir import VerifyError
from repro_torch.compiler import (ArtifactError, ArtifactStore, Graph, Node,
                                  array_digest, compile_graph, load_program,
                                  program_from_numpy, save_program)
from repro_torch.compiler import executor as texec
from repro_torch.compiler.artifact import _blob_array
from repro_torch.launch import serve
from repro_torch.models import resnet as tresnet
from repro_torch.models.layers import QuantPolicy
from repro_torch.serving import InferenceService, ModelRegistry

INTEGER_KINDS = ("quantize_pack", "conv_packed", "gemm_packed", "maxpool",
                 "pack_codes")
W2A2 = QuantPolicy(mode="serial", w_bits=2, a_bits=2, radix_bits=7)
W2A8 = QuantPolicy(mode="serial", w_bits=2, a_bits=8, radix_bits=7)


def _scale(a) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64)))) + 1e-30


def _to_np(t: torch.Tensor, like) -> np.ndarray:
    a = t.numpy()
    if np.asarray(like).dtype == np.uint32:
        a = a.view(np.uint32)
    return a


# ------------------------------------------------ a store the reference wrote

@pytest.fixture(scope="module")
def ref_store(tmp_path_factory):
    """The reference's tiny_mixed_cnn and its ResNet9 (full width, 16x16
    inputs, batch 2) compiled and saved by the JAX package; returns
    (root, {name: (jax Program, input batch)})."""
    root = str(tmp_path_factory.mktemp("ref_store"))
    store = JStore(root)
    g, calib = j_tiny_mixed_cnn()
    tiny = j_compile_graph(g, calib)
    j_save_program(tiny, store, name="tiny_cnn@W2A2")
    params = tresnet.resnet9_init(0, tresnet.ResNet9Config())
    images = np.random.RandomState(0).rand(2, 16, 16, 3).astype(np.float32)
    r9 = jresnet.resnet9_compile(params, jnp.asarray(images),
                                 jresnet.ResNet9Config(), backend="xla",
                                 input_hw=16)
    j_save_program(r9, store, name="resnet9@W2A2")
    x_tiny = np.random.RandomState(2).rand(2, 8, 8, 8).astype(np.float32)
    return root, {"tiny_cnn@W2A2": (tiny, x_tiny),
                  "resnet9@W2A2": (r9, images)}


@pytest.mark.parametrize("name", ["tiny_cnn@W2A2", "resnet9@W2A2"])
def test_reference_store_loads_and_runs_in_port(ref_store, name):
    """Loaded by name (the stream-drift check and the verifier pass), every
    step equals the reference's on the reference step's own input, the
    stream equals the reference's job for job, and the logits agree."""
    root, progs = ref_store
    jprog, x = progs[name]
    prog = load_program(name, ArtifactStore(root), device="cpu")
    assert [s.kind for s in prog.steps] == [s.kind for s in jprog.steps]
    assert all("tile" not in s.attrs for s in prog.steps)
    assert "tiles" not in prog.meta and prog.meta["formats"]
    assert prog.per_layer_bits == {k: tuple(v) for k, v in
                                   jprog.per_layer_bits.items()}
    env = {jprog.input_name: jnp.asarray(x)}
    for jst, st in zip(jprog.steps, prog.steps):
        fn = jax.jit(jexec.make_step_runner(jprog, jst, backend="xla"))
        env[jst.output] = fn(jprog.params, *[env[i] for i in jst.inputs])
        ins = []
        for i in jst.inputs:
            a = np.asarray(env[i])
            ins.append(torch.from_numpy(np.array(
                a.view(np.int32) if a.dtype == np.uint32 else a)))
        got = texec.make_step_runner(prog, st)(prog.params, *ins)
        ref = np.asarray(env[jst.output])
        out = _to_np(got, ref)
        assert out.shape == ref.shape, st.name
        if st.kind in INTEGER_KINDS:
            assert out.dtype == ref.dtype, st.name
            np.testing.assert_array_equal(out, ref, err_msg=st.name)
        else:
            np.testing.assert_allclose(out, ref, rtol=1e-5,
                                       atol=1e-5 * _scale(ref),
                                       err_msg=st.name)
    logits = prog(torch.from_numpy(x)).numpy()
    ref = np.asarray(jprog(jnp.asarray(x)))
    np.testing.assert_allclose(logits, ref, rtol=0, atol=0.02 * _scale(ref))
    assert np.array_equal(logits.argmax(-1), ref.argmax(-1))
    cs, jcs = prog.to_command_stream(), jprog.to_command_stream()
    assert cs.summary() == jcs.summary()
    assert cs.per_mvu_cycles == jcs.per_mvu_cycles


def test_port_save_of_a_carried_program_names_planes_as_the_reference(
        ref_store, tmp_path):
    """A reference Program carried across and saved by the port writes
    every blob under the reference's digest (planes as uint32): the same
    plane is one file in a shared store."""
    root, progs = ref_store
    jprog, _ = progs["resnet9@W2A2"]
    record = {"graph_name": jprog.graph_name,
              "input_name": jprog.input_name,
              "output_name": jprog.output_name,
              "steps": JStore(root).get_program(JStore(root).resolve(
                  "resnet9@W2A2"))["steps"],
              "params": {k: {n: np.asarray(a) for n, a in p.items()}
                         for k, p in jprog.params.items()}}
    carried = program_from_numpy(record, device="cpu")
    ours = ArtifactStore(str(tmp_path / "ours"))
    save_program(carried, ours)
    ref_manifest = JStore(root).get_program(
        JStore(root).resolve("resnet9@W2A2"))
    our_manifest = ours.get_program(next(iter(
        n[:-5] for n in os.listdir(os.path.join(ours.root, "programs")))))
    for step, rec in ref_manifest["params"].items():
        for key, blob in rec.items():
            assert our_manifest["params"][step][key]["blob"] == blob["blob"]
            assert our_manifest["params"][step][key]["dtype"] == \
                blob["dtype"]
    plane = carried.params["conv1"]["w_packed"]
    assert plane.dtype == torch.int32
    assert array_digest(_blob_array("w_packed", plane)) == j_array_digest(
        jprog.params["conv1"]["w_packed"])


def test_bit31_plane_survives_the_uint32_boundary(tmp_path):
    """Words with bit 31 set: stored as the reference's uint32 bits under
    the reference's digest, and back as the same int32 bits."""
    words = np.array([[0x80000000, 0xFFFFFFFF, 0x7FFFFFFF, 1]],
                     dtype=np.uint32)
    plane = torch.from_numpy(words.view(np.int32).copy())
    stored = _blob_array("w_packed", plane)
    assert stored.dtype == np.uint32
    np.testing.assert_array_equal(stored, words)
    assert array_digest(stored) == j_array_digest(words)
    assert array_digest(stored) != array_digest(plane)   # the dtype counts
    store = ArtifactStore(str(tmp_path / "s"))
    digest = store.put_array(stored)
    assert digest == j_array_digest(words)
    back = store.get_array(digest)
    assert back.dtype == np.uint32
    assert torch.equal(torch.from_numpy(back.view(np.int32)), plane)


# ---------------------------------------------- the port's own store (CPU)

def _tiny_graph(name, seed=0, ci=8, co=16, h=8, w=8):
    rng = np.random.RandomState(seed)
    return Graph(
        name, {"x": (None, h, w, ci)}, ["out"],
        [Node("c1", "conv2d", ["x", "c1.w"], "c1.y",
              {"stride": 1, "padding": 1}),
         Node("r1", "relu", ["c1.y"], "c1.o"),
         Node("gap", "global_avg_pool", ["c1.o"], "p"),
         Node("fc", "gemm", ["p", "fc.w"], "out", {"host": True})],
        {"c1.w": rng.randn(3, 3, ci, co).astype(np.float32),
         "fc.w": rng.randn(co, 10).astype(np.float32)})


def _calib():
    return np.random.RandomState(1).rand(4, 8, 8, 8).astype(np.float32)


def _x(batch=2):
    return torch.from_numpy(
        np.random.RandomState(2).rand(batch, 8, 8, 8).astype(np.float32))


def _register_all(registry):
    """2 models x 2 precisions — fresh graph objects each call (a compile
    annotates the graph in place, as a real restart never sees)."""
    calib = _calib()
    return [registry.register_graph(g.name, g, calib, p)
            for g in (_tiny_graph("m0", seed=0), _tiny_graph("m1", seed=3))
            for p in (W2A2, W2A8)]


@pytest.fixture(scope="module")
def populated(tmp_path_factory):
    """(store_root, {variant: logits}) — a store holding all 4 variants,
    written by a cold registry on the CPU, plus the compiled outputs."""
    root = str(tmp_path_factory.mktemp("artifacts"))
    reg = ModelRegistry(store=root, device="cpu")
    keys = _register_all(reg)
    outs = {str(k): reg.program(k)(_x()) for k in keys}
    assert reg.compiles == 4 and reg.artifact_saves == 4
    return root, outs


def test_round_trip_bit_exact(populated):
    root, outs = populated
    store = ArtifactStore(root)
    prog = load_program("m0@W2A2", store, device="cpu")
    assert torch.equal(prog(_x()), outs["m0@W2A2"])
    fresh = compile_graph(_tiny_graph("m0", seed=0), _calib(), policy=W2A2,
                          device="cpu")
    cs_fresh = fresh.to_command_stream(mode="pipelined")
    cs_load = prog.to_command_stream(mode="pipelined")
    assert cs_load.jobs == cs_fresh.jobs
    assert cs_load.per_mvu_cycles == cs_fresh.per_mvu_cycles
    assert prog.meta["policy"]["a_bits"] == 2
    assert prog.meta["input_shape"] == (8, 8, 8)
    assert prog.params["c1"]["w_packed"].dtype == torch.int32


def test_load_accepts_ref_or_name(populated):
    root, _ = populated
    store = ArtifactStore(root)
    ref = store.resolve("m1@W2A8")
    assert ref is not None
    by_ref = load_program(ref, store, device="cpu")
    by_name = load_program("m1@W2A8", store, device="cpu")
    assert torch.equal(by_ref(_x()), by_name(_x()))
    assert store.stats()["loads"] == 2


def test_packed_planes_deduped_on_disk(populated):
    """W2A2 and W2A8 of one model share every packed plane: one blob on
    disk, and one tensor when both load into one registry."""
    root, _ = populated
    store = ArtifactStore(root)
    ra2 = store.get_program(store.resolve("m0@W2A2"))
    ra8 = store.get_program(store.resolve("m0@W2A8"))
    assert ra2["params"]["c1"]["w_packed"] == ra8["params"]["c1"]["w_packed"]
    assert ra2["params"]["c1"]["w_packed"]["dtype"] == "uint32"
    assert store.stats()["dedup_ratio"] > 1.0
    reg = ModelRegistry(store=root, device="cpu")
    k2 = reg.register_artifact("m0", precision="W2A2")
    k8 = reg.register_artifact("m0", precision="W2A8")
    assert reg.program(k2).params["c1"]["w_packed"] is \
        reg.program(k8).params["c1"]["w_packed"]


def test_unknown_ref_rejected(populated):
    root, _ = populated
    with pytest.raises(ArtifactError, match="neither a program ref"):
        load_program("nope@W9A9", ArtifactStore(root), device="cpu")


def _blob_paths(root):
    d = os.path.join(root, "blobs")
    return [os.path.join(d, n) for n in sorted(os.listdir(d))]


def _restore(path, payload):
    with open(path, "wb") as f:
        f.write(payload)


@pytest.mark.parametrize("corruption", ["garbage", "truncate", "swap"])
def test_corrupt_blobs_rejected(populated, corruption):
    root, _ = populated
    store = ArtifactStore(root)
    saved = {}
    try:
        for path in _blob_paths(root):
            with open(path, "rb") as f:
                saved[path] = f.read()
            if corruption == "garbage":
                _restore(path, b"\x00not an npy file")
            elif corruption == "truncate":
                _restore(path, saved[path][:max(1, len(saved[path]) // 2)])
            else:   # valid npy, wrong content
                a = np.load(io.BytesIO(saved[path]), allow_pickle=False)
                buf = io.BytesIO()
                np.save(buf, np.zeros_like(np.atleast_1d(a)),
                        allow_pickle=False)
                _restore(path, buf.getvalue())
        with pytest.raises(ArtifactError,
                           match="unreadable|integrity|decodes to"):
            load_program("m0@W2A2", store, device="cpu")
    finally:
        for path, payload in saved.items():
            _restore(path, payload)


def test_missing_blob_rejected(populated, tmp_path):
    root, _ = populated
    store = ArtifactStore(root)
    ref = store.resolve("m0@W2A2")
    empty = ArtifactStore(str(tmp_path / "empty"))
    with open(store._program_path(ref), "rb") as f:
        empty._atomic_write(empty._program_path(ref), f.read())
    with pytest.raises(ArtifactError, match="missing blob"):
        load_program(ref, empty, device="cpu")


def test_tampered_manifest_rejected(populated):
    root, _ = populated
    store = ArtifactStore(root)
    ref = store.resolve("m0@W2A2")
    path = store._program_path(ref)
    with open(path, "rb") as f:
        payload = f.read()
    try:
        _restore(path, payload.replace(b'"m0"', b'"mx"', 1))
        with pytest.raises(ArtifactError, match="integrity"):
            load_program(ref, store, device="cpu")
    finally:
        _restore(path, payload)


def test_version_bump_rejected(populated):
    store = ArtifactStore(populated[0])
    manifest = store.get_program(store.resolve("m0@W2A2"))
    manifest["version"] += 1
    future_ref = store.put_program(manifest)
    with pytest.raises(ArtifactError, match="format version"):
        load_program(future_ref, store, device="cpu")


def test_wrong_format_rejected(populated):
    store = ArtifactStore(populated[0])
    payload = json.dumps({"format": "other", "version": 1}).encode()
    ref = hashlib.sha256(payload).hexdigest()
    store._atomic_write(store._program_path(ref), payload)
    with pytest.raises(ArtifactError, match="not a repro-program-artifact"):
        load_program(ref, store, device="cpu")


def test_redigested_tamper_rejected_by_the_verifier(populated):
    """A manifest edited and re-digested passes the hash checks; the
    program verifier at the ungated ``artifact_load`` site rejects it."""
    store = ArtifactStore(populated[0])
    manifest = store.get_program(store.resolve("m0@W2A2"))
    manifest["steps"][1]["inputs"] = ["ghost"]
    bad_ref = store.put_program(manifest)
    with pytest.raises(ArtifactError) as ei:
        load_program(bad_ref, store, device="cpu")
    assert "step-dangling-input" in str(ei.value)
    assert isinstance(ei.value.__cause__, VerifyError)


def test_stream_drift_rejected(populated):
    store = ArtifactStore(populated[0])
    manifest = store.get_program(store.resolve("m0@W2A2"))
    manifest["stream_pipelined"][0]["m_tiles"] += 1
    with pytest.raises(ArtifactError, match="drift"):
        load_program(store.put_program(manifest), store, device="cpu")


# -------------------------------------------------------- registry + store

def test_warm_boot_zero_compiles(populated):
    root, outs = populated
    reg = ModelRegistry(store=root, device="cpu")
    keys = _register_all(reg)
    report = reg.warm_boot()
    assert len(report["restored"]) == 4 and not report["compiled"]
    assert reg.compiles == 0 and reg.artifact_hits == 4
    for k in keys:
        assert torch.equal(reg.program(k)(_x()), outs[str(k)])
    st = reg.stats()
    assert st["artifact_hits"] == 4
    assert st["artifact_store"]["loads"] == 4
    assert st["artifact_store"]["load_p50_ms"] > 0


def test_register_artifact_needs_no_recipe(populated):
    root, outs = populated
    reg = ModelRegistry(store=root, device="cpu")
    key = reg.register_artifact("m1", precision="W2A2")
    assert torch.equal(reg.program(key)(_x()), outs["m1@W2A2"])
    assert reg.compiles == 0
    with pytest.raises(ArtifactError, match="no artifact tagged"):
        reg.register_artifact("ghost", precision="W2A2")
    with pytest.raises(ValueError, match="requires a registry store"):
        ModelRegistry(device="cpu").register_artifact("m1",
                                                      precision="W2A2")


def test_eviction_readmits_via_load_not_recompile(populated):
    root, _ = populated
    reg = ModelRegistry(store=root, max_programs=1, device="cpu")
    k_a2, k_a8 = _register_all(reg)[:2]
    y_a2 = reg.program(k_a2)(_x())
    reg.program(k_a8)                      # evicts m0@W2A2
    assert reg.evictions == 1 and reg.artifact_spills == 1
    loads_before = reg.store.loads
    assert torch.equal(reg.program(k_a2)(_x()), y_a2)
    assert reg.compiles == 0               # re-admission was a disk load
    assert reg.store.loads == loads_before + 1


def test_eviction_keeps_planes_shared_with_siblings(populated):
    """A re-admitted Program re-shares the very tensor its resident sibling
    holds, instead of a second copy of the plane."""
    root, _ = populated
    reg = ModelRegistry(store=root, max_programs=1, device="cpu")
    k_a2, k_a8 = _register_all(reg)[:2]
    reg.program(k_a2)
    p_a8 = reg.program(k_a8)               # evicts p_a2
    p_a2_again = reg.program(k_a2)         # loads from disk, evicts p_a8
    assert reg.shared_arrays >= 1
    assert p_a2_again.params["c1"]["w_packed"] is \
        p_a8.params["c1"]["w_packed"]


def test_stale_ref_falls_through_to_compile(populated, tmp_path):
    """A graph entry whose stored artifact no longer loads compiles its
    recipe (a store miss), as the reference's registry does; an artifact
    entry has no recipe and raises."""
    root, outs = populated
    import shutil
    copy = str(tmp_path / "copy")
    shutil.copytree(root, copy)
    for path in _blob_paths(copy):
        _restore(path, b"\x00broken")
    reg = ModelRegistry(store=copy, device="cpu")
    key = reg.register_graph("m0", _tiny_graph("m0", seed=0), _calib(),
                             W2A2)
    assert torch.equal(reg.program(key)(_x()), outs["m0@W2A2"])
    assert reg.compiles == 1 and reg.artifact_hits == 0
    assert reg.store.misses == 1
    reg2 = ModelRegistry(store=copy, device="cpu")
    k = reg2.register_artifact("m1", precision="W2A2")
    with pytest.raises(ArtifactError):
        reg2.program(k)


def test_service_metrics_expose_store(populated):
    """Warm boot through the service (restores, then captures its buckets),
    and one request answered equal to the loaded Program at the request's
    bucket — the same shape, so the same float rounding."""
    root, _ = populated
    reg = ModelRegistry(store=root, device="cpu")
    keys = _register_all(reg)
    with InferenceService(reg, max_wait_s=0.0) as svc:
        report = svc.warm_boot()
        assert len(report["restored"]) == 4 and not report["compiled"]
        assert report["bucket_compiles"] >= 4
        x1 = _x(1)
        f = svc.submit(keys[0], x1[0].numpy())
        got = f.result(timeout=60)
        m = svc.metrics()
    assert np.array_equal(got, reg.program(keys[0])(x1)[0].numpy())
    assert reg.compiles == 0
    assert m["artifact_store"]["loads"] >= 4
    assert m["registry"]["artifact_hits"] == 4


def test_warm_boot_enumerates_no_tile_buckets_included(populated):
    """The store is the tile tuner's L2: once a service has warm-booted
    from it (every bucket tuned and persisted), a restarted process's
    warm boot restores the Programs with their tiles and captures every
    bucket with zero compiles and zero enumerations."""
    from repro_torch.kernels import tuning
    root, outs = populated
    old = tuning.set_persistent_store(None)
    try:
        for restart in (False, True):
            tuning.clear_cache()          # a fresh process's empty L1
            reg = ModelRegistry(store=root, device="cpu")
            keys = _register_all(reg)
            with InferenceService(reg, max_wait_s=0.0) as svc:
                report = svc.warm_boot()
            assert not report["compiled"] and report["bucket_compiles"] >= 4
        info = tuning.cache_info()
        assert info["enumerations"] == 0 and info["persist_hits"] > 0
        for k in keys:
            prog = reg.program(k)
            packed = [s for s in prog.steps if s.kind == "conv_packed"]
            assert packed and all(isinstance(s.attrs["tile"],
                                             tuning.ConvTileConfig)
                                  for s in packed)
            assert prog.meta["tiles"] == {s.name: s.attrs["tile"]
                                          for s in packed}
            assert torch.equal(prog(_x()), outs[str(k)])
    finally:
        tuning.set_persistent_store(old)
        tuning.clear_cache()


# ------------------------------------------------------------ garbage gc

@pytest.fixture()
def gc_store(tmp_path):
    root = str(tmp_path / "gcstore")
    reg = ModelRegistry(store=root, device="cpu")
    keys = _register_all(reg)
    outs = {str(k): reg.program(k)(_x()) for k in keys}
    return ArtifactStore(root), keys, outs


def test_gc_noop_when_everything_tagged(gc_store):
    store, _, _ = gc_store
    before = store.stats()
    rep = store.gc()
    assert rep["removed_programs"] == 0 and rep["removed_blobs"] == 0
    assert rep["bytes_freed"] == 0
    assert rep["live_programs"] == len(set(store.tags().values()))
    assert store.stats() == before


def test_gc_dry_run_reports_without_deleting(gc_store):
    store, keys, _ = gc_store
    assert store.untag(str(keys[0]))
    assert not store.untag(str(keys[0]))
    before = store.stats()
    rep = store.gc(dry_run=True)
    assert rep["dry_run"] is True and rep["removed_programs"] == 1
    assert rep["bytes_freed"] > 0
    assert store.stats() == before
    live = store.gc()
    assert live["removed_programs"] == 1
    assert live["bytes_freed"] >= rep["bytes_freed"]


def test_gc_keeps_blobs_shared_with_surviving_tags(gc_store):
    store, keys, outs = gc_store
    k_dead, k_live = keys[0], keys[1]
    blobs_before = store.stats()["blobs"]
    store.untag(str(k_dead))
    rep = store.gc()
    assert rep["removed_programs"] == 1
    assert store.stats()["blobs"] == blobs_before - rep["removed_blobs"]
    prog = load_program(str(k_live), store, device="cpu")
    assert torch.equal(prog(_x()), outs[str(k_live)])


def test_gc_collects_fully_untagged_model(gc_store):
    store, keys, outs = gc_store
    st0 = store.stats()
    for k in keys[2:]:
        assert store.untag(str(k))
    rep = store.gc()
    assert rep["removed_programs"] == 2 and rep["removed_blobs"] > 0
    assert rep["bytes_freed"] > 0
    st = store.stats()
    assert st["programs"] == st0["programs"] - 2
    assert st["blobs"] == st0["blobs"] - rep["removed_blobs"]
    for k in keys[:2]:
        prog = load_program(str(k), store, device="cpu")
        assert torch.equal(prog(_x()), outs[str(k)])
    assert store.gc()["removed_programs"] == 0
    assert store.gc()["removed_blobs"] == 0


def test_gc_keeps_unreadable_but_tagged_manifest(gc_store):
    store, keys, _ = gc_store
    ref = store.resolve(str(keys[0]))
    path = os.path.join(store.root, "programs", f"{ref}.json")
    _restore(path, b"{not json")
    rep = store.gc()
    assert rep["removed_programs"] == 0
    assert os.path.exists(path)


def test_recipe_keys_differ_from_the_reference(tmp_path):
    """One recipe compiled by each package lands under different recipe
    keys, so neither serves the other's compile by recipe."""
    from repro.compiler import recipe_digest as j_recipe_digest
    from repro.models.layers import QuantPolicy as JPolicy
    from repro_torch.compiler import recipe_digest
    g, calib = _tiny_graph("m0"), _calib()
    ours = recipe_digest(g, calib, W2A2, route="torch:cpu")
    assert ours == recipe_digest(_tiny_graph("m0"), calib, W2A2,
                                 route="torch:cpu")
    assert ours != recipe_digest(g, calib, W2A2, route="torch:cuda")
    jpol = JPolicy(mode="serial", w_bits=2, a_bits=2, radix_bits=7)
    assert ours != j_recipe_digest(g, calib, jpol)


# ------------------------------------------------------------------- CLI

def _run_cli(argv, capsys):
    serve.main(argv)
    return capsys.readouterr().out


def test_compile_cli_twice_then_profile(tmp_path, capsys):
    """``compile`` compiles and saves W2A2 and W2A8 (sharing planes); a
    second run is a store hit; ``--gc-dry-run`` finds nothing; ``profile``
    loads the compile and persists a calibration; the CNN CLI with
    ``--store`` warm-boots from the same recipe with zero compiles."""
    from repro_torch.obs import calibrate
    root = str(tmp_path / "clistore")
    base = ["compile", "--arch", "resnet9-cifar10", "--store", root,
            "--device", "cpu"]
    out = _run_cli(base + ["--precisions", "W2A2,W2A8"], capsys)
    assert out.count("(compiled)") == 2
    assert "programs=2" in out
    out = _run_cli(base + ["--gc-dry-run"], capsys)
    assert "resnet9_cifar10@W2A2" in out and "(store hit)" in out
    assert "gc dry-run: removed_programs=0" in out
    out = _run_cli(["profile", "--store", root, "--device", "cpu",
                    "--batch", "1", "--repeats", "1"], capsys)
    assert "conv_packed" in out and "roofline_us" in out
    assert "calibration persisted" in out
    cal = calibrate.load(ArtifactStore(root), "cpu", "resnet9_cifar10@W2A2")
    assert cal is not None and cal.ns_for("conv_packed") > 0
    assert calibrate.load(ArtifactStore(root), "cuda",
                          "resnet9_cifar10@W2A2") is None
    out = _run_cli(["--arch", "resnet9-cifar10", "--batch", "2", "--device",
                    "cpu", "--store", root], capsys)
    assert "restored=['resnet9_cifar10@W2A2'] compiled=[]" in out
    assert "artifact store: hits=1 misses=0 loads=1" in out
    with pytest.raises(SystemExit, match="not a CNN"):
        serve.main(["compile", "--arch", "stablelm-1.6b", "--store", root])


def test_cnn_server_from_store_and_artifact(tmp_path):
    """``CNNServer(store=)`` saves its compile; a second server on the same
    store boots with zero compiles; ``CNNServer(artifact=)`` serves the
    stored Program by tag with no graph; answers equal the compiled
    Program at the request's bucket."""
    root = str(tmp_path / "srvstore")
    imgs = np.random.default_rng(3).random((1, 32, 32, 3), dtype=np.float32)
    with serve.CNNServer(store=root, device="cpu", calib_batch=2) as first:
        compiled = first.program
        want = compiled(torch.from_numpy(imgs)).numpy()
        assert first.registry.artifact_saves == 1
    with serve.CNNServer(store=root, device="cpu", calib_batch=2) as again:
        report = again.warm_boot()
        assert report["restored"] == [str(again.key)]
        assert again.registry.compiles == 0
        assert np.array_equal(again.classify(imgs), want)
    with serve.CNNServer(store=root, artifact="resnet9_cifar10@W2A2",
                         device="cpu") as fleet:
        assert fleet.graph is None
        assert np.array_equal(fleet.classify(imgs), want)
        assert fleet.registry.compiles == 0
    with pytest.raises(ValueError, match="requires store"):
        serve.CNNServer(artifact="resnet9_cifar10@W2A2", device="cpu")
    with pytest.raises(ValueError, match="model@precision"):
        serve.CNNServer(store=root, artifact="resnet9", device="cpu")
