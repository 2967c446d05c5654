"""The port's sharding rules (``distributed/sharding.py``) against the
reference's, in this process with no ranks: every parameter leaf of all
ten FULL configs and every decode-cache leaf of the archs with
``decode_32k`` gets the reference's spec on both production meshes (the
reference's trees from ``jax.eval_shape``, the port's from the ``meta``
device), every spec divides its dims, ``batch_pspec`` agrees, DTensor
placements round-trip to specs, and the dry run's per-device bytes equal
the sum over the reference's leaves of each leaf's bytes over its spec's
shards. Everything compared is integer or exact: no tolerance.
"""

import _torch_threads  # noqa: F401  (first: caps torch's threads under xdist)

import dataclasses
import types
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.configs import base as jbase
from repro.distributed import sharding as jsh
from repro.models import transformer as jt
from repro.optim.optimizer import adamw_init as j_adamw_init

from repro_torch import configs as tconfigs
from repro_torch.distributed import sharding as tsh
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import MESH_AXES, make_production_mesh
from repro_torch.models import transformer as tt

ARCHS = sorted(tconfigs.list_archs())
KINDS = ("single", "multi")


def _jmesh(kind):
    mesh = make_production_mesh(multi_pod=kind == "multi")
    try:                                           # jax >= 0.5
        return jax.sharding.AbstractMesh(mesh.sizes, mesh.axis_names)
    except TypeError:                              # 0.4.x: (name, size) pairs
        return jax.sharding.AbstractMesh(tuple(zip(mesh.axis_names,
                                                   mesh.sizes)))


def _norm(spec, ndim):
    """A ``PartitionSpec`` as the port's tuple: one entry per dim, a
    one-name tuple as the name."""
    out = list(tuple(spec)) + [None] * (ndim - len(tuple(spec)))
    return tuple(a[0] if isinstance(a, tuple) and len(a) == 1 else a
                 for a in out)


def _jspecs(tree, jmesh, kind):
    """``{path: (shape, spec)}`` of the reference's tensor leaves (its
    caches' ``len``/``rolling`` left out: the port keeps them on the
    host)."""
    specs = jsh.tree_pspecs(tree, jmesh, kind=kind)
    flat_l = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_s = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    out = {}
    for (kp, leaf), (_, spec) in zip(flat_l, flat_s):
        path = jsh._path_str(kp)
        if path.split("/")[-1] in ("len", "rolling"):
            continue
        out[path] = (tuple(leaf.shape), _norm(spec, len(leaf.shape)))
    return out


def _tspecs(tree, mesh, rule):
    import torch
    return {path: (tuple(t.shape), rule(path, tuple(t.shape), mesh))
            for path, t in tsh.tree_paths(tree) if torch.is_tensor(t)}


def _divides(specs, mesh):
    sizes = mesh.shape
    for path, (shape, spec) in specs.items():
        assert len(spec) == len(shape), path
        for d, ax in enumerate(spec):
            if ax is not None:
                n = int(np.prod([sizes[a] for a in (
                    ax if isinstance(ax, tuple) else (ax,))]))
                assert shape[d] % n == 0, (path, shape, spec)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_cache_specs_equal_reference(arch):
    """Every parameter leaf of the FULL config, and (archs with
    ``decode_32k``) every cache leaf at batch 128 and 32,768 positions,
    has the reference's spec on the 256- and 512-device meshes."""
    jcfg, tcfg = jconfigs.get_arch(arch).full, tconfigs.get_arch(arch).full
    jp = jax.eval_shape(partial(jt.init_params, cfg=jcfg),
                        jax.random.PRNGKey(0))
    tp = tt.init_params(dryrun._MetaGenerator(), tcfg)
    decode = "decode_32k" in jconfigs.get_arch(arch).shapes
    if decode:
        jc = jax.eval_shape(partial(jt.init_caches, cfg=jcfg, batch=128,
                                    max_len=32768))
        tc = tt.init_caches(tcfg, 128, 32768, device="meta")
        assert len(jc) == len(tc)
    for kind in KINDS:
        mesh = make_production_mesh(multi_pod=kind == "multi")
        jmesh = _jmesh(kind)
        want = _jspecs(jp, jmesh, "param")
        got = _tspecs(tp, mesh, tsh.param_pspec)
        assert got == want, (arch, kind)
        _divides(got, mesh)
        if decode:
            for jg, tg in zip(jc, tc):
                want = _jspecs(jg, jmesh, "cache")
                got = _tspecs(tg, mesh, tsh.cache_pspec)
                assert got == want, (arch, kind)
                _divides(got, mesh)


def test_batch_pspec_and_tree_pspecs_equal_reference():
    """``batch_pspec`` of batch shapes that divide and that don't, and
    ``tree_pspecs`` of a small tree (a list, nested dicts, a cache's
    ``len``), as the reference's."""
    for kind in KINDS:
        mesh, jmesh = make_production_mesh(multi_pod=kind == "multi"), \
            _jmesh(kind)
        for shape in [(256, 4096), (512, 128, 64), (8, 64), (32,), ()]:
            assert tsh.batch_pspec(shape, mesh) == _norm(
                jsh.batch_pspec(shape, jmesh), len(shape)), (kind, shape)
        tree = {"groups": [{"attn": {"wq": {"w": np.zeros((2, 512, 1024))},
                                     "norm": np.zeros((512,))}}],
                "embed": np.zeros((4096, 512))}
        got = tsh.tree_pspecs(tree, mesh)
        want = jsh.tree_pspecs(jax.tree.map(jnp.asarray, tree), jmesh)
        assert got["embed"] == _norm(want["embed"], 2)
        assert got["groups"][0]["attn"]["wq"]["w"] == _norm(
            want["groups"][0]["attn"]["wq"]["w"], 3)
        cache = {"k": np.zeros((2, 128, 64, 8, 16)), "len": 0}
        assert tsh.tree_pspecs(cache, mesh, kind="cache")["k"] == _norm(
            jsh.tree_pspecs(jax.tree.map(jnp.asarray, cache), jmesh,
                            kind="cache")["k"], 5)


@pytest.mark.parametrize("kind", KINDS)
def test_to_placements_round_trips(kind):
    """Every spec of deepseek-v2-lite's and qwen1.5-110b's params and
    caches becomes DTensor placements (``Shard(d)`` on each mesh dim the
    spec names, ``("pod", "data")`` on both) and back to itself; an axis
    out of the mesh's order raises. ``to_placements`` reads the mesh's
    dimension names only, so no process group is needed."""
    from torch.distributed.tensor import Replicate, Shard
    dmesh = types.SimpleNamespace(mesh_dim_names=MESH_AXES[kind])
    mesh = make_production_mesh(multi_pod=kind == "multi")
    seen = set()
    for arch in ("deepseek-v2-lite-16b", "qwen1.5-110b"):
        cfg = tconfigs.get_arch(arch).full
        specs = list(_tspecs(tt.init_params(dryrun._MetaGenerator(), cfg),
                             mesh, tsh.param_pspec).values())
        for c in tt.init_caches(cfg, 128, 32768, device="meta"):
            specs += _tspecs(c, mesh, tsh.cache_pspec).values()
        for shape, spec in specs:
            pls = tsh.to_placements(spec, dmesh)
            assert len(pls) == len(MESH_AXES[kind])
            assert tsh.from_placements(pls, dmesh, len(shape)) == spec
            seen.add(spec)
    dp = ("pod", "data") if kind == "multi" else "data"
    assert any(dp in s for s in seen) and any("model" in s for s in seen)
    if kind == "multi":
        assert tsh.to_placements((("pod", "data"), "model"), dmesh) == (
            Shard(0), Shard(0), Shard(1))
        assert tsh.to_placements((None,), dmesh) == (Replicate(),) * 3
        with pytest.raises(ValueError, match="order"):
            tsh.to_placements((("data", "pod"),), dmesh)


def _jdevice_bytes(tree, jmesh, kind, float_as=None):
    sizes = dict(zip(jmesh.axis_names, jmesh.axis_sizes))
    total = 0
    for path, (shape, spec) in _jspecs(tree, jmesh, kind).items():
        leaf = dict((jsh._path_str(kp), l) for kp, l in
                    jax.tree_util.tree_flatten_with_path(tree)[0])[path]
        size = leaf.dtype.itemsize
        if float_as is not None and leaf.dtype == jnp.float32:
            size = float_as
        n = int(np.prod([sizes[a] for ax in spec if ax is not None
                         for a in (ax if isinstance(ax, tuple) else (ax,))]))
        total += int(np.prod(shape)) * size // n
    return total


@pytest.mark.parametrize("arch,shape", [("stablelm-1.6b", "train_4k"),
                                        ("deepseek-v2-lite-16b", "train_4k"),
                                        ("qwen1.5-110b", "decode_32k")])
def test_dryrun_per_device_bytes_equal_reference_specs(arch, shape,
                                                       tmp_path):
    """``run_cell``'s per-device bytes on each production mesh equal the
    reference's leaves' bytes over their specs' shards: params (packed,
    float32 leaves as bf16, for a serve cell) and AdamW moments, caches,
    inputs."""
    s = jbase.SHAPES[shape]
    jcfg = dataclasses.replace(jconfigs.get_arch(arch).full,
                               use_chunked_attn=s.kind != "decode")
    key = jax.random.PRNGKey(0)
    pf = jax.eval_shape(lambda k: jt.init_params(k, jcfg), key)
    for kind in KINDS:
        jmesh = _jmesh(kind)
        rec = dryrun.run_cell(arch, shape, kind, out_dir=str(tmp_path),
                              cost=False)
        got = rec["per_device_bytes"]
        assert got["mesh"] == make_production_mesh(
            multi_pod=kind == "multi").shape
        if s.kind == "train":
            assert got["params"] == _jdevice_bytes(pf, jmesh, "param")
            assert got["adamw"] == _jdevice_bytes(
                jax.eval_shape(j_adamw_init, pf), jmesh, "param")
            assert got["caches"] == 0
        else:
            ps = jax.eval_shape(lambda p: jt.pack_params(p, jcfg), pf)
            assert got["params"] == _jdevice_bytes(ps, jmesh, "param",
                                                   float_as=2)
            cell = dryrun.build_cell(arch, shape)
            caches = jax.eval_shape(lambda: jt.init_caches(
                jcfg, s.global_batch, cell.max_len, src_len=cell.src_len))
            assert got["caches"] == sum(_jdevice_bytes(c, jmesh, "cache")
                                        for c in caches)
        sizes = dict(zip(jmesh.axis_names, jmesh.axis_sizes))
        inputs = jbase.input_specs(jcfg, s)
        want_in = 0
        for v in inputs.values():
            spec = _norm(jsh.batch_pspec(tuple(v.shape), jmesh), len(v.shape))
            n = int(np.prod([sizes[a] for ax in spec if ax is not None
                             for a in (ax if isinstance(ax, tuple)
                                       else (ax,))]))
            want_in += int(np.prod(v.shape)) * v.dtype.itemsize // n
        assert got["inputs"] == want_in
        assert got["total"] == sum(got[k] for k in ("params", "adamw",
                                                    "caches", "inputs"))
        assert got["total"] < rec["bytes"]["total"]
