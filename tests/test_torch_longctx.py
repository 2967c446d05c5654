"""The port's long-context paths on the CPU against the JAX package:
``chunked_attention`` (GQA, ragged lengths, windows, non-causal, MLA's
padded ``v``, its gradient), the int8 KV cache (``_quant_kv`` and the
sequential, per-row and rolling writes and the read), prefill and decode
with ``use_chunked_attn`` and ``kv_bits=8`` on four smoke configs, the
continuous engine on that config, the assigned shapes
(``configs/base.py``) and ``launch/dryrun.py``'s accounting against the
reference's ``jax.eval_shape`` bytes. JAX runs its XLA path.

Tolerances, each with its reason:

* ``chunked_attention`` and its gradient: ``rtol=1e-4, atol=1e-5``, as
  ``tests/test_models_consistency.py`` holds the reference's chunked
  attention against its materialized one: the two packages' float32
  matmuls and exponentials sum in other orders.
* ``_quant_kv``'s codes and scales, the int8 cache and its read: exact
  against the reference compiled alone (the same float32 operations,
  rounded half to even). Inside a whole compiled stack XLA emits the
  scale's ``max / 127 + 1e-9`` as a multiply by the reciprocal, fused
  into an FMA or not by graph, so there a scale is held within an ulp
  (``rtol=2.5e-7``) and the codes exactly.
* Logits of the smoke stacks: 1e-4 of the largest value, as
  ``tests/test_torch_lm.py`` holds the dense stack (an ulp in the softmax
  can move an 8-bit activation code). Greedy tokens: equal.
* Shapes, specs and bytes: equal.
"""

import _torch_threads  # noqa: F401  (first: caps torch's threads under xdist)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs import base as jbase
from repro.models import attention as jattn
from repro.models import transformer as jt
from repro.optim.optimizer import adamw_init as j_adamw_init

from repro_torch import configs as tconfigs
from repro_torch.configs import base as tbase
from repro_torch.launch import dryrun
from repro_torch.launch.serve import GenRequest, Server
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as tt
from repro_torch.models.transformer import params_from_numpy
from repro_torch.serving import ContinuousLMEngine

TOL = dict(rtol=1e-4, atol=1e-5)
CHUNK = 4


def _t(a):
    return params_from_numpy(a, "cpu")


def _close(got, ref, rel=1e-4):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(got.detach().float().numpy(), ref, rtol=0,
                               atol=rel * np.abs(ref).max())


def _qkv(seed, b, sq, sk, h, hkv, d, dv=None):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return f(b, sq, h, d), f(b, sk, hkv, d), f(b, sk, hkv, dv or d)


# ------------------------------------------------------- chunked attention

CASES = {
    # name: (b, s, h, hkv, d, causal, window, q_chunk, kv_chunk, skip)
    "gqa": (2, 16, 4, 2, 8, True, None, 4, 4, True),
    "ragged": (2, 13, 4, 4, 8, True, None, 4, 8, True),
    "ragged_kv_wider": (1, 11, 6, 3, 8, True, None, 8, 4, True),
    "window": (2, 19, 4, 2, 8, True, 5, 4, 4, True),
    "window_wide_chunks": (1, 21, 2, 1, 8, True, 7, 8, 8, True),
    "non_causal": (2, 13, 4, 2, 8, False, None, 4, 4, True),
    "no_skip": (1, 10, 4, 2, 8, True, 3, 4, 4, False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_chunked_attention_equals_reference(case):
    b, s, h, hkv, d, causal, window, qc, kc, skip = CASES[case]
    q, k, v = _qkv(1, b, s, s, h, hkv, d)
    kw = dict(causal=causal, window=window, q_chunk=qc, kv_chunk=kc,
              skip_masked_blocks=skip)
    ref = jattn.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), **kw)
    got = tattn.chunked_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    # and the port's own materialized attention
    full = tattn._sdpa_full(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), causal=causal, q_offset=0,
                            window=window)
    np.testing.assert_allclose(got.numpy(), full.numpy(), **TOL)


def test_chunked_attention_mla_padded_v_equals_reference():
    """MLA's prefill: q/k of width dn + dr = 12, v of width 8 padded to 12
    for the shared blocks, the output cut back to 8."""
    q, k, v = _qkv(2, 2, 13, 13, 4, 4, 12, dv=8)
    vpad = np.pad(v, ((0, 0), (0, 0), (0, 0), (0, 4)))
    ref = jattn.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(vpad), causal=True,
                                  q_chunk=CHUNK, kv_chunk=CHUNK)[..., :8]
    got = tattn.chunked_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(vpad), causal=True,
                                  q_chunk=CHUNK, kv_chunk=CHUNK)[..., :8]
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("window", [None, 5])
def test_chunked_attention_grad_equals_jax_grad(window):
    q, k, v = _qkv(3, 2, 13, 13, 4, 2, 8)
    w = np.random.default_rng(4).standard_normal(q.shape).astype(np.float32)
    kw = dict(causal=True, window=window, q_chunk=CHUNK, kv_chunk=CHUNK)

    def jloss(q, k, v):
        return jnp.sum(jattn.chunked_attention(q, k, v, **kw) * w)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                            jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    loss = torch.sum(tattn.chunked_attention(tq, tk, tv, **kw)
                     * torch.from_numpy(w))
    tg = torch.autograd.grad(loss, (tq, tk, tv))
    for g, r in zip(tg, jg):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)


# ------------------------------------------------------------ int8 cache

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quant_kv_equals_reference(dtype):
    """Against the reference compiled, as its models run it (XLA turns
    the scale's division into an FMA with the reciprocal)."""
    x = np.random.default_rng(5).standard_normal((4, 64, 3, 16)) * 3
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    jq, js = jax.jit(jattn._quant_kv)(jx)
    tq, ts = tattn._quant_kv(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def _assert_cache_equal(tc, jc):
    for name in ("k_q", "v_q", "k_s", "v_s"):
        np.testing.assert_array_equal(tc[name].numpy(), np.asarray(jc[name]))
    tk, tv = tattn.read_kv_cache(tc, torch.float32)
    jk, jv = jattn.read_kv_cache(jc, jnp.float32)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("mode", ["sequential", "per_row", "rolling"])
def test_int8_cache_writes_and_read_equal_reference(mode):
    """A prefill of 5, then decode steps: at host positions, at per-row
    (B,) positions (rows at their own depths), and into a rolling
    window of 4 slots (the prefill longer than the window). The
    reference's update runs compiled, as in its models."""
    b, hkv, d, max_len = 3, 2, 8, 12
    window = 4 if mode == "rolling" else None
    rng = np.random.default_rng(6)
    kv = lambda s: [rng.standard_normal((b, s, hkv, d)).astype(np.float32)
                    for _ in range(2)]
    jupdate = jax.jit(jattn.update_kv_cache)
    jc = jattn.init_kv_cache(b, max_len, hkv, d, kv_bits=8, window=window)
    tc = tattn.init_kv_cache(b, max_len, hkv, d, kv_bits=8, window=window)
    assert set(tc) == set(jc)
    k, v = kv(5)
    jc = jupdate(jc, jnp.asarray(k), jnp.asarray(v), 0)
    tc = tattn.update_kv_cache(tc, torch.from_numpy(k), torch.from_numpy(v),
                               0)
    _assert_cache_equal(tc, jc)
    for step in range(4):
        k, v = kv(1)
        if mode == "per_row":
            pos = np.array([5 + step, 2 + step, 7], np.int32)
            jpos, tpos = jnp.asarray(pos), torch.from_numpy(pos)
        else:
            jpos = tpos = 5 + step
        jc = jupdate(jc, jnp.asarray(k), jnp.asarray(v), jpos)
        tc = tattn.update_kv_cache(tc, torch.from_numpy(k),
                                   torch.from_numpy(v), tpos)
        _assert_cache_equal(tc, jc)
        np.testing.assert_array_equal(np.asarray(tc["len"]),
                                      np.asarray(jc["len"]))


def test_int8_cache_refuses_other_widths():
    with pytest.raises(ValueError, match="kv_bits=8 only"):
        tattn.init_kv_cache(1, 4, 1, 8, kv_bits=4)


# ------------------------------------------------------- the smoke stacks

LONG = ("stablelm-1.6b", "deepseek-v2-lite-16b", "hymba-1.5b",
        "seamless-m4t-large-v2")


def _long_cfgs(arch):
    kw = dict(use_chunked_attn=True, attn_q_chunk=CHUNK, attn_kv_chunk=CHUNK,
              kv_bits=8)
    jcfg = dataclasses.replace(jconfigs.get_arch(arch).smoke, **kw)
    tcfg = dataclasses.replace(tconfigs.get_arch(arch).smoke, **kw)
    return jt.serve_policy(jcfg, pack_acts=True), tt.serve_policy(
        tcfg, pack_acts=True)


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy(v) for v in tree]
    return tree.numpy()


def _packed(jcfg, tcfg):
    """Float params drawn by the port (its tree is the reference's), packed
    by the reference under ``jit``: numpy, for both sides."""
    params = _numpy(tt.init_params(torch.Generator().manual_seed(0), tcfg))
    return jax.tree.map(np.asarray, jax.jit(
        lambda p: jt.pack_params(p, jcfg))(jax.tree.map(jnp.asarray, params)))


@pytest.mark.parametrize("arch", LONG)
def test_chunked_int8_prefill_and_decode_equal_reference(arch):
    """A prefill of 11 tokens (3 chunks of 4, the last ragged) into an
    int8 cache (hymba: windows of 8, rolling and int8 too; deepseek: MLA's
    latent cache, which ``kv_bits`` leaves alone; seamless: over a source
    of 9 frames), then two decode steps: greedy tokens equal, logits
    within 1e-4 of the largest, the first group's int8 codes exact and
    its scales within an ulp."""
    jcfg, tcfg = _long_cfgs(arch)
    packed = _packed(jcfg, tcfg)
    rng = np.random.default_rng(7)
    toks = rng.integers(0, jcfg.vocab_size, (2, 11)).astype(np.int32)
    jb, tb = {"tokens": jnp.asarray(toks)}, {
        "tokens": torch.from_numpy(toks).long()}
    if jcfg.family in ("encdec", "audio"):
        src = rng.standard_normal(
            (2, 9, jcfg.frontend_dim or jcfg.d_model)).astype(np.float32)
        jb["src_embeds"] = jnp.asarray(src)
        tb["src_embeds"] = torch.from_numpy(src)
    jlog, jc = jax.jit(lambda p, b: jt.prefill(p, b, jcfg, max_len=16))(
        packed, jb)
    tp = _t(packed)
    tlog, tc = tt.prefill(tp, tb, tcfg, max_len=16)
    _close(tlog, jlog)
    jdecode = jax.jit(lambda p, c, t, pos: jt.decode_step(p, c, t, pos,
                                                          jcfg))
    for pos in (11, 12):
        nxt = np.array(jnp.argmax(jlog, -1))[:, None]
        assert np.array_equal(torch.argmax(tlog, -1).numpy()[:, None], nxt)
        jlog, jc = jdecode(packed, jc, jnp.asarray(nxt), jnp.int32(pos))
        tlog, tc = tt.decode_step(tp, tc, torch.from_numpy(nxt).long(), pos,
                                  tcfg)
        _close(tlog, jlog)
    if not jcfg.mla:
        tg, jg = tc[0], jc[0]
        tg = tg.get("attn", tg.get("self", tg))
        jg = jg.get("attn", jg.get("self", jg))
        for name in ("k_q", "v_q"):
            np.testing.assert_array_equal(tg[name].numpy(),
                                          np.asarray(jg[name]))
        for name in ("k_s", "v_s"):     # an ulp: see the module docstring
            np.testing.assert_allclose(tg[name].numpy(), np.asarray(jg[name]),
                                       rtol=2.5e-7, atol=0)


def _mixed_requests(cls):
    rng = np.random.RandomState(11)
    reqs = []
    for _ in range(8):
        n = int(rng.randint(1, 13))
        m = int(rng.randint(1, 17 - n))
        reqs.append(cls(rng.randint(0, 64, (n,)).astype(np.int32), m))
    return reqs


def test_engine_int8_chunked_equals_static_server():
    """The slot arena on an int8 cache, its bucketed right-padded prefills
    chunked (exact under the causal mask): every request's tokens equal a
    1-slot static ``Server``'s on the same config (which the test above
    holds to the reference)."""
    jcfg, tcfg = _long_cfgs("stablelm-1.6b")
    packed = _t(_packed(jcfg, tcfg))
    eng = ContinuousLMEngine(tcfg, packed, batch_slots=2, max_len=16,
                             device="cpu")
    out = eng.serve(_mixed_requests(GenRequest))
    solo = Server(tcfg, packed, batch_slots=1, max_len=16, device="cpu")
    for r in out:
        one = solo.generate([GenRequest(r.prompt.copy(),
                                        r.max_new_tokens)])[0]
        assert r.out_tokens == one.out_tokens, (len(r.prompt),
                                                r.max_new_tokens)
    arena = eng._arena["caches"][0]
    assert arena["k_q"].dtype == torch.int8 and "k" not in arena


# ------------------------------------------------------- shapes and specs

def test_shapes_equal_reference():
    assert tbase.SHAPES.keys() == jbase.SHAPES.keys()
    for name, s in jbase.SHAPES.items():
        assert dataclasses.asdict(tbase.SHAPES[name]) == dataclasses.asdict(s)
    assert tbase.STANDARD_SHAPES == jbase.STANDARD_SHAPES
    assert tbase.ALL_SHAPES == jbase.ALL_SHAPES
    assert tbase.FULL_ATTN_SKIP == jbase.FULL_ATTN_SKIP


@pytest.mark.parametrize("arch", sorted(tconfigs.list_archs()))
def test_arch_shapes_skip_notes_and_input_specs_equal_reference(arch):
    te, je = tconfigs.get_arch(arch), jconfigs.get_arch(arch)
    assert te.shapes == je.shapes
    assert te.skip_notes == je.skip_notes
    for name in jbase.ALL_SHAPES:
        got = tbase.input_specs(te.full, tbase.SHAPES[name])
        ref = jbase.input_specs(je.full, jbase.SHAPES[name])
        assert got.keys() == ref.keys()
        for k, spec in ref.items():
            assert tuple(got[k].shape) == tuple(spec.shape), (name, k)
            assert str(got[k].dtype).split(".")[-1] == str(spec.dtype)
            assert got[k].device.type == "meta"


def test_long_500k_applicability():
    """long_500k runs only for the sub-quadratic architectures."""
    for arch in tconfigs.list_archs():
        e = tconfigs.get_arch(arch)
        if arch in ("mamba2-780m", "hymba-1.5b"):
            assert "long_500k" in e.shapes
        else:
            assert "long_500k" not in e.shapes
            assert "long_500k" in e.skip_notes


# ------------------------------------------------------------ dry run

def _jbytes(tree, float_as=None):
    """Bytes of the reference's abstract tree, its caches' ``len`` and
    ``rolling`` scalars left out (the port keeps them on the host)."""
    total = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        if getattr(path[-1], "key", None) in ("len", "rolling"):
            continue
        size = leaf.dtype.itemsize
        if float_as is not None and leaf.dtype == jnp.float32:
            size = float_as
        total += int(np.prod(leaf.shape)) * size
    return total


@pytest.mark.parametrize("arch", sorted(tconfigs.list_archs()))
def test_dryrun_accounting_equals_reference_eval_shape(arch, tmp_path):
    """Every cell's parameter, AdamW, cache and input bytes equal the
    reference's ``jax.eval_shape`` of its ``init_params`` (and
    ``pack_params``, float32 leaves as bf16, for a serve cell),
    ``adamw_init`` and ``init_caches`` at the cell's cache length, with
    the reference's config replacements (``kv_bits=8`` on the decode
    cells, both caches alike)."""
    key = jax.random.PRNGKey(0)
    for shape in jconfigs.get_arch(arch).shapes:
        kv = 8 if jbase.SHAPES[shape].kind == "decode" else None
        rec = dryrun.run_cell(arch, shape, kv_bits=kv, out_dir=str(tmp_path),
                              cost=False)
        cell = dryrun.build_cell(arch, shape, kv_bits=kv)
        s = jbase.SHAPES[shape]
        jcfg = dataclasses.replace(
            jconfigs.get_arch(arch).full,
            use_chunked_attn=s.kind != "decode", kv_bits=kv)
        assert (cell.cfg.use_chunked_attn, cell.cfg.kv_bits) == (
            jcfg.use_chunked_attn, jcfg.kv_bits)
        pf = jax.eval_shape(lambda k: jt.init_params(k, jcfg), key)
        by = rec["bytes"]
        if s.kind == "train":
            assert by["params"] == _jbytes(pf)
            assert by["adamw"] == _jbytes(jax.eval_shape(j_adamw_init, pf))
            assert by["caches"] == 0
        else:
            ps = jax.eval_shape(lambda p: jt.pack_params(p, jcfg), pf)
            assert by["params"] == _jbytes(ps, float_as=2)
            caches = jax.eval_shape(lambda: jt.init_caches(
                jcfg, s.global_batch, cell.max_len, src_len=cell.src_len))
            assert by["caches"] == _jbytes(caches), shape
        assert by["inputs"] == _jbytes(jbase.input_specs(jcfg, s))
        assert rec["ok"] and rec["fits"] is None


def test_dryrun_refuses_a_mesh_and_takes_dots_remat(tmp_path):
    """One card runs: running the 512-device ``multi`` mesh raises instead
    of running something else (it accounts only: its per-device bytes
    are a 512th of a fully split leaf's at most); the reference's ``dots``
    remat policy is taken into the cell's config and record, and an
    unknown policy raises."""
    with pytest.raises(ValueError, match="512 devices"):
        dryrun.run_cell("stablelm-1.6b", "train_4k", "multi", run=True,
                        out_dir=str(tmp_path))
    multi = dryrun.run_cell("stablelm-1.6b", "train_4k", "multi",
                            out_dir=str(tmp_path), cost=False)
    assert multi["ok"] and multi["per_device_bytes"]["mesh"] == {
        "pod": 2, "data": 16, "model": 16}
    assert (multi["bytes"]["total"] // 512
            <= multi["per_device_bytes"]["total"] < multi["bytes"]["total"])
    rec = dryrun.run_cell("stablelm-1.6b", "train_4k", remat_policy="dots",
                          out_dir=str(tmp_path), cost=False)
    assert rec["ok"] and rec["remat_policy"] == "dots"
    assert (tmp_path / "stablelm-1.6b__train_4k__single__r7__dots.json"
            ).exists()
    cell = dryrun.build_cell("stablelm-1.6b", "train_4k", remat_policy="dots")
    assert cell.cfg.remat_policy == "dots"
    assert (dryrun._act_bytes_per_row(cell) > dryrun._act_bytes_per_row(
        dryrun.build_cell("stablelm-1.6b", "train_4k")))
    with pytest.raises(ValueError, match="'nothing' or 'dots'"):
        dryrun.build_cell("stablelm-1.6b", "train_4k", remat_policy="full")
    with pytest.raises(SystemExit):
        dryrun.main(["--arch", "stablelm-1.6b", "--shape", "train_4k",
                     "--mesh", "multi", "--out", str(tmp_path)])


def test_dryrun_cut_depth_keeps_the_layer_kinds():
    """``n_layers`` (the plain versions' depth on the card) keeps hymba's
    first global layer and deepseek's dense layer."""
    hy = dryrun.build_cell("hymba-1.5b", "long_500k", n_layers=2).cfg
    assert [(g.n, g.window) for g in tt.layer_groups(hy)] == [(1, None),
                                                             (1, 1024)]
    ds = dryrun.build_cell("deepseek-v2-lite-16b", "prefill_32k",
                           n_layers=2).cfg
    assert [(g.n, g.use_moe) for g in tt.layer_groups(ds)] == [(1, False),
                                                              (1, True)]
