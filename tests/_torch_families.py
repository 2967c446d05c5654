"""Shared by ``tests/test_torch_families.py`` and
``tests/test_torch_encdec.py``: the reference's six remaining
architectures on the port, on the CPU against the JAX package.

Each runs at its smoke config with the reference's random parameters
carried across by ``params_from_numpy``, every bias set to seeded nonzero
values first (the reference draws them as zeros, which would hide a bias
that is dropped or misplaced); the reference runs its plain path
(``backend="xla"``), the port its kernels' plain versions. Inputs are made
by numpy from a seed.

Tolerances, each with its reason:

* Layer groups, parameter trees (paths, shapes, dtypes), packed words,
  the integer stage of a down projection on activations carried from the
  reference, greedy tokens, registry and admission answers: exact.
* Logits, losses and caches (float32): 1e-4 of the largest value, as
  ``tests/test_torch_lm.py`` states it for the dense stack: float32 ulps
  of the softmax, norms and products can move an 8-bit activation code
  across a rounding boundary. GELU adds its own: torch's and XLA's tanh
  approximations differ by a float32 ulp or two in about a third of the
  elements, which can move a code of the down projection's input too.
* Losses: 1e-5 relative (float32 sums in another order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_arch as j_get_arch
from repro.launch.serve import GenRequest as JRequest
from repro.launch.serve import Server as JServer
from repro.models import layers as jl
from repro.models import transformer as jt

from repro_torch.configs import get_arch
from repro_torch.launch.serve import GenRequest, Server
from repro_torch.models import layers as tl
from repro_torch.models import transformer as tt
from repro_torch.models.transformer import params_from_numpy

SLOTS, MAX_LEN = 4, 32


def t_(a):
    return params_from_numpy(a, "cpu")


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def np_(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def close(got, ref, rel=1e-4):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(np_(got), ref, rtol=0,
                               atol=rel * np.abs(ref).max())


def nonzero_biases(tree, rng):
    """Every ``b`` leaf replaced by seeded values of its shape (0.1 std)."""
    if isinstance(tree, dict):
        return {k: (rng.standard_normal(np.shape(v)).astype(np.float32) * 0.1
                    if k == "b" else nonzero_biases(v, rng))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [nonzero_biases(v, rng) for v in tree]
    return tree


MODELS = {}


def model(arch):
    """The smoke config (both sides), the reference's float params with
    nonzero biases and their packed form (numpy), made once per arch."""
    if arch not in MODELS:
        jcfg = j_get_arch(arch).smoke
        params = np_tree(jt.init_params(jax.random.PRNGKey(0), jcfg))
        params = nonzero_biases(params, np.random.default_rng(1))
        packed = np_tree(jt.pack_params(jax.tree.map(jnp.asarray, params),
                                         jcfg))
        MODELS[arch] = (jcfg, get_arch(arch).smoke, params, packed)
    return MODELS[arch]


def inputs(cfg, b=3, s=7, seed=6):
    """Tokens (B, S) and, by family, the frontend's (B, frontend_len,
    frontend_dim) or the source's (B, 5, frontend_dim) embeddings."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(
        np.int32)}
    if cfg.family == "vlm":
        batch["frontend_embeds"] = rng.standard_normal(
            (b, cfg.frontend_len, cfg.frontend_dim)).astype(np.float32)
    if cfg.family in ("encdec", "audio"):
        batch["src_embeds"] = rng.standard_normal(
            (b, 5, cfg.frontend_dim)).astype(np.float32)
    return batch


def jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def tbatch(batch):
    return {k: (torch.from_numpy(v).long() if v.dtype == np.int32
                else torch.from_numpy(v)) for k, v in batch.items()}


def leaves(tree, path=()):
    """(path, shape, dtype) of every tensor leaf, in jax's flatten order
    (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in leaves(v, path + (i,))]
    return [(path, tuple(tree.shape), tree.dtype)]


def check_layer_groups_and_param_trees(arch):
    """The decoder's groups (cross-attending for the encoder-decoder), the
    encoder's, and the float and packed parameter trees: the same leaves,
    shapes and dtypes in the same order."""
    jcfg, tcfg, params, packed = model(arch)
    keys = ("kind", "n", "use_moe", "window", "causal", "cross")
    assert [tuple(getattr(g, k) for k in keys)
            for g in tt.layer_groups(tcfg)] == \
        [tuple(getattr(g, k) for k in keys) for g in jt.layer_groups(jcfg)]
    # the reference builds its encoder's group inline in init_params
    enc = jt.GroupSpec("attn", jcfg.n_enc_layers or jcfg.n_layers,
                       causal=False)
    assert [tuple(getattr(g, k) for k in keys)
            for g in tt.encoder_groups(tcfg)] == \
        [tuple(getattr(enc, k) for k in keys)]
    own = tt.init_params(torch.Generator().manual_seed(0), tcfg)
    assert leaves(own) == leaves(t_(params))
    assert leaves(tt.pack_params(own, tcfg)) == leaves(t_(packed))
    # drawn and packed a layer at a time: the same tree as packed after
    again = tt.init_params(torch.Generator().manual_seed(0), tcfg,
                           packed=True)
    assert leaves(again) == leaves(t_(packed))
    if tcfg.family == "audio":
        assert "w_packed" in again["enc"]["groups"][0]["mlp"]["w_up"]
    if tcfg.frontend is not None:
        assert set(again["frontend_proj"]) == {"w"}      # float, mode none


def check_mlp_down_projection(act, pack_acts):
    """The activation (float32) is computed by the reference and carried
    across: the port's integer stage (K1 + K3, or K4, plain) on it equals
    the reference's bit for bit; the port's own activation agrees to
    float32 rounding (GELU: a few ulps, the tanh approximation in two
    libraries; relu2: exact)."""
    arch = "nemotron-4-15b" if act == "relu2" else "seamless-m4t-large-v2"
    jcfg, tcfg, _, packed = model(arch)
    pol_j = dataclasses.replace(jcfg.policy, pack_acts=pack_acts)
    pol_t = dataclasses.replace(tcfg.policy, pack_acts=pack_acts)
    mlp = jax.tree.map(lambda a: a[0], packed["groups"][0]["mlp"])
    x = np.random.default_rng(3).standard_normal(
        (2, 5, jcfg.d_model)).astype(np.float32)
    up = np.asarray(jl.qdense(mlp["w_up"], jnp.asarray(x), pol_j))
    tup = tl.qdense(t_(mlp["w_up"]), torch.from_numpy(x), pol_t)
    np.testing.assert_array_equal(tup.numpy(), up)
    if act == "relu2":
        h = np.array(jnp.square(jnp.maximum(jnp.asarray(up), 0)))
        th = torch.clamp_min(tup, 0) ** 2
        np.testing.assert_array_equal(th.numpy(), h)
    else:
        h = np.array(jax.nn.gelu(jnp.asarray(up)))
        th = torch.nn.functional.gelu(tup, approximate="tanh")
        np.testing.assert_allclose(th.numpy(), h, rtol=4e-7, atol=1e-6)
    ref = np.asarray(jl.qdense(mlp["w_down"], jnp.asarray(h), pol_j))
    got = tl.qdense(t_(mlp["w_down"]), torch.from_numpy(h), pol_t)
    np.testing.assert_array_equal(got.numpy(), ref)
    # and the port's whole MLP on its own activation, within rounding
    close(tt._mlp_apply(t_(mlp), torch.from_numpy(x),
                         dataclasses.replace(tcfg, policy=pol_t)),
           jt._mlp_apply(mlp, jnp.asarray(x),
                         dataclasses.replace(jcfg, policy=pol_j)))



def check_forward_and_loss(arch):
    """The fake-quant forward on the float params and the integer forward
    on the packed ones: logits and ``loss_fn`` (the VLM's logits cut to
    the labels past its frontend tokens; MoE ``lb_loss`` included)."""
    jcfg, tcfg, params, packed = model(arch)
    batch = inputs(tcfg)
    batch["labels"] = np.roll(batch["tokens"], -1, axis=1)
    batch["labels"][:, -1] = -1
    jb, tb = jbatch(batch), tbatch(batch)
    for tree in (params, packed):
        jlog, jaux = jt.forward(jax.tree.map(jnp.asarray, tree), jb, jcfg)
        with torch.no_grad():
            tlog, taux = tt.forward(t_(tree), tb, tcfg)
            tloss, tmet = tt.loss_fn(t_(tree), tb, tcfg)
        front = tcfg.frontend_len if tcfg.family == "vlm" else 0
        assert tuple(tlog.shape) == (3, 7 + front, tcfg.vocab_size)
        close(tlog, jlog)
        jloss, jmet = jt.loss_fn(jax.tree.map(jnp.asarray, tree), jb, jcfg)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
        np.testing.assert_allclose(float(tmet["ce"]), float(jmet["ce"]),
                                   rtol=1e-5)
        if tcfg.n_experts:
            np.testing.assert_allclose(float(taux["lb_loss"]),
                                       float(jaux["lb_loss"]), rtol=1e-5)



def check_prefill_and_decode(arch, pack_acts):
    """``prefill`` and three ``decode_step``s on the packed params, K1 +
    K3 or K4 (plain): logits at every step, the greedy tokens, the caches'
    lengths, and for the encoder-decoder the cross K/V the prefill put in
    the cache."""
    jcfg, tcfg, _, packed = model(arch)
    jcfg = jt.serve_policy(jcfg, backend="xla", pack_acts=pack_acts)
    tcfg = tt.serve_policy(tcfg, pack_acts=pack_acts)
    batch = inputs(tcfg)
    jp, tp = jax.tree.map(jnp.asarray, packed), t_(packed)
    max_len = 24
    jlog, jc = jt.prefill(jp, jbatch(batch), jcfg, max_len=max_len)
    with torch.no_grad():
        tlog, tc = tt.prefill(tp, tbatch(batch), tcfg, max_len=max_len)
    close(tlog, jlog)
    if tcfg.family == "audio":
        close(tc[0]["cross_k"], jc[0]["cross_k"])
        close(tc[0]["cross_v"], jc[0]["cross_v"])
        assert tuple(tc[0]["cross_k"].shape) == (
            tcfg.n_layers, 3, 5, tcfg.n_kv_heads, tcfg.head_dim)
    pos = batch["tokens"].shape[1] + (tcfg.frontend_len
                                      if tcfg.family == "vlm" else 0)
    for step in range(3):
        nxt = np.asarray(jnp.argmax(jlog, -1))[:, None]
        assert np.array_equal(torch.argmax(tlog, -1).numpy()[:, None], nxt)
        jlog, jc = jt.decode_step(jp, jc, jnp.asarray(nxt),
                                  jnp.int32(pos + step), jcfg)
        with torch.no_grad():
            tlog, tc = tt.decode_step(tp, tc, torch.from_numpy(nxt).long(),
                                      pos + step, tcfg)
        close(tlog, jlog)
    self_len = tc[0]["self"]["len"] if tcfg.family == "audio" else \
        tc[0]["len"]
    assert self_len == pos + 3



JAX_TOKENS = {}


def prompts(vocab):
    return [np.arange(n, dtype=np.int32) * 7 % vocab for n in (3, 6, 9)]


def jax_tokens(arch):
    """The JAX ``Server``'s greedy tokens (3 prompts, 6 new), once per
    arch."""
    if arch not in JAX_TOKENS:
        jcfg, _, _, packed = model(arch)
        js = JServer(jcfg, jax.tree.map(jnp.asarray, packed),
                     batch_slots=SLOTS, max_len=MAX_LEN, backend="xla")
        JAX_TOKENS[arch] = [r.out_tokens for r in js.generate(
            [JRequest(p.copy(), 6) for p in prompts(jcfg.vocab_size)])]
    return JAX_TOKENS[arch]


def check_server_generate(arch, pack_acts):
    """Greedy tokens of ``Server.generate`` (the VLM text-only, as the
    reference's ``generate`` feeds tokens alone) through K1 + K3 and K4."""
    _, tcfg, _, packed = model(arch)
    srv = Server(tcfg, t_(packed), batch_slots=SLOTS, max_len=MAX_LEN,
                 pack_acts=pack_acts, device="cpu")
    got = [r.out_tokens for r in srv.generate(
        [GenRequest(p.copy(), 6) for p in prompts(tcfg.vocab_size)])]
    assert got == jax_tokens(arch)
