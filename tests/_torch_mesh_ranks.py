"""The rank side of ``tests/test_torch_mesh.py``: functions that
``repro_torch.launch.mesh.run_ranks`` starts in spawned gloo ranks. This
module imports torch and the port only (no jax), so a rank starts fast;
the test module computes every reference and unsharded result and hands
the ranks numpy inputs. Besides training on the (2, 2) mesh, the ranks
serve packed models sharded (``Server(mesh=)``) on (2, 2), on two (1, 2)
meshes (the ranks split in pairs) and on one (1, 4) mesh; the MoE
family (deepseek-v2-lite with MLA, qwen3-moe with GQA) on the same three
meshes, its experts split over ``model``; and the SSM, hybrid and
encoder-decoder families (mamba2, hymba, seamless) on the same three.
The continuous engine (``ContinuousLMEngine(mesh=)``) serves the engine
tests' mixed requests on the same meshes (:data:`ENGINE_CASES`), and
per-row ``decode_step`` runs on each placement of the caches
(:data:`PER_ROW_CASES`)."""

import contextlib

import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.core.tree import tree_flatten, tree_leaves, tree_unflatten
from repro_torch.distributed import placed
from repro_torch.distributed.compression import (compress_tree,
                                                 compressed_allreduce_mean)
from repro_torch.distributed.context import bind_axes, constrain
from repro_torch.distributed.sharding import (batch_pspec, distribute_tree,
                                              to_placements, tree_shardings)
from repro_torch.launch.hlo_analysis import analyze
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.launch.serve import GenRequest, Server
from repro_torch.launch.train import (Trainer, init_placed_params,
                                      make_train_step)
from repro_torch.models import transformer as tt
from repro_torch.serving import ContinuousLMEngine
from repro_torch.optim import AdamWConfig
from repro_torch.optim.optimizer import reduce_gradients
from repro_torch.runtime.checkpoint import CheckpointManager

#: the mesh tests' Trainer runs: 3 steps of the smoke config
TRAIN = dict(batch_size=4, seq_len=16, seed=0)
OPT = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=3)
#: the sharded servers: the smoke configs served on each mesh, the
#: prompts' lengths, new tokens and the KV budget (positions 0..13 of 16:
#: on the (1, 4) mesh a position-split cache's 4 slots a rank all hold
#: some)
SERVE_ARCHS = ("stablelm-1.6b", "qwen1.5-110b", "nemotron-4-15b")
#: the MoE family's smoke configs served on every mesh: deepseek's MLA
#: latent cache (its dim split over ``model``), qwen3-moe's 2 kv heads (on
#: (1, 4) its cache's positions split); 4 and 8 experts split over
#: ``model``
MOE_ARCHS = ("deepseek-v2-lite-16b", "qwen3-moe-235b-a22b")
#: the SSM, hybrid and encoder-decoder smoke configs served on every mesh:
#: mamba2's state split by its 8 heads, hymba's 8-slot windows (2 kv heads:
#: on (1, 4) the slots split, 2 a rank, and positions up to 13 cross ranks)
#: and seamless on a seeded source, its cross K/V whole over ``model``
FAMILY_ARCHS = ("mamba2-780m", "hymba-1.5b", "seamless-m4t-large-v2")
SERVE_PROMPTS = (5, 9, 3, 7)
SERVE_NEW, SERVE_MAX_LEN = 5, 16
#: the encoder-decoder's source frames per request
SRC_LEN = 6


#: the continuous engine on a mesh: (arch, mesh tag, pack_acts, kv_bits),
#: each served on :func:`engine_requests` with 4 slots and a KV budget of
#: 16: stablelm's 4 kv heads split (K1 + K3 on (1, 2), K4 on (2, 2)),
#: qwen1.5's 2 on 4 ranks splitting the positions (bf16 and int8 caches),
#: deepseek's MLA latent and its experts (on (2, 2) dispatching one group
#: a data rank)
ENGINE_CASES = (("stablelm-1.6b", "1x2", True, None),
                ("stablelm-1.6b", "2x2", False, None),
                ("qwen1.5-110b", "1x4", True, None),
                ("qwen1.5-110b", "1x4", True, 8),
                ("deepseek-v2-lite-16b", "1x2", True, None),
                ("deepseek-v2-lite-16b", "2x2", True, None))
ENGINE_SLOTS, ENGINE_MAX_LEN = 4, 16
#: per-row ``decode_step`` on a placed cache, one case per branch of
#: ``attention._attend_placed`` and MLA's: (name, arch, mesh tag, max_len,
#: kv_bits). qwen1.5's 2 kv heads on 4 ranks: 16 positions split, 4 a
#: rank; 14 do not divide, so the cache is whole on every rank. hymba's
#: sliding windows (rolling buffers) refuse per-row positions.
PER_ROW_CASES = (("heads", "stablelm-1.6b", "1x2", SERVE_MAX_LEN, None),
                 ("whole", "qwen1.5-110b", "1x4", 14, None),
                 ("positions", "qwen1.5-110b", "1x4", SERVE_MAX_LEN, None),
                 ("positions int8", "qwen1.5-110b", "1x4", SERVE_MAX_LEN, 8),
                 ("mla", "deepseek-v2-lite-16b", "1x2", SERVE_MAX_LEN, None),
                 ("rolling", "hymba-1.5b", "1x4", SERVE_MAX_LEN, None))
#: the rows' positions at the first per-row step (the prompts fill 0..8):
#: rows at different depths, two of them rewriting prompt positions
PER_ROW_POS = (9, 4, 2, 7)


def engine_requests():
    """The first 6 of ``tests/test_torch_engine.py``'s 12 mixed requests
    (``_mixed_requests``: RandomState(11), prompts of 1-12 tokens over 64
    ids, budgets up to the KV budget of 16)."""
    rng = np.random.RandomState(11)
    reqs = []
    for _ in range(12):
        n = int(rng.randint(1, 13))
        m = int(rng.randint(1, 17 - n))
        reqs.append(GenRequest(rng.randint(0, 64, (n,)).astype(np.int32), m))
    return reqs[:6]


def engine(cfg, params, mesh, pack_acts, n_groups=1):
    """``ContinuousLMEngine`` (``mesh`` None: unsharded, its MoE
    dispatching in ``n_groups`` groups, as a data axis of that size makes
    a placed one) warmed up, then serving :func:`engine_requests`: the
    tokens, the logits (whole, on the host) of one more arena step after
    the load, the drop fractions, the compiles after warmup and the
    stats' mesh."""
    eng = ContinuousLMEngine(cfg, params, batch_slots=ENGINE_SLOTS,
                             max_len=ENGINE_MAX_LEN, pack_acts=pack_acts,
                             device="cpu", mesh=mesh)
    groups = (bind_axes(dp="data", mesh={"data": n_groups}) if mesh is None
              else contextlib.nullcontext())
    with groups:
        eng.warmup()
        toks = [r.out_tokens for r in eng.serve(engine_requests())]
        with eng._context():
            a = eng._arena
            logits, _ = tt.decode_step(eng.params, a["caches"], a["tok"],
                                       a["pos"], eng.cfg)
            logits = _np(placed.plain(logits))
    st = eng.stats()
    return {"tokens": toks, "logits": logits,
            "drops": eng.drop_fractions(),
            "recompiles": st["recompiles_after_warmup"], "mesh": st["mesh"],
            "graph": st["cuda_graph"]}


def engine_config(arch, kv_bits):
    cfg = get_arch(arch).smoke
    return cfg if kv_bits is None else dataclasses.replace(cfg,
                                                           kv_bits=kv_bits)


def _engines_on(inputs, mesh, out, tag):
    """:func:`engine` of every :data:`ENGINE_CASES` case on ``tag``'s
    mesh, on the reference's packed planes: ``out["engine"][case]``."""
    res = out.setdefault("engine", {})
    for case in ENGINE_CASES:
        arch, t, pa, kv = case
        if t == tag:
            res[case] = engine(engine_config(arch, kv), tt.params_from_numpy(
                inputs["serve"][arch]), mesh, pa)


def per_row_steps(cfg, params, mesh, max_len):
    """``Server``'s prefill of :func:`padded_prompts` (``mesh`` None:
    unsharded), then 3 ``decode_step``s with per-row positions
    :data:`PER_ROW_POS` (+ the step), a plain (B,) tensor: each step's
    logits, whole, on the host; or the message of what it raised."""
    srv = Server(cfg, params, batch_slots=4, max_len=max_len, device="cpu",
                 mesh=mesh)
    toks = padded_prompts(cfg.vocab_size)
    out = []
    with srv._context():
        logits, caches = tt.prefill(srv.params, {"tokens": srv._place_batch(
            torch.from_numpy(toks))}, cfg, max_len=max_len)
        pos = torch.tensor(PER_ROW_POS, dtype=torch.int32)
        for t in range(3):
            tok = torch.argmax(logits, -1)[:, None]
            try:
                logits, caches = tt.decode_step(srv.params, caches, tok,
                                                pos + t, cfg)
            except (ValueError, NotImplementedError) as e:
                return f"{type(e).__name__}: {e}"
            out.append(_np(placed.plain(logits)))
    return out


def _per_row_on(inputs, mesh, out, tag):
    res = out.setdefault("per_row", {})
    for name, arch, t, max_len, kv in PER_ROW_CASES:
        if t == tag:
            res[name] = per_row_steps(engine_config(arch, kv),
                                      tt.params_from_numpy(
                                          inputs["serve"][arch]),
                                      mesh, max_len)


def serve_requests(vocab):
    rng = np.random.RandomState(0)
    return [GenRequest(rng.randint(0, vocab, (n,)).astype(np.int32),
                       SERVE_NEW) for n in SERVE_PROMPTS]


def source(cfg):
    """Seeded (4, ``SRC_LEN``, frontend_dim) ``src_embeds`` for an
    encoder-decoder's requests."""
    rng = np.random.default_rng(7)
    return rng.standard_normal((len(SERVE_PROMPTS), SRC_LEN,
                                cfg.frontend_dim)).astype(np.float32)


def padded_prompts(vocab):
    """:func:`serve_requests`' prompts left-padded with 0, as
    ``Server.generate`` pads them: (4, longest) int64."""
    reqs = serve_requests(vocab)
    toks = np.zeros((len(reqs), max(len(r.prompt) for r in reqs)), np.int64)
    for i, r in enumerate(reqs):
        toks[i, -len(r.prompt):] = r.prompt
    return toks


def int8_cache(cfg):
    """``cfg`` with the int8 KV cache (codes and per-position scales)."""
    return dataclasses.replace(cfg, kv_bits=8)


def serve(cfg, params, mesh, pack_acts, n_groups=1):
    """``Server`` (``mesh`` None: unsharded) on :func:`serve_requests`:
    the tokens and the last step's logits (whole, on the host). An
    unsharded MoE dispatches in ``n_groups`` groups (what a data axis of
    that size makes a placed one do). An encoder-decoder, whose source
    ``generate`` does not feed, is served by :func:`drive` on
    :func:`source`."""
    srv = Server(cfg, params, batch_slots=4, max_len=SERVE_MAX_LEN,
                 pack_acts=pack_acts, device="cpu", mesh=mesh)
    if cfg.family in ("encdec", "audio"):
        return drive(srv, source(cfg))[:2]
    with bind_axes(dp="data", mesh={"data": n_groups}):
        res = srv.generate(serve_requests(cfg.vocab_size))
    return [r.out_tokens for r in res], _np(srv.last_logits)


def drive(srv, src=None):
    """What ``Server.generate`` does, on :func:`padded_prompts` and, for
    an encoder-decoder, the source ``src`` (``src_embeds``, numpy):
    ``prefill``, then greedy ``decode_step``s, inside the server's step
    context. Returns the tokens, the last step's logits (whole, on the
    host) and the caches."""
    cfg = srv.cfg
    toks = padded_prompts(cfg.vocab_size)
    with srv._context():
        batch = {"tokens": srv._place_batch(torch.from_numpy(toks))}
        if src is not None:
            batch["src_embeds"] = srv._place_batch(torch.from_numpy(src))
        logits, caches = tt.prefill(srv.params, batch, cfg,
                                    max_len=SERVE_MAX_LEN)
        tok = torch.argmax(logits, -1)[:, None]
        cols = [tok]
        for t in range(1, SERVE_NEW):
            logits, caches = tt.decode_step(srv.params, caches, tok,
                                            toks.shape[1] + t - 1, cfg)
            tok = torch.argmax(logits, -1)[:, None]
            cols.append(tok)
        out = placed.plain(torch.cat(cols, dim=1)).tolist()
        return out, _np(placed.plain(logits)), caches


def window_slots(params_np, mesh):
    """hymba-smoke's sliding-window layers' rolling K and V (8 slots)
    after :func:`drive` served the requests (K1 + K3) on ``mesh`` (None:
    unsharded), gathered whole: numpy ``(k, v)``."""
    srv = Server(get_arch("hymba-1.5b").smoke, tt.params_from_numpy(
        params_np), batch_slots=4, max_len=SERVE_MAX_LEN, device="cpu",
        mesh=mesh)
    window = [i for i, g in enumerate(tt.layer_groups(srv.cfg))
              if g.window is not None][0]
    cache = drive(srv)[2][window]["attn"]
    return tuple(_np(placed.plain(cache[n])) for n in ("k", "v"))


def chunked(cfg):
    """``cfg`` with the chunked attention, 8 x 8 blocks (2 x 2 of them at
    the tests' 16 tokens)."""
    return dataclasses.replace(cfg, use_chunked_attn=True, attn_q_chunk=8,
                               attn_kv_chunk=8)


def _np(t):
    return t.detach().cpu().numpy()


def _place_batch(batch, mesh):
    from torch.distributed.tensor import distribute_tensor
    return {k: distribute_tensor(
        torch.from_numpy(v).long(), mesh,
        to_placements(batch_pspec(v.shape, mesh), mesh), src_data_rank=None)
        for k, v in batch.items()}


def _loss_and_grads(params, batch, cfg, mesh):
    """The loss and the gradients (reduced to the params' placements) of
    placed params, each gathered whole."""
    leaves, treedef = tree_flatten(params)
    leaves = [l.detach().requires_grad_(True) for l in leaves]
    with placed.mesh_context(mesh):
        loss, _ = tt.loss_fn(tree_unflatten(treedef, leaves), batch, cfg)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
    grads = tree_leaves(reduce_gradients(list(grads), leaves))
    placements = [str(tuple(g.placements)) for g in grads]
    return (float(placed.plain(loss.detach())),
            [_np(placed.plain(g)) for g in grads], placements)


def mesh_rank(rank, inputs, part):
    """The 2 x 2 gloo mesh's checks of one ``part`` (the test runs the two
    in two process groups at once): ``"dense"`` — ``constrain``,
    stablelm's loss and gradients and its chunked attention, the
    ``Trainer``, the checkpoints and the int8 all-reduce; ``"ssm_moe"`` — mamba2's loss and gradients and
    deepseek's EP-sharded MoE. Returns, on every rank, a dict of results
    (gathered whole)."""
    mesh = make_local_mesh(2, 2, device="cpu")
    out = {"rank": rank, "coord": tuple(mesh.get_coordinate())}
    if part == "dense":
        _dense(rank, inputs, mesh, out)
        _serve_on(inputs, mesh, out, "2x2",
                  SERVE_ARCHS + MOE_ARCHS + FAMILY_ARCHS)
        out["placed_packing"] = _placed_packing(mesh)
        _engines_on(inputs, mesh, out, "2x2")
    else:
        _ssm_moe(inputs, mesh, out)
        _serve_pairs_and_four(inputs, out)
    return out


def _serve_on(inputs, mesh, out, tag, archs=SERVE_ARCHS):
    """The sharded ``Server`` of every ``archs`` smoke config on the
    reference's packed planes, K1 + K3 and K4: ``out["serve"][(arch,
    tag, pack_acts)] = (tokens, last logits)``."""
    res = out.setdefault("serve", {})
    for arch in archs:
        cfg = get_arch(arch).smoke
        params = tt.params_from_numpy(inputs["serve"][arch])
        for pa in (True, False):
            res[(arch, tag, pa)] = serve(cfg, params, mesh, pa)


def _placed_packing(mesh):
    """The three ways a rank comes by its packed planes: drawn and packed
    a layer at a time, each layer split after packing
    (``init_placed_params(packed=True)``); the whole packed params placed
    (``place_tree``); and the placed float params packed (``pack_params``
    gathers, packs and places). Returns, per way, whether every local
    shard equals the first way's, and how many leaves are split."""
    from repro_torch.distributed.sharding import place_tree
    cfg = get_arch("stablelm-1.6b").smoke
    gen = lambda: torch.Generator().manual_seed(3)
    drawn = tree_leaves(init_placed_params(gen(), cfg, mesh, packed=True))
    ways = [tree_leaves(place_tree(tt.init_params(gen(), cfg, packed=True),
                                   mesh)),
            tree_leaves(tt.pack_params(init_placed_params(gen(), cfg, mesh),
                                       cfg))]
    same = [len(w) == len(drawn) and all(
        torch.equal(a.to_local(), b.to_local()) and a.placements ==
        b.placements for a, b in zip(w, drawn)) for w in ways]
    split = sum(any(p.is_shard() for p in t.placements) for t in drawn)
    return same, split


def _serve_pairs_and_four(inputs, out):
    """Two (data 1, model 2) meshes, ranks {0, 1} and {2, 3} (the model
    axis of a (2, 1, 2) mesh), then one (data 1, model 4) mesh: qwen1.5's
    2 kv heads on 4 ranks split the cache's positions (hymba's 2 split its
    windows' slots: :func:`window_slots`). Then the
    unaligned-K cases of ``qdense``'s placed path on the (1, 2) mesh."""
    from torch.distributed.device_mesh import init_device_mesh
    pairs = init_device_mesh("cpu", (2, 1, 2), mesh_dim_names=(
        "rep", "data", "model"))["data", "model"]
    _serve_on(inputs, pairs, out, "1x2",
              SERVE_ARCHS + MOE_ARCHS + FAMILY_ARCHS)
    _engines_on(inputs, pairs, out, "1x2")
    _per_row_on(inputs, pairs, out, "1x2")
    four = init_device_mesh("cpu", (1, 4), mesh_dim_names=("data", "model"))
    _engines_on(inputs, four, out, "1x4")
    _per_row_on(inputs, four, out, "1x4")
    _serve_on(inputs, four, out, "1x4",
              ("qwen1.5-110b",) + MOE_ARCHS + FAMILY_ARCHS)
    qwen = get_arch("qwen1.5-110b").smoke
    qwen_params = tt.params_from_numpy(inputs["serve"]["qwen1.5-110b"])
    for tag, cfg in (("int8", int8_cache(qwen)),
                     ("int8 chunked", chunked(int8_cache(qwen)))):
        out["serve"][("qwen1.5-110b", f"1x4 {tag}", True)] = serve(
            cfg, qwen_params, four, True)
    cache = tt.init_caches(qwen, 4, SERVE_MAX_LEN, device="cpu", mesh=four)
    out["serve_cache_placements"] = str(tuple(cache[0]["k"].placements))
    hymba = tt.init_caches(get_arch("hymba-1.5b").smoke, 4, SERVE_MAX_LEN,
                           device="cpu", mesh=four)
    out["window_cache_placements"] = str(tuple(
        hymba[1]["attn"]["k"].placements))
    out["window_slots"] = window_slots(inputs["serve"]["hymba-1.5b"], four)
    out["unaligned"] = _unaligned(inputs["unaligned"], pairs)


def _unaligned(case, mesh):
    """``qdense`` on packed params placed on ``mesh`` whose K words do not
    line up with the activation's split (K = 48: words 32 + 16, the
    activation 24 + 24), or do not divide (K = 80: 3 words, left whole),
    K1 + K3 and K4: each (output gathered, its placements, the planes'
    placements)."""
    from torch.distributed.tensor import distribute_tensor, Replicate, Shard
    from repro_torch.distributed.sharding import place_tree
    from repro_torch.models.layers import QuantPolicy, qdense
    got = {}
    for name, (p_np, x_np) in case.items():
        p = place_tree({"mlp": {"w_down": tt.params_from_numpy(p_np)}},
                       mesh)["mlp"]["w_down"]
        x = distribute_tensor(torch.from_numpy(x_np), mesh,
                              [Replicate(), Shard(2)], src_data_rank=None)
        for pa in (True, False):
            pol = QuantPolicy(mode="serial", w_bits=4, a_bits=8,
                              pack_acts=pa)
            with torch.no_grad(), placed.mesh_context(mesh):
                y = qdense(p, x, pol)
            got[(name, pa)] = (_np(placed.plain(y)),
                               str(tuple(y.placements)),
                               str(tuple(p["w_packed"].placements)))
    return got


def _models(inputs, mesh, out, archs):
    """Loss and gradients on params placed by the reference's rules."""
    for arch in archs:
        params_np, batch = inputs["models"][arch]
        cfg = get_arch(arch).smoke
        params = tt.params_from_numpy(params_np)
        params = distribute_tree(params, tree_shardings(params, mesh))
        out[arch] = _loss_and_grads(params, _place_batch(batch, mesh), cfg,
                                    mesh)


def _dense(rank, inputs, mesh, out):
    # a constraint redistributes a placed tensor, a plain one passes
    from torch.distributed.tensor import distribute_tensor, Partial
    x = distribute_tensor(torch.arange(16.).reshape(4, 4), mesh,
                          to_placements((None, None), mesh))
    y = torch.ones(4)
    with bind_axes(dp="data", tp="model", mesh=mesh):
        out["constrain"] = [str(tuple(constrain(x, "dp", "tp").placements)),
                            str(tuple(constrain(x, "dp").placements)),
                            constrain(y, "dp") is y]
        part = torch.distributed.tensor.DTensor.from_local(
            torch.full((2, 4), float(rank)), mesh, [Partial(), Partial()])
        whole = constrain(part, None, None)
        out["constrain_partial"] = (str(tuple(whole.placements)),
                                    _np(whole.to_local()))

    # 3 heads of 8 split over the 2-way model axis: made whole, then viewed;
    # the gradient comes back at the input's placements
    w = distribute_tensor(torch.arange(2 * 5 * 24.).reshape(2, 5, 24), mesh,
                          to_placements(("data", None, "model"), mesh))
    w.requires_grad_(True)
    heads = placed.split_heads(w, 3, 8)
    (g,) = torch.autograd.grad((heads * heads).sum(), w)
    out["split_heads"] = (tuple(heads.shape), _np(placed.plain(heads)),
                          str(tuple(g.placements)), _np(placed.plain(g)))

    _models(inputs, mesh, out, ["stablelm-1.6b"])
    # the chunked (online-softmax) attention on the placed params
    params_np, batch = inputs["models"]["stablelm-1.6b"]
    params = tt.params_from_numpy(params_np)
    params = distribute_tree(params, tree_shardings(params, mesh))
    with torch.no_grad(), placed.mesh_context(mesh):
        logits, _ = tt.forward(params, _place_batch(batch, mesh),
                               chunked(get_arch("stablelm-1.6b").smoke))
    out["chunked_logits"] = _np(placed.plain(logits))

    # the Trainer on the mesh (checkpointed at its last step), then a
    # checkpoint written unsharded restored onto the mesh
    lm = get_arch("stablelm-1.6b").smoke
    tr = Trainer(lm, opt_cfg=OPT, ckpt_dir=inputs["ckpt_mesh"], save_every=3,
                 device="cpu", mesh=mesh, **TRAIN)
    state, losses = tr.run(3, log_every=100)
    out["train"] = (losses, [h["grad_norm"] for h in tr.history],
                    [_np(placed.plain(l)) for l in tree_leaves(state)])
    # one more step (out of place: the state above stays), traced: this
    # rank's collectives by kind
    step_batch = tr.device_batch(tr.data.batch(3, TRAIN["batch_size"]))
    with tr._step_context():
        _, cost = analyze(make_train_step(lm, OPT), state, step_batch)
    out["train_cost"] = (cost.collective_counts, cost.collective_bytes)
    target = tr.init_state()
    ck = CheckpointManager(inputs["ckpt_plain"])
    restored = ck.restore(ck.latest_step(), target,
                          shardings=tree_shardings(target, mesh))
    out["restored"] = ([_np(placed.plain(l)) for l in tree_leaves(restored)],
                       [str(tuple(l.placements))
                        for l in tree_leaves(restored)])

    # the int8 all-reduce over all four ranks
    g = torch.from_numpy(inputs["compress"][0][rank])
    e = torch.from_numpy(inputs["compress"][1][rank])
    out["compress_mean"] = _np(compressed_allreduce_mean(g))
    red, err = compress_tree({"a": g, "b": [g[:17] * 3]},
                             {"a": e, "b": [torch.zeros(17)]})
    out["compress_tree"] = (_np(red["a"]), _np(err["a"]), _np(red["b"][0]),
                            _np(err["b"][0]))


def _ssm_moe(inputs, mesh, out):
    _models(inputs, mesh, out, ["mamba2-780m"])
    # deepseek: the EP-sharded MoE's forward, loss and gradients
    moe = get_arch("deepseek-v2-lite-16b").smoke
    params = tt.init_params(torch.Generator().manual_seed(0), moe)
    params = distribute_tree(params, tree_shardings(params, mesh))
    pb = _place_batch(inputs["moe_batch"], mesh)
    with torch.no_grad(), placed.mesh_context(mesh):
        logits, aux = tt.forward(params, pb, moe)
    out["moe_logits"] = _np(placed.plain(logits))
    out["moe_lb"] = float(placed.plain(aux["lb_loss"]))
    out["moe_placements"] = str(tuple(params["groups"][1]["moe"]["w_up"][
        "w"].placements))
    out["moe_grads"] = _loss_and_grads(params, pb, moe, mesh)
