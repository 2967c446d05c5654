"""The stacks of the model zoo: pre-norm attention (GQA or MLA) + MLP or
MoE blocks, Mamba-2 SSM blocks, Hymba hybrid blocks and an
encoder-decoder's blocks with cross-attention, with every projection
quant-aware.

Counterpart of ``repro/models/transformer.py``, every family: dense, MoE,
SSM, hybrid, ``encdec``/``audio`` (a non-causal encoder stack over
``src_tokens`` or, through ``frontend_proj``, ``src_embeds``; a decoder
whose blocks cross-attend its output) and ``vlm`` (projected
``frontend_embeds`` put in front of the tokens). GQA or MLA attention,
full or sliding-window, with or without q/k/v biases; SwiGLU, squared-ReLU
(``relu2``) or GELU (``gelu``, the tanh approximation, JAX's default) MLPs;
SwiGLU experts; a head of its own or tied to the embedding. Parameters are
plain dicts in the reference's layout: a layer group carries every leaf
with a leading ``(L, ...)`` axis, and :func:`_run_groups` walks it with a
Python loop where the reference runs ``lax.scan``.
:func:`params_from_numpy` carries the reference's parameter pytree (float
or packed) across.

Caches are stacked the same way and written in place: a KV cache by the
attention itself, an SSM state (which the reference replaces each step)
and a decoder's cross K/V (computed from the encoder's output at prefill)
by :func:`_run_groups`, which copies a block's new tensor into its layer's
slot. The cross buffers have the source's length, known at prefill, where
:func:`prefill` allocates them. ``kv_bits=8`` makes every GQA cache (a
hybrid's too) int8; ``use_chunked_attn`` sends the attention of a forward,
a prefill and training through ``chunked_attention`` (the reference's
long-context knobs, which its dry-run sets).

Training: :func:`loss_fn` is the reference's causal-LM loss. While
autograd records, each layer runs under ``torch.utils.checkpoint`` when
``cfg.remat`` is set (the reference's per-layer ``jax.checkpoint``):
``remat_policy="nothing"`` keeps only the layer's input, ``"dots"``
(``dots_with_no_batch_dims_saveable``) also the outputs of its matmuls
without batch dimensions, the projections (selective checkpointing: the
ATen ``mm``/``addmm`` outputs saved, every other op run again); any
other policy is refused. A stack is
split into its layers with one ``unbind``, whose backward stacks the
layers' gradients once.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils import checkpoint as torch_checkpoint
from torch.utils.checkpoint import (CheckpointPolicy,
                                    create_selective_checkpoint_contexts)

from repro_torch.distributed import context, placed
from repro_torch.distributed.context import constrain
from repro_torch.models.attention import (AttnConfig, attn_apply, attn_init,
                                          init_kv_cache, init_mla_cache,
                                          mla_apply, mla_init)
from repro_torch.models.hybrid import (HybridConfig, hybrid_apply,
                                       hybrid_init, init_hybrid_cache)
from repro_torch.models.layers import (QuantPolicy, layer_norm, pack_qdense,
                                       qdense, qdense_init, qdense_shared,
                                       rms_norm)
from repro_torch.models.moe import MoEConfig, moe_apply, moe_init
from repro_torch.models.ssm import (SSMConfig, init_ssm_cache, ssm_apply,
                                    ssm_decode_step, ssm_init)

__all__ = ["ModelConfig", "GroupSpec", "layer_groups", "encoder_groups",
           "init_params",
           "forward", "loss_fn", "prefill", "decode_step", "init_caches",
           "pack_params", "serve_policy", "params_from_numpy"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense|moe|ssm|hybrid|encdec|vlm|audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    act: str = "swiglu"             # swiglu | relu2 | gelu
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    partial_rotary: float = 1.0
    norm_type: str = "rms"
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    d_ff_expert: int = 0
    n_dense_layers: int = 0          # leading dense layers (deepseek)
    norm_topk_prob: bool = True
    # MLA
    mla: bool = False
    kv_lora: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    # SSM / hybrid
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_groups: int = 1
    ssm_chunk: int = 128
    window: Optional[int] = None
    global_attn_layers: Tuple[int, ...] = ()
    # encoder-decoder
    n_enc_layers: int = 0
    # frontend stub (audio frames / vision patches): embeddings provided
    frontend: Optional[str] = None
    frontend_len: int = 0
    frontend_dim: int = 0
    policy: QuantPolicy = QuantPolicy(mode="none")
    kv_bits: Optional[int] = None   # None: a bf16 cache; 8: int8 codes
    remat: bool = True
    remat_policy: str = "nothing"   # or "dots"
    dtype: str = "bfloat16"
    use_chunked_attn: bool = False
    attn_q_chunk: int = 1024
    attn_kv_chunk: int = 1024

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    def attn_cfg(self, window: Optional[int] = None,
                 causal: bool = True) -> AttnConfig:
        return AttnConfig(
            d_model=self.d_model, n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads, head_dim=self.head_dim,
            qkv_bias=self.qkv_bias, rope_theta=self.rope_theta,
            partial_rotary=self.partial_rotary, causal=causal,
            window=window, mla=self.mla, kv_lora=self.kv_lora,
            qk_nope_dim=self.qk_nope_dim, qk_rope_dim=self.qk_rope_dim,
            v_head_dim=self.v_head_dim, kv_bits=self.kv_bits)

    def ssm_cfg(self) -> SSMConfig:
        return SSMConfig(d_model=self.d_model, d_state=self.ssm_state,
                         head_dim=self.ssm_head_dim, expand=self.ssm_expand,
                         n_groups=self.ssm_groups, chunk=self.ssm_chunk)

    def moe_cfg(self) -> MoEConfig:
        return MoEConfig(d_model=self.d_model, d_ff_expert=self.d_ff_expert,
                         n_experts=self.n_experts, top_k=self.top_k,
                         n_shared=self.n_shared_experts,
                         d_ff_shared=self.n_shared_experts * self.d_ff_expert,
                         norm_topk_prob=self.norm_topk_prob, act=self.act)


@dataclasses.dataclass(frozen=True)
class GroupSpec:
    kind: str          # 'attn' | 'mla' | 'ssm' | 'hybrid'
    n: int
    use_moe: bool = False
    window: Optional[int] = None
    causal: bool = True
    cross: bool = False  # decoder cross-attention (encoder-decoder)


FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm", "audio")
ACTS = ("swiglu", "relu2", "gelu")


def _has_encoder(cfg: ModelConfig) -> bool:
    return cfg.family in ("encdec", "audio")


def layer_groups(cfg: ModelConfig) -> Tuple[GroupSpec, ...]:
    """The (decoder) stack as homogeneous groups: one group; (deepseek)
    the leading dense layers and then the MoE layers; (hybrid) runs of
    sliding-window layers split by single global-attention layers. An
    encoder-decoder's groups cross-attend (its encoder:
    :func:`encoder_groups`). A family or MLP activation the reference does
    not name raises."""
    if cfg.family not in FAMILIES or cfg.act not in ACTS:
        raise NotImplementedError(f"family {cfg.family!r} with act "
                                  f"{cfg.act!r}: the families are "
                                  f"{FAMILIES}, the activations {ACTS}")
    n_layers = cfg.n_layers
    if cfg.family == "ssm":
        return (GroupSpec("ssm", n_layers),)
    if cfg.family == "hybrid":
        groups = []
        prev = 0
        for gi in sorted(cfg.global_attn_layers):
            if gi > prev:
                groups.append(GroupSpec("hybrid", gi - prev,
                                        window=cfg.window))
            groups.append(GroupSpec("hybrid", 1, window=None))
            prev = gi + 1
        if prev < n_layers:
            groups.append(GroupSpec("hybrid", n_layers - prev,
                                    window=cfg.window))
        return tuple(groups)
    kind = "mla" if cfg.mla else "attn"
    moe = cfg.n_experts > 0
    cross = _has_encoder(cfg)
    if moe and cfg.n_dense_layers > 0:
        return (GroupSpec(kind, cfg.n_dense_layers, use_moe=False,
                          cross=cross),
                GroupSpec(kind, n_layers - cfg.n_dense_layers,
                          use_moe=True, cross=cross))
    return (GroupSpec(kind, n_layers, use_moe=moe, window=cfg.window,
                      cross=cross),)


def encoder_groups(cfg: ModelConfig) -> Tuple[GroupSpec, ...]:
    """An encoder-decoder's encoder: ``n_enc_layers`` (else ``n_layers``)
    non-causal attention blocks, as the reference builds it."""
    return (GroupSpec("attn", cfg.n_enc_layers or cfg.n_layers,
                      causal=False),)


def _hybrid_cfg(cfg: ModelConfig, spec: GroupSpec) -> HybridConfig:
    return HybridConfig(cfg.attn_cfg(window=spec.window), cfg.ssm_cfg())


# ------------------------------------------------------------------- params

def _block_init(gen: torch.Generator, cfg: ModelConfig,
                spec: GroupSpec) -> dict:
    """One layer's float parameters."""
    d, f, dev = cfg.d_model, cfg.d_ff, gen.device
    p = {"norm1": torch.ones((d,), device=dev)}
    if cfg.norm_type == "layer":
        p["norm1_b"] = torch.zeros((d,), device=dev)
    if spec.kind == "ssm":        # no second norm, no MLP
        p["ssm"] = ssm_init(gen, cfg.ssm_cfg(), cfg.policy)
        return p
    if spec.kind == "hybrid":
        p["hybrid"] = hybrid_init(gen, _hybrid_cfg(cfg, spec), cfg.policy)
    elif spec.kind == "mla":
        p["attn"] = mla_init(gen, cfg.attn_cfg(), cfg.policy)
    else:
        p["attn"] = attn_init(gen, cfg.attn_cfg(window=spec.window),
                              cfg.policy)
    if spec.cross:
        p["cross"] = attn_init(gen, cfg.attn_cfg(causal=False), cfg.policy)
        p["norm_cross"] = torch.ones((d,), device=dev)
        if cfg.norm_type == "layer":
            p["norm_cross_b"] = torch.zeros((d,), device=dev)
    p["norm2"] = torch.ones((d,), device=dev)
    if cfg.norm_type == "layer":
        p["norm2_b"] = torch.zeros((d,), device=dev)
    if spec.use_moe:
        p["moe"] = moe_init(gen, cfg.moe_cfg(), cfg.policy)
    else:
        # two matrices, and the gate for SwiGLU only
        p["mlp"] = {"w_up": qdense_init(gen, d, f, cfg.policy),
                    "w_down": qdense_init(gen, f, d, cfg.policy)}
        if cfg.act == "swiglu":
            p["mlp"]["w_gate"] = qdense_init(gen, d, f, cfg.policy)
    return p


def _stack_into(dst, src, i: int, n: int):
    """Write layer ``src`` into slot ``i`` of the (n, ...) stack ``dst``
    (allocated from the first layer when None); returns the stack."""
    if isinstance(src, dict):
        dst = {} if dst is None else dst
        for k, v in src.items():
            dst[k] = _stack_into(dst.get(k), v, i, n)
        return dst
    if dst is None:
        dst = torch.empty((n,) + tuple(src.shape), dtype=src.dtype,
                          device=src.device)
    dst[i].copy_(src)
    return dst


def init_params(gen: torch.Generator, cfg: ModelConfig, *,
                packed: bool = False, keep=None) -> dict:
    """Random float parameters drawn from ``gen`` on ``gen.device``, in
    the reference's layout and scales (its numbers differ: another
    generator). Layers are drawn one at a time into their group's stack;
    with ``packed`` each layer is packed (:func:`pack_params`) before it
    is stacked, so the float peak is one layer's — how a full-width MoE
    stack (26 x 64 experts) is made on one card. A config with
    ``tie_embeddings`` has no ``head``: the embedding is the head. An
    encoder-decoder adds ``enc`` (its stack and final norm), a frontend
    ``frontend_proj`` (a float dense, mode ``none``, never packed).

    ``keep(path, tensor, n)`` is given every leaf as it is drawn and
    returns what the tree holds instead (a mesh run keeps its shard):
    a layer's leaf with ``n``, its group's depth, and the path of the
    stacked leaf (``groups/0/attn/wq/w``); any other leaf with ``n``
    None. The draws are the same with or without it."""
    d, v, dev = cfg.d_model, cfg.vocab_size, gen.device
    top = (lambda name, t: t) if keep is None else (
        lambda name, t: _keep_tree(t, keep, f"{name}/", None))
    params = {
        "embed": top("embed", torch.randn((v, d), generator=gen,
                                          device=dev) * 0.02),
        "final_norm": top("final_norm", torch.ones((d,), device=dev)),
        "groups": [_draw_stack(gen, cfg, spec, packed, keep,
                               f"groups/{gi}/")
                   for gi, spec in enumerate(layer_groups(cfg))],
    }
    if cfg.norm_type == "layer":
        params["final_norm_b"] = top("final_norm_b",
                                     torch.zeros((d,), device=dev))
    if not cfg.tie_embeddings:
        params["head"] = top("head", qdense_init(gen, d, v,
                                                 QuantPolicy(mode="none")))
    if _has_encoder(cfg):
        params["enc"] = {
            "groups": [_draw_stack(gen, cfg, spec, packed, keep,
                                   f"enc/groups/{gi}/")
                       for gi, spec in enumerate(encoder_groups(cfg))],
            "final_norm": top("enc/final_norm",
                              torch.ones((d,), device=dev))}
    if cfg.frontend is not None:
        params["frontend_proj"] = top("frontend_proj", qdense_init(
            gen, cfg.frontend_dim or d, d, QuantPolicy(mode="none")))
    return params


def _keep_tree(tree, keep, prefix: str, n):
    if isinstance(tree, dict):
        return {k: _keep_tree(v, keep, f"{prefix}{k}/", n)
                for k, v in tree.items()}
    return keep(prefix[:-1], tree, n)


def _draw_stack(gen: torch.Generator, cfg: ModelConfig, spec: GroupSpec,
                packed: bool, keep=None, prefix: str = "") -> dict:
    """One group's (n, ...) stack, drawn (and packed) a layer at a time,
    each layer's leaves through ``keep`` (:func:`init_params`) before
    they are stacked. On the meta device (shapes only:
    ``launch/dryrun.py``'s accounting) every layer has the first's shapes,
    so one is drawn and stacked."""
    if gen.device.type == "meta":
        layer = _block_init(gen, cfg, spec)
        layer = _pack_tree(layer, cfg.policy) if packed else layer
        if keep is not None:
            layer = _keep_tree(layer, keep, prefix, spec.n)
        return _stack_into(None, layer, 0, spec.n)
    stack = None
    for i in range(spec.n):
        layer = _block_init(gen, cfg, spec)
        if packed:
            layer = _pack_tree(layer, cfg.policy)
        if keep is not None:
            layer = _keep_tree(layer, keep, prefix, spec.n)
        stack = _stack_into(stack, layer, i, spec.n)
        del layer
    return stack


def params_from_numpy(tree, device=None):
    """Carry a parameter pytree across: nested dicts/lists of numpy (or
    array-like) leaves, float or packed (uint32 words become int32 tensors
    holding the same bits), as tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device) for v in tree]
    a = np.asarray(tree)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a, order="C")).to(device)


# ------------------------------------------------------------------ forward

def _norm(x, w, b, cfg: ModelConfig):
    if cfg.norm_type == "layer":
        return layer_norm(x, w, b, cfg.norm_eps)
    return rms_norm(x, w, cfg.norm_eps)


def _mlp_apply(p, x, cfg: ModelConfig):
    """SwiGLU (gate and up share one quantize-pack), the squared ReLU
    ``max(up, 0)**2`` or GELU's tanh approximation (``jax.nn.gelu``'s
    default; torch's default is the erf form). ``h`` is quantized under
    ``cfg.policy`` whatever its sign, as the reference does."""
    if cfg.act == "swiglu":
        gate, up = qdense_shared([p["w_gate"], p["w_up"]], x, cfg.policy)
        h = F.silu(gate) * up
    else:
        up = qdense(p["w_up"], x, cfg.policy)
        if cfg.act == "relu2":
            r = torch.clamp_min(up, 0)
            h = r * r
        else:
            h = F.gelu(up, approximate="tanh")
    return qdense(p["w_down"], h, cfg.policy)


def _cross_apply(p, x, cache, enc_out, cfg: ModelConfig):
    """The decoder's cross-attention residual branch. Its K/V come from
    ``enc_out`` (one quantize-pack for both) when given, else from the
    cache (a decode step). Returns ``(out, ck, cv)``. A placed cache (a
    sharded server) holds the whole heads on every ``model`` rank, as
    ``cache_pspec`` places it: a prefill's K/V (column-parallel) are
    gathered into it once, in place, and every rank attends every head
    over it (``attention._every_head``)."""
    hx = _norm(x, p["norm_cross"], p.get("norm_cross_b"), cfg)
    acx = cfg.attn_cfg(causal=False)
    if enc_out is None:
        ck, cv = cache["cross_k"], cache["cross_v"]
    else:
        ck, cv = (placed.split_heads(t, acx.n_kv_heads, acx.head_dim)
                  for t in qdense_shared([p["cross"]["wk"],
                                          p["cross"]["wv"]], enc_out,
                                         cfg.policy))
        if cache is not None and placed.is_placed(cache["cross_k"]):
            ck, cv = (_write_whole(cache[n], t)
                      for n, t in (("cross_k", ck), ("cross_v", cv)))
    out, _ = attn_apply(p["cross"], hx, acx, cfg.policy, cross_kv=(ck, cv))
    return out, ck, cv


def _write_whole(dst, t):
    """``t`` redistributed to placed ``dst``'s placements and copied into
    it, in place; returns ``dst``."""
    dst.to_local().copy_(t.redistribute(dst.device_mesh,
                                        dst.placements).to_local())
    return dst


def _block_apply(p, x, cfg: ModelConfig, spec: GroupSpec, *, positions,
                 cache=None, cache_pos=None, enc_out=None, aux=None,
                 decode=False):
    """One pre-norm block. Returns ``(x, new_cache)``; an MoE block
    appends its ``lb_loss`` and ``drop_frac`` to ``aux``'s lists when
    ``aux`` is a dict. ``decode`` steps an SSM (or a hybrid's SSM branch)
    one token over its state. A cross-attending block's cache is
    ``{"self", "cross_k", "cross_v"}``; its K/V come from ``enc_out``
    when given (prefill, or no cache), else from that cache."""
    x = constrain(x, "dp", "sp", None)   # batch DP, optional seq-sharding
    h = _norm(x, p["norm1"], p.get("norm1_b"), cfg)
    chunk = dict(use_chunked=cfg.use_chunked_attn, q_chunk=cfg.attn_q_chunk,
                 kv_chunk=cfg.attn_kv_chunk)
    if spec.kind == "ssm":
        if decode:
            out, new_c = ssm_decode_step(p["ssm"], h, cfg.ssm_cfg(),
                                         cfg.policy, cache)
        else:
            out, new_c = ssm_apply(p["ssm"], h, cfg.ssm_cfg(), cfg.policy,
                                   cache=cache)
        return x + out.to(x.dtype), new_c
    if spec.kind == "hybrid":
        out, new_c = hybrid_apply(p["hybrid"], h, _hybrid_cfg(cfg, spec),
                                  cfg.policy, positions=positions,
                                  cache=cache, cache_pos=cache_pos,
                                  decode=decode, **chunk)
    elif spec.kind == "mla":
        out, new_c = mla_apply(p["attn"], h, cfg.attn_cfg(), cfg.policy,
                               positions=positions, cache=cache,
                               cache_pos=cache_pos, **chunk)
    else:
        self_cache = cache["self"] if (cache is not None
                                       and spec.cross) else cache
        out, new_c = attn_apply(p["attn"], h,
                                cfg.attn_cfg(window=spec.window,
                                             causal=spec.causal),
                                cfg.policy, positions=positions,
                                cache=self_cache, cache_pos=cache_pos,
                                **chunk)
        if spec.cross:
            x = x + out
            out, ck, cv = _cross_apply(p, x, cache, enc_out, cfg)
            if cache is not None:
                new_c = {"self": new_c, "cross_k": ck, "cross_v": cv}
    x = x + out
    hm = _norm(x, p["norm2"], p.get("norm2_b"), cfg)
    if spec.use_moe:
        mo, maux = moe_apply(p["moe"], hm, cfg.moe_cfg(), cfg.policy)
        if aux is not None:
            aux.setdefault("lb_loss", []).append(maux["lb_loss"])
            aux.setdefault("drop_frac", []).append(maux["drop_frac"])
        return x + mo, new_c
    return x + _mlp_apply(p["mlp"], hm, cfg), new_c


def _unstack(tree, n: int) -> list:
    """The ``n`` layers of a stacked parameter tree, as views: one
    ``unbind`` per leaf, so autograd stacks the layers' gradients once
    instead of adding ``n`` full-size zero-padded slices."""
    if isinstance(tree, dict):
        per = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: per[k][i] for k in per} for i in range(n)]
    return torch.unbind(tree, 0)


#: the ATen ops ``remat_policy="dots"`` saves: matmuls with no batch
#: dimension (a projection; a batched matmul, ``bmm``, runs again, as JAX's
#: ``dots_with_no_batch_dims_saveable`` leaves a ``dot_general`` with batch
#: dimensions)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, func, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if func in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_context():
    return create_selective_checkpoint_contexts(_save_dots)


def _remat_block(p, x, cfg: ModelConfig, spec: GroupSpec, *, positions,
                 enc_out=None, aux=None):
    """:func:`_block_apply` without a cache under activation
    checkpointing with ``cfg.remat_policy``; the MoE statistics leave as
    outputs, since the body runs again in the backward, under the logical
    axes bound now (the backward may run on another thread, where the
    binding, thread-local, is not: the MoE's group count reads it)."""
    bound = context.snapshot()

    def body(xi):
        own = {}
        with context.rebind(bound):
            y, _ = _block_apply(p, xi, cfg, spec, positions=positions,
                                enc_out=enc_out, aux=own)
        return (y,) + tuple(own[k][0] for k in ("lb_loss", "drop_frac")
                            if k in own)

    if cfg.remat_policy == "nothing":
        kw = {}
    elif cfg.remat_policy == "dots":
        kw = {"context_fn": _remat_context}
    else:
        raise ValueError(f"remat_policy {cfg.remat_policy!r}: 'nothing' or "
                         "'dots'")
    out = torch_checkpoint.checkpoint(body, x, use_reentrant=False,
                                      preserve_rng_state=False, **kw)
    if spec.use_moe and aux is not None:
        aux.setdefault("lb_loss", []).append(out[1])
        aux.setdefault("drop_frac", []).append(out[2])
    return out[0]


def _layer_cache(gcache: dict, i: int) -> dict:
    """Layer ``i``'s view of a stacked group cache (nested for a hybrid):
    each tensor indexed, ``len`` and the ``rolling`` marker as they are."""
    return {k: (_layer_cache(v, i) if isinstance(v, dict)
                else v[i] if torch.is_tensor(v) and k != "len" else v)
            for k, v in gcache.items()}


def _store_layer_cache(gcache: dict, i: int, view: dict, new: dict) -> None:
    """Store a block's returned cache in layer ``i``'s slot: a tensor the
    block replaced (an SSM's ``h`` and ``conv``) copied in, one it wrote
    in place (``view``'s own) left alone. ``len`` waits for
    :func:`_advance_len`: every layer of a group starts from the same."""
    for k, v in new.items():
        if isinstance(v, dict):
            _store_layer_cache(gcache[k], i, view[k], v)
        elif torch.is_tensor(v) and k != "len" and v is not view[k]:
            gcache[k][i].copy_(v)


def _advance_len(gcache: dict, new: dict) -> None:
    """A group's ``len`` (each nested cache's) after its last layer."""
    for k, v in new.items():
        if k == "len":
            gcache[k] = v
        elif isinstance(v, dict):
            _advance_len(gcache[k], v)


def _run_groups(groups_params, x, cfg: ModelConfig, specs, *, positions,
                caches=None, cache_pos=None, enc_out=None, aux=None,
                decode=False):
    """Run each group's layers in order; returns ``(x, caches)``. The
    caches are written in place; ``enc_out`` feeds cross-attention;
    ``aux`` (a dict) collects the MoE layers' statistics; ``decode`` steps
    SSM state one token. Without caches, while autograd records and with
    ``cfg.remat``, every layer is checkpointed."""
    remat = cfg.remat and caches is None and torch.is_grad_enabled()
    for gi, (gp, spec) in enumerate(zip(groups_params, specs)):
        gcache = caches[gi] if caches is not None else None
        for i, lp in enumerate(_unstack(gp, spec.n)):
            if remat:
                x = _remat_block(lp, x, cfg, spec, positions=positions,
                                 enc_out=enc_out, aux=aux)
                continue
            cl = _layer_cache(gcache, i) if gcache is not None else None
            x, nc = _block_apply(lp, x, cfg, spec,
                                 positions=positions, cache=cl,
                                 cache_pos=cache_pos, enc_out=enc_out,
                                 aux=aux, decode=decode)
            if gcache is not None:
                _store_layer_cache(gcache, i, cl, nc)
        if gcache is not None:
            _advance_len(gcache, nc)
    return x, caches


def _stack_aux(aux: dict) -> dict:
    """The MoE layers' statistics as (n_moe_layers,) tensors."""
    return {k: torch.stack(v) for k, v in aux.items()}


def _embed(table, tokens):
    """``F.embedding``; a placed table (a mesh run) looks up its own rows
    and the ranks' rows are summed (:func:`repro_torch.distributed.placed.
    embedding`)."""
    if placed.is_placed(table):
        return placed.embedding(table, tokens)
    return F.embedding(tokens, table)


def _embed_inputs(params, batch, cfg: ModelConfig):
    """Token embedding, after the projected ``frontend_embeds`` when the
    config has a frontend and the batch holds them; returns ``(x,
    positions)``, the positions over both. ``F.embedding``, not indexing:
    its backward sums a repeated token's rows in a fixed order, where the
    backward of indexing (``index_put_`` with accumulate) adds them in a
    varying order on the CPU, so training would not repeat."""
    dt = cfg.compute_dtype
    x = _embed(params["embed"], batch["tokens"]).to(dt)
    if cfg.frontend is not None and "frontend_embeds" in batch:
        fe = qdense(params["frontend_proj"],
                    batch["frontend_embeds"].to(dt), QuantPolicy(mode="none"))
        x = torch.cat([fe, x], dim=1)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    return x, positions


def _encode(params, batch, cfg: ModelConfig):
    """An encoder-decoder's encoder output (B, S_src, D), else None: the
    source (``src_embeds`` through ``frontend_proj``, else ``src_tokens``
    through the embedding) through the non-causal encoder stack, then
    ``rms_norm`` whatever ``norm_type`` is, as the reference."""
    if not _has_encoder(cfg):
        return None
    dt = cfg.compute_dtype
    if "src_embeds" in batch:
        src = qdense(params["frontend_proj"], batch["src_embeds"].to(dt),
                     QuantPolicy(mode="none"))
    else:
        src = _embed(params["embed"], batch["src_tokens"]).to(dt)
    pos = torch.arange(src.shape[1], device=src.device)[None, :]
    enc, _ = _run_groups(params["enc"]["groups"], src, cfg,
                         encoder_groups(cfg), positions=pos)
    return rms_norm(enc, params["enc"]["final_norm"], cfg.norm_eps)


def _logits(params, x, cfg: ModelConfig):
    """The final norm, then the head; a tied model without ``head`` (a
    :class:`~repro_torch.launch.serve.Server` casts the embedding into one
    once) multiplies by the embedding, cast to ``x``'s dtype, as the
    reference does at every call."""
    x = _norm(x, params["final_norm"], params.get("final_norm_b"), cfg)
    if "head" not in params:
        return torch.matmul(x, params["embed"].to(x.dtype).T)
    return qdense(params["head"], x, QuantPolicy(mode="none"))


def forward(params, batch, cfg: ModelConfig):
    """Full forward to logits; ``batch``: ``{"tokens": (B, S)}``, plus
    ``frontend_embeds`` (a VLM) or ``src_embeds``/``src_tokens`` (an
    encoder-decoder). Returns ``(logits, aux)``: a dense stack's ``aux``
    is empty; an MoE stack's holds ``lb_loss``, summed over its MoE
    layers, as the reference's."""
    enc_out = _encode(params, batch, cfg)
    x, positions = _embed_inputs(params, batch, cfg)
    aux = {}
    x, _ = _run_groups(params["groups"], x, cfg, layer_groups(cfg),
                       positions=positions, enc_out=enc_out, aux=aux)
    aux = {"lb_loss": _stack_aux(aux)["lb_loss"].sum()} if aux else {}
    return _logits(params, x, cfg), aux


def loss_fn(params, batch, cfg: ModelConfig):
    """Causal LM loss (next-token), as the reference's: float32 logits,
    ``logsumexp`` minus the gold logit, labels ``< 0`` masked out, the mean
    over the mask, plus ``0.01 * lb_loss`` for an MoE stack. ``batch``:
    ``{"tokens", "labels"}`` (B, S). Returns ``(loss, {"ce", **aux})``.
    On packed params (after :func:`pack_params`, under
    :func:`serve_policy`) it is the integer evaluation: K1 + K3 or K4 on
    the card."""
    logits, aux = forward(params, batch, cfg)
    labels = batch["labels"]
    # frontend tokens carry no labels: the logits cut to the labels' length
    if logits.shape[1] != labels.shape[1]:
        logits = logits[:, -labels.shape[1]:]
    lg = logits.to(torch.float32)
    if placed.is_placed(lg):            # a mesh run: the vocabulary whole
        lg = placed.whole_dim(lg, -1)
    lse = torch.logsumexp(lg, dim=-1)
    gold = torch.gather(lg, -1, labels.clamp(min=0)[..., None].long())[..., 0]
    mask = (labels >= 0).to(torch.float32)
    ce = torch.sum((lse - gold) * mask) / torch.clamp_min(torch.sum(mask),
                                                          1.0)
    loss = ce + 0.01 * aux["lb_loss"] if "lb_loss" in aux else ce
    return loss, {"ce": ce, **aux}


# ------------------------------------------------------------------ serving

def _stack_cache(c: dict, n: int) -> dict:
    """A layer's cache repeated into an (n, ...) stack, tensor by tensor;
    ``len`` and markers stay single."""
    return {k: (_stack_cache(v, n) if isinstance(v, dict)
                else v[None].repeat((n,) + (1,) * v.dim())
                if torch.is_tensor(v) else v)
            for k, v in c.items()}


def init_caches(cfg: ModelConfig, batch: int, max_len: int, device=None,
                src_len: int = 0, mesh=None):
    """One stacked cache per group, ``len`` 0: GQA ``k``/``v`` (L, B, T,
    Hkv, D) (T = the window for a rolling cache; with ``cfg.kv_bits=8``
    int8 ``k_q``/``v_q`` and float32 scales ``k_s``/``v_s`` (L, B, T,
    Hkv), a hybrid's attention too), MLA's latent ``c`` (L,
    B, T, kv_lora) and ``k_rope`` (L, B, T, qk_rope_dim), an SSM's state
    ``h`` (L, B, H, N, P) and ``conv``, or a hybrid's ``{"attn", "ssm"}``
    of both; a cross-attending group's ``{"self", "cross_k", "cross_v"}``,
    the cross buffers (L, B, max(src_len, 1), Hkv, D). The continuous
    engine's slot arena is one such list. With ``mesh`` (a
    ``DeviceMesh``) each tensor is a DTensor
    placed by ``cache_pspec``, each rank allocating its own shard."""
    if mesh is not None:
        return _placed_caches(cfg, batch, max_len, device, src_len, mesh)
    caches = []
    dt = cfg.compute_dtype
    for spec in layer_groups(cfg):
        if spec.kind == "ssm":
            c = init_ssm_cache(batch, cfg.ssm_cfg(), dtype=dt, device=device)
        elif spec.kind == "hybrid":
            c = init_hybrid_cache(batch, max_len, _hybrid_cfg(cfg, spec),
                                  dtype=dt, device=device)
        elif spec.kind == "mla":
            c = init_mla_cache(batch, max_len, cfg.attn_cfg(), dtype=dt,
                               device=device)
        else:
            c = init_kv_cache(batch, max_len, cfg.n_kv_heads, cfg.head_dim,
                              kv_bits=cfg.kv_bits, dtype=dt, device=device,
                              window=spec.window)
            if spec.cross:
                shape = (batch, max(src_len, 1), cfg.n_kv_heads,
                         cfg.head_dim)
                c = {"self": c,
                     "cross_k": torch.zeros(shape, dtype=dt, device=device),
                     "cross_v": torch.zeros(shape, dtype=dt, device=device)}
        caches.append(_stack_cache(c, spec.n))
    return caches


def _placed_caches(cfg: ModelConfig, batch: int, max_len: int, device,
                   src_len: int, mesh):
    """:func:`init_caches` as DTensors placed by ``cache_pspec`` on
    ``mesh``: zeros of each rank's shard, wrapped."""
    from torch.distributed.tensor import DTensor
    from repro_torch.distributed.sharding import (cache_pspec, local_shape,
                                                  map_paths, to_placements)
    shapes = init_caches(cfg, batch, max_len, device="meta", src_len=src_len)

    def place(path, t):
        if not torch.is_tensor(t):
            return t
        spec = cache_pspec(path, tuple(t.shape), mesh)
        loc = torch.zeros(local_shape(spec, tuple(t.shape), mesh),
                          dtype=t.dtype, device=device)
        return DTensor.from_local(loc, mesh, to_placements(spec, mesh),
                                  shape=t.shape,
                                  stride=placed.contiguous_stride(t.shape))

    return map_paths(place, shapes)


def _mesh_of(params):
    """The ``DeviceMesh`` of placed params (a sharded server), else
    None."""
    if not placed.is_placed(params["embed"]):
        return None
    return params["embed"].device_mesh


def _whole_logits(logits):
    """Logits with the vocabulary whole on every rank (a mesh run's head
    is vocab-parallel), so a greedy argmax sees every column."""
    return placed.whole_dim(logits, -1) if placed.is_placed(logits) \
        else logits


def _at_rows(x, last_pos):
    """(B, 1, D): row b of ``x`` (B, S, D) at position ``last_pos[b]``. A
    placed ``x`` (a mesh run) is gathered on each rank's rows, whole in
    its other dimensions, and indexed locally (DTensor has no strategy for
    the advanced index); the result is placed on those rows."""
    if not placed.is_placed(x):
        return x[torch.arange(x.shape[0], device=x.device), last_pos][:, None]
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = x.device_mesh
    rows_on = [i for i, p in enumerate(x.placements) if p.is_shard(0)]
    rows = [Shard(0) if i in rows_on else Replicate()
            for i in range(mesh.ndim)]
    xl = x.redistribute(mesh, rows).to_local()
    lp = placed.local_rows(last_pos, mesh, rows_on)
    out = xl[torch.arange(xl.shape[0], device=xl.device), lp][:, None]
    shape = (x.shape[0], 1, x.shape[2])
    return DTensor.from_local(out.contiguous(), mesh, rows,
                              shape=torch.Size(shape),
                              stride=placed.contiguous_stride(shape))


def prefill(params, batch, cfg: ModelConfig, max_len: int, last_pos=None):
    """Run the prompt, building caches. Returns ``(last_logits (B, V),
    caches)``: the logits of every row's last position, or, with
    ``last_pos`` (a (B,) tensor), of row b's position ``last_pos[b]`` — the
    last real token of a right-padded prompt. Under the causal mask the
    positions up to it compute as an unpadded prompt's do (an MoE layer's
    capacity still counts the pads: the reference's dispatch). ``batch``
    holds what :func:`forward` takes; an encoder-decoder's cross K/V are
    computed here, into buffers of the source's length. On placed params
    (a sharded server, run under
    :func:`~repro_torch.distributed.placed.mesh_context`) the caches are
    placed by ``cache_pspec`` and the logits are made whole."""
    mesh = _mesh_of(params)
    enc_out = _encode(params, batch, cfg)
    x, positions = _embed_inputs(params, batch, cfg)
    caches = init_caches(cfg, x.shape[0], max_len, device=x.device,
                         src_len=0 if enc_out is None else enc_out.shape[1],
                         mesh=mesh)
    x, caches = _run_groups(params["groups"], x, cfg, layer_groups(cfg),
                            positions=positions, caches=caches, cache_pos=0,
                            enc_out=enc_out)
    if last_pos is not None:
        x = _at_rows(x, last_pos)
    else:
        x = x[:, -1:]
    return _whole_logits(_logits(params, x, cfg)[:, 0]), caches


def decode_step(params, caches, tokens, pos, cfg: ModelConfig,
                aux: Optional[dict] = None):
    """One token for every row. ``tokens``: (B, 1); ``pos``: the position
    of that token, a host int for every row (a lockstep batch) or a (B,)
    tensor of per-row positions on the batch's device (the slot arena,
    every row at its own depth; nothing then reads a device value on the
    host). ``aux``, a dict, receives the MoE layers' ``lb_loss`` and
    ``drop_frac``, one per MoE layer each. Returns ``(logits (B, V),
    caches)``. On placed params and caches (a sharded server or engine)
    the logits are whole over the vocabulary on every rank, and a (B,)
    ``pos`` may be placed like the batch (the engine's arena) or plain,
    whole on every rank (then placed so, each rank keeping its rows): the
    positions and the caches' per-row writes take each rank's rows of
    it. Only a rolling (sliding-window) buffer refuses per-row
    positions, placed or not."""
    per_row = torch.is_tensor(pos) and pos.dim() == 1
    mesh = _mesh_of(params)
    if mesh is not None:
        x = _embed(params["embed"], tokens).to(cfg.compute_dtype)
        if per_row and not placed.is_placed(pos):
            from torch.distributed.tensor import distribute_tensor
            from repro_torch.distributed.sharding import (batch_pspec,
                                                          to_placements)
            pos = distribute_tensor(pos, mesh, to_placements(
                batch_pspec(tuple(pos.shape), mesh), mesh),
                src_data_rank=None)
    else:
        x = params["embed"][tokens].to(cfg.compute_dtype)
    if per_row:
        positions = pos[:, None]
    else:
        positions = torch.full((1, 1), int(pos), dtype=torch.int64,
                               device=x.device)
    own = {}
    x, caches = _run_groups(params["groups"], x, cfg, layer_groups(cfg),
                            positions=positions, caches=caches,
                            cache_pos=pos, aux=own, decode=True)
    if aux is not None:
        aux.update(_stack_aux(own))
    return _whole_logits(_logits(params, x, cfg)[:, 0]), caches


def serve_policy(cfg: ModelConfig, *, pack_acts: Optional[bool] = None,
                 plain: Optional[bool] = None) -> ModelConfig:
    """``cfg`` with its QuantPolicy retargeted for deployment: activations
    packed (K1 + K3) or as codes (K4), and optionally the plain versions.
    The packed weights never change."""
    updates = {}
    if pack_acts is not None:
        updates["pack_acts"] = pack_acts
    if plain is not None:
        updates["plain"] = plain
    if not updates:
        return cfg
    return dataclasses.replace(
        cfg, policy=dataclasses.replace(cfg.policy, **updates))


#: MLA's absorbed decode multiplies through W_uk/W_uv in latent space on
#: the fly: those two (small) matrices stay float, as in the reference
KEEP_FLOAT = frozenset({"w_uk", "w_uv"})


def _packs(p, name: str) -> bool:
    """Whether :func:`_pack_tree` packs the dense ``p`` named ``name``."""
    return ("w" in p and torch.is_tensor(p["w"]) and p["w"].dim() >= 2
            and p["w"].shape[-1] > 4 and name not in KEEP_FLOAT)


def _any_packs(p, name: str = "") -> bool:
    if isinstance(p, dict):
        return _packs(p, name) or any(_any_packs(v, k)
                                      for k, v in p.items())
    if isinstance(p, list):
        return any(_any_packs(v, name) for v in p)
    return False


def _pack_tree(p, policy: QuantPolicy, name: str = ""):
    """Every quantized dense in ``p`` (2-D, stacked or per-expert 3-D
    weights) packed, but those named in :data:`KEEP_FLOAT`."""
    if isinstance(p, dict):
        if _packs(p, name):
            return pack_qdense(p, policy)
        return {k: _pack_tree(v, policy, k) for k, v in p.items()}
    if isinstance(p, list):
        return [_pack_tree(v, policy, name) for v in p]
    return p


def pack_params(params, cfg: ModelConfig):
    """Export float params to the deployment form: every quantized dense
    of the layer groups (and of an encoder) becomes bit-transposed packed
    planes (the routed experts' (E, K, N) weights per expert), MLA's
    ``w_uk``/``w_uv`` stay float, as do the head and ``frontend_proj``.
    Packed params pass through unchanged. Placed float params (a mesh
    run's) are gathered whole, packed and placed again by
    ``param_pspec`` (each rank keeping its shard of the planes)."""
    mesh = _mesh_of(params)
    if mesh is not None and _any_packs([params["groups"],
                                        params.get("enc", {})]):
        from repro_torch.distributed.sharding import map_paths, place_tree
        return place_tree(pack_params(map_paths(
            lambda path, t: placed.plain(t), params), cfg), mesh)
    packed = dict(params)
    packed["groups"] = [_pack_tree(g, cfg.policy) for g in params["groups"]]
    if "enc" in params:
        packed["enc"] = _pack_tree(params["enc"], cfg.policy)
    return packed
