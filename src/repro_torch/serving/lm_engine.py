"""Continuous-batching LM engine: token-granular serving over a slot arena.

Counterpart of ``repro/serving/lm_engine.py``. The static
:class:`~repro_torch.launch.serve.Server` decodes a whole batch to its
longest member's ``max_new_tokens``; this engine keeps one persistent
arena of ``batch_slots x max_len`` KV caches with per-slot cache positions
and an active-slot mask, and requests join and leave it at token
boundaries: a finished request frees its slot at once and the next queued
request is prefilled into it.

Fixed shapes keep the set of compiled steps closed, as the reference's jit
cache is:

* **prefill** right-pads each prompt to a power-of-two length bucket
  (:func:`~repro_torch.compiler.executor.bucket_sizes`) and gathers the
  next-token logits at the true last position
  (:func:`~repro_torch.models.transformer.prefill` with ``last_pos``);
* **insert** copies the batch-1 prefill caches, the first token and the
  start position into the arena's row, in place;
* **decode** advances every slot at its own depth
  (:func:`~repro_torch.models.transformer.decode_step` with a (B,) ``pos``
  tensor); the active mask freezes the token and position of empty or
  finished rows, whose cache writes land in rows that the next insert
  overwrites.

On the card the arena's decode step is one ``torch.cuda.CUDAGraph``,
captured once per arena (the counterpart of the reference's jitted step)
and replayed on every step; prefill and insert run eagerly. The graph
reads and writes static buffers — the caches, ``tok`` (B, 1) int32,
``pos`` (B,) int32 and ``active`` (B,) bool — which insert and leave
update in place, never rebinding them. ``tok`` is overwritten by every
step, so each step's column is cloned before the next one runs. On the
CPU the same step runs eagerly on the same buffers. There is no eager
option on the card: a capture that fails raises.

On a data x model mesh (``mesh=``, one rank a card) every rank holds its
planes (placed by :func:`~repro_torch.serving.placement.serving_params`,
as the sharded ``Server``'s), its rows of the arena (``tok``, ``pos``,
``active`` placed like a batch; the caches by ``cache_pspec``) and its
own graph of the same step, with the NCCL collectives captured inside;
every rank runs the same host loop on the same requests, so the
collectives meet. The batch-1 prefill is whole over the data axes (every
data group computes it) and insert copies its local shard into the rank
that holds the slot.

Decoding is greedy with a fixed per-request ``max_new_tokens``, so the
loop needs no per-token host sync: token columns stay on the device and
are copied to the host, all pending ones at once, when a request
finishes.

The engine books a scheduler per decode step (:meth:`bind_runtime`) with a
synthetic per-token command stream built from the model's projection GEMVs
through :func:`repro_torch.core.codegen.generate` — the barrel-controller
cycle model prices each step by active slots and precision.

Families: dense and MoE stacks (GQA or MLA attention), as in the
reference. An MoE layer's capacity counts the tokens of its call, so a
row's tokens can depend on the other rows of the arena (the reference's
dispatch); each step's ``drop_frac`` (the share of routed (token, expert)
pairs beyond capacity, per MoE layer) is kept on the device
(:meth:`ContinuousLMEngine.drop_fractions`). Everything else
(:func:`supports_continuous` is False) belongs on the static ``Server``
path, as in the reference.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.compiler.executor import bucket_for, bucket_sizes
from repro_torch.core.codegen import generate as generate_stream
from repro_torch.core.cost_model import LinearLayer
from repro_torch.core.pipeline_modules import disable_tf32
from repro_torch.distributed import placed
from repro_torch.distributed.sharding import batch_pspec, to_placements
from repro_torch.kernels import ops
from repro_torch.models.transformer import (ModelConfig, decode_step,
                                            init_caches, layer_groups,
                                            prefill, serve_policy)
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.tracing import TraceContext, now_ns
from repro_torch.runtime.straggler import StragglerDetector
from repro_torch.serving.placement import check_mesh, serving_params

__all__ = ["ContinuousLMEngine", "supports_continuous", "decode_cost_stream"]


def supports_continuous(cfg: ModelConfig) -> bool:
    """Can this arch run the slot-arena decode loop? Dense and MoE stacks
    (GQA or MLA, any MLP activation) with full causal attention qualify,
    as in the reference; SSM/hybrid state, sliding-window caches and a
    frontend's or an encoder's second input stream do not slot-insert in
    either."""
    if getattr(cfg, "family", None) not in ("dense", "moe"):
        return False
    if cfg.frontend is not None or cfg.global_attn_layers:
        return False
    return all(s.window is None for s in layer_groups(cfg))


def decode_cost_stream(cfg: ModelConfig):
    """A synthetic one-token command stream: every projection GEMV of one
    decode step, priced at the arch's serving precision (an MoE layer
    counts its active experts: top_k routed plus the shared ones). The
    scheduler books this per decode step with ``cycle_scale = n_active``
    — slot booking in the barrel-controller cycle domain, per token
    rather than per request."""
    h, hkv, dh, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    layers: List[LinearLayer] = []
    for i in range(cfg.n_layers):
        p = f"l{i}."
        if cfg.mla:
            dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
            layers += [LinearLayer(p + "wq", d, h * (dn + dr)),
                       LinearLayer(p + "w_dkv", d, cfg.kv_lora + dr),
                       LinearLayer(p + "wo", h * dv, d)]
        else:
            layers += [LinearLayer(p + "wq", d, h * dh),
                       LinearLayer(p + "wk", d, hkv * dh),
                       LinearLayer(p + "wv", d, hkv * dh),
                       LinearLayer(p + "wo", h * dh, d)]
        if cfg.family == "moe" and i >= cfg.n_dense_layers and cfg.n_experts:
            d_ff = cfg.d_ff_expert * (cfg.top_k + cfg.n_shared_experts)
        else:
            d_ff = cfg.d_ff
        layers.append(LinearLayer(p + "w_up", d, d_ff))
        if cfg.act == "swiglu":
            layers.append(LinearLayer(p + "w_gate", d, d_ff))
        layers.append(LinearLayer(p + "w_down", d_ff, d))
    layers.append(LinearLayer("head", d, cfg.vocab_size))
    pol = cfg.policy
    bits = (pol.a_bits, pol.w_bits) if pol.mode != "none" else (8, 8)
    return generate_stream(layers, mode="pipelined",
                           a_bits=bits[0], w_bits=bits[1])


def _launch_counts() -> Dict[str, int]:
    """The kernel wrappers' launch counts the LM makes: K1, K3, K4 and
    grouped K4 (``K4g``, the routed experts)."""
    return {k: v for k, v in ops.launch_counts().items() if k != "K2"}


def _local(t):
    """A placed tensor's local shard (the storage the step writes), a
    plain one as it is."""
    return t.to_local() if placed.is_placed(t) else t


class _Slot:
    """One occupied arena row: the request, its remaining token budget, its
    first (prefill) token on the device, and the index of the first decode
    column it takes part in."""

    __slots__ = ("req", "remaining", "tok0", "start", "t0")

    def __init__(self, req, remaining, tok0, start, t0):
        self.req = req
        self.remaining = remaining
        self.tok0 = tok0
        self.start = start
        self.t0 = t0


class ContinuousLMEngine:
    """Token-granular continuous batching over a persistent slot arena.

    ``engine(requests)`` serves a list of
    :class:`~repro_torch.launch.serve.GenRequest`-shaped objects (fields
    ``prompt``, ``max_new_tokens``, ``out_tokens``) in order. Arena state
    persists across calls, so steady traffic compiles nothing new:
    :meth:`stats` counts the first sight of each step's signature (a
    prefill bucket, the insert, the decode step's capture) to prove it.

    ``params``: float or packed parameters on the engine's device (default:
    random from ``seed`` there, drawn and packed one layer at a time when
    ``quantized``); float ones are packed once when ``quantized``, and
    with ``quantized=False`` they are served as they are through the LSQ
    fake-quant forward (the reference's float branch; on the card that
    step is captured as a CUDA graph too). The head's
    float32 weight is cast to the compute dtype once, as in ``Server``.
    ``pack_acts`` selects K1 + K3 (True) or K4 (False); ``plain`` runs the
    kernels' plain versions (the yardstick). ``device=None`` means the
    card: it raises when there is none (pass ``device="cpu"`` for the plain
    versions, run eagerly).

    ``mesh`` (a ``DeviceMesh`` with the reference's axis names, this
    process one of its ranks) serves the packed model sharded over it, as
    ``Server(mesh=)`` does (float serving, a mesh of another device type
    and ``batch_slots`` that do not divide over the DP axes raise); the
    decode step is ``decode_step`` with the placed (B,) ``pos``, captured
    on the card as one graph a rank.

    ``books_own_cycles`` tells a serving runtime not to book its scheduler
    per micro-batch: the engine books per decode step (:meth:`bind_runtime`).
    """

    books_own_cycles = True

    def __init__(self, cfg: ModelConfig, params=None, *,
                 batch_slots: int = 4, max_len: int = 64, seed: int = 0,
                 quantized: bool = True, pack_acts: bool = True,
                 plain: bool = False, device=None, mesh=None):
        cfg = serve_policy(cfg, pack_acts=pack_acts, plain=plain)
        if not supports_continuous(cfg):
            raise ValueError(
                f"{cfg.name}: family={cfg.family!r} cannot run the "
                "continuous slot arena (SSM/hybrid state, rolling windows, "
                "and encoder inputs don't slot-insert) — use the static "
                "Server path")
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            disable_tf32()
        self.cfg = cfg
        self.batch_slots = batch_slots
        self.max_len = max_len
        self.mesh = mesh
        if mesh is not None:
            check_mesh(mesh, self.device, quantized, batch_slots)
        self.params = serving_params(cfg, params, device=self.device,
                                     seed=seed, quantized=quantized,
                                     mesh=mesh)
        self.prompt_buckets = bucket_sizes(max_len)
        self._n_moe = sum(g.n for g in layer_groups(cfg) if g.use_moe)

        # first-sight counters: a new prefill bucket, the insert, the
        # decode step's capture; steady-state serving keeps them flat —
        # the zero-recompile assertion the tests gate on
        self.compiles: collections.Counter = collections.Counter()
        self.calls: collections.Counter = collections.Counter()
        self.warmup_compiles: Optional[int] = None
        self._seen: Dict[str, set] = collections.defaultdict(set)

        # registry backing the serving counters (engine_metrics() reads it)
        self.metrics_registry = MetricsRegistry()
        m = self.metrics_registry
        self._c_compiles = m.counter("lm_jit_compiles_total",
                                     "first sights of a step signature")
        self._c_calls = m.counter("lm_jit_calls_total", "step calls")
        self._c_tokens = m.counter("lm_tokens_out_total",
                                   "tokens produced")
        self._c_completed = m.counter("lm_completed_total",
                                      "requests finished")
        self._c_inserts = m.counter("lm_prefill_inserts_total",
                                    "prompts prefilled into the arena")
        self._c_steps = m.counter("lm_decode_steps_total",
                                  "arena-wide decode steps")
        self._c_slot_steps = m.counter("lm_occupied_slot_steps_total",
                                       "active slots summed over steps")
        self._c_busy = m.counter("lm_busy_seconds_total",
                                 "wall seconds inside serve()")
        self._c_step_wall = m.counter(
            "lm_step_wall_seconds_total",
            "measured wall seconds summed over arena decode steps")
        self._g_queue_peak = m.gauge("lm_queue_peak",
                                     "engine-queue high-water mark")

        # per-decode-step anomaly detection, at step granularity
        self.step_straggler = StragglerDetector(window=64)
        self._step_seq = 0

        # the arena (static buffers) and, on the card, its captured step;
        # made at the first serve()
        self._arena: Optional[dict] = None
        self._graph = None
        #: kernel launches made while capturing one decode step (the
        #: wrappers count Python calls, so a replay adds nothing to them)
        self.step_launches: Optional[Dict[str, int]] = None
        #: host seconds of the eager warm-up step and the capture
        self.capture_seconds: Optional[float] = None
        self._lock = threading.Lock()

        # scheduler hook (bind_runtime): book cycles per decode step
        self._scheduler = None
        self._sched_key = None
        self._tracer = None
        self._trace_ctx = None
        self.step_stream = decode_cost_stream(cfg)

        # serving metrics (reset by warmup so it doesn't count)
        self._reset_serving_metrics()

    # ------------------------------------------------------------- plumbing
    def _call(self, name: str) -> None:
        self.calls[name] += 1
        self._c_calls.inc(fn=name)

    def _compile(self, name: str, signature) -> None:
        """Count the first sight of step ``name`` at ``signature``: a new
        prefill bucket, the insert, the decode step's capture."""
        if signature not in self._seen[name]:
            self._seen[name].add(signature)
            self.compiles[name] += 1
            self._c_compiles.inc(fn=name)

    @contextlib.contextmanager
    def _context(self):
        """Every step's context: inference mode, or on a mesh ``no_grad``
        inside :func:`~repro_torch.distributed.placed.mesh_context`, as
        the sharded ``Server`` steps (DTensor cannot make views of params
        made outside inference mode inside it)."""
        if self.mesh is None:
            with torch.inference_mode():
                yield
        else:
            with torch.no_grad(), placed.mesh_context(self.mesh):
                yield

    def _placed(self, t: torch.Tensor):
        """``t`` (B, ...), whole on every rank, placed like a batch
        (``batch_pspec``; a batch of one stays whole), each rank keeping
        its rows; as it is off a mesh."""
        if self.mesh is None:
            return t
        from torch.distributed.tensor import distribute_tensor
        return distribute_tensor(t, self.mesh, to_placements(
            batch_pspec(tuple(t.shape), self.mesh), self.mesh),
            src_data_rank=None)

    def _whole_rows(self, cols: torch.Tensor) -> torch.Tensor:
        """(steps, B): token columns of every row from this rank's (steps,
        B_local) ones; on a mesh the ranks' rows are gathered (every rank
        calls it at the same point of the same host loop)."""
        if self.mesh is None:
            return cols
        from torch.distributed.tensor import DTensor, Replicate, Shard
        rows = [Shard(1) if i in self._arena["rows_on"] else Replicate()
                for i in range(self.mesh.ndim)]
        shape = (cols.shape[0], self.batch_slots)
        return DTensor.from_local(cols, self.mesh, rows,
                                  shape=torch.Size(shape),
                                  stride=placed.contiguous_stride(shape)
                                  ).full_tensor()

    def _prefill_fn(self, prompt: np.ndarray):
        """Bucketed batch-1 prefill: the prompt right-padded to its bucket,
        logits gathered at its last token. Returns (greedy tok0 (1,) int32,
        batch-1 caches). On a mesh the batch of one is whole over the DP
        axes, so every data group computes it, its caches placed over
        ``model`` as the arena's are; tok0 is then this rank's (whole)
        copy."""
        n = len(prompt)
        sb = bucket_for(n, self.max_len)
        self._compile("prefill", sb)
        self._call("prefill")
        padded = np.zeros((1, sb), np.int64)
        padded[0, :n] = prompt
        tokens = torch.from_numpy(padded)
        if self.device.type == "cuda":
            # pinned and asynchronous: the host does not wait for the steps
            # already queued
            tokens = tokens.pin_memory().to(self.device, non_blocking=True)
        last = torch.full((1,), n - 1, dtype=torch.int64, device=self.device)
        logits, caches = prefill(self.params,
                                 {"tokens": self._placed(tokens)}, self.cfg,
                                 max_len=self.max_len,
                                 last_pos=self._placed(last))
        tok0 = torch.argmax(logits, -1).to(torch.int32)
        return (tok0.to_local() if placed.is_placed(tok0) else tok0), caches

    def _insert_fn(self, pref, si: int, tok0: torch.Tensor,
                   start_pos: int) -> None:
        """Write a batch-1 prefill into arena row ``si`` in place (the
        captured step reads these very buffers) and mark the row active.
        On a mesh only the ranks whose rows hold slot ``si`` copy, each
        its local shard (the prefill's caches lie over ``model`` as the
        arena's do); no collective."""
        self._compile("insert", "row")
        self._call("insert")
        a = self._arena
        r = self._own_row(si)
        if r is None:
            return
        for g, p in zip(a["caches"], pref):
            for name, buf in g.items():
                if name != "len":   # k/v, or MLA's c/k_rope
                    _local(buf)[:, r].copy_(_local(p[name])[:, 0])
        a["tok_l"][r].copy_(tok0)
        a["pos_l"][r].fill_(start_pos)
        a["active_l"][r].fill_(True)

    def _own_row(self, si: int) -> Optional[int]:
        """Slot ``si``'s row in this rank's shard of the arena, or None
        when another rank's rows hold it."""
        r = si - self._arena["row0"]
        return r if 0 <= r < self._arena["rows"] else None

    def _step_fn(self) -> None:
        """One arena-wide decode step on the static buffers: per-row
        positions, active mask. Inactive rows keep their token and
        position; their cache writes land in rows the next insert
        overwrites. The body captured as the CUDA graph. On a mesh the
        step reads the placed ``tok``/``pos`` and each rank writes its own
        rows (the greedy argmax over the logits, whole over the
        vocabulary)."""
        a = self._arena
        tok_l, pos_l, active_l = a["tok_l"], a["pos_l"], a["active_l"]
        aux = {}
        logits, _ = decode_step(self.params, a["caches"], a["tok"],
                                a["pos"], self.cfg, aux=aux)
        nxt = _local(torch.argmax(logits, -1).to(torch.int32))[:, None]
        tok_l.copy_(torch.where(active_l[:, None], nxt, tok_l))
        pos_l.copy_(torch.where(active_l, pos_l + 1, pos_l))
        if "drop_frac" in aux:
            a["drop_frac"].copy_(_local(aux["drop_frac"]))

    def _fresh_arena(self) -> None:
        """Allocate the arena's static buffers and, on the card, capture its
        decode step. Every slot starts empty (inactive). On a mesh the
        caches are placed by ``cache_pspec`` and ``tok``/``pos``/``active``
        like the batch (``batch_pspec``): each rank holds its rows, and
        the ``*_l`` entries are its local shards, which the captured step
        and insert write in place (never rebound)."""
        b, dev = self.batch_slots, self.device
        self._arena = {
            "caches": init_caches(self.cfg, b, self.max_len, device=dev,
                                  mesh=self.mesh),
            "tok": self._placed(torch.zeros((b, 1), dtype=torch.int32,
                                            device=dev)),
            "pos": self._placed(torch.zeros((b,), dtype=torch.int32,
                                            device=dev)),
            "active": self._placed(torch.zeros((b,), dtype=torch.bool,
                                               device=dev)),
            "drop_frac": torch.zeros((self._n_moe,), dtype=torch.float32,
                                     device=dev),
        }
        a = self._arena
        for name in ("tok", "pos", "active"):
            a[name + "_l"] = _local(a[name])
        a["rows_on"], a["row0"], a["rows"] = [], 0, b
        if self.mesh is not None:
            a["rows_on"] = [i for i, p in enumerate(a["pos"].placements)
                            if p.is_shard(0)]
            a["row0"], a["rows"] = placed.mesh_offset(
                self.mesh, a["pos"].placements, 0, b)
        self._compile("decode", (b, self.max_len))
        if dev.type != "cuda":
            self.step_launches = {k: 0 for k in _launch_counts()}
            return
        # one eager step on a side stream first: the kernels' modules load
        # and cuBLAS gets its workspace outside the capture; on a mesh it
        # also makes the NCCL communicators and runs their first
        # collectives, which a capture cannot. Every row is inactive, so
        # it changes no token or position.
        t0 = time.perf_counter()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._step_fn()
        torch.cuda.current_stream(dev).wait_stream(side)
        # On a mesh every rank captures the same step, so the same
        # collectives in the same order; the default ("global") capture
        # mode holds for them (torch 2.11, NCCL 2.28, four H100s;
        # "relaxed" too): ProcessGroupNCCL hands its watchdog no work
        # issued while its stream captures. The synchronize first lets the
        # watchdog retire the warm-up's collectives before the capture.
        torch.cuda.synchronize(dev)
        graph = torch.cuda.CUDAGraph()
        before = _launch_counts()
        with torch.cuda.graph(graph):
            self._step_fn()
        after = _launch_counts()
        torch.cuda.synchronize(dev)
        self.capture_seconds = time.perf_counter() - t0
        self.step_launches = {k: after[k] - before[k] for k in after}
        self._graph = graph

    def _run_step(self) -> None:
        if self._graph is not None:
            self._graph.replay()
        else:
            self._step_fn()

    def _reset_serving_metrics(self):
        for c in (self._c_tokens, self._c_completed, self._c_inserts,
                  self._c_steps, self._c_slot_steps, self._c_busy,
                  self._c_step_wall, self._g_queue_peak):
            c.clear()
        self._latencies = collections.deque(maxlen=4096)
        # per decode step: the MoE layers' drop_frac, on the device
        self._drops = collections.deque(maxlen=4096)
        # (booked est_cycles, measured wall ns) per decode step — the LM
        # path's calibration samples; unfenced like the straggler
        # observations, so the hot loop stays free of host syncs
        self._step_samples = collections.deque(maxlen=2048)

    # legacy attribute surface, registry-backed
    @property
    def tokens_out(self) -> int:
        return int(self._c_tokens.value())

    @property
    def completed(self) -> int:
        return int(self._c_completed.value())

    @property
    def prefill_inserts(self) -> int:
        return int(self._c_inserts.value())

    @property
    def decode_steps(self) -> int:
        return int(self._c_steps.value())

    @property
    def occupied_slot_steps(self) -> int:
        return int(self._c_slot_steps.value())

    @property
    def queue_peak(self) -> int:
        return int(self._g_queue_peak.value())

    @property
    def busy_seconds(self) -> float:
        return self._c_busy.value()

    @property
    def step_wall_seconds(self) -> float:
        return self._c_step_wall.value()

    def drop_fractions(self) -> Optional[np.ndarray]:
        """(steps, n_moe_layers): each decode step's share of routed
        (token, expert) pairs beyond capacity per MoE layer, every row of
        the arena counted (empty rows route too), since the last
        warmup/reset; None for a dense stack. One host copy."""
        if not self._n_moe:
            return None
        if not self._drops:
            return np.zeros((0, self._n_moe), np.float32)
        return torch.stack(list(self._drops)).cpu().numpy()

    def wall_samples(self) -> List[tuple]:
        """(booked est_cycles, measured wall ns) per decode step since the
        last warmup/reset — the LM path's calibration input. Samples only
        accumulate with a scheduler bound (no admission, no cycle booking
        to calibrate against)."""
        return list(self._step_samples)

    # ------------------------------------------------------------- runtime
    def bind_runtime(self, scheduler, key, *, tracer=None) -> None:
        """Book ``scheduler`` per decode step (``admit(key, n_active,
        stream=...)`` then ``complete``; idempotent). ``tracer`` makes the
        engine emit one span per arena decode step (wall + booked cycles)
        on the ``lm-decode`` track."""
        self._scheduler = scheduler
        self._sched_key = key
        if tracer is not None:
            self._tracer = tracer
            # trace_id 0 = tracker spans (not tied to one request); always
            # sampled — the decode loop is one track, not per-request
            self._trace_ctx = TraceContext(0, True, 0, tracer)

    def validate(self, requests: Sequence) -> None:
        for i, r in enumerate(requests):
            if len(r.prompt) == 0:
                raise ValueError(f"request {i}: empty prompt")
            if r.max_new_tokens < 0:
                raise ValueError(f"request {i}: max_new_tokens="
                                 f"{r.max_new_tokens} < 0")
            need = len(r.prompt) + r.max_new_tokens
            if need > self.max_len:
                raise ValueError(
                    f"request {i}: len(prompt)={len(r.prompt)} + "
                    f"max_new_tokens={r.max_new_tokens} = {need} exceeds "
                    f"the KV budget max_len={self.max_len}")

    # -------------------------------------------------------------- serving
    def serve(self, requests: Sequence) -> List:
        """Serve ``requests`` (GenRequest-shaped) through the slot arena;
        fills ``out_tokens`` per request and returns them in order. On a
        mesh every rank serves the same requests in the same order (the
        host loop depends on their lengths alone), and every rank's
        requests get every token."""
        self.validate(requests)
        t_enter = time.perf_counter()
        with self._lock, self._context():
            if self._arena is None:
                self._fresh_arena()
            active = self._arena["active_l"]
            slots: List[Optional[_Slot]] = [None] * self.batch_slots
            queue = collections.deque(requests)
            self._g_queue_peak.set_max(len(queue))
            cols: List[Optional[torch.Tensor]] = []  # (B,) per decode step
            host: List[np.ndarray] = []              # the columns pulled

            def finish(si: int) -> None:
                s = slots[si]
                if len(host) < len(cols):   # one copy for every pending col
                    pending = self._whole_rows(torch.stack(
                        cols[len(host):])).cpu().numpy()
                    for t in range(len(host), len(cols)):
                        cols[t] = None
                    host.extend(pending)
                vals = [int(s.tok0.item())]
                vals += [int(host[t][si]) for t in range(s.start, len(cols))]
                s.req.out_tokens = vals
                self._c_tokens.inc(len(vals))
                self._c_completed.inc()
                self._latencies.append(time.perf_counter() - s.t0)
                r = self._own_row(si)
                if r is not None:
                    active[r].fill_(False)
                slots[si] = None

            while queue or any(s is not None for s in slots):
                # join: prefill queued requests into free slots (a slot
                # freed by a 1-token request re-fills in the same pass)
                for si in range(self.batch_slots):
                    while slots[si] is None and queue:
                        r = queue.popleft()
                        if r.max_new_tokens == 0:
                            r.out_tokens = []
                            self._c_completed.inc()
                            self._latencies.append(0.0)
                            continue
                        tok0, pref = self._prefill_fn(
                            np.asarray(r.prompt))
                        self._insert_fn(pref, si, tok0, len(r.prompt))
                        self._c_inserts.inc()
                        slots[si] = _Slot(r, r.max_new_tokens - 1, tok0,
                                          len(cols), time.perf_counter())
                        if slots[si].remaining == 0:
                            finish(si)   # leaves at this token boundary
                n_active = sum(s is not None for s in slots)
                if n_active == 0:
                    continue
                # book this decode step on the MVU slots (per *step*, not
                # per request: n_active tokens at the arch's precision)
                st0 = time.perf_counter()
                st0_ns = now_ns()
                adm = None
                if self._scheduler is not None:
                    adm = self._scheduler.admit(self._sched_key, n_active,
                                                stream=self.step_stream)
                    if adm is not None:
                        self._scheduler.complete(adm, adm.est_seconds)
                self._call("decode")
                self._run_step()
                # the step's buffers are overwritten by the next step
                cols.append(self._arena["tok_l"][:, 0].clone())
                if self._n_moe:
                    self._drops.append(self._arena["drop_frac"].clone())
                self._c_steps.inc()
                self._c_slot_steps.inc(n_active)
                self._step_seq += 1
                # per-step anomaly detection + (if bound) one span per
                # arena step: wall ns here, booked cycles from admission
                step_dt = time.perf_counter() - st0
                self.step_straggler.observe(self._step_seq, step_dt)
                self._c_step_wall.inc(step_dt)
                if adm is not None:
                    self._step_samples.append(
                        (adm.est_cycles, step_dt * 1e9))
                if self._tracer is not None and self._tracer.enabled:
                    self._tracer.span(
                        self._trace_ctx, "decode_step", st0_ns, now_ns(),
                        track="lm-decode",
                        cycle_start=(adm.start_cycle if adm is not None
                                     else None),
                        cycle_end=(adm.finish_cycle if adm is not None
                                   else None),
                        n_active=n_active)
                # leave: finished rows free their slot at this boundary
                for si, s in enumerate(slots):
                    if s is None:
                        continue
                    s.remaining -= 1
                    if s.remaining == 0:
                        finish(si)
            self._c_busy.inc(time.perf_counter() - t_enter)
        return list(requests)

    __call__ = serve

    # -------------------------------------------------------------- warmup
    def warmup(self) -> dict:
        """Compile the closed signature set: one prefill per prompt bucket,
        the slot insert and the arena decode step (captured on the card).
        Serving metrics reset afterwards, so warmup traffic never counts."""
        t0 = time.perf_counter()

        class _Warm:
            def __init__(self, prompt, n):
                self.prompt = prompt
                self.max_new_tokens = n
                self.out_tokens = None

        warmed = []
        for b in self.prompt_buckets:
            n_prompt = max(1, min(b, self.max_len - 2))
            if bucket_for(n_prompt, self.max_len) != b:
                continue   # tiny max_len: top bucket unreachable
            self.serve([_Warm(np.zeros(n_prompt, np.int32),
                              min(2, self.max_len - n_prompt))])
            warmed.append(b)
        self._reset_serving_metrics()
        self.warmup_compiles = sum(self.compiles.values())
        return {"buckets": warmed, "compiles": self.warmup_compiles,
                "seconds": round(time.perf_counter() - t0, 3)}

    # -------------------------------------------------------------- metrics
    def stats(self) -> dict:
        total = sum(self.compiles.values())
        after = (total - self.warmup_compiles
                 if self.warmup_compiles is not None else None)
        return {"compiles": dict(self.compiles),
                "calls": dict(self.calls),
                "total_compiles": total,
                "recompiles_after_warmup": after,
                "mesh": (None if self.mesh is None else
                         dict(zip(self.mesh.mesh_dim_names,
                                  self.mesh.mesh.shape))),
                "cuda_graph": self._graph is not None,
                "step_launches": self.step_launches,
                "capture_seconds": self.capture_seconds,
                "straggler": self.step_straggler.snapshot()}

    def _observed_ns_per_cycle(self):
        cyc = sum(c for c, _ in self._step_samples)
        if cyc <= 0:
            return None
        return round(sum(w for _, w in self._step_samples) / cyc, 4)

    def engine_metrics(self) -> dict:
        lat = sorted(self._latencies)

        def pct(p):
            if not lat:
                return 0.0
            return round(lat[min(len(lat) - 1,
                                 int(p / 100 * len(lat)))] * 1e3, 3)

        occ = (self.occupied_slot_steps
               / max(1, self.decode_steps * self.batch_slots))
        return {
            "batch_slots": self.batch_slots,
            "max_len": self.max_len,
            "completed": self.completed,
            "tokens_out": self.tokens_out,
            "tokens_per_s": (round(self.tokens_out / self.busy_seconds, 1)
                             if self.busy_seconds else 0.0),
            "decode_steps": self.decode_steps,
            "prefill_inserts": self.prefill_inserts,
            "step_wall_seconds": round(self.step_wall_seconds, 6),
            "observed_ns_per_cycle": self._observed_ns_per_cycle(),
            "slot_occupancy": round(occ, 4),
            "queue_peak": self.queue_peak,
            "latency_p50_ms": pct(50),
            "latency_p99_ms": pct(99),
            "jit": self.stats(),
        }
