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

Decoding is greedy with a fixed per-request ``max_new_tokens``, so the
loop needs no per-token host sync: token columns stay on the device and
are copied to the host, all pending ones at once, when a request
finishes.

The engine books a scheduler per decode step (:meth:`bind_runtime`) with a
synthetic per-token command stream built from the model's projection GEMVs
through :func:`repro_torch.core.codegen.generate` — the barrel-controller
cycle model prices each step by active slots and precision.

Families: the dense SwiGLU stacks the port hosts. Everything else
(:func:`supports_continuous` is False) belongs on the static ``Server``
path, as in the reference.
"""

from __future__ import annotations

import collections
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
from repro_torch.kernels import bitserial_matmul, quantize_pack
from repro_torch.models.transformer import (ModelConfig, decode_step,
                                            init_caches, init_params,
                                            pack_params, prefill,
                                            serve_policy)
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.tracing import TraceContext, now_ns
from repro_torch.runtime.straggler import StragglerDetector

__all__ = ["ContinuousLMEngine", "supports_continuous", "decode_cost_stream"]


def supports_continuous(cfg: ModelConfig) -> bool:
    """Can the port run this arch's slot-arena decode loop? Dense SwiGLU
    stacks with full causal attention qualify. The reference also hosts
    MoE and MLA stacks; the port has not got them, and SSM/hybrid state,
    sliding-window caches and encoder inputs do not slot-insert in either."""
    if getattr(cfg, "family", None) != "dense":
        return False
    if getattr(cfg, "act", None) != "swiglu":
        return False
    if (getattr(cfg, "frontend", None) is not None
            or getattr(cfg, "global_attn_layers", None)):
        return False
    return getattr(cfg, "window", None) is None


def decode_cost_stream(cfg: ModelConfig):
    """A synthetic one-token command stream: every projection GEMV of one
    decode step of a dense stack, priced at the arch's serving precision.
    The scheduler books this per decode step with ``cycle_scale =
    n_active`` — slot booking in the barrel-controller cycle domain, per
    token rather than per request."""
    h, hkv, dh, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    layers: List[LinearLayer] = []
    for i in range(cfg.n_layers):
        p = f"l{i}."
        layers += [LinearLayer(p + "wq", d, h * dh),
                   LinearLayer(p + "wk", d, hkv * dh),
                   LinearLayer(p + "wv", d, hkv * dh),
                   LinearLayer(p + "wo", h * dh, d)]
        layers.append(LinearLayer(p + "w_up", d, cfg.d_ff))
        if cfg.act == "swiglu":
            layers.append(LinearLayer(p + "w_gate", d, cfg.d_ff))
        layers.append(LinearLayer(p + "w_down", cfg.d_ff, d))
    layers.append(LinearLayer("head", d, cfg.vocab_size))
    pol = cfg.policy
    bits = (pol.a_bits, pol.w_bits) if pol.mode != "none" else (8, 8)
    return generate_stream(layers, mode="pipelined",
                           a_bits=bits[0], w_bits=bits[1])


def _launch_counts() -> Dict[str, int]:
    """The kernel wrappers' launch counts: K1, K3 and K4."""
    mm = bitserial_matmul.KERNEL.entry_launches
    return {"K1": quantize_pack.KERNEL.launches,
            "K3": mm["bitserial_matmul_v2"], "K4": mm["bitserial_matmul_v1"]}


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
    random from ``seed`` there); float ones are packed once, and the head's
    float32 weight is cast to the compute dtype once, as in ``Server``.
    ``pack_acts`` selects K1 + K3 (True) or K4 (False); ``plain`` runs the
    kernels' plain versions (the yardstick). ``device=None`` means the
    card: it raises when there is none (pass ``device="cpu"`` for the plain
    versions, run eagerly).

    ``books_own_cycles`` tells a serving runtime not to book its scheduler
    per micro-batch: the engine books per decode step (:meth:`bind_runtime`).
    """

    books_own_cycles = True

    def __init__(self, cfg: ModelConfig, params=None, *,
                 batch_slots: int = 4, max_len: int = 64, seed: int = 0,
                 quantized: bool = True, pack_acts: bool = True,
                 plain: bool = False, device=None):
        cfg = serve_policy(cfg, pack_acts=pack_acts, plain=plain)
        if not supports_continuous(cfg):
            raise ValueError(
                f"{cfg.name}: family={cfg.family!r} cannot run the "
                "continuous slot arena (SSM/hybrid state, rolling windows, "
                "and encoder inputs don't slot-insert) — use the static "
                "Server path")
        if not quantized:
            raise NotImplementedError(
                "ContinuousLMEngine(quantized=False) runs the LSQ fake-quant "
                "forward, which waits for the LSQ straight-through estimator "
                "(not ported yet); serve the packed weights")
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            disable_tf32()
        self.cfg = cfg
        self.batch_slots = batch_slots
        self.max_len = max_len
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = init_params(gen, cfg)
        if params["embed"].device != self.device:
            raise ValueError(f"params lie on {params['embed'].device}, the "
                             f"engine on {self.device}")
        params = pack_params(params, cfg)
        params["head"] = dict(params["head"], w=params["head"]["w"].to(
            cfg.compute_dtype))
        self.params = params
        self.prompt_buckets = bucket_sizes(max_len)

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

    def _prefill_fn(self, prompt: np.ndarray):
        """Bucketed batch-1 prefill: the prompt right-padded to its bucket,
        logits gathered at its last token. Returns (greedy tok0 (1,) int32,
        batch-1 caches)."""
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
        logits, caches = prefill(self.params, {"tokens": tokens}, self.cfg,
                                 max_len=self.max_len, last_pos=last)
        return torch.argmax(logits, -1).to(torch.int32), caches

    def _insert_fn(self, pref, si: int, tok0: torch.Tensor,
                   start_pos: int) -> None:
        """Write a batch-1 prefill into arena row ``si`` in place (the
        captured step reads these very buffers) and mark the row active."""
        self._compile("insert", "row")
        self._call("insert")
        a = self._arena
        for g, p in zip(a["caches"], pref):
            g["k"][:, si].copy_(p["k"][:, 0])
            g["v"][:, si].copy_(p["v"][:, 0])
        a["tok"][si].copy_(tok0)
        a["pos"][si].fill_(start_pos)
        a["active"][si].fill_(True)

    def _step_fn(self) -> None:
        """One arena-wide decode step on the static buffers: per-row
        positions, active mask. Inactive rows keep their token and
        position; their cache writes land in rows the next insert
        overwrites. The body captured as the CUDA graph."""
        a = self._arena
        tok, pos, active = a["tok"], a["pos"], a["active"]
        logits, _ = decode_step(self.params, a["caches"], tok, pos, self.cfg)
        nxt = torch.argmax(logits, -1).to(torch.int32)[:, None]
        tok.copy_(torch.where(active[:, None], nxt, tok))
        pos.copy_(torch.where(active, pos + 1, pos))

    def _fresh_arena(self) -> None:
        """Allocate the arena's static buffers and, on the card, capture its
        decode step. Every slot starts empty (inactive)."""
        b, dev = self.batch_slots, self.device
        self._arena = {
            "caches": init_caches(self.cfg, b, self.max_len, device=dev),
            "tok": torch.zeros((b, 1), dtype=torch.int32, device=dev),
            "pos": torch.zeros((b,), dtype=torch.int32, device=dev),
            "active": torch.zeros((b,), dtype=torch.bool, device=dev),
        }
        self._compile("decode", (b, self.max_len))
        if dev.type != "cuda":
            self.step_launches = {k: 0 for k in _launch_counts()}
            return
        # one eager step on a side stream first: the kernels' modules load
        # and cuBLAS gets its workspace outside the capture. Every row is
        # inactive, so it changes no token or position.
        t0 = time.perf_counter()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._step_fn()
        torch.cuda.current_stream(dev).wait_stream(side)
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
    @torch.inference_mode()
    def serve(self, requests: Sequence) -> List:
        """Serve ``requests`` (GenRequest-shaped) through the slot arena;
        fills ``out_tokens`` per request and returns them in order."""
        self.validate(requests)
        t_enter = time.perf_counter()
        with self._lock:
            if self._arena is None:
                self._fresh_arena()
            active = self._arena["active"]
            slots: List[Optional[_Slot]] = [None] * self.batch_slots
            queue = collections.deque(requests)
            self._g_queue_peak.set_max(len(queue))
            cols: List[Optional[torch.Tensor]] = []  # (B,) per decode step
            host: List[np.ndarray] = []              # the columns pulled

            def finish(si: int) -> None:
                s = slots[si]
                if len(host) < len(cols):   # one copy for every pending col
                    pending = torch.stack(cols[len(host):]).cpu().numpy()
                    for t in range(len(host), len(cols)):
                        cols[t] = None
                    host.extend(pending)
                vals = [int(s.tok0.item())]
                vals += [int(host[t][si]) for t in range(s.start, len(cols))]
                s.req.out_tokens = vals
                self._c_tokens.inc(len(vals))
                self._c_completed.inc()
                self._latencies.append(time.perf_counter() - s.t0)
                active[si].fill_(False)
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
                # the step's buffer is overwritten by the next step
                cols.append(self._arena["tok"][:, 0].clone())
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
