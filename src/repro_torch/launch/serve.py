"""Serving on the port: the quantized LM (:class:`Server`, batched greedy
generation with KV caches) and the compiled CNN (:class:`CNNServer`).

Counterpart of ``Server``, ``GenRequest``, ``make_lm_engine``,
``CNNServer`` and the CLI in ``repro/launch/serve.py``. The LM's weights run
through the bit-serial kernels: with ``pack_acts`` (the default) every
projection quantizes and packs its activations with K1 and multiplies with
K3, otherwise it multiplies int32 codes with K4; an MoE stack's routed
experts multiply int32 codes with grouped K4 (one launch for all experts
of a projection) either way. Dense (stablelm-1.6b, qwen1.5-110b with
q/k/v biases, command-r-plus-104b, nemotron-4-15b with a squared-ReLU
MLP), MoE (deepseek-v2-lite-16b with MLA, qwen3-moe-235b-a22b), SSM
(mamba2-780m), hybrid (hymba-1.5b) and VLM (internvl2-76b, text-only
through ``generate``, as the reference's) stacks are served by
:class:`Server`; the continuous engine takes the dense and MoE ones. An
encoder-decoder (seamless-m4t-large-v2) needs a source that ``generate``
does not feed: :class:`Server` raises, and it is served by
:func:`~repro_torch.models.transformer.prefill` and ``decode_step`` with
``src_embeds``.

Both paths serve through the serving runtime (:mod:`repro_torch.serving`),
as the reference's do:

* :class:`CNNServer` registers its graph in a
  :class:`~repro_torch.serving.ModelRegistry` (compiled on first use, onto
  the card) and classifies per image through the dynamic-batching
  :class:`~repro_torch.serving.InferenceService`, which books every batch
  on the :class:`~repro_torch.serving.SlotScheduler` (the barrel
  controller's cycle domain) and runs it through a
  :class:`~repro_torch.compiler.executor.BucketedRunner` — on the card one
  CUDA graph per padding bucket (K1 and K2 inside);
* the CLI registers the continuous-batching
  :class:`~repro_torch.serving.ContinuousLMEngine` (K1 + K3, its decode
  step one CUDA graph on the card) as a callable and submits its mixed
  load of ``max(batch x 4, 8)`` requests through the same service; the
  engine books the scheduler per decode step. An SSM, hybrid or VLM arch
  does not fit the engine's slot arena: the CLI says so and serves
  ``batch`` 8-token prompts through the static :class:`Server`, as the
  reference's CLI does; for an encoder-decoder it exits with the reason.

    python -m repro_torch.launch.serve --arch stablelm-1.6b --batch 4 --new-tokens 16
    python -m repro_torch.launch.serve --arch stablelm-1.6b --device cpu --smoke [--no-pack-acts]
    python -m repro_torch.launch.serve --arch deepseek-v2-lite-16b [--device cpu --smoke]
    python -m repro_torch.launch.serve --arch mamba2-780m [--device cpu --smoke]
    python -m repro_torch.launch.serve --arch hymba-1.5b [--device cpu --smoke]
    python -m repro_torch.launch.serve --arch qwen1.5-110b --device cpu --smoke
    python -m repro_torch.launch.serve --arch internvl2-76b --device cpu --smoke
    python -m repro_torch.launch.serve --arch stablelm-1.6b --smoke --device cpu --model-par 2 [--data-par 2]
    python -m repro_torch.launch.serve --arch hymba-1.5b --smoke --device cpu --model-par 4   # windows' slots split
    python -m repro_torch.launch.serve --arch qwen1.5-110b --model-par 4   # one rank a card
    python -m repro_torch.launch.serve --arch qwen3-moe-235b-a22b --model-par 4   # 32 experts a card
    python -m repro_torch.launch.serve --arch resnet9-cifar10 --batch 32 [--trace-out trace.json]
    python -m repro_torch.launch.serve --arch resnet9-cifar10 --batch 4 --device cpu
    python -m repro_torch.launch.serve --arch resnet9-cifar10 --store DIR
    python -m repro_torch.launch.serve trace trace.json [--top-k 10]
    python -m repro_torch.launch.serve compile --arch resnet9-cifar10 --store DIR [--precisions W2A2,W2A8] [--gc | --gc-dry-run]
    python -m repro_torch.launch.serve profile --store DIR [--precision w2a2] [--batch 32] [--trace-out measured.json]

``--trace-out PATH`` writes the run's request trace as Chrome trace JSON
(the ``trace`` subcommand summarizes it), ``--metrics-port PORT`` serves
Prometheus text on ``127.0.0.1:PORT/metrics`` for the run, and
``--metrics-every S`` prints a one-line metrics snapshot every S seconds.
``--store DIR`` warm-boots the CNN from an artifact store (compiling and
saving on a miss). ``--data-par``/``--model-par`` (LM; every family but
the encoder-decoder, which the CLI does not serve) serve the packed model
sharded over a (data, model) mesh: the CLI starts one rank a card (gloo
ranks with ``--device cpu``); each builds a
:class:`~repro_torch.serving.ContinuousLMEngine` with ``mesh=`` and
serves the mixed load (its decode step one CUDA graph a rank, the NCCL
collectives inside), or, for an arch the engine does not take, a
:class:`Server` with ``mesh=`` serving ``batch`` 8-token prompts
(``batch`` must divide over ``data``); rank 0 prints.
``compile`` is the offline code-generator run: graph →
passes → calibration → packing → artifact store. ``profile`` times the
compiled Program step by step on the device (CUDA events on the card)
beside the cycle model's prediction, fits ns per virtual cycle and, with
``--store``, persists the fit.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import threading
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_arch, list_archs
from repro_torch.core.pipeline_modules import disable_tf32
from repro_torch.distributed import placed
from repro_torch.distributed.sharding import batch_pspec, to_placements
from repro_torch.models.layers import QuantPolicy
from repro_torch.models.resnet import ResNet9Config, resnet9_graph, resnet9_init
from repro_torch.models.transformer import (ModelConfig, decode_step,
                                            prefill, serve_policy)
from repro_torch.obs import (format_trace_summary, start_metrics_server,
                             trace_summary, write_chrome_trace)
from repro_torch.serving import (ContinuousLMEngine, InferenceService,
                                 ModelRegistry, supports_continuous)
from repro_torch.serving.placement import check_mesh, serving_params

__all__ = ["GenRequest", "Server", "make_lm_engine", "CNNServer", "main"]

CNN_ARCH = "resnet9-cifar10"
LM_MAX_LEN = 64   # the CLI's KV budget, as the reference's


class _ObsSession:
    """``--trace-out`` / ``--metrics-port`` / ``--metrics-every`` wiring
    for one run, plus the single console writer.

    Every output line — the run's own prints *and* the periodic metrics
    dump — goes through :meth:`emit` under one lock, so the dump thread
    can never tear a line mid-print."""

    def __init__(self, service, *, trace_out: Optional[str] = None,
                 metrics_port: Optional[int] = None,
                 metrics_every: float = 0.0):
        self.service = service
        self.trace_out = trace_out
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._http = None
        self._dumper = None
        if metrics_port is not None:
            self._http = start_metrics_server(metrics_port,
                                              service.registries)
            port = self._http.server.server_address[1]
            self.emit(f"metrics: serving Prometheus text on "
                      f"http://127.0.0.1:{port}/metrics")
        if metrics_every and metrics_every > 0:
            self._dumper = threading.Thread(
                target=self._dump_loop, args=(float(metrics_every),),
                name="metrics-dump", daemon=True)
            self._dumper.start()

    def emit(self, *lines) -> None:
        """The single writer: one locked print per call."""
        with self._lock:
            print("\n".join(str(l) for l in lines), flush=True)

    def _dump_loop(self, every: float) -> None:
        while not self._stop.wait(every):
            m = self.service.metrics()
            self.emit(f"[metrics] completed={m['completed']} "
                      f"failed={m['failed']} requeues={m['requeues']} "
                      f"queue={m['queue_depth']} "
                      f"p50={m['latency_p50_ms']}ms "
                      f"p99={m['latency_p99_ms']}ms")

    def close(self) -> None:
        self._stop.set()
        if self._dumper is not None:
            self._dumper.join(timeout=5)
        if self._http is not None:
            self._http.server.shutdown()
            self._http.server.server_close()
        if self.trace_out:
            path = write_chrome_trace(self.service.tracer, self.trace_out)
            st = self.service.tracer.stats()
            self.emit(f"trace: {st['buffered']} spans "
                      f"({st['sampled']}/{st['started']} requests sampled) "
                      f"-> {path}",
                      "       load it in https://ui.perfetto.dev or run "
                      f"`python -m repro_torch.launch.serve trace {path}`")


@dataclasses.dataclass
class GenRequest:
    prompt: np.ndarray          # (S,) int32
    max_new_tokens: int = 16
    out_tokens: Optional[List[int]] = None


class Server:
    """Static-batch LM server, greedy decoding, over the quantized
    (bit-transposed) deployment path or, with ``quantized=False``, the
    float params through the LSQ fake-quant forward (mode ``qat``), as the
    reference serves them.

    ``params``: float or packed parameters on the server's device (default:
    random from ``seed`` on that device, drawn and packed one layer at a
    time when ``quantized``); float ones are packed once when
    ``quantized``. The
    head's float32 weight (a tied model's: the embedding, whose float32
    copy the lookup keeps) is cast to the compute dtype once here, where
    the reference casts it at every call — the same numbers. ``pack_acts``
    selects K1 + K3 (True) or K4 (False); ``plain`` runs the kernels'
    plain versions (the yardstick). ``device=None`` means the card: it
    raises when there is none (pass ``device="cpu"`` for the plain
    versions).

    ``mesh`` (a ``DeviceMesh`` with the reference's axis names, from
    ``launch/mesh.make_local_mesh``; this process one of its ranks)
    serves the packed model sharded over it: the params placed by
    ``param_pspec`` (whole ones given are split, each rank keeping its
    shard; none given are drawn placed), the caches by ``cache_pspec``,
    the prompts' rows by ``batch_pspec`` (``batch_slots`` must divide
    over the DP axes), every step under
    :func:`~repro_torch.distributed.placed.mesh_context`. Each rank runs
    K1 and K3 (or K4) on its own planes (``layers._placed_qdense``); the
    embedding and the head are vocab-parallel, held whole over the DP
    axes; tokens and ``last_logits`` come back whole on every rank. An
    MoE's routed experts split over ``model`` (expert parallelism): each
    rank dispatches its rows' groups and runs grouped K4 on its experts'
    planes, the experts' outputs are gathered over ``model`` for the
    combine (``moe._moe_apply_placed``); their ``scale`` and ``alpha_a``
    are placed by the expert axis once, here, and MLA's float
    ``w_uk``/``w_uv`` made whole on every rank, so a step moves no
    parameter. MLA's latent cache keeps ``cache_pspec``'s placement and
    each rank attends its own heads (``attention._mla_placed``). An SSM
    layer (mamba2's, hymba's SSM branch) convolves each rank's channels
    and runs the scan on every head over the state gathered whole,
    keeping its heads of it (``ssm._ssm_placed``), its per-head vectors
    and gated norm's ``norm`` held whole on every rank from here; a
    sliding window whose slots are split shifts only the slots that
    cross ranks (``attention._roll_positions``); an encoder-decoder's
    cross K/V are held whole over ``model`` and every rank attends every
    head over them (``transformer._cross_apply``). Every family is
    served; float serving raises ``NotImplementedError``. ``device`` must
    be of the mesh's device type (``meta`` counts, as the dry run does).
    """

    def __init__(self, cfg: ModelConfig, params=None, *,
                 batch_slots: int = 4, max_len: int = 128, seed: int = 0,
                 quantized: bool = True, pack_acts: bool = True,
                 plain: bool = False, device=None, mesh=None):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            disable_tf32()
        cfg = serve_policy(cfg, pack_acts=pack_acts, plain=plain)
        self.cfg = cfg
        self.max_len = max_len
        self.batch_slots = batch_slots
        self.mesh = mesh
        if mesh is not None:
            check_mesh(mesh, self.device, quantized, batch_slots)
        self.params = serving_params(cfg, params, device=self.device,
                                     seed=seed, quantized=quantized,
                                     mesh=mesh)
        self.last_logits = None
        self.last_stats = {}

    @contextlib.contextmanager
    def _context(self):
        """A step's context: inference mode, or on a mesh ``no_grad``
        inside :func:`~repro_torch.distributed.placed.mesh_context`
        (DTensor cannot make views of params made outside inference mode
        inside it)."""
        if self.mesh is None:
            with torch.inference_mode():
                yield
        else:
            with torch.no_grad(), placed.mesh_context(self.mesh):
                yield

    def _place_batch(self, toks: torch.Tensor):
        if self.mesh is None:
            return toks
        from torch.distributed.tensor import distribute_tensor
        return distribute_tensor(toks, self.mesh, to_placements(
            batch_pspec(tuple(toks.shape), self.mesh), self.mesh),
            src_data_rank=None)

    def generate(self, requests: List[GenRequest], *,
                 step_seconds: Optional[list] = None) -> List[GenRequest]:
        """Serve a batch of prompts, left-padded with token 0 to the longest
        (no pad mask, as the reference). Tokens stay on the card until one
        host transfer at the end. ``last_logits`` keeps the last step's
        (B, V) logits on the device. With a ``step_seconds`` list the
        device is synchronized after the prefill and after every decode
        step, and each one's wall seconds are appended (the prefill's
        first): a measurement, which gives up the single sync. A VLM is
        served text-only, as the
        reference's ``generate`` feeds tokens alone; an encoder-decoder
        raises ``ValueError`` (its encoder needs a source, which the
        reference's ``generate`` does not feed either: it fails there with
        a ``KeyError``)."""
        if self.cfg.family in ("encdec", "audio"):
            raise ValueError(
                f"{self.cfg.name}: family {self.cfg.family!r} needs a source "
                "for its encoder (src_embeds or src_tokens) and generate() "
                "feeds tokens only; call transformer.prefill and decode_step "
                "with src_embeds on server.params")
        if not requests:
            raise ValueError("generate() needs at least one request")
        if len(requests) > self.batch_slots:
            raise ValueError(f"{len(requests)} requests exceed "
                             f"batch_slots={self.batch_slots} — use "
                             "make_lm_engine to queue larger loads")
        too_long = [(i, len(r.prompt)) for i, r in enumerate(requests)
                    if len(r.prompt) > self.max_len]
        if too_long:
            raise ValueError(
                f"prompt(s) longer than max_len={self.max_len}: "
                + ", ".join(f"request {i} has {n} tokens"
                            for i, n in too_long))
        # the decode loop writes KV at positions up to
        # len(prompt) + max_new_tokens - 2: reject over-budget requests
        over = [(i, len(r.prompt) + r.max_new_tokens)
                for i, r in enumerate(requests)
                if len(r.prompt) + r.max_new_tokens > self.max_len]
        if over:
            raise ValueError(
                f"len(prompt) + max_new_tokens exceeds the KV budget "
                f"max_len={self.max_len}: "
                + ", ".join(f"request {i} needs {n}" for i, n in over))
        n_real = len(requests)
        # pad free slots with minimal dummies: one token, no decode budget
        while len(requests) < self.batch_slots:
            requests = requests + [GenRequest(np.zeros(1, np.int32), 0)]
        s = max(len(r.prompt) for r in requests)
        toks = np.zeros((len(requests), s), np.int64)
        for i, r in enumerate(requests):
            toks[i, -len(r.prompt):] = r.prompt  # left-pad
        batch = {"tokens": self._place_batch(
            torch.from_numpy(toks).to(self.device))}
        n_new = max((r.max_new_tokens for r in requests), default=0)

        def timed(t0):
            if step_seconds is not None:
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                step_seconds.append(time.perf_counter() - t0)

        with self._context():
            t0 = time.perf_counter()
            logits, caches = prefill(self.params, batch, self.cfg,
                                     max_len=self.max_len)
            tok = torch.argmax(logits, -1)[:, None]
            timed(t0)
            steps = [tok]                   # device-side token columns
            for t in range(1, n_new):
                t0 = time.perf_counter()
                logits, caches = decode_step(self.params, caches, tok,
                                             s + t - 1, self.cfg)
                tok = torch.argmax(logits, -1)[:, None]
                timed(t0)
                steps.append(tok)
            if n_new:
                all_toks = placed.plain(torch.cat(steps, dim=1)).cpu(
                ).numpy()                                       # 1 sync
            else:
                all_toks = np.zeros((len(requests), 0), np.int64)
            logits = placed.plain(logits)
        self.last_logits = logits
        for i, r in enumerate(requests):
            r.out_tokens = [int(v) for v in all_toks[i, :r.max_new_tokens]]
        self.last_stats = {        # dummies excluded from all accounting
            "real_requests": n_real,
            "padded_slots": len(requests) - n_real,
            "real_tokens": sum(len(r.out_tokens)
                               for r in requests[:n_real]),
            "decode_steps": max(0, n_new - 1),
        }
        return requests[:n_real]  # dummies pad the batch; don't return them


def make_lm_engine(server: Server):
    """Adapt a :class:`Server` to an engine ``fn(requests) -> results``
    (one result per request, in order) by serving the load in sequential
    slot-sized chunks; every chunk decodes to its longest member's
    ``max_new_tokens``. The static-batch baseline of
    :class:`~repro_torch.serving.lm_engine.ContinuousLMEngine`, where
    requests join and leave at token boundaries instead."""

    def engine(requests: List[GenRequest]) -> List[GenRequest]:
        out: List[GenRequest] = []
        for i in range(0, len(requests), server.batch_slots):
            out.extend(server.generate(requests[i:i + server.batch_slots]))
        return out

    return engine


def resnet9_recipe(seed: int = 0, calib_batch: int = 8):
    """Full-width ResNet9/CIFAR10 as :class:`CNNServer` compiles it:
    ``(graph, calib, policy)`` — the graph from ``resnet9_init(seed)``,
    ``calib_batch`` uniform images from ``seed + 1`` and the config's
    W2A2 policy. The ``compile`` and ``profile`` subcommands build the
    same recipe, so their artifacts are the server's store hits."""
    cfg = ResNet9Config()
    graph = resnet9_graph(resnet9_init(seed, cfg), cfg)
    in_shape = next(iter(graph.inputs.values()))
    calib = np.random.default_rng(seed + 1).random(
        (calib_batch,) + tuple(int(d) for d in in_shape[1:]),
        dtype=np.float32)
    policy = QuantPolicy(mode="serial", w_bits=cfg.w_bits, a_bits=cfg.a_bits,
                         radix_bits=cfg.radix_bits)
    return graph, calib, policy


class CNNServer:
    """Batched CNN inference server over the **compiled** deployment path.

    ``graph``: a compiler IR graph (default: full-width ResNet9/CIFAR10
    W2A2 from ``resnet9_init(seed)``, calibrated on ``calib_batch`` uniform
    images from ``seed + 1``). The graph is registered in a
    :class:`~repro_torch.serving.ModelRegistry` and compiled at first use
    (passes, calibration, ahead-of-time weight packing) onto ``device``;
    ``classify`` goes through the dynamic-batching
    :class:`~repro_torch.serving.InferenceService`, so any batch size is
    served out of the power-of-two padding buckets — on the card one CUDA
    graph each, captured at a bucket's first batch (or by
    ``service.warmup()``). The service worker is a daemon thread;
    ``close()`` (or use as a context manager) stops it.

    ``device=None`` means the card: it raises when there is none (pass
    ``device="cpu"`` for the plain versions).

    ``n_banks``/``placement`` scale the service across MVU banks (one
    stream each on the card, round-robin over the visible cards; on the
    CPU the banks run one after another): ``placement="banked"``
    load-balances micro-batches across banks, ``"sharded"`` splits each
    micro-batch evenly over all of them.

    ``store`` (an :class:`~repro_torch.compiler.ArtifactStore` or directory
    path) loads compiles from disk and persists fresh ones;
    ``artifact="model@precision"`` serves a precompiled artifact by its
    store tag with **no** graph and no calibration data — the BARVINN
    fleet story: ship the command stream, not the compiler.
    """

    def __init__(self, graph=None, *, calib=None, seed: int = 0,
                 calib_batch: int = 8, policy=None,
                 max_batch: int = 32, max_wait_s: float = 0.0,
                 n_banks: Optional[int] = None, placement: str = "banked",
                 store=None, artifact: Optional[str] = None, device=None):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            disable_tf32()
        if artifact is not None:
            if store is None:
                raise ValueError("artifact=... requires store=")
            model, _, prec = artifact.partition("@")
            if not prec:
                raise ValueError(f"artifact must be 'model@precision', "
                                 f"got {artifact!r}")
            self.graph = None
            self.registry = ModelRegistry(device=self.device, store=store)
            self.key = self.registry.register_artifact(model, precision=prec)
        else:
            if graph is None:
                graph, default_calib, policy0 = resnet9_recipe(seed,
                                                               calib_batch)
                calib = default_calib if calib is None else calib
                policy = policy0 if policy is None else policy
            if policy is None:
                policy = QuantPolicy(mode="serial", w_bits=2, a_bits=2,
                                     radix_bits=7)
            if calib is None:
                in_shape = next(iter(graph.inputs.values()))
                calib = np.random.default_rng(seed + 1).random(
                    (calib_batch,) + tuple(int(d) for d in in_shape[1:]),
                    dtype=np.float32)
            self.graph = graph
            self.registry = ModelRegistry(device=self.device, store=store)
            self.key = self.registry.register_graph(graph.name or "cnn",
                                                    graph, calib, policy)
        self.service = InferenceService(
            self.registry, max_batch=max_batch, max_wait_s=max_wait_s,
            n_banks=n_banks, placement=placement)
        self.service.start()

    @property
    def program(self):
        """The compiled Program (lazy — first access compiles or loads)."""
        return self.registry.program(self.key)

    def warm_boot(self) -> dict:
        """Restore every variant from the artifact store and capture its
        padding buckets (see :meth:`InferenceService.warm_boot`)."""
        return self.service.warm_boot()

    def classify(self, images) -> np.ndarray:
        """Logits for a batch of images (NHWC float): per-image requests
        through the service, re-assembled in order."""
        futures = self.service.submit_many(
            self.key, list(np.asarray(images, np.float32)))
        return np.stack([f.result() for f in futures])

    def metrics(self) -> dict:
        """The serving runtime's metrics snapshot (latency percentiles,
        bucket-cache counters, slot utilization, straggler events)."""
        return self.service.metrics()

    def cycle_report(self, mode: str = "pipelined") -> str:
        """Accelerator cycle estimate of the compiled model (paper §3.3)."""
        return self.program.to_command_stream(mode=mode).summary()

    def close(self) -> None:
        self.service.stop()

    def __enter__(self) -> "CNNServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _device_name(device: torch.device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")


def _main_cnn(args) -> None:
    """CNN serving run: classification through the service + cycle
    report."""
    if args.placement != "banked" and not args.banks:
        print(f"note: --placement {args.placement} has no effect without "
              "--banks N (serving single-device)")
    server = CNNServer(seed=args.seed, device=args.device, store=args.store,
                       n_banks=args.banks, placement=args.placement)
    obs = _ObsSession(server.service, trace_out=args.trace_out,
                      metrics_port=args.metrics_port,
                      metrics_every=args.metrics_every)
    images = np.random.RandomState(args.seed).rand(
        args.batch, 32, 32, 3).astype(np.float32)
    # compile (or load), and capture every bucket on this thread before
    # traffic
    if args.store:
        t0 = time.perf_counter()
        report = server.warm_boot()
        obs.emit(f"warm boot in {(time.perf_counter() - t0) * 1e3:.0f}ms: "
                 f"restored={report['restored']} "
                 f"compiled={report['compiled']} "
                 f"bucket_compiles={report['bucket_compiles']}")
    else:
        server.service.warmup()
    if args.banks and args.banks > 1:
        obs.emit(f"serving across {server.service.n_banks} MVU banks "
                 f"(placement={server.service.placement})")
    server.classify(images)
    t0 = time.perf_counter()
    logits = server.classify(images)   # ends in the host copy
    dt = time.perf_counter() - t0
    obs.emit(f"classified {len(logits)} images in {dt * 1e3:.1f}ms "
             f"({len(logits) / dt:.1f} img/s, compiled path, on "
             f"{_device_name(server.device)})",
             f"sample logits: {logits[0, :4]}")
    m = server.metrics()
    obs.emit(f"serving: p50={m['latency_p50_ms']}ms "
             f"p99={m['latency_p99_ms']}ms "
             f"bucket_caches={m['bucket_caches']}")
    if m["banks"]["n_banks"] > 1:
        sched = m["scheduler"]
        obs.emit(f"banks: util={sched['bank_utilization']} "
                 f"requests={sched['bank_requests']} "
                 f"replica_cache={m['banks']['replica_cache']}")
    if args.store:
        st = m["artifact_store"]
        obs.emit(f"artifact store: hits={st['hits']} misses={st['misses']} "
                 f"loads={st['loads']} load_p50={st['load_p50_ms']}ms "
                 f"bytes_on_disk={st['bytes_on_disk']} "
                 f"dedup_ratio={st['dedup_ratio']}")
    obs.emit(server.cycle_report())
    obs.close()
    server.close()


def _parse_precisions(spec: Optional[str], cfg) -> list:
    """``"W2A2,W2A8"`` → [(2, 2), (2, 8)]; default: the config's own
    policy."""
    import re
    if not spec:
        return [(int(cfg.w_bits), int(cfg.a_bits))]
    out = []
    for tok in spec.split(","):
        m = re.fullmatch(r"[Ww](\d+)[Aa](\d+)", tok.strip())
        if not m:
            raise SystemExit(f"bad precision {tok!r} — expected e.g. W2A2")
        out.append((int(m.group(1)), int(m.group(2))))
    return out


def _main_compile(argv) -> None:
    """The offline BARVINN "code generator" run: graph → passes →
    calibration → packing → artifact store. A serving process pointed at
    ``--store`` then boots with zero recompiles and needs no calibration
    data."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.serve compile",
        description="AOT-compile an arch into an artifact store")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--store", required=True,
                    help="artifact store directory (created if missing)")
    ap.add_argument("--precisions", default=None,
                    help="comma-separated variants, e.g. W2A2,W2A8 "
                         "(default: the arch policy)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--calib-batch", type=int, default=8)
    ap.add_argument("--gc", action="store_true",
                    help="after compiling, drop store artifacts no ref "
                         "tag reaches (untagged manifests + orphaned "
                         "blobs)")
    ap.add_argument("--gc-dry-run", action="store_true",
                    help="report what --gc would delete without deleting")
    args = ap.parse_args(argv)
    if args.arch != CNN_ARCH:
        raise SystemExit(f"compile: arch {args.arch!r} is not a CNN — only "
                         "graph-compiled archs produce Program artifacts")
    graph, calib, base = resnet9_recipe(args.seed, args.calib_batch)
    registry = ModelRegistry(device=args.device, store=args.store)
    for w_bits, a_bits in _parse_precisions(args.precisions, base):
        policy = dataclasses.replace(base, w_bits=w_bits, a_bits=a_bits)
        key = registry.register_graph(graph.name or "cnn", graph, calib,
                                      policy)
        hits0 = registry.artifact_hits
        t0 = time.perf_counter()
        registry.program(key)   # store hit or compile+save
        dt = time.perf_counter() - t0
        how = ("store hit" if registry.artifact_hits > hits0
               else "compiled")
        print(f"{key}: {registry.entry(key).ref[:12]}… ({how}) in "
              f"{dt * 1e3:.0f}ms on {_device_name(registry.device)}")
    if args.gc or args.gc_dry_run:
        rep = registry.store.gc(dry_run=args.gc_dry_run)
        mode = "gc dry-run" if rep["dry_run"] else "gc"
        print(f"{mode}: removed_programs={rep['removed_programs']} "
              f"removed_blobs={rep['removed_blobs']} "
              f"bytes_freed={rep['bytes_freed']} "
              f"(live: {rep['live_programs']} programs, "
              f"{rep['live_blobs']} blobs)")
    st = registry.store.stats()
    print(f"store {args.store}: programs={st['programs']} "
          f"blobs={st['blobs']} bytes_on_disk={st['bytes_on_disk']} "
          f"dedup_ratio={st['dedup_ratio']}")


def _main_profile(argv) -> None:
    """Measured-time profile of the compiled ResNet9: per-layer device
    time next to the cost model's predicted virtual cycles and the H100
    roofline, a fitted ns/cycle per op kind, and the misprediction
    outliers."""
    from repro_torch.obs import calibrate
    from repro_torch.obs.profiler import format_profile, profile_program
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.serve profile",
        description="profile a compiled model step by step and calibrate "
                    "the cycle cost model against measured time")
    ap.add_argument("--model", default="resnet9",
                    help="graph-compiled model (resnet9)")
    ap.add_argument("--precision", default=None,
                    help="comma-separated variants, e.g. w2a2,w2a8 "
                         "(default: the model's own policy)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--warmup", type=int, default=1)
    ap.add_argument("--repeats", type=int, default=3,
                    help="timed runs per step (best run kept)")
    ap.add_argument("--mode", default="pipelined",
                    choices=["pipelined", "distributed"],
                    help="command-stream mapping for predicted cycles")
    ap.add_argument("--tolerance", type=float, default=1.0,
                    help="|relative residual| beyond which a layer is "
                         "reported as a cost-model outlier")
    ap.add_argument("--store", default=None,
                    help="artifact store: load the compile from it and "
                         "persist the fitted Calibration record")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write the measured spans as the third "
                         "('measured') track of a Chrome trace JSON")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--calib-batch", type=int, default=8)
    args = ap.parse_args(argv)
    if args.model not in ("resnet9", "cnn"):
        raise SystemExit(f"profile: unknown model {args.model!r} — only "
                         "graph-compiled CNNs (resnet9) profile per step")
    graph, calib, base = resnet9_recipe(args.seed, args.calib_batch)
    registry = ModelRegistry(device=args.device, store=args.store)
    if registry.device.type == "cuda":
        disable_tf32()
    precisions = _parse_precisions(args.precision, base)
    for w_bits, a_bits in precisions:
        policy = dataclasses.replace(base, w_bits=w_bits, a_bits=a_bits)
        key = registry.register_graph(graph.name or "cnn", graph, calib,
                                      policy)
        program = registry.program(key)
        prof = profile_program(program, batch=args.batch,
                               warmup=args.warmup, repeats=args.repeats,
                               mode=args.mode)
        cal = calibrate.fit(prof, tolerance=args.tolerance)
        print(f"== {key} (on {_device_name(registry.device)}) ==")
        print(format_profile(prof, cal))
        print(calibrate.format_calibration(cal))
        if registry.store is not None:
            k = calibrate.save(registry.store, cal, str(key))
            print(f"calibration persisted: {k}")
        if args.trace_out:
            from repro_torch.obs.tracing import Tracer
            out = args.trace_out
            if len(precisions) > 1:   # one trace file per variant
                stem, dot, ext = out.rpartition(".")
                out = (f"{stem}.W{w_bits}A{a_bits}.{ext}" if dot
                       else f"{out}.W{w_bits}A{a_bits}")
            path = write_chrome_trace(Tracer(), out,
                                      extra_spans=prof.spans())
            print(f"measured trace ({len(prof.steps)} step spans on the "
                  f"'measured' track) -> {path}")
        print()


def _main_static_lm(args, cfg: ModelConfig, mesh=None, rank: int = 0
                    ) -> None:
    """An arch the slot arena cannot take (SSM or hybrid state, rolling
    windows, a VLM's frontend) through the static :class:`Server`, as the
    reference's CLI serves it: ``batch`` prompts of 8 tokens from
    ``RandomState(seed)``, ``new_tokens`` each. With ``mesh`` (one rank
    of a mesh run, :func:`_serve_mesh_rank`) the server is sharded over
    it, and rank 0 alone prints."""
    if mesh is None:
        print(f"note: family={cfg.family!r} doesn't fit the continuous "
              "slot arena (SSM/hybrid state, rolling windows, or a "
              "frontend's inputs) — serving via the static batch path")
    if (rank == 0 and (args.trace_out or args.metrics_port is not None
                       or args.metrics_every)):
        print("note: --trace-out/--metrics-port/--metrics-every apply to "
              "the serving-runtime paths only (static batch has no spine)")
    server = Server(cfg, batch_slots=args.batch, max_len=LM_MAX_LEN,
                    seed=args.seed, pack_acts=not args.no_pack_acts,
                    device=args.device, mesh=mesh)
    rng = np.random.RandomState(args.seed)
    reqs = [GenRequest(rng.randint(0, cfg.vocab_size, (8,)).astype(np.int32),
                       args.new_tokens) for _ in range(args.batch)]
    t0 = time.perf_counter()
    out = server.generate(reqs)
    dt = time.perf_counter() - t0
    if rank:
        return
    total = sum(len(r.out_tokens) for r in out)
    kernels = "K1 + K3" if not args.no_pack_acts else "K4"
    where = (_device_name(server.device) if mesh is None else
             f"a (data {args.data_par}, model {args.model_par}) mesh of "
             f"{mesh.device_type}")
    print(f"{cfg.name}: generated {total} tokens in {dt:.2f}s "
          f"({total / dt:.1f} tok/s, static batch) on {where}, "
          f"{cfg.n_layers} layers, {kernels}"
          + ("" if mesh is None else " on each rank's planes"), flush=True)
    print("sample:", out[0].out_tokens, flush=True)


def _serve_mesh_rank(rank: int, cfg: ModelConfig, args) -> None:
    """One rank of the LM CLI's mesh run (started by ``run_ranks``) on a
    (``data_par``, ``model_par``) mesh: the engine's mixed load
    (:func:`_main_engine_lm`) when the slot arena takes the arch, else
    the static load (:func:`_main_static_lm`)."""
    from repro_torch.launch.mesh import make_local_mesh
    if args.device is not None and torch.device(args.device).type == "cuda":
        args.device = None                      # this rank's own card
    mesh = make_local_mesh(args.data_par, args.model_par, device=args.device)
    if supports_continuous(cfg):
        _main_engine_lm(args, cfg, mesh=mesh, rank=rank)
    else:
        _main_static_lm(args, cfg, mesh=mesh, rank=rank)


def _main_lm(args) -> None:
    """The reference CLI's LM load through the continuous engine, submitted
    through the serving runtime (:func:`_main_engine_lm`). An arch the
    engine cannot take goes through :func:`_main_static_lm`; with
    ``--data-par``/``--model-par`` above one rank, the ranks serve the
    same loads sharded (:func:`_serve_mesh_rank`). An encoder-decoder
    exits with the reason: :meth:`Server.generate` feeds no source."""
    entry = get_arch(args.arch)
    cfg = entry.smoke if args.smoke else entry.full
    if cfg.family in ("encdec", "audio"):
        raise SystemExit(
            f"{cfg.name}: family {cfg.family!r} is an encoder-decoder "
            "whose encoder needs a source (src_embeds); "
            "Server.generate feeds tokens only, so the CLI cannot "
            "serve it (the reference's CLI fails there too). Drive "
            "repro_torch.models.transformer.prefill and decode_step "
            "with src_embeds instead.")
    n = args.data_par * args.model_par
    if n > 1:
        from repro_torch.launch.mesh import run_ranks
        if args.batch % args.data_par:
            raise SystemExit(f"--batch {args.batch} does not divide over "
                             f"--data-par {args.data_par}")
        run_ranks(_serve_mesh_rank, n, device=args.device, args=(cfg, args),
                  timeout=24 * 3600)
        return
    if not supports_continuous(cfg):
        _main_static_lm(args, cfg)
        return
    _main_engine_lm(args, cfg)


def _main_engine_lm(args, cfg: ModelConfig, mesh=None, rank: int = 0
                    ) -> None:
    """The continuous engine on the reference CLI's mixed load: prompts of
    4-16 tokens and decode budgets from ``RandomState(seed)``, every 4th
    request long, ``max(batch x 4, 8)`` of them, submitted through the
    serving runtime. With ``mesh`` (one rank of a mesh run) the engine is
    sharded over it and rank 0 alone prints; every rank's engine must
    then take the same requests in the same calls (its host loop runs the
    same collectives as its peers'), so the service hands it the whole
    load as one micro-batch rather than what a timing window holds."""
    engine = ContinuousLMEngine(cfg, batch_slots=args.batch,
                                max_len=LM_MAX_LEN, seed=args.seed,
                                pack_acts=not args.no_pack_acts,
                                device=args.device, mesh=mesh)
    warm = engine.warmup()
    if rank == 0:
        print(f"engine warmup: {warm['compiles']} compiles (buckets "
              f"{warm['buckets']}) in {warm['seconds']}s", flush=True)
    registry = ModelRegistry(device=engine.device)
    key = registry.register_callable(args.arch, engine)
    rng = np.random.RandomState(args.seed)
    n_load = max(args.batch * 4, 8)
    m_long = max(1, min(args.new_tokens, LM_MAX_LEN - 16))
    reqs = [GenRequest(
        rng.randint(0, cfg.vocab_size,
                    (int(rng.randint(4, 17)),)).astype(np.int32),
        m_long if i % 4 == 0 else max(1, m_long // 4))
        for i in range(n_load)]
    kernels = "K1 + K3" if not args.no_pack_acts else "K4"
    if cfg.n_experts:
        kernels += " + grouped K4"
    where = (_device_name(engine.device) if mesh is None else
             f"a (data {args.data_par}, model {args.model_par}) mesh of "
             f"{mesh.device_type}")
    batching = (dict(max_wait_s=0.0) if mesh is None else
                dict(max_batch=n_load, max_wait_s=24 * 3600.0))
    with InferenceService(registry, **batching) as svc:
        obs = _ObsSession(svc, trace_out=args.trace_out if rank == 0
                          else None,
                          metrics_port=args.metrics_port if rank == 0
                          else None,
                          metrics_every=args.metrics_every if rank == 0
                          else 0.0)
        t0 = time.perf_counter()
        futures = svc.submit_many(key, reqs)
        svc.drain()
        dt = time.perf_counter() - t0
        out = [f.result() for f in futures]
        m = svc.metrics()
        total = sum(len(r.out_tokens) for r in out)
        em = m["engines"][str(key)]
        step = "CUDA graph" if em["jit"]["cuda_graph"] else "eager"
        if rank == 0:
            obs.emit(f"{cfg.name}: generated {total} tokens over {len(out)} "
                     f"requests in {dt:.2f}s ({total / dt:.1f} tok/s, "
                     f"continuous batching) on {where}, "
                     f"{cfg.n_layers} layers, {kernels}"
                     + ("" if mesh is None else " on each rank's planes")
                     + f", decode step {step}",
                     f"engine: occupancy={em['slot_occupancy']} "
                     f"decode_steps={em['decode_steps']} "
                     f"recompiles_after_warmup="
                     f"{em['jit']['recompiles_after_warmup']} "
                     f"scheduler_steps={m['scheduler']['admitted_batches']}",
                     f"sample: {out[0].out_tokens}")
        obs.close()


def _main_trace(argv) -> None:
    """Summarize a saved Chrome trace: top-k slowest requests by phase."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.serve trace",
        description="pretty-print a saved --trace-out file: the top-k "
                    "slowest requests with per-phase wall breakdowns")
    ap.add_argument("file", help="Chrome trace JSON from --trace-out")
    ap.add_argument("--top-k", type=int, default=10)
    args = ap.parse_args(argv)
    with open(args.file) as f:
        doc = json.load(f)
    print(format_trace_summary(trace_summary(doc, top_k=args.top_k)))
    other = doc.get("otherData", {})
    st = other.get("tracer")
    if st:
        print(f"tracer: {st['sampled']}/{st['started']} requests sampled, "
              f"{st['buffered']} spans buffered "
              f"(sample_every={st['sample_every']})")
    domains = other.get("domains")
    if domains:
        print("domains: " + "; ".join(f"{k}: {v}"
                                      for k, v in domains.items()))


def main(argv=None) -> None:
    import sys
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "trace":
        _main_trace(argv[1:])
        return
    if argv and argv[0] == "compile":
        _main_compile(argv[1:])
        return
    if argv and argv[0] == "profile":
        _main_profile(argv[1:])
        return
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=CNN_ARCH,
                    choices=(CNN_ARCH,) + tuple(list_archs()))
    ap.add_argument("--batch", type=int, default=None,
                    help="images (CNN, default 8) or LM batch slots (4)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--no-pack-acts", action="store_true",
                    help="LM: int32 activation codes into K4 instead of "
                         "packed planes into K3")
    ap.add_argument("--smoke", action="store_true",
                    help="LM: the arch's reduced config (for the CPU)")
    ap.add_argument("--data-par", type=int, default=1,
                    help="LM: ranks over the data axis (one process each)")
    ap.add_argument("--model-par", type=int, default=1,
                    help="LM: ranks over the model axis (one process each)")
    ap.add_argument("--banks", type=int, default=None,
                    help="CNN: serve across N MVU banks (one CUDA stream "
                         "each, round-robin over the visible cards; on "
                         "the CPU one after another)")
    ap.add_argument("--placement", default="banked",
                    choices=["banked", "sharded"],
                    help="multi-bank placement: load-balance whole "
                         "micro-batches (banked) or split each across "
                         "all banks (sharded)")
    ap.add_argument("--store", default=None,
                    help="CNN: artifact store directory — warm-boot the "
                         "compile from it (compiling and saving on a miss)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write the run's request trace as Chrome trace "
                         "JSON (Perfetto-loadable; summarize with the "
                         "`trace` subcommand)")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve Prometheus text on 127.0.0.1:PORT/metrics "
                         "for the duration of the run (0 = any free port)")
    ap.add_argument("--metrics-every", type=float, default=0.0,
                    help="print a one-line metrics snapshot every S "
                         "seconds through the single console writer "
                         "(0 = off)")
    args = ap.parse_args(argv)
    if args.arch != CNN_ARCH:
        if args.store:
            ap.error("--store applies to the compiled CNN arch only")
        args.batch = args.batch or 4
        _main_lm(args)
        return
    if args.data_par * args.model_par > 1:
        ap.error("--data-par/--model-par apply to the LM archs (the CNN "
                 "scales over banks: --banks)")
    args.batch = args.batch or 8
    _main_cnn(args)


if __name__ == "__main__":
    main()
