"""Serving on the port: the quantized LM (:class:`Server`, batched greedy
generation with KV caches) and the compiled CNN (:class:`CNNServer`).

Counterpart of ``Server``, ``GenRequest``, ``make_lm_engine`` and
``CNNServer`` in ``repro/launch/serve.py``. The LM's weights run through the
bit-serial kernels: with ``pack_acts`` (the default) every projection
quantizes and packs its activations with K1 and multiplies with K3,
otherwise it multiplies int32 codes with K4. The CNN is compiled once
(passes, calibration, ahead-of-time weight packing) onto the card, and
every batch runs through :class:`~repro_torch.compiler.executor.
BucketedRunner`.

The CLI serves the LM as the reference's does, through the
continuous-batching :class:`~repro_torch.serving.lm_engine.
ContinuousLMEngine` (on the card its decode step is one captured CUDA
graph): a mixed load of ``max(batch x 4, 8)`` requests. The reference's
registry, dynamic batcher and ``InferenceService`` around the engine are
not ported yet.

    python -m repro_torch.launch.serve --arch stablelm-1.6b --batch 4 --new-tokens 16
    python -m repro_torch.launch.serve --arch stablelm-1.6b --device cpu --smoke [--no-pack-acts]
    python -m repro_torch.launch.serve --arch resnet9-cifar10 --batch 32
    python -m repro_torch.launch.serve --arch resnet9-cifar10 --batch 4 --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.compiler.executor import BucketedRunner
from repro_torch.compiler.lower import compile_graph
from repro_torch.configs import get_arch, list_archs
from repro_torch.core.pipeline_modules import disable_tf32
from repro_torch.models.layers import QuantPolicy
from repro_torch.models.resnet import ResNet9Config, resnet9_graph, resnet9_init
from repro_torch.models.transformer import (ModelConfig, decode_step,
                                            init_params, pack_params, prefill,
                                            serve_policy)
from repro_torch.serving.lm_engine import ContinuousLMEngine

__all__ = ["GenRequest", "Server", "make_lm_engine", "CNNServer", "main"]

CNN_ARCH = "resnet9-cifar10"
LM_MAX_LEN = 64   # the CLI's KV budget, as the reference's


@dataclasses.dataclass
class GenRequest:
    prompt: np.ndarray          # (S,) int32
    max_new_tokens: int = 16
    out_tokens: Optional[List[int]] = None


class Server:
    """Static-batch LM server over the quantized (bit-transposed)
    deployment path, greedy decoding.

    ``params``: float or packed parameters on the server's device (default:
    random from ``seed`` on that device); float ones are packed once. The
    head's float32 weight is cast to the compute dtype once here, where the
    reference casts it at every call — the same numbers. ``pack_acts``
    selects K1 + K3 (True) or K4 (False); ``plain`` runs the kernels'
    plain versions (the yardstick). ``device=None`` means the card: it
    raises when there is none (pass ``device="cpu"`` for the plain
    versions).
    """

    def __init__(self, cfg: ModelConfig, params=None, *,
                 batch_slots: int = 4, max_len: int = 128, seed: int = 0,
                 quantized: bool = True, pack_acts: bool = True,
                 plain: bool = False, device=None):
        if not quantized:
            raise NotImplementedError(
                "Server(quantized=False) runs the LSQ fake-quant forward, "
                "which waits for the LSQ straight-through estimator (not "
                "ported yet); serve the packed weights")
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            disable_tf32()
        cfg = serve_policy(cfg, pack_acts=pack_acts, plain=plain)
        self.cfg = cfg
        self.max_len = max_len
        self.batch_slots = batch_slots
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = init_params(gen, cfg)
        if params["embed"].device != self.device:
            raise ValueError(f"params lie on {params['embed'].device}, the "
                             f"server on {self.device}")
        params = pack_params(params, cfg)  # bit-transposed deployment
        params["head"] = dict(params["head"], w=params["head"]["w"].to(
            cfg.compute_dtype))
        self.params = params
        self.last_logits = None
        self.last_stats = {}

    def generate(self, requests: List[GenRequest]) -> List[GenRequest]:
        """Serve a batch of prompts, left-padded with token 0 to the longest
        (no pad mask, as the reference). Tokens stay on the card until one
        host transfer at the end. ``last_logits`` keeps the last step's
        (B, V) logits on the device."""
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
        batch = {"tokens": torch.from_numpy(toks).to(self.device)}
        n_new = max((r.max_new_tokens for r in requests), default=0)
        with torch.inference_mode():
            logits, caches = prefill(self.params, batch, self.cfg,
                                     max_len=self.max_len)
            tok = torch.argmax(logits, -1)[:, None]
            steps = [tok]                   # device-side token columns
            for t in range(1, n_new):
                logits, caches = decode_step(self.params, caches, tok,
                                             s + t - 1, self.cfg)
                tok = torch.argmax(logits, -1)[:, None]
                steps.append(tok)
            if n_new:
                all_toks = torch.cat(steps, dim=1).cpu().numpy()  # 1 sync
            else:
                all_toks = np.zeros((len(requests), 0), np.int64)
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


class CNNServer:
    """ResNet9/CIFAR10 W2A2 classifier over a compiled Program.

    The model is built at full width from ``resnet9_init(seed)`` and
    calibrated on ``calib_batch`` uniform images drawn from ``seed + 1``.
    ``device=None`` means the card: it raises when there is none (pass
    ``device="cpu"`` for the plain versions).
    """

    def __init__(self, *, seed: int = 0, calib_batch: int = 8,
                 max_batch: int = 32, device=None):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            disable_tf32()
        cfg = ResNet9Config()
        self.graph = resnet9_graph(resnet9_init(seed, cfg), cfg)
        calib = np.random.default_rng(seed + 1).random(
            (calib_batch, 32, 32, 3), dtype=np.float32)
        policy = QuantPolicy(mode="serial", w_bits=cfg.w_bits,
                             a_bits=cfg.a_bits, radix_bits=cfg.radix_bits)
        self.program = compile_graph(self.graph, calib, policy=policy,
                                     device=self.device)
        self.runner = BucketedRunner(self.program, max_batch=max_batch)

    def classify(self, images) -> np.ndarray:
        """Logits (numpy) for a batch of NHWC float images; batches larger
        than ``max_batch`` run in ``max_batch`` chunks."""
        x = torch.as_tensor(np.asarray(images, np.float32))
        step = self.runner.max_batch
        outs = [self.runner(x[i:i + step]) for i in range(0, len(x), step)]
        return torch.cat(outs).cpu().numpy()


def _main_lm(args) -> None:
    """The reference CLI's LM load through the continuous engine: mixed
    prompt lengths (4-16 tokens) and decode budgets, every 4th request
    long, from ``RandomState(seed)``."""
    entry = get_arch(args.arch)
    cfg = entry.smoke if args.smoke else entry.full
    engine = ContinuousLMEngine(cfg, batch_slots=args.batch,
                                max_len=LM_MAX_LEN, seed=args.seed,
                                pack_acts=not args.no_pack_acts,
                                device=args.device)
    warm = engine.warmup()
    print(f"engine warmup: {warm['compiles']} compiles (buckets "
          f"{warm['buckets']}) in {warm['seconds']}s")
    rng = np.random.RandomState(args.seed)
    n_load = max(args.batch * 4, 8)
    m_long = max(1, min(args.new_tokens, LM_MAX_LEN - 16))
    reqs = [GenRequest(
        rng.randint(0, cfg.vocab_size,
                    (int(rng.randint(4, 17)),)).astype(np.int32),
        m_long if i % 4 == 0 else max(1, m_long // 4))
        for i in range(n_load)]
    t0 = time.perf_counter()
    out = engine.serve(reqs)       # ends in the host copy of the tokens
    dt = time.perf_counter() - t0
    total = sum(len(r.out_tokens) for r in out)
    em = engine.engine_metrics()
    name = (torch.cuda.get_device_name(engine.device)
            if engine.device.type == "cuda" else "cpu")
    kernels = "K1 + K3" if not args.no_pack_acts else "K4"
    step = "CUDA graph" if em["jit"]["cuda_graph"] else "eager"
    print(f"{cfg.name}: generated {total} tokens over {len(out)} requests "
          f"in {dt:.2f} s ({total / dt:.1f} tok/s, continuous batching) "
          f"on {name}, {cfg.n_layers} layers, {kernels}, decode step "
          f"{step}")
    print(f"engine: occupancy={em['slot_occupancy']} "
          f"decode_steps={em['decode_steps']} recompiles_after_warmup="
          f"{em['jit']['recompiles_after_warmup']}")
    print("sample:", out[0].out_tokens)


def main(argv=None) -> None:
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
    args = ap.parse_args(argv)
    if args.arch != CNN_ARCH:
        args.batch = args.batch or 4
        _main_lm(args)
        return
    args.batch = args.batch or 8
    server = CNNServer(seed=args.seed, device=args.device)
    images = np.random.default_rng(args.seed + 2).random(
        (args.batch, 32, 32, 3), dtype=np.float32)
    server.classify(images)  # first sight of the bucket
    sync = (torch.cuda.synchronize if server.device.type == "cuda"
            else (lambda: None))
    sync()
    t0 = time.perf_counter()
    logits = server.classify(images)
    sync()
    dt = time.perf_counter() - t0
    name = (torch.cuda.get_device_name(server.device)
            if server.device.type == "cuda" else "cpu")
    print(f"classified {len(logits)} images in {dt * 1e3:.3f} ms "
          f"({len(logits) / dt:.1f} img/s) on {name}")
    print(f"sample logits: {logits[0, :4]}")
    print(f"buckets: {server.runner.stats()}")


if __name__ == "__main__":
    main()
