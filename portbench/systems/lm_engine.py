"""A dense decoder LM served by the port's continuous engine behind its
serving front end: the system of the ``closed_loop`` kind
(``portbench/kinds/closed_loop.py``).

The timed path is the one a user of ``launch/serve.py`` meets:
``InferenceService.submit`` → the dynamic batcher → a callable variant, a
``ContinuousLMEngine`` (eager bucketed prefill, slot insert, the decode
step replayed as one CUDA graph; K1 + K3 in every projection).

Set-up (:func:`serving`): the weights and step sizes are made on the
device from the seed (:mod:`portbench.reference.lm`), handed to the
engine, which packs them, and dropped; the service warms up one request
per prompt bucket the traffic reaches (the decode graph's capture
included).

The check (:func:`check`), after the window and after the program is
freed: the sampled requests are run through the plain reference over
their prompts and served tokens; the number compared is the widest gap by
which a served token's reference logit lies below the reference's best
at its position (``max_logit_gap``), and every resolved request must have
served as many tokens as it asked for (``wrong_lengths``).
"""

from __future__ import annotations

import gc
import math
from typing import Dict, List

import numpy as np
import torch

from portbench import seeds
from portbench.reference import lm as ref

__all__ = ["serving", "check", "expected_launches", "model_config",
           "warm_prompts", "served_gaps", "reference_rows"]


def model_config(cfg: Dict):
    """The program's ``ModelConfig`` for a configuration file."""
    from repro_torch.models.layers import QuantPolicy
    from repro_torch.models.transformer import ModelConfig
    d, h = int(cfg["hidden_size"]), int(cfg["num_attention_heads"])
    sv = cfg["serving"]
    if cfg["hidden_act"] != "silu" or cfg.get("tie_word_embeddings"):
        raise ValueError(f"{cfg['name']}: only untied SwiGLU stacks")
    return ModelConfig(
        name=cfg["name"], family="dense",
        n_layers=int(cfg["num_hidden_layers"]), d_model=d, n_heads=h,
        n_kv_heads=int(cfg["num_key_value_heads"]), head_dim=d // h,
        d_ff=int(cfg["intermediate_size"]),
        vocab_size=int(cfg["vocab_size"]), act="swiglu",
        qkv_bias=bool(cfg["use_qkv_bias"]),
        rope_theta=float(cfg["rope_theta"]),
        partial_rotary=float(cfg["partial_rotary_factor"]),
        norm_type="layer", norm_eps=float(cfg["layer_norm_eps"]),
        policy=QuantPolicy(mode="qat", w_bits=int(sv["w_bits"]),
                           a_bits=int(sv["a_bits"])),
        dtype=sv["compute_dtype"], remat=False)


def warm_prompts(spec: Dict) -> List[int]:
    """One prompt length per prefill bucket the traffic reaches: the
    longest of the traffic's lengths in that bucket."""
    from repro_torch.compiler.executor import bucket_for
    lo, hi = spec["prompt_tokens"]
    max_len = spec["engine"]["max_len"]
    longest: Dict[int, int] = {}
    for n in range(lo, hi + 1):
        longest[bucket_for(n, max_len)] = n
    return sorted(longest.values())


def _inputs(run):
    """The weights and steps from the seed, on the device (float32)."""
    cfg = run.config
    params = ref.make_params(cfg, run.seed, run.device)
    calib = seeds.rng(run.seed, "lm.calib").integers(
        0, int(cfg["vocab_size"]), size=int(cfg["serving"]["calib_tokens"]))
    ref.calibrate_alpha_a(params, cfg, torch.as_tensor(
        calib, dtype=torch.int64, device=run.device))
    return params


def _alpha_a(params) -> Dict:
    grp = params["groups"][0]
    return {(gr, n): grp[gr][n]["alpha_a"].clone() for gr, n, _ in ref.PROJ}


class _Served:
    """The engine behind the serving front end, warmed up."""

    def __init__(self, run):
        from repro_torch.launch.serve import GenRequest
        from repro_torch.serving import (ContinuousLMEngine,
                                         InferenceService, ModelRegistry)
        self._request = GenRequest
        cfg, spec = run.config, run.traffic
        dev = self.device = run.device
        params = _inputs(run)
        self.alpha_a = _alpha_a(params)
        run.mark("inputs")
        self.engine = ContinuousLMEngine(
            model_config(cfg), params=params,
            batch_slots=int(spec["engine"]["batch_slots"]),
            max_len=int(spec["engine"]["max_len"]),
            pack_acts=bool(cfg["serving"]["pack_acts"]), device=dev)
        del params
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        run.mark("packing")
        self.registry = ModelRegistry(device=self.engine.device)
        self.key = self.registry.register_callable(cfg["name"], self.engine)
        self.svc = InferenceService(
            self.registry, max_batch=int(spec["service"]["max_batch"]),
            max_wait_s=float(spec["service"]["max_wait_s"]))
        self.svc.start()
        warm = [self.svc.submit(self.key, GenRequest(np.zeros(n, np.int32),
                                                     2))
                for n in warm_prompts(spec)]
        for f in warm:
            f.result()
        self.svc.drain(timeout=600.0)      # its counters updated, too
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        run.mark("warm-up")

    def submit(self, prompt, max_new: int):
        req = self._request(prompt, max_new)
        return (self.svc.submit(self.key, req),
                lambda: list(req.out_tokens or []))

    def counters(self) -> Dict:
        m = self.svc.metrics()
        e = self.engine
        return {"completed": m["completed"], "batches": m["batches"],
                "decode_steps": e.decode_steps,
                "slot_steps": e.occupied_slot_steps,
                "batch_slots": e.batch_slots, "max_len": e.max_len}

    def queue_spans(self) -> List:
        return [(sp.t0_ns / 1e9, sp.t1_ns / 1e9,
                 (sp.args or {}).get("batch", 0))
                for sp in self.svc.tracer.spans() if sp.name == "queue"]

    def drain(self, timeout: float) -> None:
        self.svc.drain(timeout=timeout)

    def close(self) -> None:
        """Stop the front end and free the program."""
        if self.svc is None:
            return
        self.svc.stop()
        self.svc = self.registry = self.engine = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def serving(run) -> _Served:
    return _Served(run)


#: K3 (``kernels/csrc/bitserial_matmul.cu``; K4 is ``<true``)
K3 = r"bitserial_gemm_kernel<false"


def expected_launches(cfg: Dict, work: Dict) -> Dict[str, int]:
    """The K3 launches a traced round's work implies: one per packed
    projection of every layer, for each prefill and each decode step."""
    calls = len(work["prompts"]) + int(work["decode_steps"])
    return {K3: int(cfg["num_hidden_layers"]) * len(ref.PROJ) * calls}


def served_gaps(logits: torch.Tensor, tokens: List[int]) -> torch.Tensor:
    """Per served token, how far its reference logit lies below the
    reference's best at its position."""
    tok = torch.as_tensor(tokens, dtype=torch.int64, device=logits.device)
    return logits.max(dim=-1).values - logits.gather(1, tok[:, None])[:, 0]


def reference_rows(params, cfg, sample, *, a_bits: int = 8):
    """The reference's logits at each served token's position of each
    sampled request (its prompt and served tokens as one sequence)."""
    dev = params["embed"].device
    seqs, rows = [], []
    for r in sample:
        ids = np.concatenate([r["prompt_ids"].astype(np.int64),
                              np.asarray(r["tokens"][:-1], np.int64)])
        seqs.append(torch.as_tensor(ids, device=dev))
        p = r["prompt"]
        rows.append(torch.arange(p - 1, p - 1 + len(r["tokens"]),
                                 device=dev))
    return ref.forward_rows(params, cfg, seqs, rows, a_bits=a_bits)


def check(run, sample: List[Dict], served: _Served) -> None:
    run.compare("wrong_lengths", float(sum(
        len(r["tokens"]) != r["asked"] for r in run.records
        if not r["error"])))
    if not sample:
        run.compare("max_logit_gap", math.inf)
        return
    params = ref.make_params(run.config, run.seed, run.device)
    grp = params["groups"][0]
    for (gr, n), a in served.alpha_a.items():
        grp[gr][n]["alpha_a"].copy_(a)
    logits = reference_rows(params, run.config, sample)
    gap = max(float(served_gaps(lg, r["tokens"]).max())
              for lg, r in zip(logits, sample))
    run.compare("max_logit_gap", gap)
    if getattr(run, "control", False):
        # the reference at the next precision below in the program's
        # place: at each served position, the gap of the token it puts
        # first
        low = reference_rows(params, run.config, sample, a_bits=4)
        run.control_checks = {"max_logit_gap": max(
            float(served_gaps(lg, lo.argmax(dim=-1).tolist()).max())
            for lg, lo in zip(logits, low))}
