"""The ResNet9 plain CNN compiled to the port's packed Program and run
through the executor's bucketed runner: the system of the
``offline_batches`` kind (``portbench/kinds/offline_batches.py``).

The timed path is the paper's own flow: the graph is registered in the
serving runtime's ``ModelRegistry`` as ``CNNServer`` registers it, which
compiles it (passes, calibration on the seeded calibration images, weight
packing) to a Program; ``compiler/executor.py`` ``BucketedRunner`` wraps
that Program, so every batch of ``batch`` images is one replay of the
bucket's CUDA graph (conv0 on the host path, K1, the eight K2 convs, the
pools, the fc).

Set-up (:func:`offline`): the weights and calibration images from the
seed, the Program compiled, ``distinct_batches`` batches of images made
on the device, the bucket's graph captured.

The check (:func:`check`), after the window and after the program is
freed: the sampled batches are recomputed by the plain reference (its own
calibration, quantization and integer convs). Per image the error is the
largest logit difference over the largest reference logit; the numbers
compared are the share of images whose error exceeds 1e-3
(``mismatch_share``) and the largest error (``max_err``).
"""

from __future__ import annotations

import gc
import types
from typing import Dict, List

import torch

from portbench.reference import resnet9 as ref

__all__ = ["offline", "check", "image_errors", "MISMATCH"]

#: an image whose logits differ from the reference's by more than this
#: share of its largest reference logit counts as a mismatch
MISMATCH = 1e-3


def _program(run, params: Dict, calib: torch.Tensor):
    """The Program the serving runtime compiles from the graph, and the
    bucketed runner over it."""
    from repro_torch.compiler import executor
    from repro_torch.models.layers import QuantPolicy
    from repro_torch.models.resnet import resnet9_graph
    from repro_torch.serving import ModelRegistry
    cfg = run.config
    table = types.SimpleNamespace(
        layers=tuple(tuple(layer) for layer in cfg["layers"]),
        num_classes=int(cfg["num_classes"]))
    host = {k: {n: t.cpu().numpy() for n, t in v.items()}
            for k, v in params.items()}
    graph = resnet9_graph(host, table, input_hw=int(cfg["input_hw"]))
    policy = QuantPolicy(mode="serial", w_bits=int(cfg["w_bits"]),
                         a_bits=int(cfg["a_bits"]),
                         w_signed=bool(cfg["w_signed"]),
                         a_signed=bool(cfg["a_signed"]),
                         radix_bits=int(cfg["radix_bits"]))
    registry = ModelRegistry(device=run.device)
    key = registry.register_graph(cfg["name"], graph,
                                  calib.cpu().numpy(), policy)
    program = registry.program(key)
    runner = executor.make_bucketed_runner(
        program, max_batch=int(run.traffic["batch"]))
    return registry, runner


class _Offline:
    """The bucketed runner over the compiled Program, its graph captured,
    and the seeded batches it is fed (``pool``, on the device)."""

    def __init__(self, run):
        from repro_torch.core.pipeline_modules import disable_tf32
        cfg, spec = run.config, run.traffic
        dev = self.device = run.device
        batch = int(spec["batch"])
        if dev.type == "cuda":
            # what the program's entry points (CNNServer, the engine) do
            # first: the host conv0 and fc in full float32, as the
            # configuration states
            disable_tf32()
        params = ref.make_params(cfg, run.seed, dev)
        calib = ref.make_images(cfg, run.seed, "cnn.calib",
                                int(cfg["calib_images"]), dev)
        run.mark("inputs")
        self.registry, self.runner = _program(run, params, calib)
        del params, calib
        run.mark("compile")
        pool = ref.make_images(cfg, run.seed, "cnn.batches",
                               int(spec["distinct_batches"]) * batch, dev)
        self.pool = pool.reshape((-1, batch) + tuple(pool.shape[1:]))
        self.classes = int(cfg["num_classes"])
        with torch.no_grad():
            self.runner(self.pool[0])          # the bucket's capture
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        run.mark("warm-up")

    def __call__(self, x):
        return self.runner(x)

    def close(self) -> None:
        """Free the program (the pool stays, for the check)."""
        self.registry = self.runner = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def offline(run) -> _Offline:
    return _Offline(run)


def image_errors(logits: torch.Tensor, reference: torch.Tensor):
    """Per image: the largest logit difference over the largest reference
    logit (by magnitude)."""
    diff = (logits - reference).abs().amax(dim=1)
    return diff / reference.abs().amax(dim=1).clamp_min(1e-12)


def check(run, kept: List, offline: _Offline) -> None:
    """``kept``: the sampled ``(batch index, logits)``."""
    pool = offline.pool
    if not kept:
        run.compare("mismatch_share", float("inf"))
        run.compare("max_err", float("inf"))
        return
    cfg, dev = run.config, run.device
    params = ref.make_params(cfg, run.seed, dev)
    calib = ref.make_images(cfg, run.seed, "cnn.calib",
                            int(cfg["calib_images"]), dev)
    steps = ref.calibrate(params, cfg, calib)
    control = getattr(run, "control", False)
    errs, low = [], []
    for i, logits in kept:
        x = pool[i % pool.shape[0]]
        want = ref.forward(params, cfg, steps, x)
        errs.append(image_errors(torch.as_tensor(logits, device=dev), want))
        if control:
            # the reference at the next precision below (TF32 host
            # layers) in the program's place
            low.append(image_errors(
                ref.forward(params, cfg, steps, x, host_tf32=True), want))
    for name, value in _numbers(torch.cat(errs)).items():
        run.compare(name, value)
    if control:
        run.control_checks = _numbers(torch.cat(low))


def _numbers(errs: torch.Tensor) -> Dict[str, float]:
    return {"mismatch_share": float((errs > MISMATCH).float().mean()),
            "max_err": float(errs.max())}
