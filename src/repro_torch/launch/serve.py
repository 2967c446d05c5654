"""CNN serving on the port: graph → compile → padding-bucket runner →
``classify``.

Counterpart of ``CNNServer`` in ``repro/launch/serve.py``. The model is
compiled once (passes, calibration, ahead-of-time weight packing) onto the
card, and every batch runs through :class:`~repro_torch.compiler.executor.
BucketedRunner`. The reference's registry, dynamic batcher and artifact
store are not ported yet; neither is the LM server.

    python -m repro_torch.launch.serve --arch resnet9-cifar10 --batch 32
    python -m repro_torch.launch.serve --arch resnet9-cifar10 --batch 4 --device cpu
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.compiler.executor import BucketedRunner
from repro_torch.compiler.lower import compile_graph
from repro_torch.core.pipeline_modules import disable_tf32
from repro_torch.models.layers import QuantPolicy
from repro_torch.models.resnet import ResNet9Config, resnet9_graph, resnet9_init

__all__ = ["CNNServer", "main"]

ARCHS = ("resnet9-cifar10",)


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


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="resnet9-cifar10", choices=ARCHS)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
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
