"""Canonical tiny workloads: the port's copy of
``repro/compiler/bench_graphs.py`` (same numbers from the same numpy
seeds), so a test or ``chip_smoke.py`` can drive the compiled packed-GEMM
step with the reference's model.
"""

from __future__ import annotations

import numpy as np

from repro_torch.compiler.ir import Graph, Node

__all__ = ["tiny_mixed_cnn"]


def tiny_mixed_cnn(seed: int = 0):
    """``(graph, calib)``: two packed convs + gap + gemm on 8x8x8 inputs.
    Compiled, its steps are ``quantize_pack, conv_packed, conv_packed,
    global_pool, quantize_pack, gemm_packed``: the smallest Program that
    runs both K2 and K3."""
    rng = np.random.RandomState(seed)
    g = Graph(
        "tiny_cnn", {"x": (None, 8, 8, 8)}, ["y"],
        [Node("c1", "conv2d", ["x", "c1.w"], "c1.y",
              {"stride": 1, "padding": 1}),
         Node("c1.relu", "relu", ["c1.y"], "c1.r"),
         Node("c2", "conv2d", ["c1.r", "c2.w"], "c2.y",
              {"stride": 1, "padding": 1}),
         Node("c2.relu", "relu", ["c2.y"], "c2.r"),
         Node("gap", "global_avg_pool", ["c2.r"], "pooled"),
         Node("fc", "gemm", ["pooled", "fc.w"], "y")],
        {"c1.w": (rng.randn(3, 3, 8, 16) * 0.2).astype(np.float32),
         "c2.w": (rng.randn(3, 3, 16, 16) * 0.2).astype(np.float32),
         "fc.w": (rng.randn(16, 10) * 0.2).astype(np.float32)})
    calib = np.random.RandomState(42).rand(4, 8, 8, 8).astype(np.float32)
    return g, calib
