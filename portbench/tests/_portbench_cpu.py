"""Shared set-up of the benchmark's CPU tests: smoke-sized copies of the
configurations and mixes, and a run of a cell's system on the CPU (the
harness's look for a card skipped)."""

from __future__ import annotations

import json
import os
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch  # noqa: E402

if os.environ.get("PYTEST_XDIST_WORKER_COUNT"):
    # several workers share the cores: one thread each is enough here
    torch.set_num_threads(max(1, (os.cpu_count() or 1)
                              // int(os.environ["PYTEST_XDIST_WORKER_COUNT"])))

from portbench import harness  # noqa: E402

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())


def config(name: str) -> dict:
    return json.loads((ROOT / "portbench" / "configs"
                       / f"{name}.json").read_text())


def smoke_lm() -> dict:
    cfg = config("stablelm_2_1_6b_w4a8")
    cfg.update(hidden_size=64, intermediate_size=128, num_attention_heads=4,
               num_key_value_heads=4, num_hidden_layers=2, vocab_size=512)
    cfg["serving"] = dict(cfg["serving"], calib_tokens=16)
    return cfg


def smoke_cnn() -> dict:
    cfg = config("resnet9_cifar10_w2a2")
    cfg.update(input_hw=8, stem_channels=32, layers=[
        ["conv1", 32, 32, 1, False], ["conv2", 32, 32, 1, False],
        ["conv3", 32, 64, 2, False], ["conv4", 64, 64, 1, True],
        ["conv5", 64, 64, 2, False], ["conv6", 64, 64, 1, False]])
    return cfg


LM_TRAFFIC = {"kind": "closed_loop", "source": "smoke", "clients": 4,
              "prompt_tokens": [5, 20], "output_tokens": [3, 8],
              "engine": {"batch_slots": 4, "max_len": 32},
              "service": {"max_batch": 4, "max_wait_s": 0.05},
              "check_requests": 2}
CNN_TRAFFIC = {"kind": "offline_batches", "batch": 8, "in_flight": 2,
               "distinct_batches": 3, "check_batches": 2,
               "trace_slice_s": 0.2}


#: the end-to-end metrics each system's cells report
REPORTS = {"lm_engine": ("setup_s", "tokens_per_s", "request_p95_ms",
                         "peak_mem_gib"),
           "cnn_program": ("setup_s", "img_per_s", "peak_mem_gib")}


def cell(workload: str, cfg: dict, traffic: dict):
    """``workload``'s limits as ``portbench/checks`` gives them, and the
    metrics its system reports, over a smoke configuration and mix."""
    limits = json.loads((ROOT / "portbench" / "checks"
                         / f"{workload}.json").read_text())
    return types.SimpleNamespace(
        name=workload, workload={"chips": 1}, config=cfg, traffic=traffic,
        end_to_end=[{"name": n, "unit": "-"}
                    for n in REPORTS[cfg["system"]]],
        per_layer=[], limits=limits)


def run_cpu(workload: str, cfg: dict, traffic: dict, *,
            seed: int = 2 ** 33 + 5, seconds: float = 1.0,
            trace: bool = False):
    """One run of ``workload`` on the CPU, its traffic's kind driving its
    configuration's system; returns the ``Run`` and its result line."""
    run = harness.Run(cell(workload, cfg, traffic), seed=seed,
                      seconds=seconds, trace=trace,
                      device=torch.device("cpu"),
                      t_process=time.perf_counter())
    harness.drive(run)
    return run, harness.result(run)
