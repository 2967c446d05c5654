"""Each cell for 30 seconds on the card (a conversation round lasts ~8.4 s), as
the driver runs it (a fresh process from the root of the checkout);
skips where there is no card.
Run on the card with ``python -m pytest -m cuda portbench/tests``."""

import json
import subprocess
import sys

import pytest

from _portbench_cpu import MANIFEST, ROOT


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the benchmark measures the card")


@pytest.mark.cuda
@pytest.mark.parametrize("workload",
                         [w["name"] for w in MANIFEST["workloads"]])
def test_cell_runs_correct_on_the_card(card, workload):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", workload,
         "--seed", str(2 ** 31 + 17), "--seconds", "30", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"
    assert list(line)[-1] == "checks"
