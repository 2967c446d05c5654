"""Nothing the benchmark runs imports JAX or the JAX package ``repro``,
compared by whole top-level module names (``repro_torch`` begins with
``repro``), and the references import nothing of the program."""

import ast
import json
import os
import subprocess
import sys

import pytest

from _portbench_cpu import MANIFEST, ROOT, harness

PKG = ROOT / "portbench"


def test_names_are_compared_whole():
    mods = {"repro_torch": 0, "repro_torch.serving": 0, "reprox": 0,
            "repro": 0, "repro.core.quant": 0, "jax": 0, "jaxlib.xla": 0,
            "flax.linen": 0, "jax_extra": 0, "numpy": 0}
    assert harness.forbidden_modules(mods) == [
        "flax.linen", "jax", "jaxlib.xla", "repro", "repro.core.quant"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(
    p.relative_to(PKG).as_posix() for p in PKG.rglob("*.py")
    if "tests" not in p.parts and "__pycache__" not in p.parts))
def test_no_module_of_the_benchmark_imports_jax_or_repro(path):
    tops = {m.split(".")[0] for m in _imports(PKG / path)}
    assert not tops & set(harness.FORBIDDEN)
    if path.startswith(("reference/", "work/")):
        assert "repro_torch" not in tops
        assert not {m for m in _imports(PKG / path)
                    if m.startswith("portbench.systems")}


def test_the_run_path_loads_no_forbidden_module():
    code = (
        "import sys, json; sys.path[:0] = [sys.argv[1], sys.argv[1] + '/src']\n"
        "from portbench import harness, control, loadgen\n"
        "from portbench.systems import lm_engine, cnn_program\n"
        "for k in ('closed_loop', 'offline_batches'): loadgen.kind(k)\n"
        "import repro_torch.serving, repro_torch.launch.serve\n"
        "import repro_torch.compiler.executor, repro_torch.models.resnet\n"
        "for m in json.load(open(sys.argv[1] + '/BENCHMARK.json'))"
        "['per_layer']: harness.metric_reader(m['name'])\n"
        "print(json.dumps(harness.forbidden_modules()))\n")
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_a_checkout_without_the_program_gives_no_result(tmp_path):
    (tmp_path / "portbench").symlink_to(PKG)
    (tmp_path / "BENCHMARK.json").write_text(
        (ROOT / "BENCHMARK.json").read_text())
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "resnet9.offline_b256", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_no_card_gives_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         MANIFEST["workloads"][-1]["name"], "--seed", str(2 ** 33),
         "--seconds", "1", "--trace", "1"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr
