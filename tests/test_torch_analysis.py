"""The port's static verification suite against the JAX package: the
graph and Program verifiers raise the reference's check id (and blame) on
each of the reference's seeded corruptions, the pass sandwich blames the
corrupting pass, the gated sites stay at 0 with ``REPRO_VERIFY`` unset,
and the lint gives the reference's findings on the same files, with the
same CLI exit contract; the port's own tree lints clean.

Every comparison here is exact: check ids, blames, counters and findings
are strings and integers.
"""

import _torch_threads  # noqa: F401  (first: caps torch's threads under xdist)

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from repro import analysis as janalysis
from repro.analysis.lint import lint_file as j_lint_file
from repro.analysis.lint import run_lint as j_run_lint
from repro.analysis.verify_ir import VerifyError as JVerifyError
from repro.analysis.verify_ir import verify_graph as j_verify_graph
from repro.analysis.verify_ir import verify_program as j_verify_program
from repro.compiler import passes as jpasses
from repro.compiler.bench_graphs import tiny_mixed_cnn as j_tiny_mixed_cnn
from repro.compiler.ir import Node as JNode
from repro.compiler.lower import compile_graph as j_compile_graph
from repro.models.layers import QuantPolicy as JPolicy

from repro_torch import analysis
from repro_torch.analysis.lint import lint_file, run_lint
from repro_torch.analysis.verify_ir import (VerifyError, verify_graph,
                                            verify_program)
from repro_torch.compiler import passes
from repro_torch.compiler.bench_graphs import tiny_mixed_cnn
from repro_torch.compiler.ir import Graph, Node
from repro_torch.compiler.lower import compile_graph
from repro_torch.models.layers import QuantPolicy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _policy(cls=QuantPolicy):
    return cls(mode="serial", w_bits=2, a_bits=2, radix_bits=7)


def _annotated(pkg):
    """tiny_mixed_cnn after the full pass pipeline, in either package."""
    if pkg == "ref":
        g, _ = j_tiny_mixed_cnn()
        pol = _policy(JPolicy)
        jpasses.run_pipeline(g, pol)
    else:
        g, _ = tiny_mixed_cnn()
        pol = _policy()
        passes.run_pipeline(g, pol)
    return g, pol


# ------------------------------------------------------------ graph defects

def _dangling_output(g, pol, node_cls):
    g.outputs = ["ghost"]
    return {"blame": "mutation"}


def _dangling_node_input(g, pol, node_cls):
    g.nodes.append(node_cls("evil", "relu", ["phantom"], "evil.y"))
    g.outputs = ["evil.y"]
    return {}


def _shape_annotation_lie(g, pol, node_cls):
    g.nodes[0].attrs["shape"] = (1, 2, 3)
    return {"blame": "annotator"}


def _shape_drift(g, pol, node_cls):
    return {"expect_output_shapes": {"y": (None, 999)}}


def _serial(g):
    return next(n for n in g.nodes
                if n.attrs.get("precision", {}).get("mode") == "serial")


def _precision_out_of_range(g, pol, node_cls):
    _serial(g).attrs["precision"]["a_bits"] = 12
    return {}


def _precision_policy_mismatch(g, pol, node_cls):
    _serial(g).attrs["precision"]["a_bits"] = 3
    return {}


def _signedness_mismatch(g, pol, node_cls):
    _serial(g).attrs["precision"]["w_signed"] = False
    return {}


def _unknown_mode(g, pol, node_cls):
    _serial(g).attrs["precision"]["mode"] = "analog"
    return {}


GRAPH_DEFECTS = [_dangling_output, _dangling_node_input,
                 _shape_annotation_lie, _shape_drift,
                 _precision_out_of_range, _precision_policy_mismatch,
                 _signedness_mismatch, _unknown_mode]


def test_clean_graph_verifies_to_the_reference_shapes():
    g, pol = _annotated("port")
    jg, jpol = _annotated("ref")
    assert verify_graph(g, policy=pol) == j_verify_graph(jg, policy=jpol)


@pytest.mark.parametrize("defect", GRAPH_DEFECTS,
                         ids=lambda f: f.__name__.strip("_"))
def test_graph_defect_raises_the_reference_check(defect):
    got = {}
    for pkg, verify, err, node_cls in (
            ("port", verify_graph, VerifyError, Node),
            ("ref", j_verify_graph, JVerifyError, JNode)):
        g, pol = _annotated(pkg)
        kw = defect(g, pol, node_cls)
        with pytest.raises(err) as ei:
            verify(g, policy=pol, **kw)
        got[pkg] = (ei.value.check, ei.value.blame)
    assert got["port"] == got["ref"]


def test_pass_sandwich_blames_the_corrupting_pass(monkeypatch):
    def evil(g):
        g.nodes[0].attrs["shape"] = (6, 6, 6)
        return g
    monkeypatch.setenv("REPRO_VERIFY", "1")
    monkeypatch.setattr(passes, "fuse_epilogues", evil)
    analysis.reset_counters()
    g, _ = tiny_mixed_cnn()
    with pytest.raises(VerifyError) as ei:
        passes.run_pipeline(g, _policy())
    assert ei.value.check == "shape-annotation"
    assert ei.value.blame == "fuse_epilogues"
    assert analysis.counters()["pass_sandwich"] >= 1
    assert passes._PIPELINE == jpasses._PIPELINE


# ---------------------------------------------------------- program defects

@pytest.fixture(scope="module")
def progs():
    g, calib = tiny_mixed_cnn()
    jg, jcalib = j_tiny_mixed_cnn()
    return compile_graph(g, calib, device="cpu"), j_compile_graph(jg, jcalib)


def _replace(prog, **kw):
    if hasattr(prog, "_jit_cache"):
        kw["_jit_cache"] = {}
    return dataclasses.replace(prog, **kw)


def _step_kind(p):
    steps = list(p.steps)
    steps[0] = dataclasses.replace(steps[0], kind="warp_drive")
    return _replace(p, steps=tuple(steps))


def _step_dangling_input(p):
    steps = list(p.steps)
    steps[1] = dataclasses.replace(steps[1], inputs=("ghost",))
    return _replace(p, steps=tuple(steps))


def _step_redefinition(p):
    steps = list(p.steps)
    steps[1] = dataclasses.replace(steps[1], output=steps[0].output)
    return _replace(p, steps=tuple(steps))


def _program_output(p):
    return _replace(p, output_name="ghost")


def _missing_step_params(p):
    victim = p.steps[-1].name
    return _replace(p, params={k: v for k, v in p.params.items()
                               if k != victim})


def _missing_plane(p):
    victim = next(s.name for s in p.steps if s.kind == "conv_packed")
    params = dict(p.params)
    params[victim] = {k: v for k, v in params[victim].items()
                      if k != "w_packed"}
    return _replace(p, params=params)


def _per_layer_bits_vs_spec(p):
    packed = next(s for s in p.steps
                  if s.kind in ("conv_packed", "gemm_packed"))
    bits = dict(p.per_layer_bits)
    bits[packed.name] = (5, 5)
    return _replace(p, per_layer_bits=bits)


def _per_layer_bits_range(p):
    bits = dict(p.per_layer_bits)
    bits[next(iter(bits))] = (9, 2)
    return _replace(p, per_layer_bits=bits)


def _format_plan_output(p):
    meta = dict(p.meta)
    fmt = dict(meta["formats"])
    fmt[p.output_name] = ("codes", "x", 2, True)
    meta["formats"] = fmt
    return _replace(p, meta=meta)


def _format_plan_out_kind(p):
    steps = list(p.steps)
    i = next(i for i, s in enumerate(steps) if s.kind == "conv_packed")
    attrs = dict(steps[i].attrs, out="float")
    steps[i] = dataclasses.replace(steps[i], attrs=attrs)
    return _replace(p, steps=tuple(steps))


PROGRAM_DEFECTS = [_step_kind, _step_dangling_input, _step_redefinition,
                   _program_output, _missing_step_params, _missing_plane,
                   _per_layer_bits_vs_spec, _per_layer_bits_range,
                   _format_plan_output, _format_plan_out_kind]


def test_clean_programs_verify(progs):
    prog, jprog = progs
    verify_program(prog)
    j_verify_program(jprog)


@pytest.mark.parametrize("defect", PROGRAM_DEFECTS,
                         ids=lambda f: f.__name__.strip("_"))
def test_program_defect_raises_the_reference_check(progs, defect):
    prog, jprog = progs
    with pytest.raises(VerifyError) as ei:
        verify_program(defect(prog))
    with pytest.raises(JVerifyError) as jei:
        j_verify_program(defect(jprog))
    assert (ei.value.check, ei.value.blame) == \
        (jei.value.check, jei.value.blame)


# ---------------------------------------------------------------- the gate

def _gemm_graph(cls_g=Graph, cls_n=Node, seed=0):
    rng = np.random.RandomState(seed)
    g = cls_g("gemm_only", {"x": (None, 16)}, ["y"],
              [cls_n("fc", "gemm", ["x", "fc.w"], "y")],
              {"fc.w": (rng.randn(16, 8) * 0.2).astype(np.float32)})
    return g, rng.rand(4, 16).astype(np.float32)


def test_gated_sites_read_zero_with_verify_unset(monkeypatch):
    monkeypatch.delenv("REPRO_VERIFY", raising=False)
    assert not analysis.verify_enabled()
    analysis.reset_counters()
    g, calib = _gemm_graph(seed=1)
    prog = compile_graph(g, calib, device="cpu")
    prog.to_command_stream()
    c = analysis.counters()
    assert all(c[site] == 0 for site in analysis.GATED_SITES), c
    assert analysis.GATED_SITES == janalysis.GATED_SITES
    assert analysis.UNGATED_SITES == janalysis.UNGATED_SITES


def test_enabled_verification_counts_every_site(monkeypatch):
    monkeypatch.setenv("REPRO_VERIFY", "1")
    analysis.reset_counters()
    g, calib = _gemm_graph(seed=2)
    prog = compile_graph(g, calib, device="cpu")
    prog.to_command_stream()
    c = analysis.counters()
    assert c["pass_sandwich"] == len(passes._PIPELINE)
    assert c["post_lowering"] == 1
    assert c["to_command_stream"] == 1


def test_artifact_load_verifies_with_verify_unset(tmp_path, progs,
                                                  monkeypatch):
    from repro_torch.compiler import ArtifactStore, load_program, save_program
    monkeypatch.delenv("REPRO_VERIFY", raising=False)
    store = ArtifactStore(str(tmp_path / "store"))
    ref = save_program(progs[0], store)
    analysis.reset_counters()
    load_program(ref, store, device="cpu")
    c = analysis.counters()
    assert c["artifact_load"] == 1
    assert all(c[site] == 0 for site in analysis.GATED_SITES), c


# --------------------------------------------------------------------- lint

_GUARDED_SRC = '''
import threading

class Box:
    def __init__(self):
        self._lock = threading.Lock()
        self._items = []   # guarded-by: _lock
        self._count = 0    # guarded-by: _lock

    def bad(self, x):
        self._items = [x]

    def bad_aug(self):
        self._count += 1

    def good(self, x):
        with self._lock:
            self._items = [x]

    def helper(self, x):  # requires: _lock
        self._items = [x]

    def silenced(self, x):
        self._items = [x]  # lint: disable=guarded-by
'''

LINT_SOURCES = {
    "guarded_by": _GUARDED_SRC,
    "bare_assert": "def f(x):\n    assert x > 0\n",
    "time_time": "import time\n\ndef f():\n    return time.time()\n",
    "from_time_import": "from time import time\n",
    "mutable_default": "def f(x, acc=[]):\n    return acc\n",
    "mutable_call_default": "def f(x, *, acc=dict()):\n    return acc\n",
    "syntax_error": "def f(:\n",
    "clean": "X = 1\n",
}


def _key(f):
    return (f.check, f.line, f.message, f.symbol)


@pytest.mark.parametrize("name", sorted(LINT_SOURCES))
def test_lint_findings_equal_reference(tmp_path, name):
    p = tmp_path / f"{name}.py"
    p.write_text(LINT_SOURCES[name])
    got, ref = lint_file(str(p)), j_lint_file(str(p))
    assert [_key(f) for f in got] == [_key(f) for f in ref]
    assert (name == "clean") == (not got)


def test_lint_baseline_grandfathers_by_symbol(tmp_path):
    p = tmp_path / "mod.py"
    p.write_text("def f(x):\n    assert x\n")
    findings, _ = run_lint([str(p)])
    assert len(findings) == 1
    baseline = {f.key() for f in findings}
    assert run_lint([str(p)], baseline) == ([], 1)
    assert j_run_lint([str(p)], baseline) == ([], 1)


def _cli(args, cwd=REPO):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    return subprocess.run([sys.executable, "-m", "repro_torch.analysis"]
                          + args, capture_output=True, text=True, env=env,
                          cwd=cwd, timeout=120)


def test_cli_exit_contract_and_baseline_is_only_read(tmp_path):
    clean = tmp_path / "clean.py"
    clean.write_text("X = 1\n")
    dirty = tmp_path / "dirty.py"
    dirty.write_text("def f(x, acc=[]):\n    return acc\n")
    r = _cli([str(clean)])
    assert r.returncode == 0 and "clean" in r.stdout
    r = _cli([str(dirty)], cwd=str(tmp_path))
    assert r.returncode == 1 and "mutable-default" in r.stdout
    assert not os.path.exists(tmp_path / ".analysis-baseline.json")
    r = _cli([str(tmp_path / "nope.py")])
    assert r.returncode == 2
    out = tmp_path / "base.json"
    r = _cli([str(dirty), "--write-baseline", str(out)], cwd=str(tmp_path))
    assert r.returncode == 0 and "wrote 1" in r.stdout
    assert [e["check"] for e in json.loads(out.read_text())] == \
        ["mutable-default"]
    r = _cli([str(dirty), "--baseline", str(out)], cwd=str(tmp_path))
    assert r.returncode == 0 and "1 grandfathered" in r.stdout
    r = _cli(["--write-baseline"])          # a path is required
    assert r.returncode == 2


def test_cli_port_tree_is_clean():
    r = _cli([os.path.join("src", "repro_torch")])
    assert r.returncode == 0, r.stdout + r.stderr
    assert _cli([]).returncode == 0          # default path: the port
