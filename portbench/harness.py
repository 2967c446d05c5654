"""The benchmark's driver: find the cell in ``BENCHMARK.json``, load its
configuration, traffic and metrics by name, run its system once, check
what the timed path produced, and print the result line.

Everything that belongs to one configuration, traffic mix or metric sits
in a file of its own, found by the name ``BENCHMARK.json`` gives:

* ``portbench/configs/<config>.json`` — the configuration as it is run;
  its ``system`` names ``portbench/systems/<system>.py``, which builds
  the program from the seed and checks its answers;
* ``portbench/traffic/<traffic>.json`` — the mix; its ``kind`` names
  ``portbench/kinds/<kind>.py``, which generates the requests and drives
  the window through the system (:mod:`portbench.loadgen`);
* ``portbench/metrics/<metric>.py`` — one reader per metric,
  ``read(run) -> float | None``;
* ``portbench/checks/<workload>.json`` — the limits of the numbers the
  cell's check compares.

Standard output's last line is the result; standard error's last lines
are the numbers compared, each beside its limit.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

from portbench import loadgen

__all__ = ["ROOT", "Cell", "Run", "main", "forbidden_modules",
           "metric_reader"]

ROOT = Path(__file__).resolve().parents[1]
PKG = Path(__file__).resolve().parent
#: top-level module names the process may not hold once the window closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class Cell:
    """One workload of ``BENCHMARK.json`` with its configuration, traffic,
    metrics and limits, all found by name."""

    def __init__(self, manifest: Dict, name: str, root: Path = ROOT):
        cells = {w["name"]: w for w in manifest["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                           f"{sorted(cells)}")
        self.workload = cells[name]
        self.name = name
        configs = {c["name"]: c for c in manifest["configs"]}
        entry = configs[self.workload["config"]]
        self.config = json.loads((root / entry["file"]).read_text())
        self.traffic = loadgen.load(self.workload["traffic"],
                                    root / "portbench" / "traffic",
                                    root / "portbench" / "kinds")
        self.end_to_end = [m for m in manifest["end_to_end"]
                           if name in m.get("workloads", [name])]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in manifest["per_layer"]
                          if (name in m["workloads"] if "workloads" in m
                              else m["moves"] in reported)]
        self.limits = json.loads(
            (root / "portbench" / "checks" / f"{name}.json").read_text())


class Run:
    """What one run of a cell produced and measured, for the metric
    readers: the system fills it."""

    def __init__(self, cell: Cell, *, seed: int, seconds: float,
                 trace: bool, device, t_process: float):
        self.cell = cell
        self.config = cell.config
        self.traffic = cell.traffic
        self.seed = seed
        self.seconds = seconds
        self.trace = trace
        self.device = device
        self.t_process = t_process
        self.setup_s: Optional[float] = None
        #: the window on the host clock (perf_counter seconds)
        self.t0: Optional[float] = None
        self.t1: Optional[float] = None
        #: program counters read at the window's start and after its end
        self.counters: Dict[str, Dict] = {}
        #: host spans by name: lists of (start_s, end_s)
        self.spans: Dict[str, List] = {}
        #: per request (serving) or per batch (offline) records
        self.records: List[Dict] = []
        self.slice = None
        self.memory_peak_bytes: Optional[int] = None
        #: name -> {"value", "limit"}: the numbers the check compared
        self.checks: Dict[str, Dict] = {}
        self.attempted = 0
        self.failed = 0
        #: set-up's phases: (name, host clock at its end)
        self.marks: List = [("start", t_process)]
        #: the round a traced run records, where rounds are counted: the
        #: rates read from that run count only the rounds before it
        self.traced_round: Optional[int] = None

    def mark(self, name: str) -> None:
        """The end of a phase of set-up."""
        self.marks.append((name, time.perf_counter()))

    def phases(self) -> str:
        return ", ".join(f"{b[0]} {b[1] - a[1]:.3f} s"
                         for a, b in zip(self.marks, self.marks[1:]))

    def counter_delta(self, name: str) -> float:
        return self.counters["after"][name] - self.counters["before"][name]

    def limit(self, name: str) -> float:
        return float(self.cell.limits[name]["limit"])

    def compare(self, name: str, value: float) -> None:
        self.checks[name] = {"value": value, "limit": self.limit(name)}

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(
            c["value"] <= c["limit"] for c in self.checks.values())


def metric_reader(name: str, root: Path = PKG):
    """The ``read`` function of ``portbench/metrics/<name>.py``."""
    path = root / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules(modules=None) -> List[str]:
    """The modules whose top-level name (the part before the first dot)
    is one of :data:`FORBIDDEN`, compared whole."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in modules if m.split(".")[0] in FORBIDDEN)


def _args(argv):
    ap = argparse.ArgumentParser(prog="python3 portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def _cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the port's own ``build/repro_torch/`` is fixed there already)."""
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "portbench" /
                                         "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "portbench" /
                                             "torch_extensions")
    os.environ["USE_FLAX"] = "0"


def _fail(msg: str, code: int) -> int:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    return code


def main(argv=None, *, t_process: Optional[float] = None) -> int:
    t_process = time.perf_counter() if t_process is None else t_process
    args = _args(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        return _fail("the program (src/repro_torch) is not in this "
                     "checkout", 2)
    _cache_dirs()
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = Cell(manifest, args.workload)
    chips = int(cell.workload["chips"])
    import torch
    t_imports = time.perf_counter()
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        return _fail(f"{args.workload} needs {chips} CUDA device(s); "
                     f"torch sees {torch.cuda.device_count()}", 3)
    device = torch.device("cuda", 0)
    torch.cuda.init()
    run = Run(cell, seed=args.seed, seconds=args.seconds,
              trace=bool(args.trace), device=device, t_process=t_process)
    run.marks.append(("imports", t_imports))
    run.mark("CUDA context")
    drive(run)
    found = forbidden_modules()
    if found:
        return _fail("the process holds modules it may not: "
                     + ", ".join(found), 4)
    print(json.dumps(result(run)), flush=True)
    return 0


def drive(run: Run) -> None:
    """One run of the cell: its traffic's kind drives the window through
    its configuration's system."""
    system = importlib.import_module(
        f"portbench.systems.{run.config['system']}")
    run.mark("program imports")
    loadgen.kind(run.traffic["kind"]).run(run, system)


def result(run: Run) -> Dict:
    """The result line, and the numbers compared as standard error's last
    lines."""
    import torch
    metrics = {}
    wanted = run.cell.per_layer if run.trace else run.cell.end_to_end
    for m in wanted:
        value = metric_reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = run.device
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else dev.type),
              "count": int(run.cell.workload["chips"]),
              "memory_peak_bytes": run.memory_peak_bytes}
    out = {"correct": run.correct, "attempted": run.attempted,
           "failed": run.failed, "metrics": metrics, "device": device}
    if run.trace and run.slice is not None:
        device["busy_s"] = run.slice.busy_s
        device["window_s"] = run.slice.window_s
        out["breakdown"] = run.slice.breakdown()
    out["checks"] = run.checks
    print(f"portbench: set-up {run.setup_s!r} s: {run.phases()}",
          file=sys.stderr)
    for name, c in run.checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    return out
