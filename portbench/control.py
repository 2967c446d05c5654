"""Readings the limits of ``portbench/checks/<cell>.json`` are set from:
the program's sound runs and the control's, on many seeds, in one
process.

    python3 portbench/control.py --workload <cell> --seconds <s> --seeds <n1> <n2> ...

For each seed it runs the cell (a window of ``--seconds``, long enough to
finish the mix's longest requests) and prints one JSON line: the numbers
the check compared for the program, and the same numbers for the
control — the plain reference put in the program's place at the next
precision below the configuration's (an LM's activations at int4 instead
of int8; the CNN's float32 host layers at TF32). A limit lies above the
largest sound reading and below the smallest control reading.
"""

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:] = [str(ROOT), str(ROOT / "src")] + [
    p for p in sys.path if Path(p or ".").resolve() != ROOT / "portbench"]


def main(argv=None) -> int:
    import argparse

    import torch

    from portbench import harness
    ap = argparse.ArgumentParser(prog="python3 portbench/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = harness.Cell(manifest, args.workload)
    if not torch.cuda.is_available():
        print("portbench: the control runs on the card", file=sys.stderr)
        return 3
    for seed in args.seeds:
        run = harness.Run(cell, seed=seed, seconds=args.seconds,
                          trace=False, device=torch.device("cuda", 0),
                          t_process=time.perf_counter())
        run.control = True
        harness.drive(run)
        print(json.dumps({
            "workload": args.workload, "seed": seed,
            "program": {k: v["value"] for k, v in run.checks.items()},
            "control": getattr(run, "control_checks", None),
            "requests_or_batches": len(run.records) or None}), flush=True)
        del run
    return 0


if __name__ == "__main__":
    sys.exit(main())
