"""CLI: ``python -m repro_torch.analysis [paths...]``.

Exit-code contract (what CI keys on): **0** clean, **1** findings,
**2** usage error. Default path is ``src/repro_torch``; the default
baseline is ``.analysis-baseline.json`` in the current directory when
present (``--baseline ''`` disables). The CLI only reads a baseline:
``--write-baseline PATH`` grandfathers the current findings into ``PATH``
instead of failing on them.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from repro_torch.analysis.lint import load_baseline, run_lint

DEFAULT_BASELINE = ".analysis-baseline.json"
DEFAULT_PATH = os.path.join("src", "repro_torch")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="concurrency/convention lint (exit 0 clean, 1 "
                    "findings, 2 usage error)")
    ap.add_argument("paths", nargs="*", default=None,
                    help=f"files/directories to lint (default: "
                         f"{DEFAULT_PATH})")
    ap.add_argument("--baseline", default=None,
                    help=f"baseline JSON (default: {DEFAULT_BASELINE} "
                         "when present; '' disables)")
    ap.add_argument("--write-baseline", default=None, metavar="PATH",
                    help="write current findings to PATH as a baseline "
                         "and exit 0")
    try:
        args = ap.parse_args(argv)
    except SystemExit as e:
        return 0 if e.code in (0, None) else 2
    paths = args.paths or [DEFAULT_PATH]
    missing = [p for p in paths if not os.path.exists(p)]
    if missing:
        print(f"error: no such path(s): {missing}", file=sys.stderr)
        return 2

    baseline_path = args.baseline
    if baseline_path is None:
        baseline_path = (DEFAULT_BASELINE
                         if os.path.exists(DEFAULT_BASELINE) else "")
    baseline = set()
    if baseline_path and args.write_baseline is None:
        try:
            baseline = load_baseline(baseline_path)
        except (OSError, ValueError, KeyError) as e:
            print(f"error: unreadable baseline {baseline_path!r}: {e}",
                  file=sys.stderr)
            return 2

    findings, grandfathered = run_lint(paths, baseline)

    if args.write_baseline is not None:
        entries = [{"check": f.check, "file": f.key()[1],
                    "symbol": f.symbol} for f in findings]
        with open(args.write_baseline, "w", encoding="utf-8") as fh:
            json.dump(entries, fh, indent=1, sort_keys=True)
            fh.write("\n")
        print(f"wrote {len(entries)} grandfathered finding(s) to "
              f"{args.write_baseline}")
        return 0

    for f in findings:
        print(f)
    tail = f" ({grandfathered} grandfathered)" if grandfathered else ""
    if findings:
        print(f"{len(findings)} finding(s){tail}")
        return 1
    print(f"clean{tail}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
