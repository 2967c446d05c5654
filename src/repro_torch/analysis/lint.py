"""Concurrency / convention lint (AST-based, zero imports of the code
under analysis).

The port's copy of ``repro/analysis/lint.py``: the same checks, the same
suppressions and the same baseline matching, so both packages' lints give
the same findings on the same files.

Checks:

* ``guarded-by`` — the concurrency convention: an attribute whose
  declaration (typically in ``__init__``) carries a trailing
  ``# guarded-by: <lock>`` comment may only be written while that lock is
  lexically held (``with self.<lock>:``), inside ``__init__``, or inside a
  method whose ``def`` line carries ``# requires: <lock>`` (caller holds
  the lock — e.g. a ``_commit`` helper only ever called under ``admit``'s
  lock). Reads are not flagged: the convention targets lost updates on
  shared ``InferenceService``/``DynamicBatcher``/``ModelRegistry``/
  ``ArtifactStore`` state.
* ``bare-assert`` — ``assert`` in library code vanishes under
  ``python -O``; invariants must raise typed exceptions.
* ``time-time`` — ``time.time()`` on timing paths is wall-clock and
  jumps with NTP; use ``time.perf_counter()``.
* ``mutable-default`` — mutable default arguments are shared across
  calls.

A finding on a line carrying ``# lint: disable=<check>`` is suppressed.
Grandfathered findings live in a JSON baseline (list of
``{check, file, symbol}``), matched by symbol rather than line so
unrelated edits do not resurrect them. The shipped tree's baseline is
empty.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
import re
from typing import Dict, List, Optional, Sequence, Set, Tuple

__all__ = ["Finding", "run_lint", "lint_file", "load_baseline"]

CHECKS = ("guarded-by", "bare-assert", "time-time", "mutable-default",
          "syntax-error")

_GUARDED_RE = re.compile(r"#\s*guarded-by:\s*([A-Za-z_]\w*)")
_REQUIRES_RE = re.compile(r"#\s*requires:\s*([A-Za-z_]\w*)")
_DISABLE_RE = re.compile(r"#\s*lint:\s*disable=([\w,-]+)")


@dataclasses.dataclass(frozen=True)
class Finding:
    check: str
    path: str
    line: int
    message: str
    symbol: str = ""

    def key(self) -> Tuple[str, str, str]:
        """Baseline identity: line numbers shift, symbols rarely do."""
        return (self.check, self.path.replace(os.sep, "/"), self.symbol)

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.check}] {self.message}"


def _suppressed(lines: List[str], lineno: int, check: str) -> bool:
    if 1 <= lineno <= len(lines):
        m = _DISABLE_RE.search(lines[lineno - 1])
        if m and check in m.group(1).split(","):
            return True
    return False


def _self_attr_root(node) -> Optional[str]:
    """``self.x``, ``self.x[k]``, ``self.x[k][h]`` → ``"x"``."""
    while isinstance(node, ast.Subscript):
        node = node.value
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def _with_locks(node) -> Set[str]:
    """Lock attrs entered by a ``with`` statement (``with self.X: ...``)."""
    locks: Set[str] = set()
    for item in node.items:
        ce = item.context_expr
        if (isinstance(ce, ast.Attribute)
                and isinstance(ce.value, ast.Name)
                and ce.value.id == "self"):
            locks.add(ce.attr)
    return locks


class _FileLint:
    def __init__(self, path: str, source: str):
        self.path = path
        self.lines = source.splitlines()
        self.findings: List[Finding] = []

    def emit(self, check: str, lineno: int, message: str,
             symbol: str = "") -> None:
        if not _suppressed(self.lines, lineno, check):
            self.findings.append(
                Finding(check, self.path, lineno, message, symbol))

    # ------------------------------------------------------------ traversal
    def run(self) -> List[Finding]:
        try:
            tree = ast.parse("\n".join(self.lines), filename=self.path)
        except SyntaxError as e:
            self.findings.append(Finding(
                "syntax-error", self.path, e.lineno or 1, str(e.msg)))
            return self.findings
        self._walk(tree, qual="")
        return self.findings

    def _walk(self, node, qual: str) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                self._lint_class(child, f"{qual}{child.name}.")
                self._walk(child, f"{qual}{child.name}.")
            elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                sym = f"{qual}{child.name}"
                self._lint_function(child, sym)
                self._walk(child, f"{sym}.")
            else:
                self._lint_stmts(child, qual)
                self._walk(child, qual)

    # ------------------------------------------------- per-construct checks
    def _lint_function(self, fn, sym: str) -> None:
        args = fn.args
        defaults = list(args.defaults) + list(args.kw_defaults)
        for d in defaults:
            if d is None:
                continue
            mutable = isinstance(d, (ast.List, ast.Dict, ast.Set)) or (
                isinstance(d, ast.Call) and isinstance(d.func, ast.Name)
                and d.func.id in ("list", "dict", "set"))
            if mutable:
                self.emit("mutable-default", d.lineno,
                          f"{sym}: mutable default argument is shared "
                          "across calls — default to None", sym)

    def _lint_stmts(self, node, qual: str) -> None:
        if isinstance(node, ast.Assert):
            self.emit("bare-assert", node.lineno,
                      f"bare assert vanishes under python -O — raise a "
                      "typed exception", qual.rstrip("."))
        if isinstance(node, ast.Attribute) and node.attr == "time" and \
                isinstance(node.value, ast.Name) and node.value.id == "time":
            self.emit("time-time", node.lineno,
                      "time.time() is NTP-steppable wall clock — use "
                      "time.perf_counter() on timing paths",
                      qual.rstrip("."))
        if isinstance(node, ast.ImportFrom) and node.module == "time":
            for alias in node.names:
                if alias.name == "time":
                    self.emit("time-time", node.lineno,
                              "importing time.time — use "
                              "time.perf_counter() on timing paths",
                              qual.rstrip("."))

    # -------------------------------------------------------- guarded-by
    def _lint_class(self, cls, qual: str) -> None:
        guards: Dict[str, str] = {}
        for node in ast.walk(cls):
            if isinstance(node, (ast.Assign, ast.AnnAssign)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                for t in targets:
                    attr = _self_attr_root(t)
                    if attr is None:
                        continue
                    lo = node.lineno
                    hi = min(getattr(node, "end_lineno", lo) or lo,
                             len(self.lines))
                    for ln in range(lo, hi + 1):
                        m = _GUARDED_RE.search(self.lines[ln - 1])
                        if m:
                            guards[attr] = m.group(1)
                            break
        if not guards:
            return
        for item in cls.body:
            if not isinstance(item, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                continue
            if item.name == "__init__":
                continue  # construction precedes sharing
            held: Set[str] = set()
            for ln in range(item.lineno,
                            min(item.body[0].lineno, len(self.lines)) + 1):
                m = _REQUIRES_RE.search(self.lines[ln - 1])
                if m:
                    held.add(m.group(1))
            self._check_method(item, guards, held,
                               f"{qual}{item.name}")

    def _check_method(self, node, guards: Dict[str, str],
                      held: Set[str], sym: str) -> None:
        if isinstance(node, (ast.With, ast.AsyncWith)):
            held = held | _with_locks(node)
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                attr = _self_attr_root(t)
                lock = guards.get(attr) if attr else None
                if lock is not None and lock not in held:
                    self.emit(
                        "guarded-by", node.lineno,
                        f"{sym} writes self.{attr} (guarded-by {lock}) "
                        f"without holding self.{lock} — wrap in "
                        f"'with self.{lock}:' or annotate the method "
                        f"'# requires: {lock}'", f"{sym}.{attr}")
        for child in ast.iter_child_nodes(node):
            self._check_method(child, guards, held, sym)


# --------------------------------------------------------------------------
# driver
# --------------------------------------------------------------------------

def lint_file(path: str) -> List[Finding]:
    with open(path, encoding="utf-8") as f:
        source = f.read()
    rel = os.path.relpath(path)
    return _FileLint(rel, source).run()


def _collect(paths: Sequence[str]) -> List[str]:
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, _dirs, files in os.walk(p):
                out += [os.path.join(root, f) for f in sorted(files)
                        if f.endswith(".py")]
        elif p.endswith(".py"):
            out.append(p)
    return out


def load_baseline(path: str) -> Set[Tuple[str, str, str]]:
    with open(path, encoding="utf-8") as f:
        entries = json.load(f)
    return {(e["check"], e["file"], e.get("symbol", ""))
            for e in entries}


def run_lint(paths: Sequence[str],
             baseline: Optional[Set[Tuple[str, str, str]]] = None,
             ) -> Tuple[List[Finding], int]:
    """Lint every ``.py`` under ``paths``; returns ``(findings,
    n_grandfathered)`` with baseline-matched findings filtered out."""
    baseline = baseline or set()
    findings: List[Finding] = []
    grandfathered = 0
    for path in _collect(paths):
        for f in lint_file(path):
            if f.key() in baseline:
                grandfathered += 1
            else:
                findings.append(f)
    return findings, grandfathered
