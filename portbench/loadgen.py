"""The one general traffic loader: every mix is a data file,
``portbench/traffic/<name>.json``, of parameters; its ``kind`` names the
module that checks them, generates the requests from the seed and drives
the window, ``portbench/kinds/<kind>.py``, found by that name. A later
mix of a known kind is a data file alone; a new kind is a new file, and
no file here changes.

A kind's module has ``check(name, spec)``, which raises ``ValueError``
on parameters it cannot run, and ``run(run, system)``, which drives one
run of a cell through the configuration's system (``portbench/systems/
<system>.py``), as the kind's docstring sets out.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Dict

__all__ = ["load", "kind"]

DIR = Path(__file__).resolve().parent / "traffic"
KINDS = Path(__file__).resolve().parent / "kinds"


_LOADED: Dict[Path, object] = {}


def kind(name: str, root: Path = KINDS):
    """The module ``portbench/kinds/<name>.py``."""
    path = root / f"{name}.py"
    if not path.is_file():
        raise ValueError(f"traffic kind {name!r}: no {path.name} in "
                         f"{root}")
    if path not in _LOADED:
        spec = importlib.util.spec_from_file_location(
            f"portbench.kinds.{name.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _LOADED[path] = mod
    return _LOADED[path]


def load(name: str, root: Path = DIR, kinds: Path = KINDS) -> Dict:
    """The mix ``name``'s parameters, checked by its kind."""
    spec = json.loads((root / f"{name}.json").read_text())
    if not isinstance(spec.get("kind"), str):
        raise ValueError(f"traffic {name}: no kind")
    kind(spec["kind"], kinds).check(name, spec)
    return spec
