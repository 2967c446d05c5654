"""Typed graph IR — the front half of the code generator (paper §3.3).

The port's own copy of ``repro/compiler/ir.py`` (numpy only), so the port
imports nothing of the reference. A :class:`Graph` is a flat
single-assignment DAG of :class:`Node` ops over named tensors, with
weights/constants held as ``initializers`` (numpy arrays). Producers:

* :func:`graph_from_dict` / :func:`graph_to_dict` — the **native format**
  (plain dicts, JSON-serializable), the same payload as the reference's,
* hand construction — e.g. :func:`repro_torch.models.resnet.resnet9_graph`.

The op vocabulary is the paper's CNN subset (§3.1): Conv2D, Gemm, ReLU,
MaxPool, global average pool, Flatten, Add, Requantize — plus the fused
epilogue ops (``fused_conv2d``/``fused_gemm``) that only the fusion pass in
:mod:`repro_torch.compiler.passes` may introduce. Layout is NHWC / HWIO
throughout.

Conv2D/Gemm input slots are positional with ``""`` marking an absent
optional operand: ``(x, w, scale, bias)`` — ``scale`` is the per-output-
channel multiplier the MVU scaler RAM applies (folded batch norm), ``bias``
the bias RAM contents.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["Node", "Graph", "GraphError", "UnsupportedOpError", "OPS",
           "FUSED_OPS", "graph_to_dict", "graph_from_dict", "graph_to_json",
           "graph_from_json"]

#: importable op vocabulary (what front ends may emit).
OPS = frozenset({
    "conv2d", "gemm", "matmul", "relu", "maxpool", "global_avg_pool",
    "flatten", "add", "requantize",
})

#: pass-introduced fused-epilogue ops (never produced by an importer).
FUSED_OPS = frozenset({"fused_conv2d", "fused_gemm"})


class GraphError(ValueError):
    """Malformed graph: dangling tensors, duplicate definitions, cycles."""


class UnsupportedOpError(GraphError):
    """An importer met an op outside the supported subset."""


@dataclasses.dataclass
class Node:
    """One op. ``inputs`` name tensors (graph inputs, initializers or other
    nodes' outputs); ``""`` marks an absent optional slot. ``output`` is the
    single tensor this node defines. ``attrs`` hold op parameters (stride,
    padding, window, precisions, ...) — JSON-plain values only."""

    name: str
    op: str
    inputs: List[str]
    output: str
    attrs: Dict = dataclasses.field(default_factory=dict)

    def real_inputs(self) -> List[str]:
        return [i for i in self.inputs if i]


@dataclasses.dataclass
class Graph:
    """A single-assignment op DAG. ``inputs`` maps graph-input tensor names
    to shapes (``None`` dims allowed for deferred batch); ``outputs`` names
    the result tensors; ``initializers`` holds weights/constants."""

    name: str
    inputs: Dict[str, Tuple]
    outputs: List[str]
    nodes: List[Node]
    initializers: Dict[str, np.ndarray] = dataclasses.field(
        default_factory=dict)

    # ------------------------------------------------------------ structure
    def producer(self, tensor: str) -> Optional[Node]:
        for n in self.nodes:
            if n.output == tensor:
                return n
        return None

    def consumers(self, tensor: str) -> List[Node]:
        return [n for n in self.nodes if tensor in n.real_inputs()]

    def node(self, name: str) -> Node:
        for n in self.nodes:
            if n.name == name:
                return n
        raise KeyError(name)

    def validate(self) -> None:
        """Check single assignment, known ops, and that every referenced
        tensor is defined (graph input, initializer, or a node output)."""
        defined = set(self.inputs) | set(self.initializers)
        seen_names = set()
        for n in self.nodes:
            if n.op not in OPS and n.op not in FUSED_OPS:
                raise UnsupportedOpError(
                    f"node {n.name!r}: unsupported op {n.op!r} "
                    f"(supported: {sorted(OPS)})")
            if n.name in seen_names:
                raise GraphError(f"duplicate node name {n.name!r}")
            seen_names.add(n.name)
            for i in n.real_inputs():
                if i not in defined:
                    raise GraphError(
                        f"node {n.name!r} reads undefined tensor {i!r} "
                        "(nodes must be topologically ordered)")
            if n.output in defined:
                raise GraphError(
                    f"node {n.name!r} redefines tensor {n.output!r}")
            defined.add(n.output)
        for o in self.outputs:
            if o not in defined:
                raise GraphError(f"graph output {o!r} is never defined")

    def toposorted(self) -> List[Node]:
        """Nodes in dependency order (validates as a side effect)."""
        self.validate()  # validated graphs are stored pre-sorted
        return list(self.nodes)


# -------------------------------------------------------------- native format

def graph_to_dict(g: Graph) -> Dict:
    """The native JSON-plain encoding (inverse of :func:`graph_from_dict`)."""
    return {
        "format": "repro-graph-v1",
        "name": g.name,
        "inputs": {k: list(v) for k, v in g.inputs.items()},
        "outputs": list(g.outputs),
        "nodes": [
            {"name": n.name, "op": n.op, "inputs": list(n.inputs),
             "output": n.output, "attrs": dict(n.attrs)}
            for n in g.nodes
        ],
        "initializers": {
            k: {"shape": list(v.shape), "dtype": str(v.dtype),
                "data": np.asarray(v).reshape(-1).tolist()}
            for k, v in g.initializers.items()
        },
    }


def graph_from_dict(d: Dict) -> Graph:
    """Import the native dict/JSON graph format (always available)."""
    if d.get("format") != "repro-graph-v1":
        raise GraphError(
            f"not a repro-graph-v1 payload (format={d.get('format')!r})")
    inits = {}
    for k, v in d.get("initializers", {}).items():
        arr = np.asarray(v["data"], dtype=np.dtype(v["dtype"]))
        inits[k] = arr.reshape([int(s) for s in v["shape"]])
    g = Graph(
        name=d.get("name", "graph"),
        inputs={k: tuple(v) for k, v in d["inputs"].items()},
        outputs=list(d["outputs"]),
        nodes=[Node(name=n["name"], op=n["op"], inputs=list(n["inputs"]),
                    output=n["output"], attrs=dict(n.get("attrs", {})))
               for n in d["nodes"]],
        initializers=inits,
    )
    g.validate()
    return g


def graph_to_json(g: Graph, path: str) -> None:
    with open(path, "w") as f:
        json.dump(graph_to_dict(g), f)


def graph_from_json(path: str) -> Graph:
    with open(path) as f:
        return graph_from_dict(json.load(f))
