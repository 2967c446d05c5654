"""Graph passes: shape inference, constant folding, epilogue fusion,
precision annotation, dead-node elimination.

Counterpart of ``repro/compiler/passes.py`` (numpy only). Pass order in
:func:`run_pipeline`: fold constants → eliminate dead → fuse epilogues →
annotate precision → eliminate dead. With ``REPRO_VERIFY`` set each pass
runs inside the IR verifier (the pass sandwich).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.compiler.ir import Graph, GraphError, Node
from repro_torch.models.layers import QuantPolicy

__all__ = ["infer_shapes", "fold_constants", "fuse_epilogues",
           "annotate_precision", "eliminate_dead", "run_pipeline",
           "ShapeError"]


class ShapeError(GraphError):
    """Inconsistent tensor geometry discovered during inference."""


def _conv_out(shape, wshape, stride, padding, name):
    if len(shape) != 4 or len(wshape) != 4:
        raise ShapeError(f"{name}: conv2d wants NHWC x HWIO, got "
                         f"{shape} x {wshape}")
    n, h, w, ci = shape
    fh, fw, wci, co = wshape
    if ci is not None and ci != wci:
        raise ShapeError(f"{name}: input channels {ci} != weight Ci {wci}")
    ho = (h + 2 * padding - fh) // stride + 1
    wo = (w + 2 * padding - fw) // stride + 1
    if ho <= 0 or wo <= 0:
        raise ShapeError(f"{name}: empty output map {ho}x{wo} for input "
                         f"{h}x{w} (filter {fh}x{fw}, stride {stride}, "
                         f"padding {padding})")
    return (n, ho, wo, co)


def infer_shapes(g: Graph) -> Dict[str, Tuple]:
    """Propagate shapes from graph inputs + initializers through every node.
    Leading batch dims may be ``None`` (deferred)."""
    shapes: Dict[str, Tuple] = {k: tuple(v) for k, v in g.inputs.items()}
    shapes.update({k: tuple(v.shape) for k, v in g.initializers.items()})
    for n in g.toposorted():
        s = [shapes[i] for i in n.real_inputs()]
        if n.op in ("conv2d", "fused_conv2d"):
            shapes[n.output] = _conv_out(
                shapes[n.inputs[0]], shapes[n.inputs[1]],
                n.attrs.get("stride", 1), n.attrs.get("padding", 1), n.name)
        elif n.op in ("gemm", "matmul", "fused_gemm"):
            x, w = shapes[n.inputs[0]], shapes[n.inputs[1]]
            if len(w) != 2 or not x or x[-1] != w[0]:
                raise ShapeError(f"{n.name}: gemm {x} x {w} mismatch")
            shapes[n.output] = x[:-1] + (w[1],)
        elif n.op == "maxpool":
            x = shapes[n.inputs[0]]
            if len(x) != 4:
                raise ShapeError(f"{n.name}: maxpool wants NHWC, got {x}")
            win = n.attrs.get("window", 2)
            st = n.attrs.get("stride", win)
            ho, wo = (x[1] - win) // st + 1, (x[2] - win) // st + 1
            if ho <= 0 or wo <= 0:
                raise ShapeError(f"{n.name}: empty pooled map {ho}x{wo}")
            shapes[n.output] = (x[0], ho, wo, x[3])
        elif n.op == "global_avg_pool":
            x = shapes[n.inputs[0]]
            if len(x) != 4:
                raise ShapeError(f"{n.name}: global pool wants NHWC, got {x}")
            shapes[n.output] = (x[0], x[3])
        elif n.op == "flatten":
            x = shapes[n.inputs[0]]
            if any(d is None for d in x[1:]):
                raise ShapeError(f"{n.name}: cannot flatten deferred {x}")
            shapes[n.output] = (x[0], int(np.prod(x[1:])))
        elif n.op == "add":
            a, b = s
            if a != b:
                raise ShapeError(f"{n.name}: add shapes {a} != {b}")
            shapes[n.output] = a
        elif n.op in ("relu", "requantize"):
            shapes[n.output] = s[0]
        else:  # ir.validate() already rejects unknown ops
            raise GraphError(f"{n.name}: no shape rule for {n.op!r}")
    return shapes


def fold_constants(g: Graph) -> Graph:
    """Evaluate nodes whose inputs are all initializers (offline, numpy);
    only ops without optional ``""`` input slots fold."""
    foldable = {"relu": lambda a: np.maximum(a, 0),
                "add": lambda a, b: a + b,
                "flatten": lambda a: a.reshape(a.shape[0], -1),
                "matmul": lambda a, b: a @ b}
    changed = True
    while changed:
        changed = False
        for n in list(g.nodes):
            fn = foldable.get(n.op)
            if fn is None or n.output in g.outputs:
                continue
            ins = n.real_inputs()
            if not ins or not all(i in g.initializers for i in ins):
                continue
            g.initializers[n.output] = np.asarray(
                fn(*[g.initializers[i] for i in ins]))
            g.nodes.remove(n)
            changed = True
    return g


def _single_consumer(g: Graph, tensor: str) -> Optional[Node]:
    if tensor in g.outputs:
        return None
    cons = g.consumers(tensor)
    return cons[0] if len(cons) == 1 else None


def fuse_epilogues(g: Graph) -> Graph:
    """``conv2d/gemm → relu? → requantize?`` chains collapse into one
    ``fused_*`` node carrying ``relu`` / ``requant`` attrs (sole-consumer
    edges only)."""
    for n in list(g.nodes):
        if n.op not in ("conv2d", "gemm", "matmul"):
            continue
        n.op = "fused_conv2d" if n.op == "conv2d" else "fused_gemm"
        n.attrs.setdefault("relu", False)
        nxt = _single_consumer(g, n.output)
        if nxt is not None and nxt.op == "relu":
            n.attrs["relu"] = True
            n.output = nxt.output
            g.nodes.remove(nxt)
            nxt = _single_consumer(g, n.output)
        if nxt is not None and nxt.op == "requantize":
            n.attrs["requant"] = {
                "bits": nxt.attrs.get("bits", 8),
                "signed": nxt.attrs.get("signed", True),
                "scale": nxt.attrs.get("scale"),   # None -> calibrated
            }
            n.output = nxt.output
            g.nodes.remove(nxt)
    return g


def annotate_precision(g: Graph, policy: QuantPolicy,
                       per_layer: Optional[Dict[str, Tuple[int, int]]] = None,
                       ) -> Graph:
    """Stamp each compute node with ``attrs["precision"] = {mode, a_bits,
    w_bits, a_signed, w_signed}``; ``host=True`` nodes stay full precision,
    ``per_layer`` overrides {node: (a_bits, w_bits)}."""
    per_layer = per_layer or {}
    unknown = set(per_layer) - {n.name for n in g.nodes}
    if unknown:
        raise GraphError(f"per_layer precision for unknown nodes {unknown}")
    for n in g.nodes:
        if n.op not in ("conv2d", "fused_conv2d", "gemm", "matmul",
                        "fused_gemm"):
            continue
        if n.attrs.get("host") or policy.mode != "serial":
            n.attrs["precision"] = {"mode": "host"}
            continue
        ab, wb = per_layer.get(n.name, (policy.a_bits, policy.w_bits))
        n.attrs["precision"] = {
            "mode": "serial", "a_bits": int(ab), "w_bits": int(wb),
            "a_signed": bool(policy.a_signed),
            "w_signed": bool(policy.w_signed),
        }
    return g


def eliminate_dead(g: Graph) -> Graph:
    """Drop nodes and initializers that do not reach a graph output."""
    live = set(g.outputs)
    for n in reversed(g.toposorted()):
        if n.output in live:
            live.update(n.real_inputs())
    g.nodes = [n for n in g.nodes if n.output in live]
    g.initializers = {k: v for k, v in g.initializers.items() if k in live}
    return g


#: the standard pass order — names resolved through the module namespace
#: at run time so a monkeypatched pass is still sandwich-verified.
_PIPELINE = ("fold_constants", "eliminate_dead", "fuse_epilogues",
             "annotate_precision", "eliminate_dead")


def run_pipeline(g: Graph, policy: QuantPolicy,
                 per_layer: Optional[Dict[str, Tuple[int, int]]] = None,
                 ) -> Graph:
    """The standard pass order; returns the same (mutated) graph.

    With ``REPRO_VERIFY`` set, every pass runs inside a verifier sandwich
    (:func:`repro_torch.analysis.verify_ir.verify_graph`): the graph is
    re-checked after each pass with that pass's name as blame, and graph
    *output* shapes recorded up front must survive the whole pipeline.
    Disabled, the only extra work is one env lookup.
    """
    from repro_torch import analysis
    verify = analysis.verify_enabled()
    g.validate()
    if verify:
        from repro_torch.analysis.verify_ir import verify_graph
        shapes = infer_shapes(g)
        out_shapes = {o: shapes[o] for o in g.outputs if o in shapes}
    else:
        infer_shapes(g)      # fail early on malformed geometry
    annotated = False
    for pass_name in _PIPELINE:
        fn = globals()[pass_name]
        if pass_name == "annotate_precision":
            fn(g, policy, per_layer)
            annotated = True
        else:
            fn(g)
        if verify:
            analysis.count("pass_sandwich")
            # policy agreement only binds once THIS pipeline's annotator
            # ran: a recompile at a new precision legitimately sees the
            # previous variant's annotations until then
            verify_graph(g, policy=policy if annotated else None,
                         per_layer=per_layer, blame=pass_name,
                         expect_output_shapes=out_shapes)
    g.validate()
    return g
