"""ONNX-subset importer (optional dependency) — paper §3.3's front end.

The port's own copy of ``repro/compiler/onnx_import.py``, onto
:mod:`repro_torch.compiler.ir` (numpy only, like the reference's). Maps the
CNN subset the accelerator executes onto IR graphs: Conv, Gemm, MatMul,
Relu, MaxPool, GlobalAveragePool, Flatten, Add. Anything else raises
:class:`UnsupportedOpError` — the compiler refuses models it cannot lower
rather than silently running them on the host.

Layout: ONNX is NCHW / OIHW; the IR (and every kernel in this repo) is
NHWC / HWIO. The importer transposes conv weights ``(Co,Ci,FH,FW) →
(FH,FW,Ci,Co)`` and the image input shape ``(N,C,H,W) → (N,H,W,C)``; all
spatial attributes (stride/pads/kernel) are layout-invariant. ONNX
``Flatten`` after ``GlobalAveragePool`` flattens the pooled ``(N, C)``
tensor identically in either layout, so the imported graph computes the
same function on NHWC inputs.

``onnx`` itself is an *optional extra*: when it is not installed,
:data:`HAS_ONNX` is False and :func:`import_onnx` raises a descriptive
ImportError — callers (tests) skip gracefully.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from repro_torch.compiler.ir import Graph, Node, UnsupportedOpError

__all__ = ["HAS_ONNX", "import_onnx", "SUPPORTED_ONNX_OPS"]

try:  # optional extra — the native dict/JSON front end needs nothing
    import onnx
    from onnx import numpy_helper
    HAS_ONNX = True
except ImportError:  # pragma: no cover - exercised on bare CI images
    onnx = None
    numpy_helper = None
    HAS_ONNX = False

SUPPORTED_ONNX_OPS = frozenset({
    "Conv", "Gemm", "MatMul", "Relu", "MaxPool", "GlobalAveragePool",
    "Flatten", "Add",
})


def _attr_map(node) -> Dict:
    out = {}
    for a in node.attribute:
        if a.type == onnx.AttributeProto.INT:
            out[a.name] = int(a.i)
        elif a.type == onnx.AttributeProto.INTS:
            out[a.name] = [int(v) for v in a.ints]
        elif a.type == onnx.AttributeProto.FLOAT:
            out[a.name] = float(a.f)
        elif a.type == onnx.AttributeProto.STRING:
            out[a.name] = a.s.decode()
    return out


def _reject_silent_geometry(op: str, name: str, attrs: Dict) -> None:
    """Attributes that change the computed function must be refused, not
    defaulted — 'the compiler refuses models it cannot lower'."""
    if attrs.get("auto_pad", "NOTSET") not in ("", "NOTSET"):
        raise UnsupportedOpError(
            f"{op} {name!r}: auto_pad={attrs['auto_pad']!r} unsupported "
            "(use explicit symmetric pads)")
    if any(d != 1 for d in attrs.get("dilations", [])):
        raise UnsupportedOpError(
            f"{op} {name!r}: dilations {attrs['dilations']} unsupported")
    if attrs.get("ceil_mode", 0):
        raise UnsupportedOpError(f"{op} {name!r}: ceil_mode unsupported")


def _square(vals, what: str) -> int:
    vals = list(vals)
    if len(set(vals)) != 1:
        raise UnsupportedOpError(f"non-uniform {what} {vals} not supported "
                                 "(MVU convs are square)")
    return int(vals[0])


def import_onnx(model_or_path) -> Graph:
    """Import an ONNX model (path or ``onnx.ModelProto``) into the IR.

    Only the accelerator's CNN subset is accepted; anything else raises
    :class:`UnsupportedOpError`. Requires the optional ``onnx`` package.
    """
    if not HAS_ONNX:
        raise ImportError(
            "the ONNX importer needs the optional 'onnx' package "
            "(pip install onnx) — the native dict/JSON importer "
            "(repro_torch.compiler.ir.graph_from_dict) is always available")
    model = (model_or_path if isinstance(model_or_path, onnx.ModelProto)
             else onnx.load(model_or_path))
    og = model.graph

    inits: Dict[str, np.ndarray] = {
        t.name: numpy_helper.to_array(t) for t in og.initializer}

    inputs: Dict[str, tuple] = {}
    for vi in og.input:
        if vi.name in inits:
            continue
        dims = tuple(
            int(d.dim_value) if d.HasField("dim_value") else None
            for d in vi.type.tensor_type.shape.dim)
        if len(dims) == 4:  # NCHW image input -> NHWC
            dims = (dims[0], dims[2], dims[3], dims[1])
        inputs[vi.name] = dims

    nodes: List[Node] = []
    used_names = set()
    # layout transforms applied in place to shared ``inits`` entries — an
    # initializer referenced twice must want the SAME transform (applying
    # OIHW->HWIO twice would silently scramble a tied weight)
    transforms: Dict[str, str] = {}

    def transform_weight(w_name: str, kind: str, fn) -> None:
        prev = transforms.get(w_name)
        if prev == kind:
            return  # already in the target layout (tied weight)
        if prev is not None:
            raise UnsupportedOpError(
                f"initializer {w_name!r} is shared with conflicting "
                f"layouts ({prev} vs {kind})")
        transforms[w_name] = kind
        if fn is not None:
            inits[w_name] = fn(inits[w_name])

    def fresh(base: str) -> str:
        name, i = base, 1
        while name in used_names or not name:
            name = f"{base or 'node'}_{i}"
            i += 1
        used_names.add(name)
        return name

    for n in og.node:
        if n.op_type not in SUPPORTED_ONNX_OPS:
            raise UnsupportedOpError(
                f"ONNX op {n.op_type!r} ({n.name or n.output[0]!r}) is "
                f"outside the supported subset {sorted(SUPPORTED_ONNX_OPS)}")
        attrs = _attr_map(n)
        name = fresh(n.name or f"{n.op_type.lower()}_{n.output[0]}")
        out = n.output[0]
        if n.op_type == "Conv":
            _reject_silent_geometry("Conv", name, attrs)
            if attrs.get("group", 1) != 1:
                raise UnsupportedOpError("grouped/depthwise Conv unsupported")
            w_name = n.input[1]
            if w_name not in inits:
                raise UnsupportedOpError("Conv weight must be an initializer")
            transform_weight(w_name, "oihw->hwio",      # (Co,Ci,FH,FW)
                             lambda w: np.transpose(w, (2, 3, 1, 0)))
            stride = _square(attrs.get("strides", [1, 1]), "strides")
            pads = attrs.get("pads", [0, 0, 0, 0])
            padding = _square(pads, "pads")
            bias = n.input[2] if len(n.input) > 2 else ""
            nodes.append(Node(name, "conv2d",
                              [n.input[0], w_name, "", bias], out,
                              {"stride": stride, "padding": padding}))
        elif n.op_type in ("Gemm", "MatMul"):
            w_name = n.input[1]
            if w_name not in inits:
                raise UnsupportedOpError(
                    f"{n.op_type} weight must be an initializer")
            if n.op_type == "Gemm":
                if attrs.get("transA", 0):
                    raise UnsupportedOpError("Gemm transA unsupported")
                if attrs.get("alpha", 1.0) != 1.0 or attrs.get("beta", 1.0) != 1.0:
                    raise UnsupportedOpError("Gemm alpha/beta != 1 unsupported")
                if attrs.get("transB", 0):  # (N, K) -> (K, N)
                    transform_weight(
                        w_name, "transpose",
                        lambda w: np.ascontiguousarray(w.T))
                else:
                    transform_weight(w_name, "identity", None)
            else:
                transform_weight(w_name, "identity", None)
            bias = n.input[2] if len(n.input) > 2 else ""
            nodes.append(Node(name, "gemm", [n.input[0], w_name, "", bias],
                              out, {}))
        elif n.op_type == "MaxPool":
            _reject_silent_geometry("MaxPool", name, attrs)
            window = _square(attrs.get("kernel_shape", [2, 2]), "kernel_shape")
            stride = _square(attrs.get("strides", [window, window]), "strides")
            if any(attrs.get("pads", [0, 0, 0, 0])):
                raise UnsupportedOpError("padded MaxPool unsupported")
            nodes.append(Node(name, "maxpool", [n.input[0]], out,
                              {"window": window, "stride": stride}))
        elif n.op_type == "GlobalAveragePool":
            nodes.append(Node(name, "global_avg_pool", [n.input[0]], out, {}))
        elif n.op_type == "Flatten":
            if attrs.get("axis", 1) != 1:
                raise UnsupportedOpError(
                    f"Flatten {name!r}: axis={attrs['axis']} unsupported "
                    "(only batch-preserving axis=1)")
            nodes.append(Node(name, "flatten", [n.input[0]], out, {}))
        elif n.op_type == "Relu":
            nodes.append(Node(name, "relu", [n.input[0]], out, {}))
        elif n.op_type == "Add":
            nodes.append(Node(name, "add", list(n.input[:2]), out, {}))

    g = Graph(name=og.name or "onnx_graph", inputs=inputs,
              outputs=[o.name for o in og.output], nodes=nodes,
              initializers=inits)
    g.validate()
    return g
