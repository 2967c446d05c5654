"""Lowering: annotated IR graph → executable :class:`Program` of packed
kernel calls (the back half of the paper's §3.3 code generator).

Counterpart of ``repro/compiler/lower.py``. Per serial compute node,
:func:`compile_graph` calibrates (a replay of the graph on a calibration
batch through the exact-integer plain ops, recording activation step
sizes), packs weights ahead of time with the dequant scaler folded per
output channel, plans each node's output format from its consumers
(conv→conv packed, conv→maxpool→conv integer codes, else float) and
records each compute node's geometry (:class:`LoweredConv` /
:class:`LoweredGemm`) for the code generator: :meth:`Program.to_command_stream`
lowers any compiled Program to the paper's
:class:`~repro_torch.core.codegen.CommandStream`, which the serving
scheduler books on the barrel controller. Each packed step records the
tile :mod:`repro_torch.kernels.tuning` picks for it at the calibration
batch (step attr ``tile``, and ``meta["tiles"]``), as the reference's
lowering does; the executor launches the tuner's choice for each batch
it runs at. With ``REPRO_VERIFY`` set the lowered Program is checked by
the post-lowering verifier (``tile-budget`` among its checks).

:func:`program_from_numpy` builds a Program from a record shaped like the
reference's artifact manifest, so a Program lowered by the reference runs
here with the very same parameters and yields the very same stream.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.compiler import passes
from repro_torch.compiler.ir import Graph, GraphError, Node
from repro_torch.core import codegen
from repro_torch.core.bitserial import (SerialSpec, plan_spec, serial_conv2d,
                                        serial_matmul)
from repro_torch.core.pipeline_modules import host_conv2d, maxpool_relu
from repro_torch.core.quant import (QuantSpec, init_alpha, pack_conv_weights,
                                    pack_weights, quantize_int)
from repro_torch.kernels import tuning
from repro_torch.models.layers import QuantPolicy

__all__ = ["Step", "Program", "compile_graph", "program_from_numpy",
           "to_tensor", "LoweredConv", "LoweredGemm"]

_SERIAL_OPS = ("fused_conv2d", "fused_gemm")


@dataclasses.dataclass(frozen=True)
class Step:
    """One executor step: static metadata only; bound tensors live in
    ``Program.params[name]``."""

    name: str                  # params key
    kind: str                  # dispatch key (executor._APPLY)
    inputs: Tuple[str, ...]
    output: str
    attrs: Dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class LoweredConv:
    """Codegen view of a lowered conv node — duck-typed by
    :func:`repro_torch.core.codegen.generate` (the fused conv+relu+requant
    epilogue maps onto one CONV2D job with the pipeline modules enabled)."""

    name: str
    c_in: int
    c_out: int
    h: int
    w: int
    fh: int = 3
    fw: int = 3
    stride: int = 1
    padding: int = 1
    relu: bool = False
    requant: bool = False
    on_host: bool = False
    kind: str = "conv2d"


@dataclasses.dataclass(frozen=True)
class LoweredGemm:
    """Codegen view of a lowered gemm node (GEMV job)."""

    name: str
    k: int
    n: int
    relu: bool = False
    requant: bool = False
    on_host: bool = False
    kind: str = "gemm"


@dataclasses.dataclass
class Program:
    """The executable artifact: a static step list and its parameters
    (step name → dict of tensors on ``device``).

    ``cost_nodes``/``per_layer_bits``
    are the CommandStream linkage consumed by
    :func:`repro_torch.core.codegen.generate`."""

    graph_name: str
    steps: Tuple[Step, ...]
    params: Dict[str, Dict[str, torch.Tensor]]
    input_name: str
    output_name: str
    device: torch.device
    cost_nodes: List = dataclasses.field(default_factory=list)
    per_layer_bits: Dict[str, Tuple[int, int]] = dataclasses.field(
        default_factory=dict)
    meta: Dict = dataclasses.field(default_factory=dict)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """Run the program eagerly on a batch."""
        from repro_torch.compiler import executor
        return executor.make_runner(self)(self.params, x)

    def run(self, x: torch.Tensor, **kw) -> torch.Tensor:
        """Eager execution, as the reference's ``Program.run`` (its un-jitted
        path, for debugging and dispatch costing): ``kw`` goes to
        :func:`~repro_torch.compiler.executor.make_runner` (``steps``,
        ``input_name``, ``output_name``; the reference's ``backend`` and
        ``interpret`` select Pallas or XLA, which the port has no
        counterpart of)."""
        from repro_torch.compiler import executor
        return executor.make_runner(self, **kw)(self.params, x)

    def to_command_stream(self, mode: str = "pipelined",
                          **kw) -> codegen.CommandStream:
        """Lower to the controller command stream (cycle estimates, runtime
        scheduling) — any compiled model gets the paper's §3.3 artifact.
        With ``REPRO_VERIFY`` set, the emitted stream is hazard-checked
        and cycle-reconciled before it is handed out."""
        cs = codegen.generate(self, mode=mode, **kw)
        from repro_torch import analysis
        if analysis.verify_enabled():
            analysis.count("to_command_stream")
            from repro_torch.analysis.verify_stream import verify_stream
            verify_stream(cs)
        return cs


def to_tensor(a, device) -> torch.Tensor:
    """numpy/array-like → tensor on ``device``, in the reference's 32-bit
    types: float64 → float32, int64 → int32, uint32 words → their int32
    bits."""
    a = np.asarray(a)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    elif a.dtype == np.int64:
        a = a.astype(np.int32)
    elif a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a, order="C")).to(device)


# --------------------------------------------------------------------------
# calibration: reference replay recording activation step sizes
# --------------------------------------------------------------------------

def _node_operands(g: Graph, n: Node):
    w = g.initializers.get(n.inputs[1]) if len(n.inputs) > 1 else None
    scale = (g.initializers.get(n.inputs[2])
             if len(n.inputs) > 2 and n.inputs[2] else None)
    bias = (g.initializers.get(n.inputs[3])
            if len(n.inputs) > 3 and n.inputs[3] else None)
    if w is None and n.op in _SERIAL_OPS:
        raise GraphError(f"{n.name}: weight {n.inputs[1]!r} must be an "
                         "initializer (dynamic weights cannot be packed)")
    return w, scale, bias


def _precision(n: Node) -> Dict:
    p = n.attrs.get("precision")
    if p is None:
        raise GraphError(
            f"node {n.name!r} has no precision annotation — run "
            "passes.annotate_precision (or passes.run_pipeline) first")
    return p


def _calibrate(g: Graph, calib: torch.Tensor, radix_bits: int, device):
    """Replay the graph on the calibration batch with the exact-integer
    plain ops, recording per-node activation/weight step sizes. The float
    expressions and their order are the reference's (run eagerly there, so
    the scaler and bias round separately here too)."""
    act_alphas: Dict[str, torch.Tensor] = {}
    w_alphas: Dict[str, torch.Tensor] = {}
    requant_alphas: Dict[str, torch.Tensor] = {}
    env = {k: to_tensor(v, device) for k, v in g.initializers.items()}
    env[next(iter(g.inputs))] = calib

    def opt(a):
        return None if a is None else to_tensor(a, device)

    def epilogue(n: Node, y):
        if n.attrs.get("relu"):
            y = torch.clamp_min(y, 0.0)
        rq = n.attrs.get("requant")
        if rq is not None:
            spec = QuantSpec(rq["bits"], rq["signed"])
            if rq.get("scale") is not None:
                ra = torch.tensor(rq["scale"], dtype=torch.float32,
                                  device=device)
            else:
                ra = init_alpha(y, spec)
            requant_alphas[n.name] = ra
            y = quantize_int(y, ra, spec).to(torch.float32) * ra
        return y

    for n in g.toposorted():
        x = env[n.inputs[0]] if n.real_inputs() else None
        if n.op in _SERIAL_OPS:
            w, scale, bias = _node_operands(g, n)
            w, scale, bias = to_tensor(w, device), opt(scale), opt(bias)
            prec = _precision(n)
            if prec["mode"] == "host":
                if n.op == "fused_conv2d":
                    y = host_conv2d(x, w, n.attrs.get("stride", 1),
                                    n.attrs.get("padding", 1))
                else:
                    y = x @ w.to(x.dtype)
                if scale is not None:
                    y = y * scale
                if bias is not None:
                    y = y + bias
                env[n.output] = epilogue(n, y)
                continue
            conv = n.op == "fused_conv2d"
            wspec = QuantSpec(prec["w_bits"], prec["w_signed"],
                              per_channel=True)
            aw = init_alpha(w, wspec, axis=(0, 1, 2) if conv else 0)
            wq = quantize_int(w, aw, wspec)
            aspec = QuantSpec(prec["a_bits"], prec["a_signed"])
            ax = init_alpha(x, aspec)
            act_alphas[n.name], w_alphas[n.name] = ax, aw
            xq = quantize_int(x, ax, aspec)
            spec = plan_spec(SerialSpec(
                prec["a_bits"], prec["w_bits"], prec["a_signed"],
                prec["w_signed"], radix_bits))
            co = w.shape[-1]
            if conv:
                acc = serial_conv2d(xq, wq, spec,
                                    stride=n.attrs.get("stride", 1),
                                    padding=n.attrs.get("padding", 1))
                y = acc.to(torch.float32) * (
                    ax * aw.reshape(1, 1, 1, co)
                    * (1.0 if scale is None else scale))
            else:
                acc = serial_matmul(xq, wq, spec)
                y = acc.to(torch.float32) * (
                    ax * aw.reshape(1, -1) * (1.0 if scale is None else scale))
                y = y.reshape(x.shape[:-1] + (co,))
            if bias is not None:
                y = y + bias
            env[n.output] = epilogue(n, y)
        elif n.op == "maxpool":
            env[n.output] = maxpool_relu(
                x, n.attrs.get("window", 2),
                n.attrs.get("stride", n.attrs.get("window", 2)),
                with_relu=False)
        elif n.op == "global_avg_pool":
            env[n.output] = torch.mean(x, dim=(1, 2))
        elif n.op == "flatten":
            env[n.output] = x.reshape(x.shape[0], -1)
        elif n.op == "relu":
            env[n.output] = torch.clamp_min(x, 0)
        elif n.op == "add":
            env[n.output] = x + env[n.inputs[1]]
        elif n.op == "requantize":
            spec = QuantSpec(n.attrs.get("bits", 8),
                             n.attrs.get("signed", True))
            ra = (torch.tensor(n.attrs["scale"], dtype=torch.float32,
                               device=device)
                  if n.attrs.get("scale") is not None
                  else init_alpha(x, spec))
            requant_alphas[n.name] = ra
            env[n.output] = quantize_int(x, ra, spec).to(torch.float32) * ra
        else:
            raise GraphError(f"{n.name}: cannot lower op {n.op!r} — run "
                             "passes.run_pipeline first")
    return act_alphas, w_alphas, requant_alphas


# --------------------------------------------------------------------------
# lowering proper
# --------------------------------------------------------------------------

def _is_serial(n: Optional[Node]) -> bool:
    return (n is not None and n.op in _SERIAL_OPS
            and n.attrs.get("precision", {}).get("mode") == "serial")


def _output_plan(g: Graph, n: Node) -> Tuple[str, Optional[Node]]:
    """A serial node's output format from its consumers: ``packed`` (next
    serial node), ``codes`` (through one maxpool into a serial node),
    ``requant_codes`` (an explicit fused requantize, which always
    dominates) or ``float``."""
    if n.attrs.get("requant") is not None:
        return "requant_codes", None
    if n.output in g.outputs:
        return "float", None
    cons = g.consumers(n.output)
    if len(cons) == 1:
        c = cons[0]
        if _is_serial(c) and c.inputs[0] == n.output:
            return "packed", c
        if c.op == "maxpool":
            cc_list = g.consumers(c.output)
            if (c.output not in g.outputs and len(cc_list) == 1
                    and _is_serial(cc_list[0])
                    and cc_list[0].inputs[0] == c.output):
                return "codes", cc_list[0]
    return "float", None


def _plan_requant(g: Graph, n: Node, act_alphas: Dict, requant_alphas: Dict):
    """``(out_kind, requant_scale, rq_bits, rq_signed, fmt_tuple)``: how a
    serial node's output leaves the kernel."""
    out_kind, nxt = _output_plan(g, n)
    if out_kind in ("packed", "codes"):
        prec = _precision(nxt)
        rq_bits, rq_signed = prec["a_bits"], prec["a_signed"]
        return (out_kind, act_alphas[nxt.name], rq_bits, rq_signed,
                (out_kind, nxt.name, rq_bits, rq_signed))
    if out_kind == "requant_codes":
        rq = n.attrs["requant"]
        return (out_kind, requant_alphas[n.name], rq["bits"], rq["signed"],
                ("codes", f"{n.name}::requant", rq["bits"], rq["signed"]))
    return out_kind, None, None, None, ("float",)


def compile_graph(g: Graph, calib, *, policy: Optional[QuantPolicy] = None,
                  per_layer: Optional[Dict[str, Tuple[int, int]]] = None,
                  device=None) -> Program:
    """Compile an IR graph into an executable :class:`Program` on
    ``device`` (default: the card).

    ``calib``: calibration batch for the graph input. ``policy``: the
    :class:`QuantPolicy` driving precision annotation (default W2A2
    serial); ``per_layer`` overrides {node: (a_bits, w_bits)}.
    """
    device = resolve_device(device)
    if policy is None:
        policy = QuantPolicy(mode="serial", w_bits=2, a_bits=2, radix_bits=7)
    g = passes.run_pipeline(g, policy, per_layer)
    if len(g.inputs) != 1 or len(g.outputs) != 1:
        raise GraphError("compile_graph supports single-input single-output "
                         f"graphs (got {list(g.inputs)} -> {g.outputs})")
    shapes = passes.infer_shapes(g)
    calib = (calib.to(device) if isinstance(calib, torch.Tensor)
             else to_tensor(calib, device))
    act_alphas, w_alphas, requant_alphas = _calibrate(
        g, calib, policy.radix_bits, device)

    input_name = next(iter(g.inputs))
    steps: List[Step] = []
    params: Dict[str, Dict] = {}
    cost_nodes: List = []
    per_layer_bits: Dict[str, Tuple[int, int]] = {}
    meta: Dict = {"formats": {}, "tiles": {},
                  "input_shape": tuple(int(d) for d in calib.shape[1:]),
                  "calib_batch": int(calib.shape[0]),
                  "policy": dataclasses.asdict(policy)}
    # tensor -> ("float",) | ("codes"|"packed", alpha_key, bits, signed)
    fmt: Dict[str, Tuple] = {input_name: ("float",)}

    def alpha_for(key: str):
        return (requant_alphas[key[:-len("::requant")]]
                if key.endswith("::requant") else act_alphas[key])

    def as_float(tensor: str, ctx: str) -> str:
        """Insert a dequant step if ``tensor`` currently holds codes."""
        f = fmt[tensor]
        if f[0] == "float":
            return tensor
        if f[0] == "codes":
            out = f"{tensor}::f32"
            if out in fmt:   # a second float consumer shares the dequant
                return out
            name = f"{ctx}.dequant"
            params[name] = {"alpha": alpha_for(f[1])}
            steps.append(Step(name, "dequant", (tensor,), out))
            fmt[out] = ("float",)
            return out
        raise GraphError(f"{ctx}: cannot consume packed tensor {tensor!r} "
                         "in the float domain")

    def packed_input(n: Node, prec: Dict) -> str:
        """Deliver node ``n``'s input in packed-plane format."""
        t = n.inputs[0]
        f = fmt[t]
        bits, signed = prec["a_bits"], prec["a_signed"]
        if f[0] == "packed":
            if f[1:] != (n.name, bits, signed):
                raise GraphError(f"{n.name}: packed input format {f} does "
                                 "not match this node's quantization")
            return t
        if f[0] == "codes" and f[1:] == (n.name, bits, signed):
            name = f"{n.name}.in_pack"
            out = f"{t}::packed"
            params[name] = {}
            steps.append(Step(name, "pack_codes", (t,), out, {"bits": bits}))
            fmt[out] = ("packed",) + f[1:]
            return out
        tf = as_float(t, n.name)
        name = f"{n.name}.in_q"
        out = f"{tf}::q{n.name}"
        params[name] = {"act_alpha": act_alphas[n.name]}
        steps.append(Step(name, "quantize_pack", (tf,), out,
                          {"bits": bits, "signed": signed}))
        fmt[out] = ("packed", n.name, bits, signed)
        return out

    def host_params(w, scale, bias):
        p = {"w": to_tensor(w, device)}
        if scale is not None:
            p["scale"] = to_tensor(scale, device)
        if bias is not None:
            p["bias"] = to_tensor(bias, device)
        return p

    for n in g.toposorted():
        if n.op in _SERIAL_OPS:
            w, scale, bias = _node_operands(g, n)
            prec = _precision(n)
            conv = n.op == "fused_conv2d"
            relu = bool(n.attrs.get("relu"))
            xshape = shapes[n.inputs[0]]
            if conv:
                fh, fw_, ci, co = np.shape(w)
                st, pd = n.attrs.get("stride", 1), n.attrs.get("padding", 1)
                geom = (ci, co, xshape[1], xshape[2], fh, fw_, st, pd)
            else:
                geom = tuple(np.shape(w))
            lowered = LoweredConv if conv else LoweredGemm
            if prec["mode"] == "host":
                tin = as_float(n.inputs[0], n.name)
                params[n.name] = host_params(w, scale, bias)
                attrs = {"relu": relu}
                if conv:
                    attrs.update(stride=n.attrs.get("stride", 1),
                                 padding=n.attrs.get("padding", 1))
                steps.append(Step(n.name, "host_conv" if conv else "host_gemm",
                                  (tin,), n.output, attrs))
                fmt[n.output] = ("float",)
                cost_nodes.append(lowered(n.name, *geom, relu=relu,
                                          on_host=True))
                continue
            tin = packed_input(n, prec)
            spec = plan_spec(SerialSpec(
                prec["a_bits"], prec["w_bits"], prec["a_signed"],
                prec["w_signed"], policy.radix_bits))
            wspec = QuantSpec(prec["w_bits"], prec["w_signed"],
                              per_channel=True)
            aw, ax = w_alphas[n.name], act_alphas[n.name]
            wt = to_tensor(w, device)
            co = wt.shape[-1]
            sc = 1.0 if scale is None else to_tensor(scale, device)
            if conv:
                packed = pack_conv_weights(wt, wspec, aw).packed
                folded = (ax * aw.reshape(1, 1, 1, co) * sc).reshape(co)
            else:
                packed = pack_weights(wt, wspec, aw).packed
                folded = (ax * aw.reshape(-1) * sc).to(
                    torch.float32).reshape(co)
            out_kind, rq_scale, rq_bits, rq_signed, out_fmt = _plan_requant(
                g, n, act_alphas, requant_alphas)
            p = {"w_packed": packed, "scale": folded.contiguous()}
            if bias is not None:
                p["bias"] = to_tensor(bias, device)
            if rq_scale is not None:
                p["requant_scale"] = rq_scale
            params[n.name] = p
            attrs = {"spec": spec, "relu": relu, "out": out_kind,
                     "requant_bits": rq_bits, "requant_signed": rq_signed}
            out_bits = rq_bits if out_kind == "packed" else None
            n_calib = int(calib.shape[0])
            if conv:
                st, pd = n.attrs.get("stride", 1), n.attrs.get("padding", 1)
                attrs.update(ci=wt.shape[2], stride=st, padding=pd)
                tile = tuning.choose_conv_tile(
                    n_calib, xshape[1], xshape[2], ci, co, fh=fh, fw=fw_,
                    stride=st, padding=pd, spec=spec, out_bits=out_bits)
            else:
                attrs["k"] = wt.shape[0]
                m = int(np.prod([d or n_calib for d in xshape[:-1]]))
                tile = tuning.choose_tile(m, wt.shape[0], co, spec,
                                          out_bits=out_bits)
            attrs["tile"] = tile
            meta["tiles"][n.name] = tile
            steps.append(Step(n.name, "conv_packed" if conv else "gemm_packed",
                              (tin,), n.output, attrs))
            fmt[n.output] = out_fmt
            cost_nodes.append(lowered(n.name, *geom, relu=relu,
                                      requant=rq_bits is not None))
            per_layer_bits[n.name] = (prec["a_bits"], prec["w_bits"])
        elif n.op == "maxpool":
            f = fmt[n.inputs[0]]
            if f[0] == "packed":
                raise GraphError(f"{n.name}: pooling packed planes directly "
                                 "is unsupported (producer should emit codes)")
            params[n.name] = {}
            steps.append(Step(n.name, "maxpool", (n.inputs[0],), n.output, {
                "window": n.attrs.get("window", 2),
                "stride": n.attrs.get("stride", n.attrs.get("window", 2))}))
            fmt[n.output] = f  # codes pool to codes, float to float
        elif n.op in ("global_avg_pool", "flatten", "relu"):
            tin = as_float(n.inputs[0], n.name)
            params[n.name] = {}
            kind = "global_pool" if n.op == "global_avg_pool" else n.op
            steps.append(Step(n.name, kind, (tin,), n.output))
            fmt[n.output] = ("float",)
        elif n.op == "add":
            a = as_float(n.inputs[0], n.name)
            b = as_float(n.inputs[1], n.name)
            params[n.name] = {}
            steps.append(Step(n.name, "add", (a, b), n.output))
            fmt[n.output] = ("float",)
        elif n.op == "requantize":
            tin = as_float(n.inputs[0], n.name)
            params[n.name] = {"scale": requant_alphas[n.name]}
            steps.append(Step(n.name, "fake_quant", (tin,), n.output, {
                "bits": n.attrs.get("bits", 8),
                "signed": n.attrs.get("signed", True)}))
            fmt[n.output] = ("float",)
        else:
            raise GraphError(f"{n.name}: cannot lower op {n.op!r}")

    out_name = g.outputs[0]
    if fmt[out_name][0] != "float":  # graph output must be host-readable
        out_name = as_float(out_name, "output")
    meta["formats"] = dict(fmt)
    program = Program(graph_name=g.name, steps=tuple(steps), params=params,
                      input_name=input_name, output_name=out_name,
                      device=device, cost_nodes=cost_nodes,
                      per_layer_bits=per_layer_bits, meta=meta)
    from repro_torch import analysis
    if analysis.verify_enabled():
        analysis.count("post_lowering")
        from repro_torch.analysis.verify_ir import verify_program
        verify_program(program, site="post_lowering")
    return program


# --------------------------------------------------------------------------
# carry-across: a Program lowered elsewhere, as numpy
# --------------------------------------------------------------------------

def _decode(v):
    """Invert the reference artifact's ``_enc`` for step attrs and codegen
    nodes: tuples, SerialSpecs, LoweredConv/LoweredGemm; any other marker
    is refused."""
    if isinstance(v, list):
        return [_decode(x) for x in v]
    if isinstance(v, dict):
        if "__t__" in v:
            return tuple(_decode(x) for x in v["__t__"])
        if "__serialspec__" in v:
            return SerialSpec(**v["__serialspec__"])
        if "__lconv__" in v:
            return LoweredConv(**v["__lconv__"])
        if "__lgemm__" in v:
            return LoweredGemm(**v["__lgemm__"])
        markers = [k for k in v if k.startswith("__") and k.endswith("__")]
        if markers:
            raise ValueError(f"unsupported encoded value {markers[0]!r}")
        return {k: _decode(x) for k, x in v.items()}
    return v


def program_from_numpy(record: Dict, device=None) -> Program:
    """Build a port Program from a record shaped like the reference's
    artifact manifest: ``graph_name``, ``input_name``, ``output_name``,
    ``steps`` (``{name, kind, inputs, output, attrs}`` with attrs in the
    manifest's encoded form) and ``params`` ({step: {key: numpy array}},
    uint32 words as they are or viewed as int32). An optional ``meta``
    contributes ``input_shape``/``calib_batch``, and an optional
    ``cost_nodes`` (the manifest's ``__lconv__``/``__lgemm__`` markers) the
    code generator's nodes, so the Program lowers to the reference's
    command stream.

    The step attrs' ``tile`` (the reference's TPU VMEM blocks) is dropped:
    it names no tile of the CUDA kernels, so the steps launch the kernels'
    own heuristic.
    """
    device = resolve_device(device)
    steps = []
    for s in record["steps"]:
        attrs = _decode(dict(s.get("attrs", {})))
        attrs.pop("tile", None)
        steps.append(Step(s["name"], s["kind"], tuple(s["inputs"]),
                          s["output"], attrs))
    params = {name: {k: to_tensor(v, device) for k, v in p.items()}
              for name, p in record["params"].items()}
    meta = {}
    rec_meta = record.get("meta") or {}
    for key in ("input_shape", "calib_batch"):
        if key in rec_meta:
            val = rec_meta[key]
            meta[key] = (tuple(_decode(val)) if key == "input_shape"
                         else int(val))
    per_layer_bits = {s.name: (s.attrs["spec"].a_bits, s.attrs["spec"].w_bits)
                      for s in steps if "spec" in s.attrs}
    cost_nodes = [_decode(c) for c in record.get("cost_nodes") or []]
    return Program(graph_name=record["graph_name"], steps=tuple(steps),
                   params=params, input_name=record["input_name"],
                   output_name=record["output_name"], device=device,
                   cost_nodes=cost_nodes,
                   per_layer_bits=per_layer_bits, meta=meta)
