"""Graph / Program verifier (the FINN-R "verify the folded design against
the model before deploying" stage, as a static check).

The port's copy of ``repro/analysis/verify_ir.py``. :func:`verify_graph`
re-derives everything a pass could corrupt — shapes, precision
annotations, structural invariants — and raises :class:`VerifyError`
carrying the *blame* (the pass that ran last, or the load site).
:func:`verify_program` checks the lowered artifact: step I/O chaining,
dispatchable kinds, params presence, format-planner consistency, the
per-layer precision plan and, as ``tile-budget`` (the card's counterpart
of the reference's ``tile-vmem``), each packed step's tuned tile against
the shared-memory budget and the launch bound of the kernel instantiation
it selects.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

__all__ = ["VerifyError", "verify_graph", "verify_program"]


class VerifyError(ValueError):
    """A static-verification failure.

    ``check`` names the violated invariant (stable identifier, e.g.
    ``"hazard-order"``); ``blame`` names the pass / step / site responsible.
    """

    def __init__(self, check: str, detail: str, *,
                 blame: Optional[str] = None):
        self.check = check
        self.blame = blame
        where = f" [blame: {blame}]" if blame else ""
        super().__init__(f"{check}: {detail}{where}")


def _precision_ok(bits) -> bool:
    return isinstance(bits, int) and 1 <= bits <= 8


def verify_graph(g, *, policy=None, per_layer=None,
                 blame: Optional[str] = None,
                 expect_output_shapes: Optional[Dict[str, Tuple]] = None,
                 ) -> Dict[str, Tuple]:
    """Well-formedness of a typed IR graph; returns the re-derived shapes.

    Checks (each raises :class:`VerifyError` with ``blame`` attached):

    * ``graph-structure`` — single assignment, known ops, def-before-use
      (no dangling tensor refs), via :meth:`Graph.validate`;
    * ``dangling-output`` — every graph output is actually defined;
    * ``shape`` — shape inference succeeds (consistent geometry);
    * ``shape-annotation`` — a node's optional ``attrs["shape"]`` claim
      matches the re-derived shape of its output;
    * ``shape-drift`` — output shapes match ``expect_output_shapes``
      (recorded before a pass ran: passes must preserve graph outputs);
    * ``precision-range`` — annotated serial precisions are ints in [1, 8];
    * ``precision-policy`` — annotations agree with the driving
      :class:`~repro_torch.models.layers.QuantPolicy` + ``per_layer``
      overrides.
    """
    from repro_torch.compiler import passes
    from repro_torch.compiler.ir import GraphError

    try:
        g.validate()
    except GraphError as e:
        raise VerifyError("graph-structure", str(e), blame=blame) from e

    defined = set(g.inputs) | set(g.initializers) | {
        n.output for n in g.nodes}
    for out in g.outputs:
        if out not in defined:
            raise VerifyError(
                "dangling-output",
                f"graph output {out!r} is produced by no node", blame=blame)

    try:
        shapes = passes.infer_shapes(g)
    except GraphError as e:  # ShapeError is a GraphError
        raise VerifyError("shape", str(e), blame=blame) from e

    for n in g.nodes:
        claimed = n.attrs.get("shape")
        if claimed is not None and tuple(claimed) != tuple(shapes[n.output]):
            raise VerifyError(
                "shape-annotation",
                f"node {n.name!r} claims output shape {tuple(claimed)} but "
                f"re-derivation gives {tuple(shapes[n.output])}", blame=blame)

    if expect_output_shapes:
        for out, want in expect_output_shapes.items():
            got = shapes.get(out)
            if got is not None and tuple(got) != tuple(want):
                raise VerifyError(
                    "shape-drift",
                    f"graph output {out!r} changed shape {tuple(want)} -> "
                    f"{tuple(got)} across a pass", blame=blame)

    per_layer = per_layer or {}
    for n in g.nodes:
        prec = n.attrs.get("precision")
        if prec is None:
            continue
        mode = prec.get("mode")
        if mode not in ("host", "serial"):
            raise VerifyError(
                "precision-range",
                f"node {n.name!r}: unknown precision mode {mode!r}",
                blame=blame)
        if mode != "serial":
            continue
        ab, wb = prec.get("a_bits"), prec.get("w_bits")
        if not (_precision_ok(ab) and _precision_ok(wb)):
            raise VerifyError(
                "precision-range",
                f"node {n.name!r}: serial precisions must be ints in "
                f"[1, 8], got a_bits={ab!r} w_bits={wb!r}", blame=blame)
        if policy is not None and policy.mode == "serial":
            want_ab, want_wb = per_layer.get(
                n.name, (policy.a_bits, policy.w_bits))
            if (ab, wb) != (int(want_ab), int(want_wb)):
                raise VerifyError(
                    "precision-policy",
                    f"node {n.name!r}: annotated A{ab}/W{wb} disagrees "
                    f"with the policy's A{want_ab}/W{want_wb}", blame=blame)
            if (bool(prec.get("a_signed")) != bool(policy.a_signed)
                    or bool(prec.get("w_signed")) != bool(policy.w_signed)):
                raise VerifyError(
                    "precision-policy",
                    f"node {n.name!r}: signedness flags disagree with the "
                    "policy", blame=blame)
    return shapes


# --------------------------------------------------------------------------
# lowered Program
# --------------------------------------------------------------------------

_PACKED_KINDS = ("conv_packed", "gemm_packed")


def _tile_budget(step, cost_node, budget: int, blame: str) -> None:
    """Re-derive the step's tile through the cost model's own accounting:
    its shared memory against the budget the tuner enumerated with, its
    threads against the launch bound of the instantiation its plans
    select, its rows per block whole row tiles that instantiation has."""
    from repro_torch.core import cost_model

    spec = step.attrs.get("spec")
    tile = step.attrs.get("tile")
    if spec is None or tile is None or cost_node is None:
        raise VerifyError(
            "tile-budget",
            f"step {step.name!r} ({step.kind}) is missing its "
            "spec/tile/cost-node linkage", blame=blame)
    fixed = cost_model.fixed_plans(spec.a_bits, spec.w_bits, spec.a_signed,
                                   spec.w_signed)
    try:
        kw = tile.kernel_kwargs()
        nt, warps = int(kw["nt"]), int(kw["warps"])
        bound = cost_model.launch_bound_threads(fixed, nt)
    except (AttributeError, KeyError, TypeError, ValueError) as e:
        raise VerifyError(
            "tile-budget", f"step {step.name!r} ({step.kind}): tile {tile} "
            f"names no instantiation of the kernel: {e}", blame=blame) from e
    used = (cost_model.conv_kernel_smem_bytes(nt)
            if step.kind == "conv_packed" else cost_model.kernel_smem_bytes(nt))
    if used > budget:
        raise VerifyError(
            "tile-budget",
            f"step {step.name!r} ({step.kind}): tile {tile} needs {used} B "
            f"of shared memory, over the {budget} B budget", blame=blame)
    if not 1 <= 32 * warps <= bound:
        raise VerifyError(
            "tile-budget",
            f"step {step.name!r} ({step.kind}): tile {tile} launches "
            f"{32 * warps} threads a block, the instantiation's launch "
            f"bound is {bound}", blame=blame)


def verify_program(program, *, site: str = "post_lowering") -> None:
    """Post-lowering checks on a compiled / deserialized ``Program``.

    * ``step-kind`` — every step dispatches (``executor._APPLY``);
    * ``step-dangling-input`` / ``step-redefinition`` / ``program-output``
      — the step list chains: each input is the program input or an
      earlier step's output, outputs are single-assignment, and the
      program output is produced;
    * ``step-params`` — each step has its params entry, packed steps carry
      their weight planes and folded scaler;
    * ``format-plan`` — the packed-format planner's record in
      ``meta["formats"]`` is consistent: packed steps consume packed
      input, their declared out-kind matches the planned format, and the
      program output is host-readable float;
    * ``precision-range`` / ``precision-spec`` — ``per_layer_bits`` are in
      [1, 8] and agree with each packed step's planned ``SerialSpec``;
    * ``tile-budget`` — each packed step's tuned tile fits the shared
      memory budget and its instantiation's launch bound (re-derived via
      :mod:`repro_torch.core.cost_model`). A Program whose packed steps
      carry no tile at all (a store the reference wrote: its steps launch
      the kernels' heuristic) has none to check; one that tiles some steps
      and not others is blamed.
    """
    from repro_torch.compiler.executor import _APPLY
    from repro_torch.core import cost_model

    defined = {program.input_name}
    for step in program.steps:
        if step.kind not in _APPLY:
            raise VerifyError(
                "step-kind",
                f"step {step.name!r} has undispatchable kind "
                f"{step.kind!r} (known: {sorted(_APPLY)})", blame=step.name)
        for t in step.inputs:
            if t not in defined:
                raise VerifyError(
                    "step-dangling-input",
                    f"step {step.name!r} reads {t!r} before it is defined",
                    blame=step.name)
        if step.output in defined:
            raise VerifyError(
                "step-redefinition",
                f"step {step.name!r} redefines tensor {step.output!r}",
                blame=step.name)
        defined.add(step.output)
        if step.name not in program.params:
            raise VerifyError(
                "step-params",
                f"step {step.name!r} has no params entry", blame=step.name)
        if step.kind in _PACKED_KINDS:
            p = program.params[step.name]
            for key in ("w_packed", "scale"):
                if key not in p:
                    raise VerifyError(
                        "step-params",
                        f"packed step {step.name!r} is missing "
                        f"params[{key!r}]", blame=step.name)
    if program.output_name not in defined:
        raise VerifyError(
            "program-output",
            f"program output {program.output_name!r} is produced by no "
            "step", blame=site)

    fmt = program.meta.get("formats") or {}
    if fmt:
        out_f = fmt.get(program.output_name)
        if out_f is not None and tuple(out_f)[0] != "float":
            raise VerifyError(
                "format-plan",
                f"program output {program.output_name!r} planned as "
                f"{tuple(out_f)}, must be host-readable float", blame=site)
        for step in program.steps:
            if step.kind in _PACKED_KINDS:
                in_f = fmt.get(step.inputs[0])
                if in_f is not None and tuple(in_f)[0] != "packed":
                    raise VerifyError(
                        "format-plan",
                        f"step {step.name!r} consumes {step.inputs[0]!r} "
                        f"planned as {tuple(in_f)}, wants packed planes",
                        blame=step.name)
                out_kind = step.attrs.get("out")
                planned = fmt.get(step.output)
                want = {"packed": "packed", "codes": "codes",
                        "requant_codes": "codes", "float": "float"
                        }.get(out_kind)
                if (planned is not None and want is not None
                        and tuple(planned)[0] != want):
                    raise VerifyError(
                        "format-plan",
                        f"step {step.name!r} declares out={out_kind!r} but "
                        f"the planner recorded {tuple(planned)} for "
                        f"{step.output!r}", blame=step.name)
            elif step.kind in ("quantize_pack", "pack_codes"):
                planned = fmt.get(step.output)
                if planned is not None and tuple(planned)[0] != "packed":
                    raise VerifyError(
                        "format-plan",
                        f"step {step.name!r} packs into {step.output!r} "
                        f"planned as {tuple(planned)}", blame=step.name)

    for name, (ab, wb) in (program.per_layer_bits or {}).items():
        if not (_precision_ok(int(ab)) and _precision_ok(int(wb))):
            raise VerifyError(
                "precision-range",
                f"per_layer_bits[{name!r}] = A{ab}/W{wb} out of [1, 8]",
                blame=name)

    packed = [st for st in program.steps if st.kind in _PACKED_KINDS]
    tiled = any("tile" in st.attrs for st in packed)
    budget = cost_model.smem_budget_bytes()
    cost_by_name = {c.name: c for c in (program.cost_nodes or [])}
    for step in packed:
        if tiled:
            _tile_budget(step, cost_by_name.get(step.name), budget, step.name)
        bits = (program.per_layer_bits or {}).get(step.name)
        spec = step.attrs.get("spec")
        if bits is not None and spec is not None and (
                int(bits[0]) != spec.a_bits or int(bits[1]) != spec.w_bits):
            raise VerifyError(
                "precision-spec",
                f"step {step.name!r}: per_layer_bits A{bits[0]}/W{bits[1]} "
                f"disagrees with the planned spec "
                f"A{spec.a_bits}/W{spec.w_bits}", blame=step.name)
