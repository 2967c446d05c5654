"""What one step of a torch program costs: dot FLOPs, an HBM-traffic
proxy and collective bytes by kind, counted per device.

Counterpart of ``repro/launch/hlo_analysis.py``, which parses a compiled
jax program's optimized per-device HLO and rolls its call graph up. There
is no HLO here: a torch step is counted from a dispatch trace of one run
of it. :class:`CostMode` (a ``TorchDispatchMode``) sees every ATen op the
step dispatches, in the order it runs, and adds up

* dot FLOPs, 2·|result|·K, for ``mm``, ``addmm``, ``bmm``, ``baddbmm``,
  ``_int_mm`` and ``convolution`` (grouped); ``linear``, ``matmul``,
  ``einsum`` and the like reach the trace as these. A result of an
  integer type counts in ``flops_int`` as well (the reference's
  integer-dot share);
* an HBM-traffic proxy: every op that is not a view or an allocation
  reads its tensor operands and writes its results once (the reference's
  rule for an op outside a fusion). An op that writes into part of a
  buffer (``copy_`` into a slice, ``index_put_``, ``index_copy_``,
  ``scatter_``, ``slice_scatter``, ...: a KV-cache write) charges its
  operands and results less twice the buffer, the counterpart of the
  reference's dynamic-update-slice rule;
* collectives by the reference's five kinds (``all-gather``,
  ``all-reduce``, ``reduce-scatter``, ``all-to-all``,
  ``collective-permute``): the ``_c10d_functional`` ops and the in-place
  ``c10d`` ones, each its result's bytes on this rank; ``wait_tensor`` is
  not counted, as the reference skips ``-done``.

On a ``DeviceMesh`` the trace defers each op on a DTensor to DTensor's
own dispatch and counts the ops that run on the local shards and the
collectives DTensor issues, so a count is one rank's, as the reference's
HLO is one device's. The shape propagation DTensor runs on fake tensors
is not counted. A layer loop in Python is traced whole, so nothing is
multiplied by trip counts (the reference's ``while_trips`` has no
counterpart); ``torch.utils.checkpoint``'s recompute is counted as it
runs, as XLA's rematerialized ops are.

A packed kernel (K1, K2, K3, K4, grouped K4) counts as one op whatever
runs it (the CUDA kernel, its plain version on the CPU, or its shape on
the ``meta`` device): its wrapper reports the call to the active mode
through :meth:`CostMode.kernel` with its work, and the ops beneath it are
not counted. K2, K3, K4 and grouped K4: ``flops_int`` = 2·M·N·K ×
``kernel_digits(a)`` × ``kernel_digits(w)``, the int8 tensor-core work
the kernel issues, and ``flops_logical`` = 2·M·N·K; K1: no FLOPs (the
reference counts no elementwise FLOPs). Bytes: the tensors it is given
and its output. With no mode active a wrapper checks ``ACTIVE.mode`` and
does nothing more. The mode is per thread, as torch's dispatch modes
are: a kernel another thread launches is not this trace's.

``flops_logical`` counts each product once, 2·M·N·K, whatever its
digits: the work whatever implements it. ``kernel_calls`` counts the
kernels as ``kernels.ops.launch_counts`` names them; ``ops`` counts the
ATen ops the trace saw, views included.

Usage::

    out, cost = analyze(step, state, batch)
    cost.flops, cost.bytes_hbm, cost.collective_bytes["all-gather"]
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

__all__ = ["HLOCost", "CostMode", "analyze", "ACTIVE", "COLLECTIVES",
           "KERNELS", "gemm_flops"]

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
KERNELS = ("K1", "K2", "K3", "K4", "K4g")

class _Active(threading.local):
    mode: Optional["CostMode"] = None


#: ``ACTIVE.mode``: this thread's innermost active :class:`CostMode` (or
#: None); the kernel wrappers read it
ACTIVE = _Active()

# (op, index of the left operand): 2·|result|·lhs.shape[-1]
_DOTS = {"aten.mm": 0, "aten.addmm": 1, "aten.bmm": 0, "aten.baddbmm": 1,
         "aten._int_mm": 0}
# allocations and metadata: no bytes move
_FREE = {"aten.empty", "aten.empty_strided", "aten.empty_like",
         "aten.new_empty", "aten.new_empty_strided", "aten._unsafe_view",
         "aten.alias"}
# a write into part of the first operand (the buffer)
_PARTIAL_WRITES = {"aten.copy_", "aten.index_put_", "aten.index_put",
                   "aten._index_put_impl_", "aten.index_copy_",
                   "aten.index_copy", "aten.scatter_", "aten.scatter",
                   "aten.scatter_add_", "aten.scatter_add",
                   "aten.scatter_reduce_", "aten.scatter_reduce",
                   "aten.slice_scatter", "aten.select_scatter",
                   "aten.index_add_", "aten.index_add",
                   "aten.masked_scatter_", "aten.masked_scatter"}
_KIND = {}
for _ns in ("_c10d_functional", "_c10d_functional_autograd"):
    _KIND.update({
        f"{_ns}.all_gather_into_tensor": "all-gather",
        f"{_ns}.all_gather_into_tensor_coalesced": "all-gather",
        f"{_ns}.all_reduce": "all-reduce",
        f"{_ns}.all_reduce_": "all-reduce",
        f"{_ns}.all_reduce_coalesced": "all-reduce",
        f"{_ns}.all_reduce_coalesced_": "all-reduce",
        f"{_ns}.reduce_scatter_tensor": "reduce-scatter",
        f"{_ns}.reduce_scatter_tensor_coalesced": "reduce-scatter",
        f"{_ns}.all_to_all_single": "all-to-all"})
_KIND.update({
    "c10d.allgather_": "all-gather", "c10d._allgather_base_": "all-gather",
    "c10d.allgather_into_tensor_coalesced_": "all-gather",
    "c10d.allreduce_": "all-reduce",
    "c10d.allreduce_coalesced_": "all-reduce",
    "c10d.reduce_scatter_": "reduce-scatter",
    "c10d._reduce_scatter_base_": "reduce-scatter",
    "c10d.reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "c10d.alltoall_": "all-to-all", "c10d.alltoall_base_": "all-to-all",
    "c10d.send": "collective-permute", "c10d.recv_": "collective-permute"})
# not ops of the step: a tensor literal's marker (seen on some devices
# only), a profiler range's ends, autograd's wrapper of a collective's
# result, and the wait (the reference skips ``-done``)
_SKIP = {"aten.lift_fresh", "profiler._record_function_enter_new",
         "profiler._record_function_exit",
         "_c10d_functional._wrap_tensor_autograd",
         "_c10d_functional.wait_tensor"}


@dataclasses.dataclass
class HLOCost:
    """One step's counts on one device (see the module's docstring)."""
    flops: float = 0.0
    flops_int: float = 0.0   # integer-dot share (the int8 tensor cores)
    flops_logical: float = 0.0   # 2·M·N·K per product, whatever its digits
    bytes_hbm: float = 0.0
    collective_bytes: Dict[str, float] = dataclasses.field(
        default_factory=lambda: dict.fromkeys(COLLECTIVES, 0.0))
    collective_counts: Dict[str, float] = dataclasses.field(
        default_factory=lambda: dict.fromkeys(COLLECTIVES, 0.0))
    kernel_calls: Dict[str, int] = dataclasses.field(
        default_factory=lambda: dict.fromkeys(KERNELS, 0))
    ops: Dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def total_collective_bytes(self) -> float:
        return float(sum(self.collective_bytes.values()))

    def as_dict(self) -> dict:
        """The record's fields, ``ops`` sorted by name."""
        d = dataclasses.asdict(self)
        d["ops"] = dict(sorted(self.ops.items()))
        d["total_collective_bytes"] = self.total_collective_bytes
        return d


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _channels_last(t: torch.Tensor) -> bool:
    return (t.dim() == 4 and not t.is_contiguous()
            and t.is_contiguous(memory_format=torch.channels_last))


def _is_int(t: torch.Tensor) -> bool:
    return not (t.dtype.is_floating_point or t.dtype.is_complex)


def gemm_flops(m: int, n: int, k: int, a_digits: int = 1,
               w_digits: int = 1) -> tuple:
    """``(flops_int, flops_logical)`` of an (M, K) x (K, N) integer
    product issued as ``a_digits`` x ``w_digits`` digit products."""
    logical = 2.0 * m * n * k
    return logical * a_digits * w_digits, logical


class CostMode(TorchDispatchMode):
    """Counts the ops dispatched inside it into :attr:`cost` (an
    :class:`HLOCost`); see the module's docstring for the rules. Modes
    nest: the innermost counts the kernels' reports."""

    def __init__(self):
        super().__init__()
        self.cost = HLOCost()
        self._quiet = 0         # > 0 inside a kernel's call
        # the modes each entry replaced: a stack, since the mode enters
        # itself again to decompose a composite op
        self._outer = []

    def __enter__(self):
        self._outer.append(ACTIVE.mode)
        ACTIVE.mode = self
        return super().__enter__()

    def __exit__(self, *exc):
        ACTIVE.mode = self._outer.pop()
        return super().__exit__(*exc)

    # ------------------------------------------------------------ kernels
    def kernel(self, kid: str, fn: Callable, args, kw: dict,
               flops_int: float = 0.0, flops_logical: float = 0.0):
        """Run the kernel wrapper ``fn(*args, **kw)`` as one op: the ops
        beneath it are not counted, and it adds one call of ``kid`` with
        its FLOPs and the bytes of its tensors in and out."""
        ACTIVE.mode, self._quiet = None, self._quiet + 1
        try:
            out = fn(*args, **kw)
        finally:
            ACTIVE.mode, self._quiet = self, self._quiet - 1
        c = self.cost
        c.kernel_calls[kid] += 1
        c.flops_int += flops_int
        c.flops += flops_int
        c.flops_logical += flops_logical
        c.bytes_hbm += _nbytes((args, kw)) + _nbytes(out)
        return out

    # ---------------------------------------------------------- dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(t.__name__ == "DTensor" for t in types):
            # DTensor runs the op on the local shards (and its
            # collectives), which this mode then counts
            return NotImplemented
        if not self._quiet and torch._C._dispatch_has_kernel_for_dispatch_key(
                func.name(), "CompositeImplicitAutograd"):
            # under no_grad or inference_mode a composite op (``linear``,
            # ``einsum``, ``to``) reaches the mode whole: count its parts,
            # as autograd's dispatch would have decomposed it
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if self._quiet:
            return out
        if (func is torch.ops.aten.convolution.default and out.is_meta
                and _channels_last(args[0])):
            # the meta convolution returns NCHW whatever its input's
            # layout; the CPU's and cuDNN's keep a channels-last input's,
            # and the ops after it (a copy or none) depend on it
            out = torch.empty(out.shape, dtype=out.dtype, device="meta",
                              memory_format=torch.channels_last)
        if any(type(t).__name__ == "FakeTensor"
               for t in tree_leaves((args, out))):
            return out      # DTensor's shape propagation
        name = str(func.overloadpacket)
        if name in _SKIP:
            return out
        self._count(func, name, args, kwargs, out)
        return out

    def _count(self, func, name: str, args, kwargs, out) -> None:
        c = self.cost
        c.ops[name] = c.ops.get(name, 0) + 1
        kind = _KIND.get(name)
        if kind is not None:
            nb = _nbytes(out)
            c.collective_bytes[kind] += nb
            c.collective_counts[kind] += 1
        if name in _DOTS:
            lhs = args[_DOTS[name]]
            f = 2.0 * out.numel() * lhs.shape[-1]
            self._add_flops(f, _is_int(out))
        elif name == "aten.convolution":
            # K: a group's input channels times the taps, weight (Co,
            # Ci / groups, kh, kw)
            w = args[1]
            self._add_flops(2.0 * out.numel() * (w.numel() // w.shape[0]),
                            _is_int(out))
        if func.is_view or name in _FREE:
            return
        nb = _nbytes((args, kwargs)) + _nbytes(out)
        if name in _PARTIAL_WRITES and isinstance(args[0], torch.Tensor):
            nb = max(nb - 2 * _nbytes(args[0]), 0)
        c.bytes_hbm += nb

    def _add_flops(self, f: float, is_int: bool) -> None:
        c = self.cost
        c.flops += f
        c.flops_logical += f
        if is_int:
            c.flops_int += f


def analyze(fn: Callable, *args, **kw):
    """Run ``fn(*args, **kw)`` once under a :class:`CostMode`: ``(its
    output, its HLOCost)``."""
    with CostMode() as mode:
        out = fn(*args, **kw)
    return out, mode.cost
