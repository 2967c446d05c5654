"""Program executor: runs a lowered :class:`~repro_torch.compiler.lower.Program`
on batched inputs.

Counterpart of ``repro/compiler/executor.py``. Each step kind maps to one
dispatch function. The packed steps go through :mod:`repro_torch.kernels.ops`,
which picks the CUDA kernel or its plain version by the tensor's device, so
one Program runs on the card or on the CPU unchanged. PyTorch runs eagerly:
there is no jit; a CUDA graph per padding bucket is later work.
``conv_packed`` steps run K2 and ``gemm_packed`` steps K3.

:func:`make_plain_runner` runs the packed steps through the kernels' plain
versions whatever the device — the yardstick the card's kernels are held
against, never a fallback of :func:`make_runner`.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Set

import torch

from repro_torch.core.pipeline_modules import host_conv2d, maxpool_relu
from repro_torch.core.quant import QuantSpec, quantize_int
from repro_torch.kernels import ops
from repro_torch.kernels.bitserial_conv import bitserial_conv2d_ref
from repro_torch.kernels.quantize_pack import pack_codes_ref, quantize_pack_ref

__all__ = ["make_runner", "make_plain_runner", "make_step_runner",
           "bucket_sizes", "bucket_for", "BucketedRunner"]


def _requant_spec(attrs) -> Optional[QuantSpec]:
    if attrs.get("out") in ("packed", "codes", "requant_codes"):
        return QuantSpec(attrs["requant_bits"], attrs["requant_signed"])
    return None


def _conv_packed(st, p, x, conv=ops.serial_conv2d_packed_op):
    return conv(
        x, p["w_packed"], p["scale"], p.get("bias"),
        spec=st.attrs["spec"], ci=st.attrs["ci"], stride=st.attrs["stride"],
        padding=st.attrs["padding"], relu=st.attrs["relu"],
        requant=_requant_spec(st.attrs),
        requant_scale=p.get("requant_scale"),
        emit_packed=st.attrs["out"] == "packed")


def _gemm_packed(st, p, x, plain=False):
    return ops.serial_matmul_packed_op(
        x, p["w_packed"], p["scale"], p.get("bias"),
        spec=st.attrs["spec"], k=st.attrs["k"], relu=st.attrs["relu"],
        requant=_requant_spec(st.attrs),
        requant_scale=p.get("requant_scale"),
        emit_packed=st.attrs["out"] == "packed", plain=plain)


def _affine(st, p, y):
    if "scale" in p:
        y = y * p["scale"]
    if "bias" in p:
        y = y + p["bias"]
    return torch.clamp_min(y, 0) if st.attrs["relu"] else y


def _host_conv(st, p, x):
    return _affine(st, p, host_conv2d(x, p["w"], st.attrs["stride"],
                                      st.attrs["padding"]))


def _host_gemm(st, p, x):
    return _affine(st, p, x @ p["w"].to(x.dtype))


def _quantize_pack(st, p, x):
    spec = QuantSpec(st.attrs["bits"], st.attrs["signed"])
    return ops.quantize_pack_activations(x, p["act_alpha"], spec)


def _quantize_pack_plain(st, p, x):
    spec = QuantSpec(st.attrs["bits"], st.attrs["signed"])
    return ops.over_rows(lambda r: quantize_pack_ref(r, p["act_alpha"], spec),
                         x, spec.bits)


def _pack_codes(st, p, x):
    return ops.pack_activations(x.to(torch.int32), st.attrs["bits"])


def _pack_codes_plain(st, p, x):
    bits = st.attrs["bits"]
    return ops.over_rows(lambda r: pack_codes_ref(r, bits), x.to(torch.int32),
                         bits)


def _maxpool(st, p, x):
    # integer codes pool as int32 (max commutes with the monotone
    # quantizer, so pooling codes == pooling floats then quantizing)
    if not torch.is_floating_point(x):
        x = x.to(torch.int32)
    return maxpool_relu(x, st.attrs["window"], st.attrs["stride"],
                        with_relu=False)


_APPLY: Dict[str, Callable] = {
    "conv_packed": _conv_packed,
    "gemm_packed": _gemm_packed,
    "host_conv": _host_conv,
    "host_gemm": _host_gemm,
    "quantize_pack": _quantize_pack,
    "pack_codes": _pack_codes,
    "maxpool": _maxpool,
    "global_pool": lambda st, p, x: torch.mean(x, dim=(1, 2)),
    "flatten": lambda st, p, x: x.reshape(x.shape[0], -1),
    "relu": lambda st, p, x: torch.clamp_min(x, 0),
    "add": lambda st, p, a, b: a + b,
    "dequant": lambda st, p, x: x.to(torch.float32) * p["alpha"],
    "fake_quant": lambda st, p, x: quantize_int(
        x, p["scale"], QuantSpec(st.attrs["bits"], st.attrs["signed"])
    ).to(torch.float32) * p["scale"],
}

#: the packed steps through the kernels' plain versions, on any device
_PLAIN: Dict[str, Callable] = dict(
    _APPLY,
    conv_packed=lambda st, p, x: _conv_packed(st, p, x,
                                              conv=bitserial_conv2d_ref),
    gemm_packed=lambda st, p, x: _gemm_packed(st, p, x, plain=True),
    quantize_pack=_quantize_pack_plain,
    pack_codes=_pack_codes_plain,
)


def _runner(program, table):
    for st in program.steps:
        if st.kind not in table:
            raise KeyError(f"no executor for step kind {st.kind!r}")

    def run(params, x):
        env = {program.input_name: x}
        for st in program.steps:
            args = [env[i] for i in st.inputs]
            env[st.output] = table[st.kind](st, params.get(st.name, {}), *args)
        return env[program.output_name]

    return run


def make_runner(program) -> Callable:
    """Build ``run(params, x) -> output`` for one Program."""
    return _runner(program, _APPLY)


def make_plain_runner(program) -> Callable:
    """``run(params, x)`` with every packed step on its kernel's plain
    version, on whatever device ``x`` lies — the oracle for the card."""
    return _runner(program, _PLAIN)


def make_step_runner(program, step) -> Callable:
    """Build ``run(params, *inputs) -> output`` for a single Program step
    (inputs positionally in ``step.inputs`` order)."""
    fn = _APPLY.get(step.kind)
    if fn is None:
        raise KeyError(f"no executor for step kind {step.kind!r}")

    def run(params, *inputs):
        return fn(step, params.get(step.name, {}), *inputs)

    return run


# --------------------------------------------------------------------------
# batch-bucket entry points
# --------------------------------------------------------------------------

def bucket_sizes(max_batch: int) -> List[int]:
    """Padding buckets: powers of two up to, and always including,
    ``max_batch``."""
    if max_batch < 1:
        raise ValueError("max_batch must be >= 1")
    sizes, b = [], 1
    while b < max_batch:
        sizes.append(b)
        b *= 2
    sizes.append(max_batch)
    return sizes


def bucket_for(n: int, max_batch: int) -> int:
    """Smallest bucket holding ``n`` examples."""
    for b in bucket_sizes(max_batch):
        if n <= b:
            return b
    raise ValueError(f"batch {n} exceeds max_batch={max_batch}")


class BucketedRunner:
    """Program caller with power-of-two padding buckets (single device).

    Each batch is padded with zero rows up to its bucket, so the set of
    batch shapes the kernels ever see is closed (``bucket_sizes``). Every
    lowered step acts per example, so padding rows cannot leak into real
    rows. ``compiles`` counts first-seen buckets and ``hits`` repeats —
    the reference's jit-cache counters; here a first-seen bucket is where
    a CUDA graph can later be captured.
    """

    def __init__(self, program, *, max_batch: int = 32):
        self.program = program
        self.max_batch = max_batch
        self._run = make_runner(program)
        self._seen: Set[int] = set()
        self._lock = threading.Lock()
        self.compiles = 0   # guarded-by: _lock
        self.hits = 0       # guarded-by: _lock

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.program.device)
        n = x.shape[0]
        b = bucket_for(n, self.max_batch)
        if b != n:
            pad = torch.zeros((b - n,) + tuple(x.shape[1:]), dtype=x.dtype,
                              device=x.device)
            x = torch.cat([x, pad], dim=0)
        with self._lock:
            if b in self._seen:
                self.hits += 1
            else:
                self._seen.add(b)
                self.compiles += 1
        return self._run(self.program.params, x)[:n]

    def stats(self) -> Dict:
        with self._lock:
            return {"compiles": self.compiles, "hits": self.hits,
                    "buckets": sorted(self._seen),
                    "bucket_set": bucket_sizes(self.max_batch)}
