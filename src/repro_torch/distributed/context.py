"""Activation-sharding context: lets model code state logical layouts
("dp", "tp", "sp") without knowing the device layout; launchers bind the
logical axes to mesh axis names.

Counterpart of ``repro/distributed/context.py``. ``mesh`` is a
``DeviceMesh`` or anything with a ``.shape`` mapping of axis sizes (a
plain dict serves), so model code can read how many ways an axis is split
(:func:`axis_size`; the MoE's group-local dispatch picks its group count
from ``"dp"``). Tensors placed on a mesh are DTensors, and
:func:`constrain` redistributes one to the bound layout (the reference's
``with_sharding_constraint``); a plain tensor, whole in its process, or
any tensor outside a bound context is returned as it is, so one-device
code runs unchanged.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional, Tuple, Union

from repro_torch.distributed import placed
from repro_torch.distributed.sharding import mesh_sizes, to_placements

_state = threading.local()

__all__ = ["bind_axes", "constrain", "axis", "axis_size", "active",
           "snapshot", "rebind"]


def _get():
    return getattr(_state, "axes", None)


@contextlib.contextmanager
def bind_axes(dp: Union[str, Tuple[str, ...], None] = None,
              tp: Optional[str] = None, sp: Optional[str] = None,
              pp: Optional[str] = None, mesh=None):
    """Bind logical axes to mesh axis names for the enclosed code.
    ``mesh`` supplies axis sizes (``mesh.shape``, or a dict of them)."""
    prev = _get()
    sizes = mesh_sizes(mesh) if mesh is not None else {}
    _state.axes = {"dp": dp, "tp": tp, "sp": sp, "pp": pp,
                   "__sizes__": sizes}
    try:
        yield
    finally:
        _state.axes = prev


def snapshot():
    """The current binding (None when unbound): what :func:`rebind`
    re-enters in another thread, such as autograd's, where a checkpointed
    layer runs again during the backward."""
    return _get()


@contextlib.contextmanager
def rebind(snap):
    """Bind exactly ``snap`` (a :func:`snapshot`) for the enclosed code."""
    prev = _get()
    _state.axes = snap
    try:
        yield
    finally:
        _state.axes = prev


def active() -> bool:
    return _get() is not None


def axis(name: str):
    ctx = _get()
    return None if ctx is None else ctx.get(name)


def axis_size(name: str) -> int:
    """Product of the mesh-axis sizes bound to a logical axis (1 if unbound
    or sizes unknown)."""
    ctx = _get()
    if ctx is None:
        return 1
    ax = ctx.get(name)
    if ax is None:
        return 1
    sizes = ctx.get("__sizes__", {})
    axes = ax if isinstance(ax, tuple) else (ax,)
    n = 1
    for a in axes:
        n *= sizes.get(a, 1)
    return n


def constrain(x, *logical):
    """The reference's ``with_sharding_constraint`` over logical axis names
    (or None): a DTensor is redistributed so that dimension ``d`` is split
    over the mesh axes bound to ``logical[d]`` and every other mesh axis
    holds it whole (a partial sum is summed). A dimension whose bound axes
    don't divide it, or that the tensor's mesh lacks, is left whole. A
    plain tensor, or any tensor outside a bound context, is returned as it
    is."""
    ctx = _get()
    if ctx is None or not placed.is_placed(x):
        return x
    mesh = x.device_mesh
    sizes = mesh_sizes(mesh)
    spec = []
    for dim, name in enumerate(logical):
        ax = ctx.get(name) if isinstance(name, str) else None
        axes = () if ax is None else ax if isinstance(ax, tuple) else (ax,)
        axes = tuple(a for a in axes if a in sizes)
        total = 1
        for a in axes:
            total *= sizes[a]
        if (not axes or total <= 1 or dim >= x.ndim
                or x.shape[dim] % total != 0):
            spec.append(None)
            continue
        spec.append(axes if len(axes) > 1 else axes[0])
    spec += [None] * (x.ndim - len(spec))
    placements = to_placements(tuple(spec), mesh)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(mesh, placements)
