"""Activation-sharding context: lets model code state logical layouts
("dp", "tp", "sp") without knowing the device layout; launchers bind the
logical axes to mesh axis names.

Counterpart of ``repro/distributed/context.py``. ``mesh`` is anything
with a ``.shape`` mapping of axis sizes (a plain dict serves), so model
code can read how many ways an axis is split (:func:`axis_size`; the
MoE's group-local dispatch picks its group count from ``"dp"``). One
process holds whole tensors, so :func:`constrain` returns its input.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional, Tuple, Union

_state = threading.local()

__all__ = ["bind_axes", "constrain", "axis", "axis_size", "active"]


def _get():
    return getattr(_state, "axes", None)


@contextlib.contextmanager
def bind_axes(dp: Union[str, Tuple[str, ...], None] = None,
              tp: Optional[str] = None, sp: Optional[str] = None,
              pp: Optional[str] = None, mesh=None):
    """Bind logical axes to mesh axis names for the enclosed code.
    ``mesh`` supplies axis sizes (``mesh.shape``, or a dict of them)."""
    prev = _get()
    shape = mesh if isinstance(mesh, dict) else getattr(mesh, "shape", None)
    sizes = dict(shape) if shape is not None else {}
    _state.axes = {"dp": dp, "tp": tp, "sp": sp, "pp": pp,
                   "__sizes__": sizes}
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
    """The reference's ``with_sharding_constraint`` over logical axis
    names: in one process every tensor is whole, so ``x`` itself."""
    return x
