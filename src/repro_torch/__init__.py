"""PyTorch/CUDA port of the BARVINN reproduction, for one NVIDIA H100.

The JAX package ``repro`` is the reference; this package mirrors its layout
(``core/``, ``kernels/``, ``compiler/``, ``models/``, ``launch/``) so each
module's counterpart is easy to find. It imports ``torch``, numpy and the
standard library only — never ``jax`` and nothing of ``repro``.

Conventions:

* Packed bit planes are carried as ``int32`` tensors holding the same bits
  as the reference's ``uint32`` words (torch has no ``uint32`` shifts on the
  CPU); lane ``t`` of a 32-lane group is bit ``t`` of its word.
* Layouts follow the reference at every public function: NHWC activations,
  HWIO weights, ``(bits, ..., ceil(K/32))`` packed planes.
* Every hand-written CUDA kernel sits beside its plain PyTorch version. A
  kernel wrapper runs the plain version for a tensor on the CPU and launches
  the kernel for a tensor on the card (or raises) — it never falls back.
* Entry points run on the card unless the caller asks for the CPU
  (:func:`resolve_device`).
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` means the card: raise when there is none rather than carry
    on quietly on the CPU. Pass ``"cpu"`` to run the plain versions."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                               "port's plain versions on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device
