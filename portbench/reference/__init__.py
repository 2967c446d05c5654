"""Plain references the benchmark holds the program's answers against.

They import nothing of the program and take nothing it made. On this card
a float32 matmul or convolution may run in TF32 unless both flags below
are off, so the references run under :func:`tf32` ``(False)``.
"""

from __future__ import annotations

import contextlib

import torch

__all__ = ["tf32"]


@contextlib.contextmanager
def tf32(enabled: bool):
    """Set ``torch.backends.cuda.matmul.allow_tf32`` and
    ``torch.backends.cudnn.allow_tf32`` for the block, then restore
    them."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old
