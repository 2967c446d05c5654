"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit).

Frozen copy of the peaks in ``src/repro_torch/core/cost_model.py``
``H100Config`` (``int8_ops``, ``hbm_bw``) at commit b3e1625; the benchmark
keeps its own so that a change to the program's tile model cannot move
the yardstick.
"""

#: dense int8 tensor-core operations a second
INT8_OPS = 1.979e15
#: HBM3 bytes a second
HBM_BYTES = 3.35e12


def bound_seconds(ops: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of the operations
    over the int8 peak and the bytes over HBM's."""
    return max(ops / INT8_OPS, nbytes / HBM_BYTES)
