"""Pipeline parallelism — BARVINN's Pipelined mode over layer groups.

Counterpart of ``repro/distributed/pipeline_parallel.py``. The FPGA
streams layer outputs MVU→MVU over an 8-way crossbar so downstream layers
start before upstream ones finish the whole tensor (§3.1.6). The
reference runs GPipe microbatching under ``shard_map`` over a stage mesh
axis. Here the stages are :class:`~repro_torch.distributed.
program_parallel.Bank` records: stage ``s``'s layers live on bank ``s``,
microbatch ``m`` occupies stage ``s`` at wavefront step ``m + s`` — the
same wavefront the paper draws in Figure 5(a) — and each hop is a wait on
the event stage ``s - 1`` recorded for that microbatch on its stream, so
stages of different microbatches may overlap on the card.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from repro_torch.distributed.program_parallel import (
    _tree_map, after_caller, bank_devices, join, on_bank, replicate_params)

__all__ = ["gpipe", "stage_stack"]


def stage_stack(tree, n_stages: int):
    """Re-stack per-layer params (L, ...) into (n_stages, L/S, ...)."""
    def f(x):
        l = x.shape[0]
        if n_stages < 1 or l % n_stages != 0:
            raise ValueError(
                f"stage_stack: leading (layer) dim {l} is not divisible "
                f"by n_stages={n_stages} (leaf shape {tuple(x.shape)})")
        return x.reshape((n_stages, l // n_stages) + tuple(x.shape[1:]))
    return _tree_map(f, tree)


def gpipe(stage_fn: Callable, stage_params, x: torch.Tensor, *,
          banks: Sequence, n_microbatches: Optional[int] = None
          ) -> torch.Tensor:
    """Run ``y = stages(x)`` through a GPipe wavefront over ``banks``.

    ``stage_fn(params_for_stage, microbatch) -> microbatch`` applies one
    stage's layers. ``stage_params``: leaves with leading dim = n_stages
    (:func:`stage_stack`); stage ``s``'s slice is placed on bank ``s``.
    ``banks``: :class:`~repro_torch.distributed.program_parallel.Bank` records
    or devices, one per stage. ``x``: (batch, ...) activations, split into
    ``n_microbatches`` (default: one per stage) along batch. Returns
    (batch, ...) outputs from the last stage, ready on the caller's
    stream.
    """
    banks = bank_devices(None, banks)
    n_stages = len(banks)
    nm = n_microbatches or n_stages
    b = x.shape[0]
    if nm < 1 or b % nm != 0:
        raise ValueError(
            f"gpipe: batch {b} is not divisible into n_microbatches={nm} "
            f"({n_stages} stages); pad the batch or pick n_microbatches "
            f"dividing it")
    mb = b // nm
    params = [replicate_params(_tree_map(lambda a, s=s: a[s], stage_params),
                               bank.device) for s, bank in enumerate(banks)]
    after_caller(banks[0], x)
    # carry[m]: microbatch m's activation after the last stage it passed,
    # done[m]: the event that stage recorded for it on its stream
    carry = [x[m * mb:(m + 1) * mb] for m in range(nm)]
    done = [None] * nm
    for t in range(nm + n_stages - 1):
        for s in range(n_stages):
            m = t - s
            if not 0 <= m < nm:
                continue
            bank = banks[s]
            with on_bank(bank):
                h = carry[m]
                if done[m] is not None:
                    bank.stream.wait_event(done[m])
                    if h.device == bank.device:
                        h.record_stream(bank.stream)
                    else:
                        src = torch.cuda.current_stream(h.device)
                        src.wait_event(done[m])
                        h.record_stream(src)
                carry[m] = stage_fn(params[s], h.to(bank.device))
                if bank.stream is not None:
                    done[m] = torch.cuda.Event()
                    done[m].record(bank.stream)
    last = banks[-1]
    with on_bank(last):
        y = torch.cat(carry, dim=0)
    return join(last, y)
