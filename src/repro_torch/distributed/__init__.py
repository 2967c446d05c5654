"""Array scaling on the card: the port's counterpart of ``repro/distributed``.

* :mod:`repro_torch.distributed.program_parallel` — a compiled Program
  across several MVU banks: banks and their streams, the replica cache,
  the sharded and pipelined Programs and ``stage_partition``.
* :mod:`repro_torch.distributed.pipeline_parallel` — ``stage_stack`` and
  ``gpipe``, the paper's Pipelined mode over layer groups.
* :mod:`repro_torch.distributed.context` — the logical-axis binding
  (``bind_axes``, ``axis_size``) that model code reads.

A bank is a placement: a device plus, on a card, a CUDA stream of its own.
Banks go round-robin over the visible cards, so four banks on one H100 are
four streams on ``cuda:0``; on the CPU every bank is the CPU and the banks
run one after another. Sharding one model's tensors across processes
(``sharding.py``, ``compression.py``) is not ported.
"""
