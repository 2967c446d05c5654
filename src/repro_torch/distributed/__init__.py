"""Array scaling on the card: the port's counterpart of ``repro/distributed``.

* :mod:`repro_torch.distributed.program_parallel` — a compiled Program
  across several MVU banks: banks and their streams, the replica cache,
  the sharded and pipelined Programs and ``stage_partition``.
* :mod:`repro_torch.distributed.pipeline_parallel` — ``stage_stack`` and
  ``gpipe``, the paper's Pipelined mode over layer groups.
* :mod:`repro_torch.distributed.context` — the logical-axis binding
  (``bind_axes``, ``axis_size``, ``constrain``) that model code reads.
* :mod:`repro_torch.distributed.sharding` — one model's tensors over a
  data x model mesh: the reference's sharding rules as per-dimension
  specs and their DTensor placements.
* :mod:`repro_torch.distributed.placed` — the model operations DTensor
  cannot place by itself (the vocab-parallel embedding, the MoE's
  dispatch), run on each rank's shards.
* :mod:`repro_torch.distributed.compression` — the int8 gradient
  all-reduce with error feedback.

A bank is a placement: a device plus, on a card, a CUDA stream of its own.
Banks go round-robin over the visible cards, so four banks on one H100 are
four streams on ``cuda:0``; on the CPU every bank is the CPU and the banks
run one after another. A mesh of ranks is one process a device
(``launch/mesh.py``): NCCL on the cards, gloo on the CPU.
"""
