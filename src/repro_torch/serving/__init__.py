"""Multi-tenant serving runtime of the port (registry → batcher → scheduler
→ service), the counterpart of ``repro/serving``.

* :mod:`repro_torch.serving.registry`  — model/precision registry: lazy
  compile, LRU eviction, content-addressed packed-weight sharing on the
  device.
* :mod:`repro_torch.serving.batcher`   — request queue + dynamic
  micro-batcher with backpressure.
* :mod:`repro_torch.serving.scheduler` — MVU-slot admission in the cycle
  domain (``BarrelController.simulate``, per-slot utilization, HPM
  counters).
* :mod:`repro_torch.serving.service`   — the thread-driven front end:
  ``submit`` / ``submit_many`` / ``drain`` + the metrics snapshot; Program
  variants run one CUDA graph per padding bucket on the card.
* :mod:`repro_torch.serving.lm_engine` — continuous-batching LM decode: a
  persistent ``batch_slots x max_len`` slot arena where requests join and
  leave at token boundaries; on the card its decode step is one captured
  CUDA graph, replayed per step, and the scheduler is booked per step.

The service serves one bank (placement ``"single"``) or several
(``n_banks > 1``, ``"banked"`` or ``"sharded"``), each bank a stream of
its own on the card (:mod:`repro_torch.distributed.program_parallel`).
"""

from repro_torch.serving.batcher import (DynamicBatcher, MicroBatch,
                                         QueueFull, Request)
from repro_torch.serving.lm_engine import (ContinuousLMEngine,
                                           decode_cost_stream,
                                           supports_continuous)
from repro_torch.serving.registry import (ModelKey, ModelRegistry,
                                          precision_label)
from repro_torch.serving.scheduler import Admission, SlotScheduler
from repro_torch.serving.service import InferenceService

__all__ = ["ModelKey", "ModelRegistry", "precision_label", "DynamicBatcher",
           "MicroBatch", "Request", "QueueFull", "SlotScheduler",
           "Admission", "InferenceService", "ContinuousLMEngine",
           "supports_continuous", "decode_cost_stream"]
