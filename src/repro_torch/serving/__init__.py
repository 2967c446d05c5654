"""Serving runtime of the port.

* :mod:`repro_torch.serving.lm_engine` — continuous-batching LM decode: a
  persistent ``batch_slots x max_len`` slot arena where requests join and
  leave at token boundaries; on the card its decode step is one captured
  CUDA graph, replayed per step.

The reference's registry, dynamic batcher, slot scheduler and
``InferenceService`` are not ported yet.
"""

from repro_torch.serving.lm_engine import (ContinuousLMEngine,
                                           decode_cost_stream,
                                           supports_continuous)

__all__ = ["ContinuousLMEngine", "supports_continuous", "decode_cost_stream"]
