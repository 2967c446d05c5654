"""The deterministic synthetic token stream (:mod:`.pipeline`)."""

from repro_torch.data.pipeline import Prefetcher, SyntheticLM, make_batch_iter

__all__ = ["SyntheticLM", "Prefetcher", "make_batch_iter"]
