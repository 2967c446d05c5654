"""Optimizers (:mod:`.optimizer`: AdamW, the cosine schedule, global-norm
clipping) on nested dict/list trees of tensors."""

from repro_torch.optim.optimizer import (AdamWConfig, adamw_init,
                                         adamw_update, clip_by_global_norm,
                                         cosine_lr, global_norm)

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cosine_lr",
           "global_norm", "clip_by_global_norm"]
