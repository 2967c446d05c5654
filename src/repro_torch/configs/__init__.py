"""Architecture registry. Importing this package registers the ported
architectures (the dense LM stablelm-1.6b, the MLA + MoE LM
deepseek-v2-lite-16b, the SSM mamba2-780m and the hybrid hymba-1.5b; the
CNN is served by ``CNNServer`` directly)."""

from repro_torch.configs.base import (ARCH_REGISTRY, ArchEntry, get_arch,
                                      list_archs)
from repro_torch.configs import deepseek_v2_lite_16b  # noqa: F401  (registers)
from repro_torch.configs import hymba_1_5b  # noqa: F401  (registers)
from repro_torch.configs import mamba2_780m  # noqa: F401  (registers)
from repro_torch.configs import stablelm_1_6b  # noqa: F401  (registers)

__all__ = ["ARCH_REGISTRY", "ArchEntry", "get_arch", "list_archs"]
