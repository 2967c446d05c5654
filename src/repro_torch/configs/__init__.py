"""Architecture registry. Importing this package registers the reference's
ten LM architectures (dense, MoE, SSM, hybrid, VLM and audio
encoder-decoder; the CNN is served by ``CNNServer`` directly)."""

from repro_torch.configs.base import (ARCH_REGISTRY, SHAPES, ArchEntry,
                                      Shape, get_arch, input_specs,
                                      list_archs)
from repro_torch.configs import (command_r_plus_104b,  # noqa: F401 (registers)
                                 deepseek_v2_lite_16b, hymba_1_5b,
                                 internvl2_76b, mamba2_780m, nemotron_4_15b,
                                 qwen1_5_110b, qwen3_moe_235b_a22b,
                                 seamless_m4t_large_v2, stablelm_1_6b)

__all__ = ["ARCH_REGISTRY", "SHAPES", "ArchEntry", "Shape", "get_arch",
           "input_specs", "list_archs"]
