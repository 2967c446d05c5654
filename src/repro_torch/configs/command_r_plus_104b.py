"""command-r-plus-104b [dense]: 64L, d_model=12288, 96H (GQA kv=8),
d_ff=33792, vocab=256000, no biases.
[hf:CohereForAI/c4ai-command-r-v01; unverified]. The port's copy of
``repro/configs/command_r_plus_104b.py``."""

from repro_torch.configs.base import FULL_ATTN_SKIP, STANDARD_SHAPES, register
from repro_torch.models.layers import QuantPolicy
from repro_torch.models.transformer import ModelConfig

FULL = ModelConfig(
    name="command-r-plus-104b", family="dense",
    n_layers=64, d_model=12288, n_heads=96, n_kv_heads=8, head_dim=128,
    d_ff=33792, vocab_size=256000, act="swiglu", rope_theta=75e6,
    policy=QuantPolicy(mode="qat", w_bits=4, a_bits=8),
)

SMOKE = ModelConfig(
    name="command-r-plus-104b-smoke", family="dense",
    n_layers=2, d_model=96, n_heads=12, n_kv_heads=2, head_dim=8,
    d_ff=256, vocab_size=512, act="swiglu", dtype="float32", remat=False,
    policy=QuantPolicy(mode="qat", w_bits=4, a_bits=8),
)

register("command-r-plus-104b", FULL, SMOKE, STANDARD_SHAPES,
         source="hf:CohereForAI/c4ai-command-r-v01; unverified",
         skip_notes=FULL_ATTN_SKIP)
