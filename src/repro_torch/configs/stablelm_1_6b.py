"""stablelm-1.6b [dense]: 24L, d_model=2048, 32H (kv=32: MHA), d_ff=5632,
vocab=100352, partial rotary 25%, LayerNorm.
[hf:stabilityai/stablelm-2-1_6b; unverified]. The port's copy of
``repro/configs/stablelm_1_6b.py``."""

from repro_torch.configs.base import FULL_ATTN_SKIP, STANDARD_SHAPES, register
from repro_torch.models.layers import QuantPolicy
from repro_torch.models.transformer import ModelConfig

FULL = ModelConfig(
    name="stablelm-1.6b", family="dense",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=5632, vocab_size=100352, act="swiglu", partial_rotary=0.25,
    norm_type="layer",
    policy=QuantPolicy(mode="qat", w_bits=4, a_bits=8),
)

SMOKE = ModelConfig(
    name="stablelm-1.6b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=512, act="swiglu", partial_rotary=0.25,
    norm_type="layer", dtype="float32", remat=False,
    policy=QuantPolicy(mode="qat", w_bits=4, a_bits=8),
)

register("stablelm-1.6b", FULL, SMOKE, STANDARD_SHAPES,
         source="hf:stabilityai/stablelm-2-1_6b; unverified",
         skip_notes=FULL_ATTN_SKIP)
