"""internvl2-76b [vlm]: InternViT frontend (stub: precomputed patch
embeddings, dim 3200) + LM backbone 80L, d_model=8192, 64H (GQA kv=8),
d_ff=28672, vocab=128256. [arXiv:2404.16821; unverified]. The port's copy of
``repro/configs/internvl2_76b.py``."""

from repro_torch.configs.base import FULL_ATTN_SKIP, STANDARD_SHAPES, register
from repro_torch.models.layers import QuantPolicy
from repro_torch.models.transformer import ModelConfig

FULL = ModelConfig(
    name="internvl2-76b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=28672, vocab_size=128256, act="swiglu", rope_theta=5e5,
    frontend="patch", frontend_len=256, frontend_dim=3200,
    policy=QuantPolicy(mode="qat", w_bits=4, a_bits=8),
)

SMOKE = ModelConfig(
    name="internvl2-76b-smoke", family="vlm",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, head_dim=8,
    d_ff=128, vocab_size=512, act="swiglu",
    frontend="patch", frontend_len=4, frontend_dim=32,
    dtype="float32", remat=False,
    policy=QuantPolicy(mode="qat", w_bits=4, a_bits=8),
)

register("internvl2-76b", FULL, SMOKE, STANDARD_SHAPES,
         source="arXiv:2404.16821; unverified", skip_notes=FULL_ATTN_SKIP)
