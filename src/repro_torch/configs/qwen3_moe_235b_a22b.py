"""qwen3-moe-235b-a22b [moe]: 94L, d_model=4096, 64H (GQA kv=4),
128 experts top-8 (no shared), expert d_ff=1536, vocab=151936.
[hf:Qwen/Qwen3-30B-A3B; hf]. The port's copy of
``repro/configs/qwen3_moe_235b_a22b.py``."""

from repro_torch.configs.base import STANDARD_SHAPES, register
from repro_torch.models.layers import QuantPolicy
from repro_torch.models.transformer import ModelConfig

FULL = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, head_dim=128,
    d_ff=1536, vocab_size=151936, act="swiglu", rope_theta=1e6,
    n_experts=128, top_k=8, n_shared_experts=0, d_ff_expert=1536,
    norm_topk_prob=True,
    policy=QuantPolicy(mode="qat", w_bits=4, a_bits=8),
)

SMOKE = ModelConfig(
    name="qwen3-moe-235b-a22b-smoke", family="moe",
    n_layers=3, d_model=64, n_heads=8, n_kv_heads=2, head_dim=8,
    d_ff=64, vocab_size=512, act="swiglu",
    n_experts=8, top_k=2, n_shared_experts=0, d_ff_expert=32,
    dtype="float32", remat=False,
    policy=QuantPolicy(mode="qat", w_bits=4, a_bits=8),
)

register("qwen3-moe-235b-a22b", FULL, SMOKE, STANDARD_SHAPES,
         source="hf:Qwen/Qwen3-30B-A3B; hf",
         skip_notes={"long_500k": "full-attention MoE; quadratic at 512k — "
                                  "skipped per assignment spec"})
