"""deepseek-v2-lite-16b [moe]: 27L, d_model=2048, 16H, MLA (kv_lora=512,
qk_nope=128, qk_rope=64, v=128), MoE 64 routed top-6 + 2 shared experts,
expert d_ff=1408, first layer dense (d_ff=10944), vocab=102400.
[arXiv:2405.04434; hf]. The port's copy of
``repro/configs/deepseek_v2_lite_16b.py`` (64 routed experts, as the v2-lite
hf config has them)."""

from repro_torch.configs.base import STANDARD_SHAPES, register
from repro_torch.models.layers import QuantPolicy
from repro_torch.models.transformer import ModelConfig

FULL = ModelConfig(
    name="deepseek-v2-lite-16b", family="moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=10944, vocab_size=102400, act="swiglu",
    mla=True, kv_lora=512, qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
    n_experts=64, top_k=6, n_shared_experts=2, d_ff_expert=1408,
    n_dense_layers=1,
    policy=QuantPolicy(mode="qat", w_bits=4, a_bits=8),
)

SMOKE = ModelConfig(
    name="deepseek-v2-lite-16b-smoke", family="moe",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=256, vocab_size=512, act="swiglu",
    mla=True, kv_lora=32, qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16,
    n_experts=4, top_k=2, n_shared_experts=1, d_ff_expert=32,
    n_dense_layers=1, dtype="float32", remat=False,
    policy=QuantPolicy(mode="qat", w_bits=4, a_bits=8),
)

register("deepseek-v2-lite-16b", FULL, SMOKE, STANDARD_SHAPES,
         source="arXiv:2405.04434; hf",
         skip_notes={"long_500k": "full-attention MoE; quadratic at 512k — "
                                  "skipped per assignment spec"})
