"""hymba-1.5b [hybrid]: 32L, d_model=1600, 25H (GQA kv=5) attention heads in
parallel with mamba heads (ssm_state=16), d_ff=5504, vocab=32001.
Sliding-window attention (1024) on most layers, full attention on layers
{0, 16, 31}. [arXiv:2411.13676; hf]. The port's copy of
``repro/configs/hymba_1_5b.py``."""

from repro_torch.configs.base import ALL_SHAPES, register
from repro_torch.models.layers import QuantPolicy
from repro_torch.models.transformer import ModelConfig

FULL = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, head_dim=64,
    d_ff=5504, vocab_size=32001, act="swiglu",
    ssm_state=16, ssm_head_dim=64, ssm_expand=2, ssm_groups=1, ssm_chunk=256,
    window=1024, global_attn_layers=(0, 16, 31),
    policy=QuantPolicy(mode="qat", w_bits=4, a_bits=8),
)

SMOKE = ModelConfig(
    name="hymba-1.5b-smoke", family="hybrid",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512, act="swiglu",
    ssm_state=8, ssm_head_dim=16, ssm_expand=2, ssm_groups=1, ssm_chunk=8,
    window=8, global_attn_layers=(0, 3),
    dtype="float32", remat=False,
    policy=QuantPolicy(mode="qat", w_bits=4, a_bits=8),
)

register("hymba-1.5b", FULL, SMOKE, ALL_SHAPES,
         source="arXiv:2411.13676; hf")
