"""qwen1.5-110b [dense]: 80L, d_model=8192, 64H (GQA kv=8), d_ff=49152,
vocab=152064, QKV bias (the bias add exercises the paper's 32-bit bias
pipeline module). [hf:Qwen/Qwen1.5-0.5B; hf]. The port's copy of
``repro/configs/qwen1_5_110b.py``."""

from repro_torch.configs.base import FULL_ATTN_SKIP, STANDARD_SHAPES, register
from repro_torch.models.layers import QuantPolicy
from repro_torch.models.transformer import ModelConfig

FULL = ModelConfig(
    name="qwen1.5-110b", family="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=49152, vocab_size=152064, act="swiglu", qkv_bias=True,
    rope_theta=1e6,
    policy=QuantPolicy(mode="qat", w_bits=4, a_bits=8),
)

SMOKE = ModelConfig(
    name="qwen1.5-110b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, head_dim=8,
    d_ff=192, vocab_size=512, act="swiglu", qkv_bias=True,
    dtype="float32", remat=False,
    policy=QuantPolicy(mode="qat", w_bits=4, a_bits=8),
)

register("qwen1.5-110b", FULL, SMOKE, STANDARD_SHAPES,
         source="hf:Qwen/Qwen1.5-0.5B; hf", skip_notes=FULL_ATTN_SKIP)
