"""mamba2-780m [ssm]: 48L, d_model=1536, attention-free SSD,
ssm_state=128, head_dim=64, expand=2 (d_inner=3072, 48 ssm heads),
vocab=50280, tied embeddings. [arXiv:2405.21060; unverified]. The port's
copy of ``repro/configs/mamba2_780m.py``: the in/out projections run
through the bit-serial kernels, the SSD recurrence in plain torch."""

from repro_torch.configs.base import ALL_SHAPES, register
from repro_torch.models.layers import QuantPolicy
from repro_torch.models.transformer import ModelConfig

FULL = ModelConfig(
    name="mamba2-780m", family="ssm",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24, head_dim=64,
    d_ff=0, vocab_size=50280, tie_embeddings=True,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_groups=1,
    ssm_chunk=256,
    policy=QuantPolicy(mode="qat", w_bits=4, a_bits=8),
)

SMOKE = ModelConfig(
    name="mamba2-780m-smoke", family="ssm",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=0, vocab_size=512, tie_embeddings=True,
    ssm_state=16, ssm_head_dim=16, ssm_expand=2, ssm_groups=1, ssm_chunk=8,
    dtype="float32", remat=False,
    policy=QuantPolicy(mode="qat", w_bits=4, a_bits=8),
)

register("mamba2-780m", FULL, SMOKE, ALL_SHAPES,
         source="arXiv:2405.21060; unverified")
