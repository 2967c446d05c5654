"""nemotron-4-15b [dense]: 32L, d_model=6144, 48H (GQA kv=8), d_ff=24576,
squared-ReLU MLP (two-matrix), vocab=256000, partial rotary 50%.
[arXiv:2402.16819; unverified]. The port's copy of
``repro/configs/nemotron_4_15b.py``. The ReLU^2 activation is unsigned,
but the reference's code quantizes it under the config's signed policy
(sign plane kept), and so does the port."""

from repro_torch.configs.base import FULL_ATTN_SKIP, STANDARD_SHAPES, register
from repro_torch.models.layers import QuantPolicy
from repro_torch.models.transformer import ModelConfig

FULL = ModelConfig(
    name="nemotron-4-15b", family="dense",
    n_layers=32, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=24576, vocab_size=256000, act="relu2", partial_rotary=0.5,
    norm_type="layer",
    policy=QuantPolicy(mode="qat", w_bits=4, a_bits=8),
)

SMOKE = ModelConfig(
    name="nemotron-4-15b-smoke", family="dense",
    n_layers=2, d_model=48, n_heads=6, n_kv_heads=2, head_dim=8,
    d_ff=128, vocab_size=512, act="relu2", partial_rotary=0.5,
    norm_type="layer", dtype="float32", remat=False,
    policy=QuantPolicy(mode="qat", w_bits=4, a_bits=8),
)

register("nemotron-4-15b", FULL, SMOKE, STANDARD_SHAPES,
         source="arXiv:2402.16819; unverified", skip_notes=FULL_ATTN_SKIP)
