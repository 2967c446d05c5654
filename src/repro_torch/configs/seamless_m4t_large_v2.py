"""seamless-m4t-large-v2 [audio]: encoder-decoder, 24L enc + 24L dec,
d_model=1024, 16H (MHA: kv=16), d_ff=8192, vocab=256206.
[arXiv:2308.11596; hf]. The speech frontend is a stub: ``input_specs``
provides precomputed frame embeddings fed to the encoder. The port's copy of
``repro/configs/seamless_m4t_large_v2.py``."""

from repro_torch.configs.base import STANDARD_SHAPES, register
from repro_torch.models.layers import QuantPolicy
from repro_torch.models.transformer import ModelConfig

FULL = ModelConfig(
    name="seamless-m4t-large-v2", family="audio",
    n_layers=24, n_enc_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    head_dim=64, d_ff=8192, vocab_size=256206, act="gelu",
    frontend="audio", frontend_dim=1024,
    policy=QuantPolicy(mode="qat", w_bits=4, a_bits=8),
)

SMOKE = ModelConfig(
    name="seamless-m4t-large-v2-smoke", family="audio",
    n_layers=2, n_enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    head_dim=16, d_ff=128, vocab_size=512, act="gelu",
    frontend="audio", frontend_dim=64, dtype="float32", remat=False,
    policy=QuantPolicy(mode="qat", w_bits=4, a_bits=8),
)

register("seamless-m4t-large-v2", FULL, SMOKE, STANDARD_SHAPES,
         source="arXiv:2308.11596; hf",
         skip_notes={"long_500k": "full-attention enc-dec; quadratic at 512k "
                                  "— skipped per assignment spec"})
