"""whisper-large-v3 — [audio] enc-dec 32L d_model=1280 20H d_ff=5120 vocab=51866, conv frontend stubbed

Source: arXiv:2212.04356 (unverified tier)
"""

from ..models.config import ModelConfig

FULL = ModelConfig(
    name='whisper-large-v3',
    family='encdec',
    n_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab_size=51866,
    n_encoder_layers=32,
    encoder_len=1500,
    mlp_variant='gelu',
)

SMOKE = ModelConfig(
    name='whisper-large-v3-smoke',
    family='encdec',
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=256,
    n_encoder_layers=2,
    encoder_len=16,
    mlp_variant='gelu',
)
