"""starcoder2-7b — [dense] 32L d_model=4608 36H (GQA kv=4) d_ff=18432 vocab=49152, GQA+RoPE

Source: arXiv:2402.19173 (hf tier)
"""

from ..models.config import ModelConfig

FULL = ModelConfig(
    name='starcoder2-7b',
    family='dense',
    n_layers=32,
    d_model=4608,
    n_heads=36,
    n_kv_heads=4,
    d_ff=18432,
    vocab_size=49152,
    mlp_variant='gelu',
    rope_theta=1000000.0,
    qkv_bias=True,
)

SMOKE = ModelConfig(
    name='starcoder2-7b-smoke',
    family='dense',
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    mlp_variant='gelu',
)
