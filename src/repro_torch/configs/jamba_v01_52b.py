"""jamba-v0.1-52b — [hybrid] 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536, Mamba+attn 1:7, MoE 16e top-2

Source: arXiv:2403.19887 (hf tier)
"""

from ..models.config import ModelConfig

FULL = ModelConfig(
    name='jamba-v0.1-52b',
    family='hybrid',
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    n_experts=16,
    experts_per_token=2,
    attn_every=8,
    mamba_d_state=16,
    mamba_d_conv=4,
    mamba_expand=2,
)

SMOKE = ModelConfig(
    name='jamba-v0.1-52b-smoke',
    family='hybrid',
    n_layers=8,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    n_experts=4,
    experts_per_token=2,
    attn_every=8,
)
