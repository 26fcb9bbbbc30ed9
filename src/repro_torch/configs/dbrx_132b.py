"""dbrx-132b — [moe] 40L d_model=6144 48H (GQA kv=8) d_ff=10752 vocab=100352, MoE 16e top-4 fine-grained

Source: hf:databricks/dbrx-base (unverified tier)
"""

from ..models.config import ModelConfig

FULL = ModelConfig(
    name='dbrx-132b',
    family='moe',
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10752,
    vocab_size=100352,
    n_experts=16,
    experts_per_token=4,
    rope_theta=500000.0,
)

SMOKE = ModelConfig(
    name='dbrx-132b-smoke',
    family='moe',
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    n_experts=4,
    experts_per_token=2,
)
