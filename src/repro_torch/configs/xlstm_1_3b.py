"""xlstm-1.3b — [ssm] 48L d_model=2048 4H d_ff=0 vocab=50304, sLSTM + mLSTM blocks (1:7)

Source: arXiv:2405.04517 (unverified tier)
"""

from ..models.config import ModelConfig

FULL = ModelConfig(
    name='xlstm-1.3b',
    family='ssm',
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    slstm_every=8,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name='xlstm-1.3b-smoke',
    family='ssm',
    n_layers=4,
    d_model=64,
    n_heads=2,
    n_kv_heads=2,
    d_ff=0,
    vocab_size=256,
    slstm_every=4,
    tie_embeddings=True,
)
