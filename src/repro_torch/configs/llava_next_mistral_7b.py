"""llava-next-mistral-7b — [vlm] 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000, anyres patch stub

Source: hf:llava-hf/llava-v1.6-mistral-7b-hf (unverified tier)
"""

from ..models.config import ModelConfig

FULL = ModelConfig(
    name='llava-next-mistral-7b',
    family='vlm',
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    n_patches=2880,
    rope_theta=1000000.0,
    sliding_window=None,
)

SMOKE = ModelConfig(
    name='llava-next-mistral-7b-smoke',
    family='vlm',
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    n_patches=8,
)
