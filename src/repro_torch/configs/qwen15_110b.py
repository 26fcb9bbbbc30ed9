"""qwen1.5-110b — [dense] 80L d_model=8192 64H (GQA kv=8) d_ff=49152 vocab=152064, QKV bias

Source: hf:Qwen/Qwen1.5-110B (scaled family config per assignment; hf tier)
"""

from ..models.config import ModelConfig

FULL = ModelConfig(
    name='qwen1.5-110b',
    family='dense',
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=49152,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1000000.0,
)

SMOKE = ModelConfig(
    name='qwen1.5-110b-smoke',
    family='dense',
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    qkv_bias=True,
)
