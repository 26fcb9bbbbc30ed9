"""ModelConfig: one dataclass describes every architecture family.

The port's own copy of the reference's ``repro.models.config.ModelConfig``
(plain data, field for field, with the derived ``hd``, ``group_size`` and
``n_groups``).  The port builds every family of the registry.
"""

from __future__ import annotations

import dataclasses

from ..core.packed_linear import LinearSpec

__all__ = ["ModelConfig"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    sliding_window: int | None = None
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    mlp_variant: str = "swiglu"  # swiglu (3-matrix) | gelu (2-matrix)

    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25

    # hybrid (jamba)
    attn_every: int = 0
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2

    # xlstm
    slstm_every: int = 0

    # encoder-decoder (whisper)
    n_encoder_layers: int = 0
    encoder_len: int = 1500

    # vlm (llava)
    n_patches: int = 0

    # compilation / memory policy of the reference (scan_layers and remat
    # kept as data); attention_chunk > 0 runs causal attention without a
    # cache as online softmax over key chunks (layers.attention)
    scan_layers: bool = True
    remat: str = "dots"
    attention_chunk: int = 0
    dtype: str = "bfloat16"
    quant: LinearSpec = LinearSpec()

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def group_size(self) -> int:
        """Layers per group (one structure repeated ``n_groups`` times)."""
        if self.family == "hybrid" and self.attn_every:
            return self.attn_every
        if self.family == "ssm" and self.slstm_every:
            return self.slstm_every
        return 1

    @property
    def n_groups(self) -> int:
        if self.n_layers % self.group_size:
            raise ValueError(f"{self.name}: n_layers {self.n_layers} is not a "
                             f"multiple of the group size {self.group_size}")
        return self.n_layers // self.group_size
