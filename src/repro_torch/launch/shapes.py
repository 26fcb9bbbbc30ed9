"""The assigned input-shape sets and each cell's inputs, on the meta device.

Counterpart of the reference's ``repro.launch.shapes``.  Four shapes per
LM arch (40 cells in all):

  train_4k     seq 4 096 × global_batch 256   → train_step
  prefill_32k  seq 32 768 × global_batch 32   → prefill_step
  decode_32k   KV depth 32 768 × batch 128    → serve_step
  long_500k    KV depth 524 288 × batch 1     → serve_step (sub-quadratic only)

:func:`supported` is the reference's skip table: ``long_500k`` needs a
sub-quadratic decode path (a sliding window's ring, SSM state, or the
hybrid), so pure full-attention archs skip it.  The reference's
``ShapeDtypeStruct`` stand-ins are tensors on ``device="meta"`` here:
shapes and dtypes without storage (int32 tokens, bf16 frames and
patches, as the reference's).
"""

from __future__ import annotations

import dataclasses

import torch

from ..models import transformer as T
from ..models.config import ModelConfig

__all__ = ["SHAPES", "ShapeSpec", "input_specs", "supported", "cache_specs"]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def supported(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    if shape.name == "long_500k":
        sub_quadratic = (
            cfg.family in ("ssm", "hybrid") or cfg.sliding_window is not None
        )
        if not sub_quadratic:
            return False, (
                "pure full-attention arch: 500k decode needs sub-quadratic "
                "attention (skip noted in DESIGN.md §5)"
            )
    return True, ""


def _meta(shape: tuple[int, ...], dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict[str, torch.Tensor]:
    """Meta-tensor stand-ins for every model input of this cell."""
    b, s = shape.global_batch, shape.seq_len
    i32, bf16 = torch.int32, torch.bfloat16
    if shape.kind == "train":
        batch = {"tokens": _meta((b, s), i32), "labels": _meta((b, s), i32)}
        if cfg.family == "encdec":
            batch["frames"] = _meta((b, cfg.encoder_len, cfg.d_model), bf16)
        if cfg.family == "vlm":
            batch = {
                "tokens": _meta((b, s - cfg.n_patches), i32),
                "labels": _meta((b, s - cfg.n_patches), i32),
                "patches": _meta((b, cfg.n_patches, cfg.d_model), bf16),
            }
        return batch
    if shape.kind == "prefill":
        batch = {"tokens": _meta((b, s), i32)}
        if cfg.family == "encdec":
            batch["frames"] = _meta((b, cfg.encoder_len, cfg.d_model), bf16)
        if cfg.family == "vlm":
            batch = {
                "tokens": _meta((b, s - cfg.n_patches), i32),
                "patches": _meta((b, cfg.n_patches, cfg.d_model), bf16),
            }
        return batch
    # decode: one new token against a cache of depth s
    batch = {"tokens": _meta((b, 1), i32), "positions": _meta((b, 1), i32)}
    if cfg.family == "encdec":
        batch["encoder_out"] = _meta((b, cfg.encoder_len, cfg.d_model), bf16)
    return batch


def cache_specs(cfg: ModelConfig, shape: ShapeSpec) -> list:
    """The decode cache of this cell on the meta device (the port's layout:
    a list of group dicts, the batch axis first in every leaf)."""
    return T.init_cache(cfg, shape.global_batch, shape.seq_len, device="meta")
