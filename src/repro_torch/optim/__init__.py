"""AdamW and learning-rate schedules of the training path."""

from .adamw import AdamWConfig, adamw_init, adamw_update, clip_by_global_norm
from .schedule import constant, cosine_with_warmup, rsqrt

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "clip_by_global_norm",
           "constant", "cosine_with_warmup", "rsqrt"]
