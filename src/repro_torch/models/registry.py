"""``--arch`` registry: name -> ModelConfig (full + smoke variants)."""

from __future__ import annotations

from .. import configs as _configs
from .config import ModelConfig

__all__ = ["get_config", "list_archs", "FULL_CONFIGS", "SMOKE_CONFIGS"]

FULL_CONFIGS = {m.FULL.name: m.FULL for m in _configs.ALL.values()}
SMOKE_CONFIGS = {m.FULL.name: m.SMOKE for m in _configs.ALL.values()}


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    table = SMOKE_CONFIGS if smoke else FULL_CONFIGS
    if name not in table:
        raise KeyError(f"unknown arch {name!r}; options: {sorted(table)}")
    return table[name]


def list_archs() -> list[str]:
    return sorted(FULL_CONFIGS)
