"""Carry the reference's parameters and plans into the port as plain data.

``params_from_numpy`` takes the reference's float parameter tree, handed
over as a nested dict of numpy arrays, and returns the port's tree: the
stacked ``groups`` axis becomes a per-layer list, every other key stays
where it was (an MoE layer's ``(L, E, d, f)`` expert stacks become
per-layer ``(E, d, f)`` stacks, its router per-layer ``(d, E)``).  ``spec_from_dict`` (the plan database's
``tuning.plans.spec_from_json``) rebuilds a :class:`PackedDotSpec` from
``dataclasses.asdict`` of the reference's spec (its constructor
re-validates), so plan tables cross over without importing the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.config import ModelConfig
from .tuning.plans import spec_from_json as spec_from_dict

__all__ = ["params_from_numpy", "spec_from_dict"]


def _to_torch(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _to_torch(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.ascontiguousarray(tree)).to(device)


def _layer(tree, i: int):
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def params_from_numpy(tree: dict, cfg: ModelConfig,
                      device: str | torch.device = "cpu") -> dict:
    """Reference float params (numpy) -> the port's params on ``device``."""
    out = {}
    for key, sub in tree.items():
        if key == "groups":
            n = next(iter(_leaves(sub))).shape[0]
            if n != cfg.n_layers:
                raise ValueError(
                    f"groups stack {n} layers, config {cfg.name} has "
                    f"{cfg.n_layers}"
                )
            out[key] = [_to_torch(_layer(sub, i), torch.device(device))
                        for i in range(n)]
        else:
            out[key] = _to_torch(sub, torch.device(device))
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree
