"""Carry the reference's parameters and plans into the port as plain data.

``params_from_numpy`` takes the reference's float parameter tree, handed
over as a nested dict of numpy arrays, and returns the port's tree: the
stacked ``groups`` axis becomes a list of ``n_groups`` group dicts, and
inside a group the reference's inner stacks (ssm: ``mlstm``; hybrid:
``mamba``, ``moe``, ``mlp``) become lists too; the per-slot norm scales
(``ln_m``, ``ln_mix``, ``ln_ffn``) stay (g, d) tensors.  The encoder's
``groups`` (encdec) are split the same way; every other key stays where
it was (an MoE layer's ``(L, E, d, f)`` expert stacks become per-layer
``(E, d, f)`` stacks, its router per-layer ``(d, E)``).
``spec_from_dict`` (the plan database's ``tuning.plans.spec_from_json``)
rebuilds a :class:`PackedDotSpec` from ``dataclasses.asdict`` of the
reference's spec (its constructor re-validates), so plan tables cross over
without importing the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.config import ModelConfig
from .tuning.plans import spec_from_json as spec_from_dict

__all__ = ["params_from_numpy", "spec_from_dict"]

# the inner stacks of a group, by family: each becomes a list
INNER_STACKS = {"ssm": ("mlstm",), "hybrid": ("mamba", "moe", "mlp")}


def _to_torch(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_torch(v, device) for v in tree]
    return torch.from_numpy(np.ascontiguousarray(tree)).to(device)


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _unstack(tree, inner: tuple[str, ...], name: str, want: int,
             device: torch.device) -> list:
    """A stacked groups tree -> the list of its groups (inner stacks split)."""
    n = _stack_len(tree)
    if n != want:
        raise ValueError(f"{name} stack {n} groups, the config has {want}")
    out = []
    for i in range(n):
        group = _index(tree, i)
        for key in inner:
            group[key] = [_index(group[key], j) for j in range(_stack_len(group[key]))]
        out.append(_to_torch(group, device))
    return out


def params_from_numpy(tree: dict, cfg: ModelConfig,
                      device: str | torch.device = "cpu") -> dict:
    """Reference float params (numpy) -> the port's params on ``device``."""
    dev = torch.device(device)
    inner = INNER_STACKS.get(cfg.family, ())
    out = {}
    for key, sub in tree.items():
        if key == "groups":
            out[key] = _unstack(sub, inner, "groups", cfg.n_groups, dev)
        elif key == "encoder":
            out[key] = {
                "groups": _unstack(sub["groups"], (), "encoder groups",
                                   cfg.n_encoder_layers, dev),
                **{k: _to_torch(v, dev) for k, v in sub.items() if k != "groups"},
            }
        else:
            out[key] = _to_torch(sub, dev)
    return out


def _stack_len(tree) -> int:
    """The leading (stacked) axis of a tree's leaves."""
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree.shape[0]
