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
``params_to_numpy`` is its inverse: every list of the port's tree (the
groups, the inner stacks) is stacked back along a new leading axis, so the
reference's layout and paths come back.  Both directions go through
``tree.to_numpy``/``tree.from_numpy``, as checkpoints do.
``state_to_numpy`` (the same function) and ``state_from_numpy`` carry a
train state ``{"params", "opt": {"m", "v", "step"}, "error_buf"?}``
across both ways (``m``, ``v`` and ``error_buf`` mirror the parameter
tree).
``spec_from_dict`` (the plan database's ``tuning.plans.spec_from_json``)
rebuilds a :class:`PackedDotSpec` from ``dataclasses.asdict`` of the
reference's spec (its constructor re-validates), so plan tables cross over
without importing the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.config import ModelConfig
from .tree import from_numpy, to_numpy, tree_leaves
from .tuning.plans import spec_from_json as spec_from_dict

__all__ = ["params_from_numpy", "params_to_numpy", "spec_from_dict",
           "state_from_numpy", "state_to_numpy"]

# the inner stacks of a group, by family: each becomes a list
INNER_STACKS = {"ssm": ("mlstm",), "hybrid": ("mamba", "moe", "mlp")}


def _layout(tree: dict, cfg: ModelConfig) -> dict:
    """The port's structure of a reference parameter tree (leaves None):
    ``groups`` (and the encoder's) a list of group dicts, a group's inner
    stacks lists; :func:`tree.from_numpy` checks each list's length
    against the stacked axis."""
    def skeleton(sub):
        return {k: skeleton(v) for k, v in sub.items()} if isinstance(sub, dict) else None

    like = skeleton(tree)
    group = like["groups"]
    for key in INNER_STACKS.get(cfg.family, ()):
        # the leaves of an inner stack are (n_groups, n_inner, ...)
        group[key] = [group[key]] * np.shape(tree_leaves(tree["groups"][key])[0])[1]
    like["groups"] = [group] * cfg.n_groups
    if "encoder" in like:
        like["encoder"]["groups"] = [like["encoder"]["groups"]] * cfg.n_encoder_layers
    return like


def _from_numpy(tree: dict, like: dict, device: torch.device) -> dict:
    # a copy: the port's tree owns its memory (the train step updates it in
    # place; a view would write into the caller's arrays, and numpy views
    # of JAX arrays are read-only)
    return from_numpy(tree, like, lambda a, _: torch.tensor(np.asarray(a), device=device))


def params_from_numpy(tree: dict, cfg: ModelConfig,
                      device: str | torch.device = "cpu") -> dict:
    """Reference float params (numpy) -> the port's params on ``device``."""
    return _from_numpy(tree, _layout(tree, cfg), torch.device(device))


def params_to_numpy(tree) -> dict:
    """The port's tree (torch leaves, anywhere) -> the reference's layout as
    numpy arrays (:func:`tree.to_numpy`: each list stacked back along a new
    leading axis); a train state crosses the same way."""
    return to_numpy(tree)


state_to_numpy = params_to_numpy


def state_from_numpy(tree: dict, cfg: ModelConfig,
                     device: str | torch.device = "cpu") -> dict:
    """The reference's train state (numpy) -> the port's on ``device``:
    ``params``, ``opt["m"]``, ``opt["v"]`` and ``error_buf`` in the
    parameters' layout, ``opt["step"]`` a 0-d int32 tensor."""
    dev = torch.device(device)
    like = _layout(tree["params"], cfg)
    opt = tree["opt"]
    out = {
        "params": _from_numpy(tree["params"], like, dev),
        "opt": {"m": _from_numpy(opt["m"], like, dev),
                "v": _from_numpy(opt["v"], like, dev),
                "step": torch.tensor(int(np.asarray(opt["step"])), dtype=torch.int32,
                                     device=dev)},
    }
    if "error_buf" in tree:
        out["error_buf"] = _from_numpy(tree["error_buf"], like, dev)
    return out
