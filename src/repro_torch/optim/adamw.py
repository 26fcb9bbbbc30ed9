"""AdamW over the port's parameter trees (dicts and lists of tensors).

Counterpart of the reference's ``repro.optim.adamw``, with its formula and
order: gradients to f32, clip by the global norm, ``step + 1``, the bias
corrections, ``m``, ``v``, then ``p - lr * (mh / (sqrt(vh) + eps) + wd *
p)``.  ``torch.optim.AdamW`` is not used: it applies the decay before the
moment update and adds ``eps`` after dividing by the bias correction's
square root, which rounds differently, and its state is not the
reference's tree.  The optimizer state mirrors the parameter tree leaf for
leaf: ``{"m", "v", "step"}``, ``m`` and ``v`` in f32, ``step`` a 0-d int32
tensor.

:func:`adamw_update` updates ``params``, ``m`` and ``v`` in place (under
``torch.no_grad``) and returns them: a second f32 copy of the state at
full width would double its memory.  This is the reference CLI's donated
state (``donate_argnums=(0,)``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ..tree import tree_leaves, tree_map

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "clip_by_global_norm"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def adamw_init(params) -> dict[str, Any]:
    """Zero moments in f32 beside each parameter, step 0."""
    def zeros(p):
        return tree_map(lambda x: torch.zeros_like(x, dtype=torch.float32), p)

    dev = tree_leaves(params)[0].device
    return {"m": zeros(params), "v": zeros(params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def clip_by_global_norm(grads, max_norm: float, shardings=None):
    """Scale the gradient tree to a global L2 norm of at most ``max_norm``;
    returns ``(grads, norm before clipping)``.  ``shardings``: the
    ``NamedSharding`` tree of a training mesh whose ranks hold shards of
    ``grads``; each rank then sums the squares of the shards it holds the
    first copy of (a replicated shard counts once) and the sums are
    reduced over the mesh."""
    leaves = tree_leaves(grads)
    if shardings is None:
        sq = sum(torch.sum(torch.square(g.to(torch.float32))) for g in leaves)
    else:
        specs = tree_leaves(shardings)
        sq = torch.zeros((), dtype=torch.float32, device=leaves[0].device) + sum(
            torch.sum(torch.square(g.to(torch.float32)))
            for g, s in zip(leaves, specs) if s.owns())
        mesh = specs[0].mesh
        mesh.all_reduce(sq, mesh.axis_names)
    gnorm = torch.sqrt(sq)
    scale = torch.clamp(max_norm / torch.clamp_min(gnorm, 1e-9), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), gnorm


@torch.no_grad()
def adamw_update(params, grads, state: dict, cfg: AdamWConfig,
                 lr_schedule: Callable[[torch.Tensor], torch.Tensor] | None = None,
                 shardings=None):
    """One AdamW step.  Returns ``(params, state, metrics)``: ``params`` and
    the moments updated in place, ``state["step"]`` a new tensor, metrics
    ``grad_norm`` (before clipping; 0 without clipping) and ``lr``.  Under
    a training mesh the leaves are this rank's shards and ``shardings``
    their placement: the update is elementwise, and only the global norm
    reduces over the ranks (:func:`clip_by_global_norm`)."""
    grads = tree_map(lambda g: g.to(torch.float32), grads)
    dev = state["step"].device
    if cfg.grad_clip:
        grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip, shardings)
    else:
        gnorm = torch.zeros((), dtype=torch.float32, device=dev)
    step = state["step"] + 1
    lr = cfg.lr if lr_schedule is None else lr_schedule(step)
    b1c = 1.0 - cfg.b1 ** step.to(torch.float32)
    b2c = 1.0 - cfg.b2 ** step.to(torch.float32)

    def upd(p, g, m, v):
        m.mul_(cfg.b1).add_(g * (1 - cfg.b1))
        v.mul_(cfg.b2).add_(torch.square(g) * (1 - cfg.b2))
        mh = m / b1c
        vh = v / b2c
        delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p.to(torch.float32)
        p.copy_(p.to(torch.float32) - lr * delta)

    tree_map(upd, params, grads, state["m"], state["v"])  # by key, not order
    lr_t = torch.as_tensor(lr, dtype=torch.float32, device=dev)
    return params, {"m": state["m"], "v": state["v"], "step": step}, {
        "grad_norm": gnorm, "lr": lr_t}
