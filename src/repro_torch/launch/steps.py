"""train_step / prefill_step / serve_step: the reference's
``repro.launch.steps`` on one device.

``loss_fn`` is next-token cross-entropy plus ``aux_weight`` times the MoE
load-balance loss plus ``z_weight`` times the mean squared log-partition;
the encdec family runs :func:`models.transformer.encode` on the batch's
``frames`` first, and the vlm family's logits are cut to the labels (the
patches carry none).  ``make_train_step`` casts the f32 matrices (leaves
with more than one dimension) to ``cfg.dtype`` for the forward, takes the
gradient with autograd (unrolled accumulation over ``microbatches``),
optionally compresses it (int8 with error feedback), and applies AdamW.
The reference's mesh arguments (activation and gradient sharding
constraints) wait for ROADMAP queue 10: only ``mesh=None`` is taken.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from ..models import transformer as T
from ..models.config import ModelConfig
from ..optim.adamw import AdamWConfig, adamw_update
from ..runtime.compression import compressed_grads
from ..tree import tree_leaves, tree_map

__all__ = ["cast_for_compute", "loss_and_grads", "loss_fn", "make_train_step",
           "make_prefill_step", "make_serve_step"]


def _no_mesh(mesh, grad_shardings=None) -> None:
    if mesh is not None or grad_shardings is not None:
        raise NotImplementedError(
            "mesh and sharding arguments are not ported yet: ROADMAP queue 10 "
            "(tensor parallelism); pass mesh=None"
        )


def loss_fn(params, cfg: ModelConfig, batch: dict[str, torch.Tensor], mesh=None,
            aux_weight: float = 0.01, z_weight: float = 1e-4):
    """Returns ``(loss, {"ce", "aux"})``."""
    _no_mesh(mesh)
    kw: dict[str, Any] = {}
    if cfg.family == "encdec":
        kw["encoder_out"] = T.encode(params, cfg, batch["frames"])
    if cfg.family == "vlm":
        kw["patch_embeds"] = batch["patches"]
    logits, _, aux = T.forward(params, cfg, batch["tokens"], **kw)
    labels = batch["labels"].long()
    if cfg.family == "vlm":  # patches carry no labels
        logits = logits[:, -labels.shape[1]:]
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    ce = torch.mean(lse - gold)
    z = torch.mean(torch.square(lse))
    return ce + aux_weight * aux + z_weight * z, {"ce": ce, "aux": aux}


def cast_for_compute(p: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Matrices (f32 leaves with more than one dimension) in the compute
    dtype; 1-D leaves (norms, biases) stay f32."""
    if p.dtype == torch.float32 and p.dim() > 1:
        return p.to(dtype)
    return p


def loss_and_grads(params, cfg: ModelConfig, batch: dict[str, torch.Tensor]):
    """``(loss, metrics, grads)`` of :func:`loss_fn` at ``params`` (f32),
    the forward on :func:`cast_for_compute`'s copies; ``grads`` mirrors
    ``params`` (zeros for a leaf the loss does not reach).  The leaves are
    marked ``requires_grad``."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    dtype = T.compute_dtype(cfg)
    loss, metrics = loss_fn(tree_map(lambda p: cast_for_compute(p, dtype), params),
                            cfg, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    it = (torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads))
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_map(lambda _: next(it), params))


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, mesh=None,
                    lr_schedule: Callable | None = None, compress_grads: bool = False,
                    grad_shardings=None, microbatches: int = 1):
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    ``state = {"params", "opt", ("error_buf")}`` with f32 parameters; the
    parameters, moments and error buffer are updated in place (the
    reference's CLI donates its state) and the state is returned.  Metrics:
    ``loss``, ``ce``, ``aux``, ``grad_norm`` and ``lr``, 0-d tensors on the
    parameters' device (reading them waits for the step).
    ``microbatches > 1`` accumulates the gradients of that many equal
    slices of the batch, one after the other, and averages them."""
    _no_mesh(mesh, grad_shardings)

    def train_step(state: dict, batch: dict[str, torch.Tensor]):
        params = state["params"]
        if microbatches == 1:
            loss, metrics, grads = loss_and_grads(params, cfg, batch)
        else:
            losses, grads, metrics = [], None, None
            for i in range(microbatches):  # unrolled accumulation
                mb = {k: v.reshape(microbatches, -1, *v.shape[1:])[i]
                      for k, v in batch.items()}
                loss_i, metrics, g = loss_and_grads(params, cfg, mb)
                losses.append(loss_i)
                grads = g if grads is None else tree_map(torch.add, grads, g)
            grads = tree_map(lambda g: g / microbatches, grads)
            loss = sum(losses) / microbatches
        new_state = dict(state)
        if compress_grads:
            grads, new_state["error_buf"] = compressed_grads(grads, state["error_buf"])
        new_state["params"], new_state["opt"], opt_metrics = adamw_update(
            params, grads, state["opt"], opt_cfg, lr_schedule)
        return new_state, {"loss": loss, **metrics, **opt_metrics}

    return train_step


def make_prefill_step(cfg: ModelConfig, mesh=None, group_shardings=None):
    """Full-sequence forward -> the last position's logits."""
    _no_mesh(mesh, group_shardings)

    def prefill_step(params, batch):
        kw: dict[str, Any] = {}
        if cfg.family == "encdec":
            kw["encoder_out"] = T.encode(params, cfg, batch["frames"])
        if cfg.family == "vlm":
            kw["patch_embeds"] = batch["patches"]
        logits, _, _ = T.forward(params, cfg, batch["tokens"], **kw)
        return logits[:, -1]

    return prefill_step


def make_serve_step(cfg: ModelConfig, mesh=None, group_shardings=None):
    """One greedy decode step over a KV/state cache: ``serve_step(params,
    cache, batch) -> (next_tokens, new_cache)``."""
    _no_mesh(mesh, group_shardings)

    def serve_step(params, cache, batch):
        kw: dict[str, Any] = {}
        if cfg.family == "encdec":
            kw["encoder_out"] = batch["encoder_out"]
        logits, new_cache, _ = T.forward(params, cfg, batch["tokens"],
                                         positions=batch["positions"], cache=cache, **kw)
        return torch.argmax(logits[:, -1], dim=-1).to(torch.int32), new_cache

    return serve_step
