"""train_step / prefill_step / serve_step: the reference's
``repro.launch.steps``.

``loss_fn`` is next-token cross-entropy plus ``aux_weight`` times the MoE
load-balance loss plus ``z_weight`` times the mean squared log-partition;
the encdec family runs :func:`models.transformer.encode` on the batch's
``frames`` first, and the vlm family's logits are cut to the labels (the
patches carry none).  ``make_train_step`` casts the f32 matrices (leaves
with more than one dimension) to ``cfg.dtype`` for the forward, takes the
gradient with autograd (unrolled accumulation over ``microbatches``),
optionally compresses it (int8 with error feedback), and applies AdamW.

Under a training mesh (``launch.mesh.TrainingMesh`` of more than one rank)
every rank runs the same step on its shards.  ``grad_shardings`` (the
train step's) and ``group_shardings`` (the prefill and serve steps') are
the parameters' placement, ``runtime.sharding.param_shardings`` of the
whole tree, by which the state was placed.  The train step runs the rank's
batch shard (``batch_pspec``), gathers the leaves outside the groups whole
once a step and each group's inside its forward (``runtime.act_sharding``),
and gets back each rank's slice of the gradients summed over the fsdp
ranks; the loss is the mean over the fsdp ranks of their batch shards'
means, which is the mean over the global batch.  The global norm and the
compression scales reduce over the mesh (``optim.adamw``,
``runtime.compression``); the update is elementwise on the shards.  The
MoE load-balance loss and expert capacity are the global batch's, as the
reference's ``jit`` computes them: the policy tells ``models.moe`` that
the batch is split over the fsdp ranks (``act_sharding.data_shards``),
and the MoE layer reduces its statistics over them.  A mesh of one rank
is the mesh-free step.
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Callable

import torch

from ..models import transformer as T
from ..models.config import ModelConfig
from ..optim.adamw import AdamWConfig, adamw_update
from ..runtime.act_sharding import activation_sharding
from ..runtime.compression import compressed_grads
from ..runtime.sharding import NamedSharding, batch_pspec, fsdp_axes, gather_for_compute
from ..tree import tree_leaves, tree_map

__all__ = ["cast_for_compute", "loss_and_grads", "loss_fn", "make_train_step",
           "make_prefill_step", "make_serve_step", "shard_batch"]


def _mesh_of(mesh, shardings, name: str):
    """``mesh``, or None for no mesh or a mesh of one rank (the mesh-free
    step); a mesh of more ranks needs the parameters' placement."""
    if mesh is None or mesh.size == 1:
        return None
    if shardings is None:
        raise ValueError(f"a mesh of {mesh.size} ranks needs {name}: the parameters' "
                         "placement (runtime.sharding.param_shardings of the whole tree)")
    return mesh


class _MeanOverFsdp(torch.autograd.Function):
    """The mean over the fsdp ranks of a per-rank value; each rank's value
    takes 1/n of the gradient (the parameters' gathers then sum the ranks'
    gradients over fsdp)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.n = math.prod(mesh.shape[a] for a in fsdp_axes(mesh))
        return mesh.all_reduce(x.detach().clone(), fsdp_axes(mesh)) / ctx.n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def shard_batch(batch: dict[str, torch.Tensor], mesh) -> dict[str, torch.Tensor]:
    """This rank's rows of a global batch, by ``batch_pspec`` (every rank
    keeps the whole batch where it does not divide over the fsdp ranks)."""
    out = {}
    for k, v in batch.items():
        entry = batch_pspec(mesh, v.shape[0])[0]
        out[k] = NamedSharding(mesh, (entry,) + (None,) * (v.dim() - 1)).place(v)
    return out


def loss_fn(params, cfg: ModelConfig, batch: dict[str, torch.Tensor], mesh=None,
            aux_weight: float = 0.01, z_weight: float = 1e-4):
    """Returns ``(loss, {"ce", "aux"})``.  Under a mesh ``batch`` is this
    rank's shard, the logits are whole on the rank (the reference's
    ``logits_pspec`` puts their batch on fsdp and their vocabulary on
    "model"; the port computes along "model" in full), and each value is
    the mean over the fsdp ranks."""
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
    loss = ce + aux_weight * aux + z_weight * z
    if mesh is not None:
        loss, ce, aux = (_MeanOverFsdp.apply(v, mesh) for v in (loss, ce, aux))
    return loss, {"ce": ce, "aux": aux}


def cast_for_compute(p: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Matrices (f32 leaves with more than one dimension) in the compute
    dtype; 1-D leaves (norms, biases) stay f32."""
    if p.dtype == torch.float32 and p.dim() > 1:
        return p.to(dtype)
    return p


def _splits(mesh, batch: dict[str, torch.Tensor]) -> bool:
    """Whether :func:`shard_batch` splits ``batch`` over the fsdp ranks."""
    return batch_pspec(mesh, batch["tokens"].shape[0])[0] is not None


@contextlib.contextmanager
def _placed(mesh, params, shardings, batch_split: bool = False):
    """``params`` for a forward: as they are without a mesh; under one the
    leaves outside the groups gathered whole, and each group's gathered in
    its forward by the policy installed for the block."""
    if mesh is None:
        yield params
        return
    with activation_sharding(mesh, shardings["groups"][0], batch_split=batch_split):
        yield _gathered(params, shardings, None)


def _gathered(params, shardings, dtype: torch.dtype | None):
    """``params`` with every leaf outside the groups gathered whole (once a
    step) and cast as :func:`cast_for_compute` casts; the groups' leaves
    stay shards, gathered group by group under the policy."""
    if isinstance(params, dict):
        return {k: v if k == "groups" else _gathered(v, shardings[k], dtype)
                for k, v in params.items()}
    return tree_map(lambda t, s: gather_for_compute(t, s, dtype), params, shardings)


def loss_and_grads(params, cfg: ModelConfig, batch: dict[str, torch.Tensor], mesh=None,
                   shardings=None):
    """``(loss, metrics, grads)`` of :func:`loss_fn` at ``params`` (f32),
    the forward on :func:`cast_for_compute`'s copies; ``grads`` mirrors
    ``params`` (zeros for a leaf the loss does not reach).  The leaves are
    marked ``requires_grad``.  Under a mesh (with ``shardings``, the
    placement of ``params``) ``batch`` is the global batch, ``params`` and
    ``grads`` this rank's shards (module docstring)."""
    mesh = _mesh_of(mesh, shardings, "shardings")
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    dtype = T.compute_dtype(cfg)
    if mesh is None:
        loss, metrics = loss_fn(tree_map(lambda p: cast_for_compute(p, dtype), params),
                                cfg, batch)
    else:
        with activation_sharding(mesh, shardings["groups"][0], dtype, _splits(mesh, batch)):
            loss, metrics = loss_fn(_gathered(params, shardings, dtype), cfg,
                                    shard_batch(batch, mesh), mesh)
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
    slices of the batch, one after the other, and averages them.  Under a
    mesh the state holds this rank's shards, placed by ``grad_shardings``
    (the moments and error buffer as the parameters), and every rank
    passes the same global batch (module docstring)."""
    mesh = _mesh_of(mesh, grad_shardings, "grad_shardings")

    def train_step(state: dict, batch: dict[str, torch.Tensor]):
        params = state["params"]
        if microbatches == 1:
            loss, metrics, grads = loss_and_grads(params, cfg, batch, mesh, grad_shardings)
        else:
            losses, grads, metrics = [], None, None
            for i in range(microbatches):  # unrolled accumulation
                mb = {k: v.reshape(microbatches, -1, *v.shape[1:])[i]
                      for k, v in batch.items()}
                loss_i, metrics, g = loss_and_grads(params, cfg, mb, mesh, grad_shardings)
                losses.append(loss_i)
                grads = g if grads is None else tree_map(torch.add, grads, g)
            grads = tree_map(lambda g: g / microbatches, grads)
            loss = sum(losses) / microbatches
        new_state = dict(state)
        if compress_grads:
            grads, new_state["error_buf"] = compressed_grads(grads, state["error_buf"], mesh)
        new_state["params"], new_state["opt"], opt_metrics = adamw_update(
            params, grads, state["opt"], opt_cfg, lr_schedule,
            shardings=None if mesh is None else grad_shardings)
        return new_state, {"loss": loss, **metrics, **opt_metrics}

    return train_step


def make_prefill_step(cfg: ModelConfig, mesh=None, group_shardings=None):
    """Full-sequence forward -> the last position's logits.  Under a mesh
    each rank runs its batch shard (``batch_pspec``) with the weights
    gathered by ``group_shardings`` (the parameters' placement), and the
    logits are gathered whole on every rank."""
    mesh = _mesh_of(mesh, group_shardings, "group_shardings")

    def prefill_step(params, batch):
        kw: dict[str, Any] = {}
        rows = batch["tokens"].shape[0]
        split = mesh is not None and _splits(mesh, batch)
        with _placed(mesh, params, group_shardings, split) as params:
            if mesh is not None:
                batch = shard_batch(batch, mesh)
            if cfg.family == "encdec":
                kw["encoder_out"] = T.encode(params, cfg, batch["frames"])
            if cfg.family == "vlm":
                kw["patch_embeds"] = batch["patches"]
            logits, _, _ = T.forward(params, cfg, batch["tokens"], **kw)
        if mesh is None:
            return logits[:, -1]
        return NamedSharding(mesh, (batch_pspec(mesh, rows)[0], None)).gather(logits[:, -1])

    return prefill_step


def make_serve_step(cfg: ModelConfig, mesh=None, group_shardings=None):
    """One greedy decode step over a KV/state cache: ``serve_step(params,
    cache, batch) -> (next_tokens, new_cache)``.  Under a mesh every rank
    decodes the whole batch on its whole cache with the weights gathered
    by ``group_shardings`` (the parameters' placement)."""
    mesh = _mesh_of(mesh, group_shardings, "group_shardings")

    def serve_step(params, cache, batch):
        kw: dict[str, Any] = {}
        if cfg.family == "encdec":
            kw["encoder_out"] = batch["encoder_out"]
        with _placed(mesh, params, group_shardings) as params:
            logits, new_cache, _ = T.forward(params, cfg, batch["tokens"],
                                             positions=batch["positions"], cache=cache,
                                             **kw)
        return torch.argmax(logits[:, -1], dim=-1).to(torch.int32), new_cache

    return serve_step
