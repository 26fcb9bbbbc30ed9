"""Mixture-of-Experts FFN (dbrx / moonshot styles).

Counterpart of the reference's ``repro.models.moe``: a softmax router
picks each token's top-k experts, gates renormalized over the k; the
token→expert assignments are sorted stably by expert, and every expert
runs the SwiGLU FFN on the rows routed to it.

* **Dropless serving** (``valid`` given, the engines): every valid
  assignment is kept (the reference's capacity ``T·k``); padding lanes
  route to the virtual expert ``E``, which runs nothing and returns zeros,
  so a token's output is a function of its own hidden state alone.
* **The capacity path** (``valid=None``: the eager forward, the
  sensitivity pass's probes): ``cap = max(1, int(T·k/E·capacity_factor))``
  and an assignment whose rank inside its expert's group of the stable sort
  reaches ``cap`` is dropped, exactly as the reference drops it.

The reference runs every expert on a ``cap``-row buffer, mostly padding
(``T·k`` rows each when dropless).  Rows are independent (activations are
quantized per row), so here each expert runs only the rows routed to it,
and an expert with none is skipped: at most ``T·k`` rows in all, and no
launch for an idle expert.  The per-expert row counts cross to the host
once per MoE layer (:data:`HOST_READS` counts those reads).

Under a training mesh whose fsdp ranks each run a shard of the batch
(``runtime.act_sharding.data_shards``) the capacity path computes what the
reference's ``jit`` computes over the global batch.  ``cap`` takes the
global token count (the rank's ``T`` times the fsdp ranks), and an
assignment keeps its rank in the global stable sort: a shard's rows follow
those of the lower fsdp indices (``batch_pspec`` splits the batch major to
minor over ``fsdp_axes``), so an expert keeps ``clamp(cap - lower, 0,
count)`` of its local assignments, ``lower`` its assignments on the lower
ranks (one all-gather of the ``(E,)`` counts).  ``density`` and
``router_prob`` are the means over the fsdp ranks of the shards' means
(:class:`_MeanOverShards`), and ``aux`` is taken of those global means.

Weights: ``router`` ``{"w": (d, E)}`` stays float; ``up``/``gate``
``(E, d, f)`` and ``down`` ``(E, f, d)``.  A stacked tensor (``native``)
is multiplied per expert in the compute dtype; per-expert leaves
(``core.packed_params.split_expert_stacks``, every quantizing mode) go
through :func:`core.packed_linear.apply_linear`, so each expert serves its
own plan.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..core.packed_linear import LinearSpec, apply_linear
from ..runtime.act_sharding import data_shards
from ..runtime.sharding import fsdp_axes
from .config import ModelConfig
from .layers import Params

__all__ = ["init_moe", "moe_ffn", "HOST_READS"]

# device-to-host reads of the per-expert row counts (one per MoE layer call)
HOST_READS = {"count": 0}


def init_moe(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype,
             device: torch.device) -> Params:
    """Router and expert stacks with the reference's scales (N(0, 1/d_in))."""
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff

    def normal(*shape):
        w = torch.randn(shape, generator=gen, dtype=dtype, device=device)
        return w.mul_(shape[-2] ** -0.5)

    return {
        "router": {"w": normal(d, e)},
        "up": normal(e, d, f),
        "gate": normal(e, d, f),
        "down": normal(e, f, d),
    }


class _MeanOverShards(torch.autograd.Function):
    """The mean over the fsdp ranks of each rank's ``x``: the global
    batch's mean, the shards being of equal size.  Every rank then computes
    the same function of it, and the loss is the mean over the ranks, so
    each rank holds a part of the mean's gradient: the backward sums the
    parts and hands each rank 1/n of the sum."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.n = mesh, math.prod(mesh.shape[a] for a in fsdp_axes(mesh))
        return mesh.all_reduce(x.detach().clone(), fsdp_axes(mesh)) / ctx.n

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g.clone(), fsdp_axes(ctx.mesh)) / ctx.n, None


def _lower_counts(mesh, counts: torch.Tensor) -> torch.Tensor:
    """Each expert's assignments on the fsdp ranks below this one (major to
    minor over ``fsdp_axes``), from one all-gather of the ``(E,)`` counts."""
    axes = fsdp_axes(mesh)
    every = mesh.all_gather(counts[None], axes, 0)
    idx = 0
    for a in axes:
        idx = idx * mesh.shape[a] + mesh.coord[a]
    return every[:idx].sum(dim=0)


def _dispatch(flat_e: torch.Tensor, e: int, cap: int, mesh) -> tuple:
    """Sort-based dispatch: ``(order, starts, kept)``, the stable sort of
    the assignments by expert (sorted rank -> token·k + choice), and each
    expert's first entry in it and the number of its entries it keeps
    (module docstring)."""
    order = torch.argsort(flat_e, stable=True)
    counts = torch.bincount(flat_e, minlength=e + 1)[:e]
    first = torch.cumsum(counts, 0) - counts
    kept = (counts.clamp(max=cap) if mesh is None
            else torch.minimum(counts, (cap - _lower_counts(mesh, counts)).clamp(min=0)))
    starts, kept = torch.stack([first, kept]).tolist()
    HOST_READS["count"] += 1
    return order, starts, kept


def _expert(params: Params, i: int, rows: torch.Tensor,
            spec: LinearSpec) -> torch.Tensor:
    """Expert ``i``'s SwiGLU on its rows, in the compute dtype."""
    up_w, gate_w, down_w = params["up"], params["gate"], params["down"]
    if isinstance(up_w, dict):
        key = f"e{i}"
        u = apply_linear({"w": up_w[key]}, rows, spec)
        g = apply_linear({"w": gate_w[key]}, rows, spec)
        return apply_linear({"w": down_w[key]}, F.silu(g) * u, spec)
    dt = rows.dtype  # float stacks (native): the stack is never quantized
    u = rows @ up_w[i].to(dt)
    g = rows @ gate_w[i].to(dt)
    return (F.silu(g) * u) @ down_w[i].to(dt)


def moe_ffn(params: Params, x: torch.Tensor, cfg: ModelConfig,
            spec: LinearSpec | None = None,
            valid: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(output, aux_load_balancing_loss)``; ``valid`` (B, S) bool
    selects dropless serving (module docstring)."""
    spec = spec if spec is not None else LinearSpec()
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.experts_per_token
    mesh = data_shards() if valid is None else None
    n_shards = 1 if mesh is None else math.prod(mesh.shape[a] for a in fsdp_axes(mesh))
    cap = (t * k if valid is not None
           else int(max(1, (t * n_shards * k / e) * cfg.capacity_factor)))
    xt = x.reshape(t, d)

    logits = xt.to(torch.float32) @ params["router"]["w"].to(torch.float32)
    probs = torch.softmax(logits, dim=-1)  # (T, E)
    gate_vals, expert_idx = torch.topk(probs, k, dim=-1)  # (T, k)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)
    if valid is not None:
        # the virtual expert e: sorted after every real assignment, never run
        expert_idx = torch.where(valid.reshape(t)[:, None], expert_idx, e)

    order, starts, kept = _dispatch(expert_idx.reshape(t * k), e, cap, mesh)

    # ---- expert compute: each expert on the rows routed to it
    per_choice = x.new_zeros((t * k, d))
    for i in range(e):
        if kept[i] == 0:
            continue
        choice = order[starts[i]:starts[i] + kept[i]]
        rows = xt.index_select(0, torch.div(choice, k, rounding_mode="floor"))
        per_choice.index_copy_(0, choice, _expert(params, i, rows, spec).to(x.dtype))

    # ---- combine: gate-weighted sum over each token's k choices
    weighted = per_choice.reshape(t, k, d) * gate_vals[..., None].to(x.dtype)
    out = weighted.sum(dim=1).reshape(b, s, d)

    # Switch-style load-balance aux loss (the virtual expert counts nowhere)
    onehot = F.one_hot(expert_idx, e + 1)[..., :e].to(torch.float32)
    density = onehot.sum(dim=1).mean(dim=0)  # (E,)
    router_prob = probs.mean(dim=0)
    if mesh is not None:  # the global batch's means
        density = _MeanOverShards.apply(density, mesh)
        router_prob = _MeanOverShards.apply(router_prob, mesh)
    aux = e * torch.sum(density * router_prob) / k
    return out, aux
