"""Activation sharding policy (opt-in, mesh-aware, model-agnostic).

Counterpart of the reference's ``repro.runtime.act_sharding``.
``activation_sharding(mesh)`` installs a thread-local policy;
``constrain(x, kind)`` and ``constrain_group_params(gp)`` are no-ops
without one, so the model code stays mesh-free.  :func:`spec_for` gives
the reference's spec of each kind: ``residual`` (B, S, D) batch over fsdp;
``hidden`` (B, S, F) and ``heads`` (B, S, H, hd) also the feature or head
dim over "model"; ``expert`` (E, C, D) experts over "model";
``scores_decode`` (B, H, q, S) the key axis over "model".

How the port realises the policy.  The reference hands its specs to XLA,
which partitions every op.  The port runs SPMD over ``torch.distributed``
ranks and keeps the state in the reference's placement
(``runtime.sharding.param_shardings``), but computes along "model" in
full: each rank runs its batch shard (``batch_pspec``: the batch over the
fsdp axes) with the whole weights.  So the ``residual`` layout, the batch
over fsdp, is what the data-parallel split already is, and
:func:`constrain` returns ``x`` under a policy too; the kinds that put a
feature dim on "model" (shard-local matmuls with a reduction,
Megatron-style) are not realised for training (ROADMAP §2).

FSDP is realised at :func:`constrain_group_params`, the reference's
per-group re-pin of the scan body: under a policy with ``group_shardings``
(one group's tree of ``NamedSharding``) it gathers the group's whole
weights from the ranks' shards (``sharding.gather_for_compute``), cast to
the policy's compute dtype; the backward hands each rank its slice of the
gradient, summed over the fsdp ranks.  Inside a group's activation
checkpoint (``cfg.remat``) the gather runs again in the backward, so only
one group's whole weights are live at a time.  An encoder group
(whisper) takes the decoder group's entries under its own keys, which
carry the same specs.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Callable

import torch

from ..tree import tree_map
from .sharding import fsdp_axes, gather_for_compute

__all__ = ["activation_sharding", "checkpoint_contexts", "constrain",
           "constrain_group_params", "data_shards"]

_STATE = threading.local()


@dataclasses.dataclass(frozen=True)
class _Policy:
    """What :func:`activation_sharding` installs (its docstring)."""

    mesh: object
    spec_for: Callable
    group_shardings: object
    compute_dtype: torch.dtype | None
    batch_split: bool


def _policy():
    return getattr(_STATE, "policy", None)


@contextlib.contextmanager
def activation_sharding(mesh, group_shardings=None,
                        compute_dtype: torch.dtype | None = None,
                        batch_split: bool = False):
    """Install the policy of ``mesh`` for the block.  ``group_shardings``:
    the ``NamedSharding`` tree of ONE group of ``params["groups"]``; when
    set, :func:`constrain_group_params` gathers each group's weights by it
    (cast to ``compute_dtype``, where given, as ``launch.steps`` casts).
    ``batch_split``: each fsdp rank runs its shard of the batch
    (``batch_pspec``), so :func:`data_shards` names the mesh."""
    fsdp = fsdp_axes(mesh)
    fs = fsdp if len(fsdp) > 1 else fsdp[0]
    n_fsdp = 1
    for a in fsdp:
        n_fsdp *= mesh.shape[a]
    n_model = mesh.shape["model"]

    def spec_for(kind: str, shape: tuple[int, ...]) -> tuple | None:
        batch = fs if shape[0] % n_fsdp == 0 else None
        if kind == "residual":
            return (batch,) + (None,) * (len(shape) - 1)
        if kind == "hidden":
            feat = "model" if shape[-1] % n_model == 0 else None
            return (batch,) + (None,) * (len(shape) - 2) + (feat,)
        if kind == "heads":  # (B, S, H, hd): heads on model, or batch only
            if shape[1] > 1 and shape[2] % n_model == 0:
                return (batch, None, "model", None)
            return (batch, None, None, None)
        if kind == "expert":  # (E, C, D)
            return ("model" if shape[0] % n_model == 0 else None, None, None)
        if kind == "scores_decode":  # (B, H, q, S): the key axis on model
            return (batch, None, None, "model" if shape[-1] % n_model == 0 else None)
        return None

    with _installed(_Policy(mesh, spec_for, group_shardings, compute_dtype, batch_split)):
        yield


@contextlib.contextmanager
def _installed(policy):
    prev = _policy()
    _STATE.policy = policy
    try:
        yield
    finally:
        _STATE.policy = prev


def checkpoint_contexts():
    """``context_fn`` of ``torch.utils.checkpoint``: the recomputation in
    the backward (which may run on autograd's own thread) under the policy
    of the forward."""
    return contextlib.nullcontext(), _installed(_policy())


def constrain(x: torch.Tensor, kind: str) -> torch.Tensor:
    """``x``: the layout the data-parallel split realises (module
    docstring), with or without a policy."""
    return x


def constrain_group_params(gp):
    """A group's weights whole, gathered from the ranks' shards by the
    policy's ``group_shardings`` (``gp`` itself without them)."""
    pol = _policy()
    if pol is None or pol.group_shardings is None:
        return gp
    return tree_map(lambda t, s: gather_for_compute(t, s, pol.compute_dtype), gp,
                    pol.group_shardings)


def data_shards():
    """The mesh whose fsdp ranks each run a shard of the batch under the
    installed policy, or None (no policy, or every rank runs the whole
    batch).  What the reference computes over the global batch, a MoE
    layer's capacity and load-balance statistics (``models.moe``), reduces
    over those ranks."""
    pol = _policy()
    return pol.mesh if pol is not None and pol.batch_split else None
