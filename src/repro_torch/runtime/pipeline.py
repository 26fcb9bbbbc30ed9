"""GPipe pipeline parallelism over the "pod" mesh axis.

Counterpart of the reference's ``repro.runtime.pipeline`` (forward only,
as the reference's).  :func:`split_stages` cuts ``params["groups"]`` into
``n_stages`` contiguous runs (a list slice: the port keeps the groups as a
list); stage ``s`` is the ranks at coordinate ``s`` of the axis, each
holding its stage's groups and the replicated embedding, final norm and
lm_head.  :func:`pipeline_forward` streams the microbatches through the
GPipe schedule: ``n_micro + n_stages - 1`` ticks, stage ``s`` running
microbatch ``t - s`` at tick ``t`` (only the ticks where that microbatch
exists), stage 0 embedding it.  A stage's output hops to the next stage by
one broadcast in the two-rank group of that boundary (one such group for
each coordinate of the other axes: the ranks of one pod compute the same
microbatches, as the reference's ``shard_map`` replicates them).  The
broadcast is the one path for every backend: gloo, which the ranks that
share a card run, takes CUDA tensors for a broadcast but not for
point-to-point sends.  The last stage collects the activations, which
then reach every rank of the axis by one broadcast (the reference's
``psum`` of the last stage's buffer); the epilogue (final norm, then
logits in f32 against ``lm_head`` or the tied embedding) is replicated.
"""

from __future__ import annotations

import itertools

import torch

from ..models import transformer as T
from ..models.config import ModelConfig
from ..models.layers import rmsnorm

__all__ = ["split_stages", "pipeline_forward"]


def split_stages(params, n_stages: int):
    """``params`` with ``groups`` cut into ``n_stages`` lists of
    ``n_groups / n_stages`` consecutive groups (the leaves are shared)."""
    groups = params["groups"]
    g = len(groups)
    if g % n_stages:
        raise ValueError(f"{g} groups do not split into {n_stages} stages")
    k = g // n_stages
    out = dict(params)
    out["groups"] = [groups[s * k:(s + 1) * k] for s in range(n_stages)]
    return out


def pipeline_forward(params, cfg: ModelConfig, tokens: torch.Tensor, mesh,
                     axis: str = "pod") -> torch.Tensor:
    """Pipelined forward over ``axis`` of ``mesh`` (a ``TrainingMesh``):
    ``tokens`` (n_micro, mb, S), the same on every rank -> logits
    (n_micro, mb, S, V) in f32 on every rank.  ``params`` is stage-split
    (:func:`split_stages`); a rank reads only its own stage's groups."""
    n_stages = mesh.shape[axis]
    n_micro, mb, s = tokens.shape
    sid = mesh.coord[axis]
    if len(params["groups"]) != n_stages:
        raise ValueError(f"params split into {len(params['groups'])} stages, the "
                         f"{axis!r} axis has {n_stages}")
    stage = params["groups"][sid]
    embed = params["embed"]["w"]
    dtype = T.compute_dtype(cfg)
    positions = torch.arange(s, device=embed.device)[None].expand(mb, s)

    # the boundary groups: (stage b, stage b + 1) at every coordinate of the
    # other axes, made by every rank in the same order
    others = [a for a in mesh.axis_names if a != axis]
    here = {a: mesh.coord[a] for a in others}
    pairs, mine = [], {}
    for b in range(n_stages - 1):
        for fixed in itertools.product(*(range(mesh.shape[a]) for a in others)):
            coord = dict(zip(others, fixed))
            pairs.append([mesh.rank_of({**coord, axis: b}),
                          mesh.rank_of({**coord, axis: b + 1})])
            if coord == here:
                mine[b] = len(pairs) - 1
    groups = mesh.subgroups(pairs) if pairs else []

    def src(stage_id: int) -> int:
        return mesh.rank_of({**here, axis: stage_id})

    buf = y = None
    outputs = torch.empty((n_micro, mb, s, cfg.d_model), dtype=dtype, device=embed.device)
    for t in range(n_micro + n_stages - 1):
        m = t - sid
        if 0 <= m < n_micro:
            x = embed[tokens[m]].to(dtype) if sid == 0 else buf
            for gp in stage:
                x, _, _ = T._run_group(gp, x, cfg, positions, None, None)
            y = x.contiguous()
            if sid == n_stages - 1:
                outputs[m] = y
        # boundary hops in boundary order (a stage receives from b - 1
        # before it sends to b + 1, so no rank waits on a later boundary)
        for b in range(n_stages - 1):
            if not 0 <= t - b < n_micro or sid not in (b, b + 1):
                continue
            if sid == b:
                mesh.broadcast(y, src(b), groups[mine[b]])
            else:
                buf = torch.empty((mb, s, cfg.d_model), dtype=dtype, device=embed.device)
                mesh.broadcast(buf, src(b), groups[mine[b]])
    pod = mesh.group((axis,))
    if pod is not None:
        mesh.broadcast(outputs, src(n_stages - 1), pod[0])

    # the replicated epilogue, a microbatch at a time (the sequential
    # forward's shapes): final norm, logits in f32
    lm_head = params.get("lm_head")
    w = (embed.T if cfg.tie_embeddings or lm_head is None else lm_head["w"]).to(torch.float32)
    return torch.stack([rmsnorm(params["final_norm"], o, cfg.norm_eps).to(torch.float32) @ w
                        for o in outputs])
