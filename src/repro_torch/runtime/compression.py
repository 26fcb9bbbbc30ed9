"""Gradient compression: int8 with error feedback.

The port's copy of the reference's ``repro.runtime.compression``: each
gradient leaf, plus its carried residual, is quantized to int8 by its
absmax (``scale = max(amax, 1e-12) / 127``) and dequantized; the
quantization error is carried to the next step in an f32 error-feedback
buffer, so compression does not bias convergence.  The absmax is the
reference leaf's: the port's list elements (groups, inner stacks), which
the reference stacks into one leaf, share one scale.  Under a training
mesh each rank holds shards of the gradients and the error buffer; the
absmax is reduced (max) over the ranks, so every shard takes the scale
of the whole leaf, and the transform is otherwise elementwise.
"""

from __future__ import annotations

import torch

from ..tree import keyed_leaves, tree_map

__all__ = ["init_error_feedback", "compressed_grads"]


def init_error_feedback(params):
    """Zero f32 residuals beside each parameter."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                    params)


def compressed_grads(grads, error_buf, mesh=None):
    """int8-compress each gradient leaf with error feedback.  Returns
    ``(compressed grads, new error buffer)``; the compressed values are
    exactly ``int8 * scale``.  ``mesh``: the training mesh whose ranks
    hold shards of ``grads`` and ``error_buf`` (None: whole leaves)."""
    g32 = tree_map(lambda g, e: g.to(torch.float32) + e, grads, error_buf)
    keyed = list(keyed_leaves(g32))
    keys = sorted({key for _, key, *_ in keyed})
    index = torch.tensor([keys.index(key) for _, key, *_ in keyed])
    leaves = [leaf for *_, leaf in keyed]
    maxes = torch.stack([torch.max(torch.abs(g)) for g in leaves])
    amax = torch.zeros(len(keys), dtype=torch.float32, device=maxes.device)
    amax = amax.scatter_reduce(0, index.to(maxes.device), maxes, "amax")
    if mesh is not None:
        mesh.all_reduce(amax, mesh.axis_names, op="max")
    scales = torch.clamp_min(amax, 1e-12) / 127.0
    it = iter(index.tolist())
    dq = tree_map(lambda g: _dequantized(g, scales[next(it)]), g32)
    # g32 becomes the residual in place (no third copy of the gradients)
    return (tree_map(lambda d, g: d.to(g.dtype), dq, grads),
            tree_map(lambda r, d: r.sub_(d), g32, dq))


def _dequantized(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    q = torch.clamp(torch.round(g / scale), -128, 127).to(torch.int8)
    return q.to(torch.float32) * scale
