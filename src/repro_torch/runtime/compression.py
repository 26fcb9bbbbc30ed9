"""Gradient compression: int8 with error feedback.

The port's copy of the reference's ``repro.runtime.compression``: each
gradient leaf, plus its carried residual, is quantized to int8 by its own
absmax (``scale = max(amax, 1e-12) / 127``) and dequantized; the
quantization error is carried to the next step in an f32 error-feedback
buffer, so compression does not bias convergence.  On one card nothing is
reduced across devices: the transform is applied between the gradient and
the optimizer exactly as the reference's train step applies it.
"""

from __future__ import annotations

import torch

from ..tree import tree_map

__all__ = ["init_error_feedback", "compressed_grads"]


def init_error_feedback(params):
    """Zero f32 residuals beside each parameter."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                    params)


def _quantize_dequantize(g: torch.Tensor) -> torch.Tensor:
    amax = torch.max(torch.abs(g))
    scale = torch.clamp_min(amax, 1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -128, 127).to(torch.int8)
    return q.to(torch.float32) * scale


def compressed_grads(grads, error_buf):
    """int8-compress each gradient leaf with error feedback.  Returns
    ``(compressed grads, new error buffer)``; the compressed values are
    exactly ``int8 * scale``."""
    out = tree_map(_one, grads, error_buf)
    return (tree_map(lambda o: o[0], out),
            tree_map(lambda o: o[1], out))


def _one(g: torch.Tensor, e: torch.Tensor):
    g32 = g.to(torch.float32) + e
    dq = _quantize_dequantize(g32)
    return dq.to(g.dtype), g32 - dq
