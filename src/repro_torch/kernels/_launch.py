"""Checks shared by the CUDA kernel wrappers: device, dtype, shape,
contiguity and alignment of what a kernel is handed, and the launch
geometry helpers (SM count, split-K choice)."""

from __future__ import annotations

import functools

import torch

__all__ = ["require", "sm_count", "split_k"]


def require(t: torch.Tensor, name: str, dtype: torch.dtype,
            device: torch.device, ndim: int) -> None:
    """Raise unless ``t`` is a contiguous, 16-byte aligned ``dtype`` tensor
    of rank ``ndim`` on ``device``."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected rank {ndim}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


@functools.cache
def sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def split_k(blocks: int, units: int, device: torch.device,
            min_units: int = 1, per_sm: int = 8, max_units: int | None = None) -> int:
    """Units of K per split so that about ``per_sm`` blocks per SM are in
    flight (enough loads outstanding to cover HBM latency in a decode GEMV);
    never fewer than ``min_units`` per split, nor more than ``max_units``."""
    want = -(-per_sm * sm_count(device.index or 0) // max(blocks, 1))
    per = max(-(-units // max(want, 1)), min(min_units, units), 1)
    return per if max_units is None else min(per, max_units)
