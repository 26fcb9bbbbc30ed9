"""Device resolution for the port's entry points: the card unless the
caller asks for the CPU, and never a silent fallback."""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device | None = "cuda") -> torch.device:
    """``torch.device`` for ``device`` (default ``"cuda"``); raises when a
    CUDA device is asked for and CUDA is absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; pass "
            "device='cpu' to run the port's plain versions on the CPU"
        )
    return dev
