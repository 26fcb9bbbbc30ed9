"""Quantizers feeding the packed compute paths.

The packing scheme wants unsigned activations and signed weights.  Signed
activations are handled with an offset-binary zero point
``zp = 2**(bits-1)``; the constant ``zp * sum_k w[k, n]`` is folded out of
the matmul once per output channel (:func:`zero_point_correction`).

Rounding is ``torch.round``, half to even like ``jnp.round``, and every
division is IEEE float32, so payloads and scales are bit-identical to the
reference's.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = [
    "QuantizedTensor",
    "dequantize",
    "quantize_signed",
    "quantize_unsigned",
    "zero_point_correction",
]


@dataclasses.dataclass
class QuantizedTensor:
    """Integer payload + per-channel scale (+ zero point for unsigned)."""

    values: torch.Tensor  # int8 (signed) or uint8 (offset-binary) payload
    scale: torch.Tensor   # f32, broadcastable against values along `axis`
    bits: int
    zero_point: int = 0   # 0 for signed; 2**(bits-1) for unsigned

    def dequantize(self) -> torch.Tensor:
        return (self.values.to(torch.float32) - self.zero_point) * self.scale


def _absmax_scale(x: torch.Tensor, axis: int, qmax: int) -> torch.Tensor:
    amax = x.abs().amax(dim=axis, keepdim=True)
    return torch.clamp_min(amax, 1e-8) / qmax


def quantize_signed(x: torch.Tensor, bits: int = 4, axis: int = -1) -> QuantizedTensor:
    """Symmetric signed quantization: values in ``[-2^(b-1), 2^(b-1)-1]``."""
    qmax = (1 << (bits - 1)) - 1
    scale = _absmax_scale(x, axis, qmax)
    q = (x / scale).round_().clamp_(-qmax - 1, qmax).to(torch.int8)
    return QuantizedTensor(q, scale, bits=bits, zero_point=0)


def quantize_unsigned(x: torch.Tensor, bits: int = 4, axis: int = -1) -> QuantizedTensor:
    """Offset-binary quantization: values in ``[0, 2^b - 1]``, zp at mid.

    The payload is uint8: an int8 store would saturate the upper half of the
    8-bit offset-binary range (every a8 value above the zero point)."""
    zp = 1 << (bits - 1)
    qmax = zp - 1
    scale = _absmax_scale(x, axis, qmax)
    q = (x / scale).round_().add_(zp).clamp_(0, (1 << bits) - 1).to(torch.uint8)
    return QuantizedTensor(q, scale, bits=bits, zero_point=zp)


def dequantize(q: QuantizedTensor) -> torch.Tensor:
    """``(values - zero_point) * scale`` in f32."""
    return q.dequantize()


def zero_point_correction(w_q: torch.Tensor, zp: int) -> torch.Tensor:
    """``zp * sum_k w[k, n]`` as int32: with ``a_u = a + zp``,
    ``a.w = a_u.w - zp * sum w`` per output channel."""
    return (zp * w_q.to(torch.int32).sum(dim=0, dtype=torch.int64)).to(torch.int32)
