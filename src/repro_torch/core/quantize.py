"""Quantizers feeding the packed compute paths.

The packing scheme wants unsigned activations and signed weights.  Signed
activations are handled with an offset-binary zero point
``zp = 2**(bits-1)``; the constant ``zp * sum_k w[k, n]`` is folded out of
the matmul once per output channel (:func:`zero_point_correction`).

Rounding is ``torch.round``, half to even like ``jnp.round``, and every
division is IEEE float32, so payloads and scales are bit-identical to the
reference's.

``fake_quant_*`` are the straight-through-estimator (STE) versions for
quantization-aware training: the forward quantizes and dequantizes, the
backward passes the gradient unchanged inside the clipping range and zero
outside it (the reference's mask: ``|x| <= scale * (qmax + 1)`` signed,
``|x| <= scale * zp`` unsigned).
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = [
    "QuantizedTensor",
    "dequantize",
    "fake_quant_signed",
    "fake_quant_unsigned",
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
    ``a.w = a_u.w - zp * sum w`` per output channel.  Summed in wrapping
    int32, which is the int64 sum cast to int32 without an int64 copy of
    ``w_q`` (8 bytes a weight at engine build)."""
    return zp * w_q.to(torch.int32).sum(dim=0, dtype=torch.int32)


class _FakeQuant(torch.autograd.Function):
    """Quantize -> dequantize forward, masked straight-through backward."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, bits: int, axis: int, signed: bool):
        quantize = quantize_signed if signed else quantize_unsigned
        q = quantize(x, bits=bits, axis=axis)
        # the clipping range: qmax + 1 steps signed, zp steps unsigned
        # (both 2**(bits-1))
        ctx.save_for_backward(x.abs() <= q.scale * (1 << (bits - 1)))
        return q.dequantize().to(x.dtype)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (mask,) = ctx.saved_tensors
        return g * mask.to(g.dtype), None, None, None


def fake_quant_signed(x: torch.Tensor, bits: int = 4, axis: int = -1) -> torch.Tensor:
    """``quantize_signed`` then dequantize, in ``x.dtype``; STE backward."""
    return _FakeQuant.apply(x, bits, axis, True)


def fake_quant_unsigned(x: torch.Tensor, bits: int = 4, axis: int = -1) -> torch.Tensor:
    """``quantize_unsigned`` then dequantize, in ``x.dtype``; STE backward."""
    return _FakeQuant.apply(x, bits, axis, False)
