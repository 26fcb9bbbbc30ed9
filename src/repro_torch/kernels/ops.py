"""Float-in/float-out dispatch around the packed matmuls.

Counterpart of the reference's ``repro.kernels.ops``: scale and zero-point
bookkeeping, and the choice between the CUDA kernel and the plain version,
keyed on ``use_kernel`` exactly as the reference keys its Pallas/jnp
branches.  ``use_kernel=True`` needs CUDA tensors and raises on CPU ones;
nothing falls back.

The f32-GEMM shortcuts (``exact_f32`` here, ``w_f32`` leaves) are taken
only when ``use_kernel`` is false, as in the reference: on the card a
shortcut would replace the packed kernel with a float GEMM.  Where a
shortcut runs, TF32 is pinned off first, because it is bit-identical to
the integer matmul only when the GEMM keeps the full 24-bit mantissa.
"""

from __future__ import annotations

import torch

from ..core.quantize import quantize_signed, quantize_unsigned, zero_point_correction
from . import ref
from .int4_matmul import int4_matmul
from .packed_matmul import packed_matmul, packed_matmul_prepacked
from .ref import INT4_EXACT, PackedDotSpec

__all__ = [
    "packed_matmul_f32",
    "dsp_tuned_matmul_f32",
    "dsp_tuned_matmul_prepacked_f32",
    "int4_matmul_f32",
    "int4_prepacked_matmul_f32",
    "quantized_matmul_ref",
    "pin_full_f32",
]


def pin_full_f32() -> None:
    """Keep float32 GEMMs and convolutions in full float32 (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _require_kernel_device(x: torch.Tensor, what: str) -> None:
    if not x.is_cuda:
        raise ValueError(
            f"{what}: use_kernel=True runs the CUDA kernel and needs CUDA "
            f"tensors, got one on {x.device} (pass use_kernel=False on the CPU)"
        )


def packed_matmul_f32(
    x: torch.Tensor,
    w: torch.Tensor,
    spec: PackedDotSpec = INT4_EXACT,
    use_kernel: bool = True,
) -> torch.Tensor:
    """float (M, K) x float (K, N) through the pair-packed integer path:
    activations offset-binary per row, weights signed per output channel,
    quantized on every call."""
    xq = quantize_unsigned(x, bits=spec.bits_a, axis=-1)
    wq = quantize_signed(w, bits=spec.bits_w, axis=0)
    if use_kernel:
        _require_kernel_device(x, "packed_matmul_f32")
        acc = packed_matmul(xq.values, wq.values, spec)
    else:
        acc = ref.ref_packed_matmul(xq.values, wq.values, spec)
    acc = acc - zero_point_correction(wq.values, xq.zero_point)[None, :]
    return acc.to(torch.float32) * xq.scale * wq.scale


def dsp_tuned_matmul_f32(
    x: torch.Tensor,
    w_values: torch.Tensor,
    w_scale: torch.Tensor,
    spec: PackedDotSpec,
    use_kernel: bool = True,
) -> torch.Tensor:
    """float (M, K) x pre-quantized signed (K, N) through a tuned plan, the
    weights packed into words on every call (non-prepacked leaves)."""
    xq = quantize_unsigned(x, bits=spec.bits_a, axis=-1)
    if use_kernel:
        _require_kernel_device(x, "dsp_tuned_matmul_f32")
        acc = packed_matmul(xq.values, w_values, spec)
    else:
        acc = ref.ref_packed_matmul(xq.values, w_values, spec)
    acc = acc - zero_point_correction(w_values, xq.zero_point)[None, :]
    return acc.to(torch.float32) * xq.scale * w_scale


def _row_scale(x: torch.Tensor, qmax: int) -> torch.Tensor:
    amax = x.abs().amax(dim=-1, keepdim=True)
    return torch.clamp_min(amax, 1e-8) / qmax


def dsp_tuned_matmul_prepacked_f32(
    x: torch.Tensor,
    words: torch.Tensor,
    wsc: torch.Tensor | None,
    zp_row: torch.Tensor,
    w_scale: torch.Tensor,
    w_f32: torch.Tensor | None,
    spec: PackedDotSpec,
    use_kernel: bool = True,
    exact_f32: bool = False,
    variant: str | None = None,
) -> torch.Tensor:
    """float (M, K) x prepacked tuned-plan weights -> f32 (M, N).

    Kernel path: the activation quantize is fused into the kernel's
    prologue; ``variant`` (a tuned leaf's block for this M) names the
    kernel, else the wrapper chooses by M.  ``exact_f32`` (CPU path only,
    for plans proven exact whose operand bound fits the f32 mantissa — a
    leaf's ``w_f32`` encodes both) evaluates the identical integer matmul
    as an f32 GEMM.
    """
    zp = 1 << (spec.bits_a - 1)
    if use_kernel:
        _require_kernel_device(x, "dsp_tuned_matmul_prepacked_f32")
        x_scale = _row_scale(x, zp - 1)
        acc = packed_matmul_prepacked(
            x.contiguous(), words, wsc, spec, x_scale=x_scale, x_zp=zp,
            variant=variant,
        )
        out_scale = x_scale
    elif exact_f32 and w_f32 is not None:
        pin_full_f32()
        x_scale = _row_scale(x, zp - 1)
        q = torch.round(x / x_scale) + zp
        acc = q @ w_f32  # exact: every partial sum fits the f32 mantissa
        acc = acc - zp_row.to(torch.float32)[None, :]
        return acc * x_scale * w_scale
    else:
        xq = quantize_unsigned(x, bits=spec.bits_a, axis=-1)
        acc = ref.ref_packed_matmul_prepacked(
            xq.values, ref.PackedWeightWords(words, wsc), spec
        )
        out_scale = xq.scale
    acc = acc - zp_row[None, :]
    return acc.to(torch.float32) * out_scale * w_scale


def int4_matmul_f32(
    x: torch.Tensor,
    w_packed: torch.Tensor,
    w_scale: torch.Tensor,
    use_kernel: bool = True,
) -> torch.Tensor:
    """float (M, K) x packed int4 (K//2, N) -> f32, int8 activations."""
    xq = quantize_signed(x, bits=8, axis=-1)
    if use_kernel:
        _require_kernel_device(x, "int4_matmul_f32")
        acc = int4_matmul(xq.values, w_packed)
    else:
        acc = ref.ref_int4_matmul(xq.values, w_packed)
    return acc.to(torch.float32) * xq.scale * w_scale


def int4_prepacked_matmul_f32(
    x: torch.Tensor,
    w_f32: torch.Tensor,
    w_scale: torch.Tensor,
) -> torch.Tensor:
    """float (M, K) x int4 grid decoded once to f32 (K, N) -> f32 (M, N).

    The CPU shortcut of ``int4_packed``: with int8 activations every partial
    sum is an integer below 2**24, so the f32 GEMM is the exact int8 x int4
    matmul, bit-identical to :func:`ref.ref_int4_matmul` on the nibbles."""
    pin_full_f32()
    qmax = 127
    scale = _row_scale(x, qmax)
    q = torch.round(x / scale)
    acc = q @ w_f32
    return acc * scale * w_scale


def quantized_matmul_ref(x: torch.Tensor, w: torch.Tensor, bits: int = 4) -> torch.Tensor:
    """Exact-arithmetic quantized matmul, no packing: the accuracy oracle.
    Activations offset-binary per row, weights signed per output channel,
    the exact integer product less the zero-point term, then the scales."""
    xq = quantize_unsigned(x, bits=bits, axis=-1)
    wq = quantize_signed(w, bits=bits, axis=0)
    acc = ref.ref_quantized_matmul(xq.values, wq.values)
    acc = acc - zero_point_correction(wq.values, xq.zero_point)[None, :]
    return acc.to(torch.float32) * xq.scale * wq.scale
