"""The linear-layer funnel: every matmul of the model goes through
:func:`apply_linear`.

Counterpart of the reference's ``repro.core.packed_linear`` for the modes
of the port:

* ``native``      — plain dense matmul in the compute dtype;
* ``int4_packed`` — packed-nibble storage, the int4 kernel;
* ``dsp_packed``  — the pair-packed path, quantized at every call, with the
  correction scheme of ``LinearSpec.dsp_spec``;
* ``dsp_tuned``   — per-layer tuned plans carried by ``DspTunedLeaf``
  leaves; a float leaf under this mode (an unpackable weight) runs natively.

The leaf decides before the mode, with the reference's two conditions: a
2-D ``DspTunedLeaf`` runs its plan whatever the mode, and a 2-D nibble
leaf runs the int4 path under ``int4_packed``; any other packed leaf (a
nibble leaf under another mode, a stacked leaf) is dequantized at use and
multiplied in float, its activations unquantized
(:func:`packed_params.materialize_weight`).

* ``int8``        — activations signed int8 per row, weights per output
  channel, quantized at every call; the exact integer product
  (:func:`ref.ref_quantized_matmul`), then the two scales.  No kernel: the
  reference computes this product outside any Pallas kernel too.

* a ``runtime.tp_packed.TpLinear`` leaf (tensor-parallel serving) runs
  its shard's arithmetic and the cross-rank collectives, whatever the
  mode.

* ``qat4``/``qat8`` — quantization-aware training: the float weight is
  fake-quantized per output column (:func:`quantize.fake_quant_signed` on
  axis 0, in f32, then cast to the compute dtype) and, when
  ``LinearSpec.act_bits`` is set, the activations per row; the backward is
  the straight-through estimator.

The integer paths (``int8``, ``int4_packed``, ``dsp_packed``,
``dsp_tuned`` and any packed leaf run through its integer arithmetic) are
inference-only: their rounding would give a silent zero gradient, so they
raise when a gradient is asked through them, as the reference's raise
under differentiation.
"""

from __future__ import annotations

import dataclasses

import torch

from ..kernels import ops
from ..kernels.ref import (
    INT4_EXACT,
    PackedDotSpec,
    pack_int4_weights,
    ref_quantized_matmul,
)
from ..runtime.tp_packed import TpLinear, apply_tp_linear
from .packed_params import is_dsp_tuned_leaf, is_packed_leaf, materialize_weight
from .quantize import fake_quant_signed, quantize_signed

__all__ = ["LinearSpec", "apply_linear", "MODES", "INTEGER_MODES"]

MODES = ("native", "qat4", "qat8", "int8", "int4_packed", "dsp_packed",
         "dsp_tuned")

INTEGER_MODES = ("int8", "int4_packed", "dsp_packed", "dsp_tuned")


@dataclasses.dataclass(frozen=True)
class LinearSpec:
    mode: str = "native"
    dsp_spec: PackedDotSpec = INT4_EXACT
    use_kernel: bool = False  # CUDA kernel vs plain version (CPU tests)
    act_bits: int | None = None  # fake-quant activations too (QAT)

    def __post_init__(self) -> None:
        if self.mode not in MODES:
            raise ValueError(f"mode {self.mode!r} not in {MODES}")


def apply_linear(params: dict, x: torch.Tensor,
                 spec: LinearSpec = LinearSpec()) -> torch.Tensor:
    """``x @ w (+ b)`` through the selected compute mode."""
    w = params["w"]
    mode = spec.mode
    lead = x.shape[:-1]
    if isinstance(w, TpLinear):
        # tensor-parallel serving: the leaf was partitioned at engine build
        # (runtime.tp_packed.shard_params_tp); the wrapper carries the
        # partition kind and runs the cross-rank arithmetic
        y = apply_tp_linear(w, x.reshape(-1, x.shape[-1]).to(torch.float32), spec)
        y = y.reshape(*lead, y.shape[-1]).to(x.dtype)
        if "b" in params:
            y = y + params["b"].to(y.dtype)
        return y
    tuned = is_dsp_tuned_leaf(w) and w.payload.dim() == 2
    nibbles = is_packed_leaf(w) and mode == "int4_packed" and w["packed"].dim() == 2
    if (tuned or nibbles or mode in INTEGER_MODES) and torch.is_grad_enabled() and (
            x.requires_grad or getattr(w, "requires_grad", False)):
        raise RuntimeError(
            f"linear mode {mode!r} runs inference-only integer arithmetic and "
            "has no gradient; train with 'native', 'qat4' or 'qat8'"
        )
    if tuned:
        # this layer's tuned plan rides on the leaf, whatever the mode
        x2 = x.reshape(-1, x.shape[-1]).to(torch.float32)
        if w.prepacked:
            # the f32 shortcut only off the kernel path (see kernels.ops)
            y = ops.dsp_tuned_matmul_prepacked_f32(
                x2, w.words, w.wsc, w.zp_row, w.scale, w.w_f32, w.spec,
                use_kernel=spec.use_kernel,
                exact_f32=w.w_f32 is not None and not spec.use_kernel,
                variant=w.block_for(x2.shape[0]),
            )
        else:
            y = ops.dsp_tuned_matmul_f32(
                x2, w.values, w.scale, w.spec, use_kernel=spec.use_kernel
            )
        y = y.reshape(*lead, y.shape[-1]).to(x.dtype)
    elif nibbles:
        # the int4 kernel straight off the stored nibbles
        x2 = x.reshape(-1, x.shape[-1]).to(torch.float32)
        if "w_f32" in w and not spec.use_kernel:
            y = ops.int4_prepacked_matmul_f32(x2, w["w_f32"], w["scale"])
        else:
            y = ops.int4_matmul_f32(
                x2, w["packed"], w["scale"], use_kernel=spec.use_kernel
            )
        y = y.reshape(*lead, y.shape[-1]).to(x.dtype)
    elif is_packed_leaf(w) or is_dsp_tuned_leaf(w):
        # packed storage under a float path: dequantize at use
        y = x @ materialize_weight(w, x.dtype)
    elif mode in ("native", "dsp_tuned"):
        y = x @ w.to(x.dtype)
    elif mode in ("qat4", "qat8"):
        bits = 4 if mode == "qat4" else 8
        wq = fake_quant_signed(w.to(torch.float32), bits, 0).to(x.dtype)
        xq = (fake_quant_signed(x.to(torch.float32), spec.act_bits, -1).to(x.dtype)
              if spec.act_bits else x)
        y = xq @ wq
    elif mode == "int8":
        x2 = x.reshape(-1, x.shape[-1]).to(torch.float32)
        xq = quantize_signed(x2, bits=8, axis=-1)
        wq = quantize_signed(w.to(torch.float32), bits=8, axis=0)
        acc = ref_quantized_matmul(xq.values, wq.values)
        y = (acc.to(torch.float32) * xq.scale * wq.scale).reshape(
            *lead, w.shape[1]).to(x.dtype)
    elif mode == "int4_packed":
        x2 = x.reshape(-1, x.shape[-1]).to(torch.float32)
        wq = quantize_signed(w.to(torch.float32), bits=4, axis=0)
        y = ops.int4_matmul_f32(
            x2, pack_int4_weights(wq.values), wq.scale,
            use_kernel=spec.use_kernel,
        ).reshape(*lead, w.shape[1]).to(x.dtype)
    else:  # dsp_packed
        x2 = x.reshape(-1, x.shape[-1]).to(torch.float32)
        y = ops.packed_matmul_f32(
            x2, w.to(torch.float32), spec=spec.dsp_spec,
            use_kernel=spec.use_kernel,
        ).reshape(*lead, w.shape[1]).to(x.dtype)
    if "b" in params:
        y = y + params["b"].to(y.dtype)
    return y
