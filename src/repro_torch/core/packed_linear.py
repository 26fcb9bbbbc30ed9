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

``qat4``/``qat8`` (training) are accepted as names, so that a reference
configuration reads the same, and raise ``NotImplementedError`` on a float
leaf.
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
from .packed_params import is_dsp_tuned_leaf, is_packed_leaf, materialize_weight
from .quantize import quantize_signed

__all__ = ["LinearSpec", "apply_linear", "MODES"]

MODES = ("native", "qat4", "qat8", "int8", "int4_packed", "dsp_packed",
         "dsp_tuned")

_NOT_PORTED = {
    "qat4": "ROADMAP queue 11 (training)",
    "qat8": "ROADMAP queue 11 (training)",
}


@dataclasses.dataclass(frozen=True)
class LinearSpec:
    mode: str = "native"
    dsp_spec: PackedDotSpec = INT4_EXACT
    use_kernel: bool = False  # CUDA kernel vs plain version (CPU tests)

    def __post_init__(self) -> None:
        if self.mode not in MODES:
            raise ValueError(f"mode {self.mode!r} not in {MODES}")


def apply_linear(params: dict, x: torch.Tensor,
                 spec: LinearSpec = LinearSpec()) -> torch.Tensor:
    """``x @ w (+ b)`` through the selected compute mode."""
    w = params["w"]
    mode = spec.mode
    lead = x.shape[:-1]
    if is_dsp_tuned_leaf(w) and w.payload.dim() == 2:
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
    elif is_packed_leaf(w) and mode == "int4_packed" and w["packed"].dim() == 2:
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
    elif mode in _NOT_PORTED:
        raise NotImplementedError(
            f"linear mode {mode!r} is not ported yet: {_NOT_PORTED[mode]}"
        )
    elif mode in ("native", "dsp_tuned"):
        y = x @ w.to(x.dtype)
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
