"""Packed-weight parameter trees for serving.

Counterpart of the reference's ``repro.core.packed_params`` for the modes
of the port: ``int4_packed`` stores every matmul weight as int4 nibbles,
two per uint8 byte, plus a per-output-channel f32 scale; ``dsp_tuned``
quantizes each weight once onto its plan's signed grid and keeps it in a
:class:`DspTunedLeaf`, and ``dsp_mixed`` does the same with a per-path
width map (``tuning.mixed``); ``int8``, ``dsp_packed``, ``native`` and
``none`` keep float weights (``int8`` and ``dsp_packed`` quantize at the
point of use).  Every mode but ``native``/``none`` first splits MoE expert
stacks into per-expert leaves (:func:`split_expert_stacks`).

Parameters are nested dicts of tensors; a list (the per-layer ``groups``)
adds no component to a weight's path, so every layer of the stack has the
path, and so the plan, of the reference's stacked leaf.

The compute operands a leaf carries depend on where it will be served.
``words``/``wsc``/``zp_row`` (the prepacked pair words, the mr
contamination operands, the zero-point row) feed the kernel and the plain
version alike.  ``w_f32`` (the grid as f32, for the CPU's exact f32-GEMM
shortcut) is built only for leaves served with ``use_kernel=False``: on the
card it would cost 4 bytes per weight for an operand no kernel reads.
"""

from __future__ import annotations

from typing import Any, Iterator

import torch

from ..kernels import ref
from ..kernels.packed_matmul import TILED_MIN_M
from ..kernels.ref import INT4_EXACT, PackedDotSpec
from .quantize import quantize_signed, zero_point_correction

__all__ = [
    "quantize_for_serving",
    "fuse_projection_weights",
    "dequantize_packed",
    "materialize_weight",
    "is_packed_leaf",
    "is_dsp_tuned_leaf",
    "iter_packable_weights",
    "split_expert_stacks",
    "pack_signed_nibbles",
    "unpack_signed_nibbles",
    "DspTunedLeaf",
    "SERVING_MODES",
    "MIN_DIM",
]

MIN_DIM = 32  # tiny matrices stay exact

# ``none`` is served exactly as ``native``; ``dsp_mixed`` is ``dsp_tuned``
# with a sensitivity-allocated per-path width map (``tuning.mixed``)
SERVING_MODES = ("native", "none", "int8", "int4_packed", "dsp_packed",
                 "dsp_tuned", "dsp_mixed")


def is_packed_leaf(p) -> bool:
    return isinstance(p, dict) and "packed" in p and "scale" in p


def is_dsp_tuned_leaf(p) -> bool:
    return isinstance(p, DspTunedLeaf)


def pack_signed_nibbles(v: torch.Tensor) -> torch.Tensor:
    """(..., K, N) signed ints in [-8, 7] -> (..., K//2, N) uint8 nibbles."""
    v = v.to(torch.int8)
    if v.shape[-2] % 2:
        raise ValueError("K must be even to pack nibbles")
    lo = v[..., 0::2, :] & 0xF
    hi = v[..., 1::2, :] & 0xF
    return (lo | (hi << 4)).to(torch.uint8)


def unpack_signed_nibbles(packed: torch.Tensor) -> torch.Tensor:
    """(..., K//2, N) uint8 -> (..., K, N) int8, sign-extended."""
    b = packed.view(torch.int8)
    lo = (b << 4) >> 4
    hi = b >> 4
    k2, n = packed.shape[-2:]
    out = torch.stack([lo, hi], dim=-2)
    return out.reshape(packed.shape[:-2] + (2 * k2, n))


class DspTunedLeaf:
    """A matmul weight quantized once to a tuned packing plan.

    Built from ``values`` ((d_in, d_out) signed ints on the plan's
    ``bits_w`` grid) and ``scale`` ((1, d_out) f32).  Storage is
    ``payload``: nibbles when ``bits_w <= 4``, int8 otherwise.  With
    ``prepack`` the compute operands of the module docstring are built
    once; ``keep_w_f32`` adds the f32 grid for the CPU shortcut, and only
    when the plan is ``exact`` and the operand bound fits the f32 mantissa.
    ``exact`` is the carried plan's verdict when given, else the static
    certificate's (``analysis.verify.certify_spec``, which proves
    exactness for a superset of ``spec.provably_exact``).  ``block`` and
    ``decode_block`` are the tuned kernel variants of the plan's block
    sweep (``tuning.autotune``), above 16 rows and at 16 or fewer; None
    lets the wrapper choose by M.
    """

    def __init__(self, values: torch.Tensor, scale: torch.Tensor,
                 spec: PackedDotSpec, block: str | None = None, *,
                 decode_block: str | None = None, exact: bool | None = None,
                 prepack: bool = True, keep_w_f32: bool = False):
        self.scale = scale
        self.spec = spec
        self.block = block
        self.decode_block = decode_block
        if exact is None:
            from ..analysis.verify import certify_spec

            exact = certify_spec(spec).exact
        self.exact = bool(exact)
        if spec.bits_w <= 4 and values.shape[-2] % 2 == 0:
            self.payload = pack_signed_nibbles(values)
        else:
            self.payload = values.to(torch.int8)
        self.words = self.wsc = self.zp_row = self.w_f32 = None
        if prepack:
            v32 = values.to(torch.int32)
            packed = ref.pack_weight_words(v32, spec)
            self.words, self.wsc = packed.words, packed.wsc
            self.zp_row = zero_point_correction(v32, 1 << (spec.bits_a - 1))
            k = values.shape[-2]
            max_a = (1 << spec.bits_a) - 1
            max_w = 1 << (spec.bits_w - 1)
            if (keep_w_f32 and self.exact
                    and ref.exact_int_matmul_fits_f32(k, max_a, max_w)):
                self.w_f32 = values.to(torch.float32)

    @property
    def nibble_packed(self) -> bool:
        return self.payload.dtype == torch.uint8

    @property
    def values(self) -> torch.Tensor:
        """The signed plan-grid integers, decoded from storage (int8)."""
        if self.nibble_packed:
            return unpack_signed_nibbles(self.payload)
        return self.payload

    @property
    def prepacked(self) -> bool:
        return self.words is not None

    def block_for(self, m: int) -> str | None:
        """The tuned kernel variant for ``m`` rows: ``decode_block`` at 16
        rows or fewer (the decode GEMVs), ``block`` above."""
        return self.decode_block if m < TILED_MIN_M else self.block


def dequantize_packed(p: dict, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """A nibble leaf (..., K//2, N) -> its float weight (..., K, N): the
    nibbles sign-extended, times the per-channel scale in f32, cast to
    ``dtype``."""
    w = unpack_signed_nibbles(p["packed"])
    return (w.to(torch.float32) * p["scale"]).to(dtype)


def materialize_weight(p, dtype: torch.dtype) -> torch.Tensor:
    """The float weight of any leaf: a nibble leaf or a
    :class:`DspTunedLeaf` dequantized, a float tensor as it is (the funnel
    multiplies by it where no packed path takes the leaf)."""
    if is_packed_leaf(p):
        return dequantize_packed(p, dtype)
    if is_dsp_tuned_leaf(p):
        return (p.values.to(torch.float32) * p.scale).to(dtype)
    return p


def fuse_projection_weights(params, fuse_attn: bool = True, fuse_mlp: bool = True):
    """Engine-build fusion of same-input projections.

    Attention's q/k/v and SwiGLU's up/gate read the same activation:
    concatenating their float weights along the output axis turns three
    (two) matmuls per step into one.  Weights are quantized per output
    channel and activations per row, so the fused quantized matmul is
    bit-identical per column to the unfused ones.  A dict holding wq/wk/wv
    linears becomes ``{"wqkv": ...}`` (cross-attention, under ``xattn``,
    never fuses); one holding up/gate/down with equal up and gate shapes
    becomes ``{"upgate": ..., "down": ...}``.  Biases concatenate alongside.
    Lists are walked element by element; a block that is itself a list
    element (the inner stacks of the ssm and hybrid groups) stays unfused.
    """

    def is_linear(d) -> bool:
        return isinstance(d, dict) and isinstance(d.get("w"), torch.Tensor)

    def fuse(parts: list[dict]) -> dict:
        fused = {"w": torch.cat([q["w"] for q in parts], dim=-1)}
        if all("b" in q for q in parts):
            fused["b"] = torch.cat([q["b"] for q in parts], dim=-1)
        return fused

    def walk(tree):
        if isinstance(tree, list):
            return [walk(v) for v in tree]
        if not isinstance(tree, dict):
            return tree
        out = {}
        for k, v in tree.items():
            if (fuse_attn and k != "xattn" and isinstance(v, dict)
                    and all(is_linear(v.get(n)) for n in ("wq", "wk", "wv"))):
                rest = {n: walk(s) for n, s in v.items() if n not in ("wq", "wk", "wv")}
                out[k] = {"wqkv": fuse([v["wq"], v["wk"], v["wv"]]), **rest}
            elif (fuse_mlp and isinstance(v, dict)
                    and all(is_linear(v.get(n)) for n in ("up", "gate", "down"))
                    and v["up"]["w"].shape == v["gate"]["w"].shape):
                rest = {n: walk(s) for n, s in v.items() if n not in ("up", "gate")}
                out[k] = {"upgate": fuse([v["up"], v["gate"]]), **rest}
            else:
                out[k] = walk(v)
        return out

    return walk(params)


def iter_packable_weights(
    params, min_dim: int = MIN_DIM, path: str = ""
) -> Iterator[tuple[str, Any]]:
    """Yield ``(path, leaf)`` for every matmul weight eligible for packed
    serving, with the reference's predicate (lists add no path component)."""
    if isinstance(params, list):
        for v in params:
            yield from iter_packable_weights(v, min_dim, path)
        return
    if not isinstance(params, dict):
        return
    parent = path.rsplit("/", 1)[-1]
    for k, v in params.items():
        p = f"{path}/{k}"
        expert_leaf = (
            k.startswith("e") and k[1:].isdigit()
            and parent in ("up", "gate", "down")
        )
        if (
            (k in ("w", "up", "gate", "down") or expert_leaf)
            and isinstance(v, torch.Tensor)
            and v.dim() >= 2
            and "embed" not in path
            and "patch_proj" not in path
            and "router" not in p
            and v.shape[-2] >= min_dim
            and v.shape[-1] >= min_dim
            and v.shape[-2] % 2 == 0
        ):
            yield p, v
        else:
            yield from iter_packable_weights(v, min_dim, p)


def split_expert_stacks(params):
    """Split stacked MoE expert weights into per-expert leaves.

    ``models.moe.init_moe`` stores each expert projection as one
    ``(E, d_in, d_out)`` stack; ``{"e0": (d_in, d_out), "e1": ...}`` gives
    every expert its own path, so its own plan, sensitivity row and
    prepacked leaf.  A stack is recognized structurally, as the reference
    does: an ``up``/``gate``/``down`` tensor of ``dim >= 3`` in a dict that
    also holds a ``router``.  Idempotent: a split tree passes unchanged.
    The layer list of ``groups`` is walked element by element.
    """
    if isinstance(params, list):
        return [split_expert_stacks(v) for v in params]
    if not isinstance(params, dict):
        return params
    is_moe = "router" in params
    out = {}
    for k, v in params.items():
        if (is_moe and k in ("up", "gate", "down") and isinstance(v, torch.Tensor)
                and v.dim() >= 3):
            out[k] = {f"e{i}": v[..., i, :, :] for i in range(v.shape[-3])}
        else:
            out[k] = split_expert_stacks(v)
    return out


def _pack_matrix(w: torch.Tensor, keep_w_f32: bool) -> dict:
    """(d_in, d_out) float -> int4 nibbles + per-channel scale (+ the f32
    grid for the CPU shortcut)."""
    q = quantize_signed(w.to(torch.float32), bits=4, axis=0)
    leaf = {"packed": ref.pack_int4_weights(q.values), "scale": q.scale}
    if keep_w_f32 and ref.exact_int_matmul_fits_f32(w.shape[0], 128, 8):
        leaf["w_f32"] = q.values.to(torch.float32)
    return leaf


def _tune_matrix(w: torch.Tensor, plan: tuple, prepack: bool,
                 keep_w_f32: bool) -> DspTunedLeaf:
    """(d_in, d_out) float -> plan-grid signed ints + per-channel scale;
    ``plan`` is (spec, block, decode_block, exact)."""
    spec, block, decode_block, exact = plan
    q = quantize_signed(w.to(torch.float32), bits=spec.bits_w, axis=0)
    return DspTunedLeaf(q.values, q.scale, spec, block, decode_block=decode_block,
                        exact=exact, prepack=prepack, keep_w_f32=keep_w_f32)


def _leaf_plan(plan) -> tuple:
    """(spec, block, decode_block, exact) of a plan-table entry: None (the
    exact int4 preset), a :class:`PackedDotSpec`, or a
    ``tuning.PlanReport`` (its tuned variants, and exact where its
    certificate proves it or an exhaustive grid measured no error)."""
    if plan is None:
        return INT4_EXACT, None, None, None
    if isinstance(plan, PackedDotSpec):
        return plan, None, None, None
    exact = plan.certificate.exact or (plan.mae == 0 and plan.exhaustive)
    return plan.spec, plan.block, plan.decode_block, exact


def _convert_tree(params, targets: dict, convert):
    """Replace the leaves named in ``targets`` (path -> per-leaf argument);
    everything else passes through untouched (tensors are shared)."""

    def walk(tree, path=""):
        if isinstance(tree, list):
            return [walk(v, path) for v in tree]
        if not isinstance(tree, dict):
            return tree
        out = {}
        for k, v in tree.items():
            p = f"{path}/{k}"
            if p in targets and isinstance(v, torch.Tensor):
                out[k] = convert(v, targets[p])
            else:
                out[k] = walk(v, p)
        return out

    return walk(params)


def quantize_for_serving(params, mode: str = "int4_packed",
                         min_dim: int = MIN_DIM, plans=None,
                         prepack: bool = True, use_kernel: bool = False,
                         only_planned: bool = False):
    """Engine-build weight conversion.

    ``int4_packed`` packs every large matmul weight to nibbles once.
    ``dsp_tuned`` quantizes each weight onto its plan (``plans``: a
    ``{path: PlanReport or PackedDotSpec}`` table, as
    ``tuning.plan_linear_layers`` builds it; a path missing from it falls
    back to :data:`INT4_EXACT`) and stores :class:`DspTunedLeaf` leaves.
    ``dsp_mixed`` is the same arithmetic with entries of different
    ``(a_bits, w_bits)`` (``tuning.mixed``'s allocation): each leaf
    quantizes onto its own plan's grid.  ``only_planned=True`` converts
    only the paths named in ``plans`` and leaves every other weight float:
    the single-path probe of the sensitivity pass.  ``int8``,
    ``dsp_packed``, ``native`` and ``none`` return the float tree (the
    first two quantize at the point of use).  Every mode but ``native`` and
    ``none`` splits MoE expert stacks first.  ``use_kernel`` says where
    the leaves will be served: the CPU's f32 shortcut operands are built
    only when it is false.
    """
    if mode not in SERVING_MODES:
        raise ValueError(f"serving mode {mode!r} not in {SERVING_MODES}")
    if mode in ("native", "none"):
        return params
    params = split_expert_stacks(params)
    keep_w_f32 = prepack and not use_kernel
    paths = {p for p, _ in iter_packable_weights(params, min_dim)}
    if mode == "int4_packed":
        return _convert_tree(
            params, dict.fromkeys(paths),
            lambda w, _: _pack_matrix(w, keep_w_f32),
        )
    if mode in ("dsp_tuned", "dsp_mixed"):
        plans = plans or {}
        targets = {p: _leaf_plan(plans.get(p)) for p in paths
                   if not only_planned or plans.get(p) is not None}
        return _convert_tree(
            params, targets,
            lambda w, spec: _tune_matrix(w, spec, prepack, keep_w_f32),
        )
    return params
