"""Generalized DSP multiplication packing (paper §III/§IV, Eqn. 4).

The port's counterpart of the reference's ``repro.core.packing``: a
simulation, in int64 tensors, of packing several narrow integer
multiplications into one wide multiplier + accumulator (the Xilinx
DSP48E2's ``P = B×(A+D) + C`` datapath).  Words reach 48 bits and more,
so everything runs in int64, whose ``>>`` is arithmetic in torch as in
numpy.  Functions compute on the device of the tensors they are given;
array-likes that are not tensors become CPU tensors.

Terminology follows the paper:
  * ``a`` — vector of *unsigned* operands (activations), packed into one
    physical multiplier input at offsets ``a_offsets``.
  * ``w`` — vector of *signed* operands (weights), packed into the other
    input at offsets ``w_offsets``.
  * the single wide product contains the full outer product
    ``r[j*|a|+i] = a_i * w_j`` at offset ``a_offsets[i] + w_offsets[j]``.
  * ``delta`` — padding bits between adjacent result fields.  ``delta >= 0``
    allows ``2**delta`` products to be accumulated before fields collide;
    ``delta < 0`` is *Overpacking* (§VI): fields overlap and corrupt each
    other by ``|delta|`` bits.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

__all__ = [
    "PackingConfig",
    "int4_packing",
    "int8_packing",
    "intn_packing",
    "pack_activations",
    "pack_weights",
    "multiply_packed",
    "extract_fields",
    "outer_product_exact",
    "sign_extend",
    "mul_lsbs",
    "as_int64",
]

# The DSP48E2 port budgets (bits).  `a` rides the 18-bit signed B port (so 17
# usable bits for unsigned payload), `w` the 27-bit signed pre-adder path (26
# payload bits + sign), and the product/accumulator is 48-bit signed.
DSP48_A_BITS = 17
DSP48_W_BITS = 26
DSP48_P_BITS = 47


def as_int64(x) -> torch.Tensor:
    """``x`` as an int64 tensor: a tensor keeps its device, anything else
    (numpy array, list, scalar) becomes a CPU tensor."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64)
    return torch.as_tensor(np.asarray(x, dtype=np.int64))


def sign_extend(v, width: int) -> torch.Tensor:
    """Reinterpret the low ``width`` bits of ``v`` as a signed integer."""
    mask = (1 << width) - 1
    sign = 1 << (width - 1)
    return ((as_int64(v) & mask) ^ sign) - sign


def mul_lsbs(a, w, nbits: int) -> torch.Tensor:
    """The ``nbits`` least-significant bits of ``a*w`` (paper Eqns. 8/9):
    the product modulo ``2**nbits``."""
    return (as_int64(a) * as_int64(w)) & ((1 << nbits) - 1)


@dataclasses.dataclass(frozen=True)
class PackingConfig:
    """A packing configuration in the paper's notation (§IV).

    ``r_offsets[j*len(a)+i] = a_offsets[i] + w_offsets[j]`` and
    ``r_widths[j*len(a)+i] = a_widths[i] + w_widths[j]`` (Eqn. 4).
    """

    a_widths: tuple[int, ...]
    w_widths: tuple[int, ...]
    a_offsets: tuple[int, ...]
    w_offsets: tuple[int, ...]
    delta: int

    def __post_init__(self) -> None:
        if len(self.a_widths) != len(self.a_offsets):
            raise ValueError("a_widths and a_offsets must have equal length")
        if len(self.w_widths) != len(self.w_offsets):
            raise ValueError("w_widths and w_offsets must have equal length")
        if sorted(self.a_offsets) != list(self.a_offsets) or sorted(
            self.w_offsets
        ) != list(self.w_offsets):
            raise ValueError("offsets must be sorted ascending")
        if self.product_bits() > 62:
            raise ValueError(
                "packing config exceeds the int64 simulation budget "
                f"({self.product_bits()} bits)"
            )

    # ---- derived field algebra (Eqn. 4) -------------------------------
    @property
    def n_a(self) -> int:
        return len(self.a_widths)

    @property
    def n_w(self) -> int:
        return len(self.w_widths)

    @property
    def n_results(self) -> int:
        return self.n_a * self.n_w

    def result_index(self, i: int, j: int) -> int:
        """Flat index of result ``a_i * w_j``."""
        return j * self.n_a + i

    def result_operands(self, n: int) -> tuple[int, int]:
        """Inverse of :meth:`result_index`: flat index -> ``(i, j)``."""
        return n % self.n_a, n // self.n_a

    @property
    def r_offsets(self) -> tuple[int, ...]:
        out = [0] * self.n_results
        for j, woff in enumerate(self.w_offsets):
            for i, aoff in enumerate(self.a_offsets):
                out[self.result_index(i, j)] = aoff + woff
        return tuple(out)

    @property
    def r_widths(self) -> tuple[int, ...]:
        out = [0] * self.n_results
        for j, ww in enumerate(self.w_widths):
            for i, aw in enumerate(self.a_widths):
                out[self.result_index(i, j)] = aw + ww
        return tuple(out)

    def product_bits(self) -> int:
        """Upper bound on the bits needed by the packed product."""
        return max(o + w for o, w in zip(self.r_offsets, self.r_widths)) + 2

    def fits_dsp48(self) -> bool:
        """Whether the configuration fits the DSP48E2 port budgets."""
        a_bits = self.a_offsets[-1] + self.a_widths[-1]
        w_bits = self.w_offsets[-1] + self.w_widths[-1]
        return (
            a_bits <= DSP48_A_BITS
            and w_bits <= DSP48_W_BITS
            and self.product_bits() - 2 <= DSP48_P_BITS
        )

    def packing_density(self, total_bits: int = 48) -> float:
        """ρ = b_used / b_total (paper §VIII / Fig. 9).

        ``b_used`` counts *logical* result bits; under Overpacking fields
        overlap so ρ can exceed the physically occupied span — that is the
        squeeze.
        """
        return sum(self.r_widths) / total_bits

    def max_accumulations(self) -> int:
        """2**delta results can be accumulated error-free (paper §III)."""
        return 2 ** max(self.delta, 0)


def intn_packing(
    a_widths: Sequence[int], w_widths: Sequence[int], delta: int
) -> PackingConfig:
    """INT-N: derive a uniform-grid packing from widths + padding (§IV).

    Field spacing is ``s = max(result width) + delta``; activation offsets
    advance by ``s`` and weight offsets by ``s * len(a)`` so the outer
    product lands on a uniform grid of result offsets (Eqn. (3)/(4),
    Figs. 2/6).
    """
    a_widths = tuple(int(x) for x in a_widths)
    w_widths = tuple(int(x) for x in w_widths)
    spacing = max(aw + ww for aw in a_widths for ww in w_widths) + delta
    if spacing <= 0:
        raise ValueError(f"spacing must be positive, got {spacing}")
    a_offsets = tuple(i * spacing for i in range(len(a_widths)))
    w_offsets = tuple(j * spacing * len(a_widths) for j in range(len(w_widths)))
    return PackingConfig(a_widths, w_widths, a_offsets, w_offsets, delta)


def int4_packing(delta: int = 3) -> PackingConfig:
    """The Xilinx INT4 configuration (§III / Fig. 2) for ``delta=3``.

    ``delta<3`` yields the Overpacked variants (e.g. Fig. 6 is ``delta=-2``).
    """
    return intn_packing((4, 4), (4, 4), delta)


def int8_packing(delta: int = 2) -> PackingConfig:
    """The Xilinx INT8 (wp486) configuration: two 8-bit multiplies."""
    return intn_packing((8,), (8, 8), delta)


# ---- packing / wide multiply / extraction ------------------------------


def _check_ranges(cfg: PackingConfig, a: torch.Tensor, w: torch.Tensor) -> None:
    if a.shape[-1] != cfg.n_a:
        raise ValueError(f"a last dim {a.shape[-1]} != {cfg.n_a}")
    if w.shape[-1] != cfg.n_w:
        raise ValueError(f"w last dim {w.shape[-1]} != {cfg.n_w}")
    for i, width in enumerate(cfg.a_widths):
        ai = a[..., i]
        if bool(((ai < 0) | (ai >= (1 << width))).any()):
            raise ValueError(f"a[{i}] out of unsigned {width}-bit range")
    for j, width in enumerate(cfg.w_widths):
        wj = w[..., j]
        lo, hi = -(1 << (width - 1)), (1 << (width - 1)) - 1
        if bool(((wj < lo) | (wj > hi)).any()):
            raise ValueError(f"w[{j}] out of signed {width}-bit range")


def _pack(x: torch.Tensor, offsets: tuple[int, ...]) -> torch.Tensor:
    out = torch.zeros(x.shape[:-1], dtype=torch.int64, device=x.device)
    for i, off in enumerate(offsets):
        out = out + (x[..., i] << off)
    return out


def pack_activations(cfg: PackingConfig, a) -> torch.Tensor:
    """Pack unsigned operands: ``A = Σ a_i · 2^a_offsets[i]`` (B port)."""
    return _pack(as_int64(a), cfg.a_offsets)


def pack_weights(cfg: PackingConfig, w) -> torch.Tensor:
    """Pack signed operands: ``W = Σ w_j · 2^w_offsets[j]``.

    This models the DSP pre-adder forming ``D·2^off + sext(A)``; the packed
    value is a plain (possibly negative) integer.
    """
    return _pack(as_int64(w), cfg.w_offsets)


def multiply_packed(
    cfg: PackingConfig,
    a,
    w,
    correction_word=None,
    check: bool = True,
) -> torch.Tensor:
    """One wide multiply: ``P = pack(a) × pack(w) (+ C)`` — the DSP op."""
    a, w = as_int64(a), as_int64(w)
    if check:
        _check_ranges(cfg, a, w)
    p = pack_activations(cfg, a) * pack_weights(cfg, w)
    if correction_word is not None:
        p = p + as_int64(correction_word)
    return p


def extract_fields(cfg: PackingConfig, p, round_half_up: bool = False) -> torch.Tensor:
    """Extract every result field from the packed product (last axis).

    ``round_half_up=False`` is the naive extraction (arithmetic right shift,
    floors toward −∞ — the biased scheme of the Xilinx white papers, §V).
    ``round_half_up=True`` implements the paper's Full Error Correction
    (Eqn. 7): inspect the bit just below the field and round to nearest.
    """
    p = as_int64(p)
    fields = []
    for n in range(cfg.n_results):
        off, width = cfg.r_offsets[n], cfg.r_widths[n]
        if round_half_up and off > 0:
            shifted = ((p >> (off - 1)) + 1) >> 1
        else:
            shifted = p >> off
        fields.append(sign_extend(shifted, width))
    return torch.stack(fields, dim=-1)


def outer_product_exact(cfg: PackingConfig, a, w) -> torch.Tensor:
    """The mathematically exact outer product, ordered like the fields."""
    a, w = as_int64(a), as_int64(w)
    cols = []
    for n in range(cfg.n_results):
        i, j = cfg.result_operands(n)
        cols.append(a[..., i] * w[..., j])
    return torch.stack(cols, dim=-1)
