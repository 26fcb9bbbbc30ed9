"""Addition packing: several narrow adders in one wide accumulator (§VII).

The port's counterpart of the reference's ``repro.core.addpack``, on int64
tensors (see :mod:`.packing`).  Packs ``k`` narrow additions as bit fields
of one 48-bit add (Fig. 7).  A lane only errs when the lane below it carries
out across the field boundary, which corrupts the victim lane's LSB
(worst-case absolute error 1).  One guard bit between lanes catches the
carry and makes every lane exact (Fig. 8) at the cost of one payload bit
per boundary.

The paper's motivating application is Spiking Neural Networks, whose main
operation is accumulation rather than MAC; :func:`accumulate` provides a
chunked accumulator that extracts lanes before any field can overflow.
The two-lane int32 form of it runs on the card as the CUDA kernel
``kernels.addpack_acc.addpack_accumulate``.
"""

from __future__ import annotations

import dataclasses

import torch

from .packing import as_int64, sign_extend

__all__ = [
    "AddPackConfig",
    "five_by_nine",
    "pack_lanes",
    "packed_add",
    "extract_lanes",
    "lane_add_expected",
    "packed_lane_add",
    "accumulate",
]


@dataclasses.dataclass(frozen=True)
class AddPackConfig:
    """Lane layout for addition packing.

    ``lane_widths[i]`` payload bits per lane, ``guard_bits`` zero bits
    inserted between lanes (0 = the approximate scheme of Table III),
    ``signed`` lanes are interpreted in two's complement.
    """

    lane_widths: tuple[int, ...]
    guard_bits: int = 0
    total_bits: int = 48
    signed: bool = True

    def __post_init__(self) -> None:
        if self.bits_used() > self.total_bits:
            raise ValueError(
                f"lanes need {self.bits_used()} bits > accumulator "
                f"{self.total_bits}"
            )

    @property
    def n_lanes(self) -> int:
        return len(self.lane_widths)

    @property
    def offsets(self) -> tuple[int, ...]:
        out, off = [], 0
        for width in self.lane_widths:
            out.append(off)
            off += width + self.guard_bits
        return tuple(out)

    def bits_used(self) -> int:
        return sum(self.lane_widths) + self.guard_bits * (self.n_lanes - 1)

    def packing_density(self) -> float:
        return sum(self.lane_widths) / self.total_bits


def five_by_nine() -> AddPackConfig:
    """The paper's example: five 9-bit adders, no guard bits (Table III)."""
    return AddPackConfig(lane_widths=(9,) * 5, guard_bits=0)


def _lane(cfg: AddPackConfig, field: torch.Tensor, i: int) -> torch.Tensor:
    """A lane's field (already masked to its width) as the lane reads it."""
    return sign_extend(field, cfg.lane_widths[i]) if cfg.signed else field


def pack_lanes(cfg: AddPackConfig, x) -> torch.Tensor:
    """Place each lane's two's-complement field at its offset (Fig. 7)."""
    x = as_int64(x)
    if x.shape[-1] != cfg.n_lanes:
        raise ValueError(f"x last dim {x.shape[-1]} != {cfg.n_lanes}")
    out = torch.zeros(x.shape[:-1], dtype=torch.int64, device=x.device)
    for i, off in enumerate(cfg.offsets):
        out = out + ((x[..., i] & ((1 << cfg.lane_widths[i]) - 1)) << off)
    return out


def packed_add(cfg: AddPackConfig, p, q) -> torch.Tensor:
    """One wide addition, wrapped to the accumulator width."""
    return (as_int64(p) + as_int64(q)) & ((1 << cfg.total_bits) - 1)


def extract_lanes(cfg: AddPackConfig, p) -> torch.Tensor:
    """Slice lane fields back out of the accumulator."""
    p = as_int64(p)
    lanes = [_lane(cfg, (p >> off) & ((1 << cfg.lane_widths[i]) - 1), i)
             for i, off in enumerate(cfg.offsets)]
    return torch.stack(lanes, dim=-1)


def lane_add_expected(cfg: AddPackConfig, x, y) -> torch.Tensor:
    """What k standalone narrow adders would produce (wrap per lane)."""
    s = as_int64(x) + as_int64(y)
    cols = [_lane(cfg, s[..., i] & ((1 << cfg.lane_widths[i]) - 1), i)
            for i in range(cfg.n_lanes)]
    return torch.stack(cols, dim=-1)


def packed_lane_add(cfg: AddPackConfig, x, y) -> torch.Tensor:
    """End-to-end: pack both operand vectors, add once, extract lanes."""
    return extract_lanes(cfg, packed_add(cfg, pack_lanes(cfg, x), pack_lanes(cfg, y)))


def accumulate(cfg: AddPackConfig, terms, headroom_bits: int | None = None) -> torch.Tensor:
    """Accumulate ``terms[..., t, lane]`` over ``t`` in the packed adder.

    SNN-style accumulation.  With ``guard_bits = g`` a lane can absorb
    ``2**g`` worst-case carries error-free; accumulation therefore runs in
    chunks of ``2**guard_bits`` packed adds between extractions, and chunk
    results are combined exactly outside the accumulator.
    """
    terms = as_int64(terms)
    chunk = max(2 ** (cfg.guard_bits if headroom_bits is None else headroom_bits), 1)
    steps = terms.shape[-2]
    total = torch.zeros(terms.shape[:-2] + (cfg.n_lanes,), dtype=torch.int64,
                        device=terms.device)
    for start in range(0, steps, chunk):
        acc = torch.zeros(terms.shape[:-2], dtype=torch.int64, device=terms.device)
        for t in range(start, min(start + chunk, steps)):
            acc = packed_add(cfg, acc, pack_lanes(cfg, terms[..., t, :]))
        total = total + extract_lanes(cfg, acc)
    return total
