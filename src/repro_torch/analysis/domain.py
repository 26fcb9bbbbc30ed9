"""Sound integer interval domain for the packing algebra.

The port's own copy of the reference's ``repro.analysis.domain`` (the port
imports nothing of the reference); the arithmetic is the same, line for
line.

The packing pipeline is built from a small set of integer primitives —
shift-pack, widening multiply, wrap-around accumulate, field extraction by
floor or round-half-up shift, sign extension, lane adds — and every one of
them is either *monotone* (shifts, adds, scaling) or has its extrema on
operand corners (products).  :class:`Interval` therefore admits **exact**
abstract transfer functions: each operation maps interval endpoints to the
true extrema of the concrete image, so the verifier's bounds are not just
sound over-approximations but the tightest interval containing every
reachable value.  (Tightness of a *composition* additionally needs the
corner-achieving operand assignments of its stages to coincide — the
verifier documents that argument per pipeline, and its witnesses prove it
constructively.)

Arithmetic is arbitrary-precision Python int throughout; wrap-around
hardware widths are modeled explicitly via :meth:`Interval.fits_signed` /
:meth:`Interval.wrap_signed`, mirroring how the int32 lanes and bit fields
behave rather than assuming they never overflow.
"""

from __future__ import annotations

import dataclasses

__all__ = ["Interval"]


@dataclasses.dataclass(frozen=True)
class Interval:
    """A closed integer interval ``[lo, hi]`` (both ends inclusive)."""

    lo: int
    hi: int

    def __post_init__(self) -> None:
        if self.lo > self.hi:
            raise ValueError(f"empty interval: lo={self.lo} > hi={self.hi}")

    # -- constructors -----------------------------------------------------

    @classmethod
    def point(cls, v: int) -> "Interval":
        return cls(v, v)

    @classmethod
    def signed(cls, bits: int) -> "Interval":
        """Two's-complement value range of a ``bits``-wide field."""
        return cls(-(1 << (bits - 1)), (1 << (bits - 1)) - 1)

    @classmethod
    def unsigned(cls, bits: int) -> "Interval":
        return cls(0, (1 << bits) - 1)

    # -- exact transfer functions -----------------------------------------

    def __add__(self, other: "Interval | int") -> "Interval":
        if isinstance(other, int):
            other = Interval.point(other)
        return Interval(self.lo + other.lo, self.hi + other.hi)

    __radd__ = __add__

    def __neg__(self) -> "Interval":
        return Interval(-self.hi, -self.lo)

    def __sub__(self, other: "Interval | int") -> "Interval":
        if isinstance(other, int):
            other = Interval.point(other)
        return Interval(self.lo - other.hi, self.hi - other.lo)

    def __mul__(self, other: "Interval | int") -> "Interval":
        """Widening multiply: extrema sit on the four operand corners."""
        if isinstance(other, int):
            other = Interval.point(other)
        corners = (
            self.lo * other.lo, self.lo * other.hi,
            self.hi * other.lo, self.hi * other.hi,
        )
        return Interval(min(corners), max(corners))

    __rmul__ = __mul__

    def sum_n(self, n: int) -> "Interval":
        """Accumulate ``n`` independent draws from this interval (each term
        ranges over the full interval, so endpoints simply scale)."""
        if n < 0:
            raise ValueError(f"sum_n needs n >= 0, got {n}")
        return Interval(self.lo * n, self.hi * n)

    def shl(self, k: int) -> "Interval":
        """Shift-pack: place the value ``k`` bits up (exact scaling)."""
        return Interval(self.lo << k, self.hi << k)

    def ashr(self, k: int) -> "Interval":
        """Arithmetic right shift == floor division by ``2**k``.

        Floor division is monotone nondecreasing, so endpoint images are
        the exact extrema — this is the ``naive`` field extraction."""
        return Interval(self.lo >> k, self.hi >> k)

    def round_half_up(self, k: int) -> "Interval":
        """Round-half-up extraction of the paper's Full Error Correction
        (Eqn. 7): ``floor((floor(v / 2**(k-1)) + 1) / 2)``.  A composition
        of monotone steps, hence endpoint-exact like :meth:`ashr`."""
        if k < 1:
            raise ValueError(f"round_half_up needs k >= 1, got {k}")
        return (self.ashr(k - 1) + 1).ashr(1)

    # -- width / wrap predicates ------------------------------------------

    def fits_signed(self, bits: int) -> bool:
        rng = Interval.signed(bits)
        return rng.lo <= self.lo and self.hi <= rng.hi

    def wrap_signed(self, bits: int) -> "Interval":
        """Model a two's-complement wrap at ``bits``: the identity when the
        value provably fits, the full field range otherwise (a wrap can
        land anywhere, so the sound result is the whole field)."""
        return self if self.fits_signed(bits) else Interval.signed(bits)

    def contains(self, v: int) -> bool:
        return self.lo <= v <= self.hi

    @property
    def magnitude(self) -> int:
        """Largest absolute value in the interval (the WCE of an error
        interval)."""
        return max(abs(self.lo), abs(self.hi))

    @property
    def is_zero(self) -> bool:
        return self.lo == 0 and self.hi == 0

    def __repr__(self) -> str:
        return f"[{self.lo}, {self.hi}]"
