"""Plain PyTorch versions of the packed arithmetic, and the plan record.

The port's counterpart of ``repro/kernels/ref.py``.  Two compute paths:

* pair-packed "DSP-sim" matmul.  Activations (unsigned, offset-binary) and
  weights (signed) are packed in pairs along K into int32 words; one int32
  multiply per pair puts the pair's dot-product contribution in the middle
  bit field.  ``n_pairs`` words are accumulated before the field is
  extracted.  Multi-column plans split the activation into unsigned
  bit-slices, run one word stream per slice against the same packed
  weights and recombine the extracted fields by shifted summation.
* packed-storage int4 matmul: weights stored two nibbles per byte,
  unpacked by arithmetic shifts and fed to an int8 x int4 dot.

Every function here is bit-exact to the reference's, errors included: the
integer arithmetic is wrapping int32 (torch's int32 ``+``, ``<<`` and ``>>``
wrap and shift arithmetically like XLA's).  The integer dots run in
float64 and are converted back through int64, which is exact because every
legal spec keeps its packed partial sums below 2**31 (far below 2**53), and
which also works on CUDA tensors, where torch has no int32 matmul.  These
are the versions the CUDA kernels are held against on the card.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..analysis import clauses

__all__ = [
    "PackedDotSpec",
    "PackedWeightWords",
    "CORRECTIONS",
    "INT4_EXACT",
    "INT4_NAIVE",
    "INT4_MR_OVERPACKED",
    "INT2_EXACT",
    "min_exact_p",
    "spec_from_name",
    "widen_for_shards",
    "int_dot",
    "extract_accumulated_field",
    "contamination_mask",
    "contamination_terms",
    "slice_column",
    "pack_weight_words",
    "packed_tile_matmul",
    "packed_tile_matmul_prepacked",
    "ref_packed_matmul",
    "ref_packed_matmul_prepacked",
    "ref_quantized_matmul",
    "exact_int_matmul_fits_f32",
    "pack_int4_weights",
    "unpack_int4_weights",
    "ref_int4_matmul",
]

# naive: floor extraction; full: round-half-up, exact for legal specs;
# mr: overpacked spacing + MSB restore; mr+full: restore and round-half-up
CORRECTIONS = ("naive", "full", "mr", "mr+full")


@dataclasses.dataclass(frozen=True)
class PackedDotSpec:
    """Parameters of the pair-packed int32 dot path (field for field the
    reference's ``repro.kernels.ref.PackedDotSpec``).

    ``p`` field spacing in bits; ``n_pairs`` packed products accumulated per
    extraction; ``correction`` one of :data:`CORRECTIONS`; ``mr_bits``
    overlap bits restored by the mr corrections; ``n_columns`` activation
    bit-slices, each with its own packed-word stream against the shared
    weights, recombined as ``sum_j field_j << (j * col_bits_a)``.  Every
    legality budget applies per column.
    """

    bits_a: int = 4
    bits_w: int = 4
    p: int = 11
    n_pairs: int = 4
    correction: str = "full"
    mr_bits: int = 0
    n_columns: int = 1

    def __post_init__(self) -> None:
        if self.correction not in CORRECTIONS:
            raise ValueError(
                f"bad correction {self.correction!r}; options: {CORRECTIONS}"
            )
        if self.bits_a < 1 or self.bits_w < 2:
            raise ValueError(
                f"operand widths too narrow: bits_a={self.bits_a} (min 1), "
                f"bits_w={self.bits_w} (min 2, signed)"
            )
        if self.n_pairs < 1 or self.p < 1:
            raise ValueError(f"n_pairs={self.n_pairs} and p={self.p} must be >= 1")
        if self.n_columns < 1 or self.n_columns > self.bits_a:
            raise ValueError(
                f"n_columns={self.n_columns} must be in [1, bits_a="
                f"{self.bits_a}]: every column carries at least one "
                "activation bit"
            )
        if (self.n_columns - 1) * self.col_bits_a >= self.bits_a:
            canonical = -(-self.bits_a // self.col_bits_a)
            raise ValueError(
                f"n_columns={self.n_columns} leaves the last column with no "
                f"activation bits ({self.col_bits_a}-bit slices cover "
                f"bits_a={self.bits_a} with {canonical} columns); use "
                f"n_columns={canonical}"
            )
        if self.uses_mr and self.mr_bits < 1:
            raise ValueError(
                f"correction {self.correction!r} restores overlapped MSBs and "
                "needs mr_bits >= 1"
            )
        if not self.uses_mr and self.mr_bits:
            raise ValueError(
                f"mr_bits={self.mr_bits} is only meaningful with an mr "
                f"correction, not {self.correction!r}"
            )
        # int32 budget per column: high / middle / low result fields of one
        # column's packed word after accumulating n_pairs products
        max_a = (1 << self.col_bits_a) - 1
        max_w = 1 << (self.bits_w - 1)
        top = self.n_pairs * max_a * max_w * (1 << (2 * self.p))
        mid = self.n_pairs * 2 * max_a * max_w * (1 << self.p)
        low = self.n_pairs * max_a * max_w
        total = top + mid + low
        if total >= 1 << 31:
            per_col = " per column" if self.n_columns > 1 else ""
            raise ValueError(
                f"{self._describe()} overflows the int32 accumulator budget: "
                f"the accumulated packed sum spans {total.bit_length()} bits"
                f"{per_col} but the int32 accumulator provides 31 value bits; "
                f"reduce n_pairs (={self.n_pairs}), the field spacing p "
                f"(={self.p}), or raise n_columns (={self.n_columns}) "
                f"[certificate clause: {clauses.CLAUSE_INT32_ACCUMULATOR}]"
            )
        # the accumulated middle field must fit the bits extraction reads
        mid_mag = self.n_pairs * 2 * max_a * max_w
        if mid_mag >= 1 << (self.extract_width - 1):
            need = mid_mag.bit_length() + 1
            if self.uses_mr:
                raise ValueError(
                    f"{self._describe()} overflows the restored middle field: "
                    f"the accumulated dot product needs {need} bits but "
                    f"p + mr_bits = {self.extract_width}; raise p, raise "
                    f"mr_bits or reduce n_pairs "
                    f"[certificate clause: {clauses.CLAUSE_MIDDLE_FIELD}]"
                )
            raise ValueError(
                f"{self._describe()} overflows the middle field: the "
                f"accumulated dot product needs {need} bits but the field "
                f"spacing provides p = {self.p}; raise p, reduce n_pairs or "
                "use an mr correction "
                f"[certificate clause: {clauses.CLAUSE_MIDDLE_FIELD}]"
            )
        # extraction aliasing: the sign extension reads back M + g, g the
        # low field's floor/rounding residue; it must not cross the sign bit
        low_lo = -self.n_pairs * max_a * max_w
        low_hi = self.n_pairs * max_a * (max_w - 1)
        if self.rounds_half_up:
            g_lo = ((low_lo >> (self.p - 1)) + 1) >> 1
            g_hi = ((low_hi >> (self.p - 1)) + 1) >> 1
        else:
            g_lo, g_hi = low_lo >> self.p, low_hi >> self.p
        mid_hi = self.n_pairs * 2 * max_a * (max_w - 1)
        bound = 1 << (self.extract_width - 1)
        if -mid_mag + g_lo < -bound or mid_hi + g_hi > bound - 1:
            raise ValueError(
                f"{self._describe()} aliases under extraction: the dot field "
                f"plus the low-field residue spans "
                f"[{-mid_mag + g_lo}, {mid_hi + g_hi}] but sign-extension at "
                f"p + mr_bits = {self.extract_width} bits only represents "
                f"[{-bound}, {bound - 1}]; raise p or reduce mr_bits "
                f"[certificate clause: {clauses.CLAUSE_EXTRACTION_ALIAS}]"
            )

    def _describe(self) -> str:
        cols = f", n_columns={self.n_columns}" if self.n_columns > 1 else ""
        return (
            f"PackedDotSpec(a{self.bits_a}w{self.bits_w}, p={self.p}, "
            f"n_pairs={self.n_pairs}, {self.correction}{cols})"
        )

    @property
    def uses_mr(self) -> bool:
        return self.correction in ("mr", "mr+full")

    @property
    def rounds_half_up(self) -> bool:
        return self.correction in ("full", "mr+full")

    @property
    def chunk(self) -> int:
        """K elements consumed per extraction group (all columns together)."""
        return 2 * self.n_pairs

    @property
    def col_bits_a(self) -> int:
        """Activation bits per column slice (top slice may carry fewer)."""
        return -(-self.bits_a // self.n_columns)

    def column_shift(self, j: int) -> int:
        """Bit offset of column ``j``'s slice, and so its recombination shift."""
        return j * self.col_bits_a

    @property
    def extract_width(self) -> int:
        return self.p + (self.mr_bits if self.uses_mr else 0)

    @property
    def delta(self) -> int:
        """Per-product padding in the paper's notation: spacing − result
        width (per column: a column's products are col_bits_a × bits_w)."""
        return self.p - (self.col_bits_a + self.bits_w)

    @property
    def provably_exact(self) -> bool:
        """Whether extraction is bit-exact for every operand combination:
        always for ``full``; for ``mr+full`` iff the accumulated low field
        stays within ``2**(p-1)``; never for the biased schemes."""
        if self.correction == "full":
            return True
        if self.correction == "mr+full":
            max_a = (1 << self.col_bits_a) - 1
            max_w = 1 << (self.bits_w - 1)
            return self.n_pairs * max_a * max_w <= 1 << (self.p - 1)
        return False

    def name(self) -> str:
        """Stable plan id, e.g. ``a4w4-p10-n16-mr+full`` or
        ``a8w8-p11-n1-full-c4`` for a column-packed plan."""
        cols = f"-c{self.n_columns}" if self.n_columns > 1 else ""
        return (
            f"a{self.bits_a}w{self.bits_w}-p{self.p}-n{self.n_pairs}"
            f"-{self.correction}{cols}"
        )


INT4_EXACT = PackedDotSpec(bits_a=4, bits_w=4, p=11, n_pairs=4, correction="full")
INT4_NAIVE = PackedDotSpec(bits_a=4, bits_w=4, p=11, n_pairs=4, correction="naive")
INT4_MR_OVERPACKED = PackedDotSpec(
    bits_a=4, bits_w=4, p=10, n_pairs=16, correction="mr+full", mr_bits=3
)
INT2_EXACT = PackedDotSpec(bits_a=2, bits_w=2, p=10, n_pairs=32, correction="full")


def widen_for_shards(spec: PackedDotSpec, n_shards: int) -> PackedDotSpec:
    """The spec an ``n_shards``-way contraction-axis sharding must satisfy.

    A row-parallel linear sums the shards' packed partial words across
    ranks before field extraction (``runtime.tp_packed``), so the summed
    word accumulates ``n_shards * n_pairs`` products per extraction group,
    and every legality budget of :class:`PackedDotSpec` (the int32
    accumulator, the middle-field width, extraction aliasing) must hold at
    that length.  Constructing the widened spec is the legality check: an
    illegal sharding raises the constructor's clause-citing
    ``ValueError``.  Extraction reads ``p``, the extract width and the
    correction, never ``n_pairs``, so extracting the summed word with
    ``spec`` is the widened spec's extraction.
    """
    if n_shards < 1:
        raise ValueError(f"n_shards={n_shards} must be >= 1")
    if n_shards == 1:
        return spec
    try:
        return dataclasses.replace(spec, n_pairs=n_shards * spec.n_pairs)
    except ValueError as e:
        raise ValueError(
            f"{spec.name()} cannot be row-sharded {n_shards} ways: the "
            f"cross-device word-space reduction accumulates "
            f"{n_shards}x{spec.n_pairs} products per extraction group and "
            f"the widened spec is illegal — {e}"
        ) from e


def min_exact_p(a_bits: int, w_bits: int, n_pairs: int,
                n_columns: int = 1) -> int:
    """Smallest spacing whose accumulated middle field never overflows (the
    tuner's rule: one bit more than ``n_pairs * 2 * a_max * |w_min|``)."""
    col_bits_a = -(-a_bits // n_columns)
    max_a = (1 << col_bits_a) - 1
    max_w = 1 << (w_bits - 1)
    return (n_pairs * 2 * max_a * max_w).bit_length() + 1


def spec_from_name(name: str) -> PackedDotSpec:
    """Inverse of :meth:`PackedDotSpec.name` for the plans the tuner emits.

    The name does not carry ``mr_bits``; the tuner squeezes mr plans
    ``mr_bits`` below the exact spacing, so it is ``min_exact_p - p``.
    """
    parts = name.split("-")
    try:
        if len(parts) not in (4, 5) or parts[0][0] != "a" or "w" not in parts[0]:
            raise ValueError
        bits_a, bits_w = (int(v) for v in parts[0][1:].split("w"))
        if parts[1][0] != "p" or parts[2][0] != "n":
            raise ValueError
        p, n_pairs = int(parts[1][1:]), int(parts[2][1:])
        correction = parts[3]
        n_columns = 1
        if len(parts) == 5:
            if parts[4][0] != "c":
                raise ValueError
            n_columns = int(parts[4][1:])
    except (ValueError, IndexError):
        raise ValueError(
            f"plan name {name!r} is not of the form aAwW-pP-nN-CORRECTION[-cC]"
        ) from None
    mr_bits = 0
    if correction in ("mr", "mr+full"):
        mr_bits = min_exact_p(bits_a, bits_w, n_pairs, n_columns) - p
    return PackedDotSpec(bits_a, bits_w, p, n_pairs, correction, mr_bits,
                         n_columns)


def int_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact integer ``a @ b`` (batched like ``torch.matmul``) as int32.

    Runs in float64, which is exact while every partial sum stays below
    2**53 (the int32 budget of every legal spec keeps it below 2**31), and
    wraps into int32 through int64 like an int32 dot would."""
    out = torch.matmul(a.to(torch.float64), b.to(torch.float64))
    return out.to(torch.int64).to(torch.int32)


def _sext(v: torch.Tensor, width: int) -> torch.Tensor:
    mask = (1 << width) - 1
    sign = 1 << (width - 1)
    return ((v & mask) ^ sign) - sign


def contamination_mask(spec: PackedDotSpec) -> int:
    """Bit mask of the high-field LSBs that corrupt an overpacked middle field."""
    return (1 << spec.mr_bits) - 1


def contamination_terms(xa: torch.Tensor, ws: torch.Tensor,
                        spec: PackedDotSpec) -> torch.Tensor:
    """The high field's LSBs that leaked into the squeezed middle field, for
    every extraction group: ``sum a_odd * w_even mod 2**mr_bits``.

    ``xa``: (m, n_chunks, n_pairs, 2); ``ws``: (n_chunks, n_pairs, 2, n);
    returns (n_chunks, m, n).
    """
    mask = contamination_mask(spec)
    a_odd = (xa[..., 1] & mask).permute(1, 0, 2)   # (n_chunks, m, n_pairs)
    w_even = ws[..., 0, :] & mask                  # (n_chunks, n_pairs, n)
    return int_dot(a_odd, w_even) & mask


def extract_accumulated_field(
    partial: torch.Tensor, spec: PackedDotSpec,
    contam: torch.Tensor | None = None,
) -> torch.Tensor:
    """Extract the accumulated middle (dot-product) field of a packed sum:
    floor or round-half-up, sign-extend at ``extract_width``, and for mr
    plans subtract the contamination at the top ``mr_bits``."""
    we = spec.extract_width
    if spec.rounds_half_up:
        t = ((partial >> (spec.p - 1)) + 1) >> 1
    else:
        t = partial >> spec.p
    e = _sext(t, we)
    if spec.uses_mr:
        if contam is None:
            raise ValueError("mr extraction needs the contamination term")
        e = _sext(e - (contam << (we - spec.mr_bits)), we)
    return e


def slice_column(x_u: torch.Tensor, spec: PackedDotSpec, j: int) -> torch.Tensor:
    """Column ``j``'s unsigned activation bit-slice (col_bits_a bits)."""
    if spec.n_columns == 1:
        return x_u.to(torch.int32)
    mask = (1 << spec.col_bits_a) - 1
    return (x_u.to(torch.int32) >> spec.column_shift(j)) & mask


class PackedWeightWords(NamedTuple):
    """Weights packed once for reuse across many packed matmuls.

    ``words``: (n_chunks, n_pairs, n) int32, each pair's packed word
    ``w_odd + (w_even << p)``.  ``wsc``: (n_chunks, n_pairs, 2, n) int32
    paired weights for the mr contamination, ``None`` for other plans.
    """

    words: torch.Tensor
    wsc: torch.Tensor | None

    @property
    def k(self) -> int:
        """Contraction length the words cover (a multiple of the chunk)."""
        return self.words.shape[-3] * 2 * self.words.shape[-2]


def _pad_rows(t: torch.Tensor, pad: int) -> torch.Tensor:
    return torch.nn.functional.pad(t, (0, 0, 0, pad)) if pad else t


def pack_weight_words(w_s: torch.Tensor, spec: PackedDotSpec) -> PackedWeightWords:
    """(k, n) signed ints -> :class:`PackedWeightWords`; ragged ``k`` is
    zero-padded to whole extraction chunks (zero pairs are bit-transparent)."""
    k, n = w_s.shape
    pad = (-k) % spec.chunk
    ws = _pad_rows(w_s.to(torch.int32), pad)
    k += pad
    n_chunks = k // spec.chunk
    ws = ws.reshape(k // 2, 2, n)
    words = (ws[:, 1, :] + (ws[:, 0, :] << spec.p)).reshape(
        n_chunks, spec.n_pairs, n
    )
    wsc = ws.reshape(n_chunks, spec.n_pairs, 2, n) if spec.uses_mr else None
    return PackedWeightWords(words, wsc)


def packed_tile_matmul_prepacked(
    x_u: torch.Tensor,
    words: torch.Tensor,
    wsc: torch.Tensor | None,
    spec: PackedDotSpec,
) -> torch.Tensor:
    """The compute stage: packed weight words x unsigned activations.

    ``x_u``: (m, k) with ``k = n_chunks * spec.chunk``.  Per column: pack
    the activation slice's pair words, contract every extraction group in
    one chunk-batched dot, extract each group's field, sum the fields in
    wrapping int32 and recombine at the slice offset.
    """
    m, k = x_u.shape
    n_chunks, n_pairs, n = words.shape
    if spec.uses_mr and wsc is None:
        raise ValueError(
            f"{spec.name()} is an mr plan: the prepacked compute stage needs "
            "the contamination operands (pack_weight_words builds them)"
        )
    acc = torch.zeros((m, n), dtype=torch.int32, device=words.device)
    for j in range(spec.n_columns):
        xa = slice_column(x_u, spec, j).reshape(m, k // 2, 2)
        a_words = (xa[:, :, 0] + (xa[:, :, 1] << spec.p)).reshape(
            m, n_chunks, spec.n_pairs
        )
        partial = int_dot(a_words.permute(1, 0, 2), words)  # (n_chunks, m, n)
        contam = (
            contamination_terms(
                xa.reshape(m, n_chunks, spec.n_pairs, 2), wsc, spec
            )
            if spec.uses_mr else None
        )
        field = extract_accumulated_field(partial, spec, contam)
        col = field.sum(dim=0, dtype=torch.int64).to(torch.int32)
        shift = spec.column_shift(j)
        acc = acc + (col << shift if shift else col)
    return acc


def packed_tile_matmul(x_u: torch.Tensor, w_s: torch.Tensor,
                       spec: PackedDotSpec) -> torch.Tensor:
    """Pack + compute in one call: (m, k) unsigned x (k, n) signed -> (m, n)
    int32, ``k`` a multiple of ``spec.chunk``."""
    packed = pack_weight_words(w_s, spec)
    return packed_tile_matmul_prepacked(x_u, packed.words, packed.wsc, spec)


def _pad_cols(t: torch.Tensor, pad: int) -> torch.Tensor:
    return torch.nn.functional.pad(t, (0, pad)) if pad else t


def ref_packed_matmul(
    x_u: torch.Tensor, w_s: torch.Tensor, spec: PackedDotSpec = INT4_EXACT
) -> torch.Tensor:
    """Plain version of the pair-packed kernel: (M, K) unsigned ints x
    (K, N) signed ints -> (M, N) int32.  Ragged K is zero-padded to the
    chunk (bit-transparent)."""
    pad = (-x_u.shape[1]) % spec.chunk
    x_u = _pad_cols(x_u.to(torch.int32), pad)
    w_s = _pad_rows(w_s.to(torch.int32), pad)
    return packed_tile_matmul(x_u, w_s, spec)


def ref_packed_matmul_prepacked(
    x_u: torch.Tensor,
    packed: PackedWeightWords,
    spec: PackedDotSpec = INT4_EXACT,
) -> torch.Tensor:
    """Plain prepacked matmul off :func:`pack_weight_words` output;
    ``x_u``'s K is zero-padded up to the words' chunk grid."""
    k = x_u.shape[1]
    pad = packed.k - k
    if pad < 0:
        raise ValueError(
            f"activation K={k} exceeds the packed weights' K={packed.k}"
        )
    x_u = _pad_cols(x_u.to(torch.int32), pad)
    return packed_tile_matmul_prepacked(x_u, packed.words, packed.wsc, spec)


def ref_quantized_matmul(x_u: torch.Tensor, w_s: torch.Tensor) -> torch.Tensor:
    """The mathematically exact unsigned×signed integer matmul (int32)."""
    return int_dot(x_u.to(torch.int32), w_s.to(torch.int32))


def exact_int_matmul_fits_f32(k: int, max_a: int, max_w: int) -> bool:
    """Whether an integer matmul with |a| <= max_a, |w| <= max_w over a
    K-long contraction is exact in f32 (every partial sum below 2**24)."""
    return k * max_a * max_w < 1 << 24


# ---- packed-storage int4 -------------------------------------------------


def pack_int4_weights(w_s: torch.Tensor) -> torch.Tensor:
    """(K, N) int4 values -> (K//2, N) uint8, two nibbles per byte (row 2i
    in the low nibble)."""
    w = w_s.to(torch.int8)
    if w.shape[0] % 2:
        raise ValueError("K must be even to pack nibbles")
    lo = w[0::2] & 0xF
    hi = w[1::2] & 0xF
    return (lo | (hi << 4)).to(torch.uint8)


def unpack_int4_weights(packed: torch.Tensor) -> torch.Tensor:
    """(K//2, N) uint8 -> (K, N) int8 with sign-extended nibbles."""
    b = packed.view(torch.int8)
    lo = (b << 4) >> 4  # arithmetic shifts sign-extend the nibbles
    hi = b >> 4
    k2, n = packed.shape
    return torch.stack([lo, hi], dim=1).reshape(2 * k2, n)


def ref_int4_matmul(x_q: torch.Tensor, w_packed: torch.Tensor) -> torch.Tensor:
    """Plain version of the int4 kernel: unpack, then exact integer matmul."""
    return int_dot(x_q, unpack_int4_weights(w_packed))
