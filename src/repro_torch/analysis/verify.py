"""Abstract-interpretation certificates for packing plans.

The paper's legality and error properties are *static*: contamination,
sign-extension aliasing and accumulator overflow are fully determined by a
plan's bit widths, offsets, accumulation count and correction scheme.  This
module walks each of the repo's three compute models symbolically with the
interval domain of :mod:`.domain` and emits a machine-checkable
:class:`PlanCertificate` per plan:

* :func:`certify_spec` — the pair-packed int32 dot path
  (:class:`~repro_torch.kernels.ref.PackedDotSpec`).  The packed word is
  ``L + M·2^p + H·2^2p`` with ``L = Σ a_even·w_odd`` (low field),
  ``M = Σ (a_even·w_even + a_odd·w_odd)`` (the wanted dot contribution) and
  ``H = Σ a_odd·w_even``; the ONLY error source after the legality clauses
  hold is the low field's floor/rounding residue
  ``g = floor(L/2^p)`` (naive/mr) or ``floor((floor(L/2^(p-1))+1)/2)``
  (full/mr+full), because the MR restore identity
  ``sext(t − c·2^p, p+mr) = sext(M + g, p+mr)`` cancels the high field's
  contamination exactly (mod ``2^(p+mr)``).  Interval endpoints of ``g``
  are *achieved* — the minimizers of ``L`` and ``M`` coincide (all
  activations at max, all weights at one extreme) — so the certified WCE
  is tight and every bounded certificate carries a :class:`SpecWitness`
  realizing it.  Mean error is derived by exact convolution of the
  single-product distribution (operands at distinct K positions are
  independent), reproducing e.g. the paper's MAE≈0.37 naive diagnosis
  analytically.

* :func:`certify_config` — the DSP48 outer-product model
  (:class:`~repro_torch.core.packing.PackingConfig` under a
  ``core.correction`` scheme).  Fields share operands (field ``(i, j)``
  reuses ``a_i`` and ``w_j``), so per-field error intervals come from the
  cumulative-lower-value recursion (sound, and corner-tight because the
  all-max/all-min operand assignment minimizes every product at once);
  exact MAE/EP additionally comes from complete operand-space enumeration
  when the space is small (a finite proof — the paper's 4-bit tables are
  ``16^4``–``16^5`` points).

* :func:`certify_addpack` — addition packing
  (:class:`~repro_torch.core.addpack.AddPackConfig`): an interval carry walk up
  the lanes.  One guard bit absorbs the single-add carry (exact); with no
  guards the carry corrupts the victim lane's LSB — error 1 *modulo the
  lane width* (Table III), which two's-complement wrap can turn into a
  sign flip, so the field-wrap clause fails for guard-0 signed lanes.

The port's copy of the reference's ``repro.analysis.verify``: the same
derivations on the port's packing modules, so that every certificate's
``to_json`` equals the reference's field for field.  The spec path is
numpy and Python integers; the config path's enumeration runs int64
tensors on the device it is given (default the card, as the paper
modules' entry points).  Certificates are consumed by ``tuning.score`` and
``tuning.tuner`` (the budget-0 "provably exact" filter and the
sampled-zero replacement), ``core.packed_params.DspTunedLeaf.exact`` and
the command line (``python -m repro_torch.analysis.verify``).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..core.addpack import AddPackConfig
from ..core.correction import (
    SCHEMES,
    error_stats,
    exhaustive_operands,
    simulate,
)
from ..core.packing import PackingConfig, outer_product_exact
from ..kernels.ref import PackedDotSpec
from . import clauses as C
from .domain import Interval

__all__ = [
    "ClauseCheck",
    "StageBound",
    "SpecWitness",
    "PlanCertificate",
    "certify_spec",
    "certify_config",
    "certify_addpack",
    "witness_operands",
    "config_name",
]

# Complete operand-space enumeration (the finite proof backing a config
# certificate's exact MAE/EP) is capped here; the paper's 4-bit tables are
# 16^4..16^5 = 2^16..2^20 points, all inside the cap.
ENUMERATION_LIMIT = 1 << 20


@dataclasses.dataclass(frozen=True)
class ClauseCheck:
    """One legality clause verdict with its recorded derivation."""

    clause: str
    ok: bool
    detail: str

    def to_json(self) -> dict:
        return {"clause": self.clause, "ok": self.ok, "detail": self.detail}


@dataclasses.dataclass(frozen=True)
class StageBound:
    """The interval derived for one pipeline stage (the proof record)."""

    stage: str
    lo: int
    hi: int
    note: str = ""

    def to_json(self) -> dict:
        return {"stage": self.stage, "lo": self.lo, "hi": self.hi,
                "note": self.note}


@dataclasses.dataclass(frozen=True)
class SpecWitness:
    """Operand pattern achieving a spec certificate's WCE exactly.

    Tiled along K: activations ``x_even`` at even positions / ``x_odd`` at
    odd, weights ``w_even`` / ``w_odd`` likewise.  With ``x_odd = 0`` and
    ``w_even = 0`` the dot field ``M`` and high field ``H`` vanish, so the
    observed output error IS the low-field residue at its interval
    endpoint — ``per_extraction_error`` per extraction, for every
    extraction and every column simultaneously (slices of an all-ones
    activation are all-ones)."""

    x_even: int
    x_odd: int
    w_even: int
    w_odd: int
    per_extraction_error: int

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class PlanCertificate:
    """Machine-checkable legality + error certificate for one plan.

    ``verdict`` is ``"exact"`` (provably zero error for every in-range
    operand) or ``"bounded"`` (sound worst-case error per extraction in
    ``wce_per_extraction``).  ``derivation`` records how the numbers were
    proved: ``"interval"`` transfer functions, ``"interval+convolution"``
    (intervals for WCE, exact distribution convolution for MAE/EP) or
    ``"enumeration"`` (complete operand-space enumeration).  ``mae_kind``
    qualifies ``mae_per_extraction``: ``"exact"`` expectation, a sound
    upper ``"bound"`` (multi-column recombination uses the triangle
    inequality), or ``"unavailable"``.
    """

    plan: str
    model: str          # "spec" | "config" | "addpack"
    verdict: str        # "exact" | "bounded"
    derivation: str
    wce_per_extraction: int
    mae_per_extraction: float | None
    mae_kind: str
    ep_per_extraction: float | None
    clauses: tuple[ClauseCheck, ...]
    stages: tuple[StageBound, ...]
    witness: SpecWitness | None = None
    max_safe_k: int | None = None

    @property
    def exact(self) -> bool:
        return self.verdict == "exact"

    @property
    def ok(self) -> bool:
        """All legality clauses hold (independent of exact vs bounded)."""
        return all(c.ok for c in self.clauses)

    @property
    def failed_clauses(self) -> tuple[str, ...]:
        return tuple(c.clause for c in self.clauses if not c.ok)

    def summary(self) -> str:
        if self.exact:
            return f"{self.plan}: exact ({self.derivation})"
        mae = (f" mae/extraction<={self.mae_per_extraction:.4f}"
               if self.mae_per_extraction is not None else "")
        bad = (f" FAILED={','.join(self.failed_clauses)}"
               if not self.ok else "")
        return (f"{self.plan}: bounded wce/extraction="
                f"{self.wce_per_extraction}{mae}{bad}")

    def to_json(self) -> dict:
        return {
            "plan": self.plan,
            "model": self.model,
            "verdict": self.verdict,
            "derivation": self.derivation,
            "wce_per_extraction": self.wce_per_extraction,
            "mae_per_extraction": self.mae_per_extraction,
            "mae_kind": self.mae_kind,
            "ep_per_extraction": self.ep_per_extraction,
            "clauses": [c.to_json() for c in self.clauses],
            "stages": [s.to_json() for s in self.stages],
            "witness": self.witness.to_json() if self.witness else None,
            "max_safe_k": self.max_safe_k,
        }

    def to_json_summary(self) -> dict:
        """Compact verdict for benchmark rows (BENCH_tuning.json)."""
        return {
            "verdict": self.verdict,
            "wce_per_extraction": self.wce_per_extraction,
            "mae_per_extraction": self.mae_per_extraction,
            "mae_kind": self.mae_kind,
        }


# ---------------------------------------------------------------------------
# pair-packed dot path (PackedDotSpec)
# ---------------------------------------------------------------------------


def _column_slice_bits(spec: PackedDotSpec) -> tuple[int, ...]:
    """True per-column activation slice widths (top slice may be narrower
    than ``col_bits_a`` — the constructor's conservative width)."""
    cb = spec.col_bits_a
    return tuple(
        min(cb, spec.bits_a - j * cb) for j in range(spec.n_columns)
    )


def _extraction_residue(spec: PackedDotSpec, low: Interval) -> Interval:
    """The extraction error as a function of the accumulated low field —
    the single non-exact stage of the dot path (see module docstring)."""
    if spec.rounds_half_up:
        return low.round_half_up(spec.p)
    return low.ashr(spec.p)


def _convolve_pmfs(base: np.ndarray, n: int) -> np.ndarray:
    """``base`` convolved with itself ``n`` times (binary exponentiation)."""
    out: np.ndarray | None = None
    cur = base
    while n:
        if n & 1:
            out = cur if out is None else np.convolve(out, cur)
        n >>= 1
        if n:
            cur = np.convolve(cur, cur)
    assert out is not None
    return out


def _low_field_distribution(
    amax: int, bits_w: int, n_pairs: int
) -> tuple[np.ndarray, np.ndarray]:
    """Exact pmf of ``L = Σ_{i<n_pairs} a_i·w_i`` over uniform operands.

    The ``a_i``/``w_i`` sit at distinct K positions, so the terms are
    independent and the sum's distribution is the n-fold convolution of the
    single-product distribution — this is what makes the dot path's MAE a
    closed-form derivation rather than a sampled estimate."""
    wmin, wmax = -(1 << (bits_w - 1)), (1 << (bits_w - 1)) - 1
    base = np.zeros(amax * wmax - amax * wmin + 1)
    off = -amax * wmin
    for a in range(amax + 1):
        for wv in range(wmin, wmax + 1):
            base[a * wv + off] += 1.0
    base /= base.sum()
    pmf = _convolve_pmfs(base, n_pairs)
    values = np.arange(pmf.size, dtype=np.int64) + n_pairs * amax * wmin
    return values, pmf


def _column_error_moments(
    spec: PackedDotSpec, slice_bits: int
) -> tuple[float, float]:
    """(E|g|, P(g != 0)) of one column's per-extraction residue."""
    amax = (1 << slice_bits) - 1
    values, pmf = _low_field_distribution(amax, spec.bits_w, spec.n_pairs)
    if spec.rounds_half_up:
        g = ((values >> np.int64(spec.p - 1)) + np.int64(1)) >> np.int64(1)
    else:
        g = values >> np.int64(spec.p)
    return float(pmf @ np.abs(g)), float(pmf[g != 0].sum())


@functools.lru_cache(maxsize=None)
def certify_spec(spec: PackedDotSpec) -> PlanCertificate:
    """Certificate for a pair-packed dot plan (see module docstring)."""
    w_iv = Interval.signed(spec.bits_w)
    we = spec.extract_width
    stages: list[StageBound] = []
    clauses: list[ClauseCheck] = []

    slice_bits = _column_slice_bits(spec)
    col_residues: list[Interval] = []
    col_mae: list[float] = []
    col_ep: list[float] = []
    alias_ok = True
    for j, sb in enumerate(slice_bits):
        a_iv = Interval.unsigned(sb)
        prod = a_iv * w_iv
        low = prod.sum_n(spec.n_pairs)
        mid = prod.sum_n(2 * spec.n_pairs)
        high = low
        residue = _extraction_residue(spec, low)
        pre = mid + residue
        if not pre.fits_signed(we):
            # the residue pushes the read-back value past the signed
            # extract width: the sign-extension wraps and the field error
            # is only bounded by the field range (sound fallback — the
            # spec constructor rejects such layouts, so this is defensive)
            alias_ok = False
            residue = Interval.signed(we) - mid
        col_residues.append(residue)
        mae_j, ep_j = _column_error_moments(spec, sb)
        col_mae.append(mae_j)
        col_ep.append(ep_j)
        if j == 0:
            # column 0 carries the widest slice: its intervals dominate
            # every other column, so the clause checks recorded below
            # cover the whole plan
            partial = low + mid.shl(spec.p) + high.shl(2 * spec.p)
            stages.extend([
                StageBound("pack-activations", a_iv.lo, a_iv.hi,
                           f"unsigned {sb}-bit slice"),
                StageBound("pack-weights", w_iv.lo, w_iv.hi,
                           f"signed {spec.bits_w}-bit"),
                StageBound("widening-multiply", prod.lo, prod.hi,
                           "one packed product a·w"),
                StageBound("accumulate-low", low.lo, low.hi,
                           f"L = sum of {spec.n_pairs} low products"),
                StageBound("accumulate-mid", mid.lo, mid.hi,
                           f"M = sum of {2 * spec.n_pairs} dot products"),
                StageBound("packed-word", partial.lo, partial.hi,
                           "L + M<<p + H<<2p before the int32 wrap"),
                StageBound("extract-residue", residue.lo, residue.hi,
                           ("round-half-up" if spec.rounds_half_up
                            else "floor") + " low-field residue g"),
                StageBound("restored-field", pre.lo, pre.hi,
                           f"M + g entering sign-extension at {we} bits"),
            ])
            clauses.append(ClauseCheck(
                C.CLAUSE_INT32_ACCUMULATOR, partial.fits_signed(32),
                f"accumulated packed sum {partial} within signed 32-bit",
            ))
            clauses.append(ClauseCheck(
                C.CLAUSE_MIDDLE_FIELD, mid.fits_signed(we),
                f"accumulated dot field {mid} within signed {we}-bit "
                "extract width",
            ))
            clauses.append(ClauseCheck(
                C.CLAUSE_EXTRACTION_ALIAS, alias_ok,
                f"M + g = {pre} within signed {we}-bit — the floor/rounding "
                "residue cannot alias into the sign bit",
            ))
            clauses.append(ClauseCheck(
                C.CLAUSE_COLUMN_COVERAGE, slice_bits[-1] >= 1,
                f"column slices {slice_bits} each carry >= 1 activation bit",
            ))

    err = Interval.point(0)
    for j, residue in enumerate(col_residues):
        err = err + residue.shl(spec.column_shift(j))
    stages.append(StageBound(
        "recombined-error", err.lo, err.hi,
        "sum of per-column residues << column_shift, per extraction",
    ))
    wce = err.magnitude
    exact = err.is_zero and alias_ok

    mae = sum(m * (1 << spec.column_shift(j)) for j, m in enumerate(col_mae))
    ep = min(1.0, sum(col_ep))
    mae_kind = "exact" if spec.n_columns == 1 else "bound"
    if not alias_ok:
        mae, ep, mae_kind = None, None, "unavailable"
    if exact:
        mae, ep, mae_kind = 0.0, 0.0, "exact"

    # output accumulation: the recombined int32 output holds the true dot
    # plus at most wce per extraction — certify the contraction length it
    # stays representable for
    amax_full = (1 << spec.bits_a) - 1
    wmag = 1 << (spec.bits_w - 1)
    per_chunk = spec.chunk * amax_full * wmag + wce
    max_safe_k = ((1 << 31) - 1) // per_chunk * spec.chunk
    clauses.append(ClauseCheck(
        C.CLAUSE_OUTPUT_ACCUMULATOR, True,
        f"true dot + certified error fits int32 up to k = {max_safe_k}",
    ))

    witness = None
    if not exact and alias_ok:
        # g is monotone in L; L is minimized by (a_even=max, w_odd=w_min)
        # and maximized by w_odd=w_max, simultaneously for every column and
        # every extraction — so the endpoint of larger magnitude is
        # realized by one constant operand pattern
        w_extreme = w_iv.lo if -err.lo >= err.hi else w_iv.hi
        witness = SpecWitness(
            x_even=amax_full, x_odd=0, w_even=0, w_odd=w_extreme,
            per_extraction_error=err.lo if -err.lo >= err.hi else err.hi,
        )

    return PlanCertificate(
        plan=spec.name(),
        model="spec",
        verdict="exact" if exact else "bounded",
        derivation="interval" if exact else "interval+convolution",
        wce_per_extraction=wce,
        mae_per_extraction=mae,
        mae_kind=mae_kind,
        ep_per_extraction=ep,
        clauses=tuple(clauses),
        stages=tuple(stages),
        witness=witness,
        max_safe_k=max_safe_k,
    )


def witness_operands(
    spec: PackedDotSpec, n_extractions: int = 1, rows: int = 1, cols: int = 1
) -> tuple[np.ndarray, np.ndarray]:
    """Materialize a bounded plan's :class:`SpecWitness` as matmul operands
    ``(x (rows, K), w (K, cols))`` with ``K = chunk · n_extractions``; the
    packed matmul's error on them is exactly
    ``n_extractions · witness.per_extraction_error`` in every output cell."""
    cert = certify_spec(spec)
    if cert.witness is None:
        raise ValueError(f"{spec.name()} is certified exact: no witness")
    wit = cert.witness
    k = spec.chunk * n_extractions
    x = np.full((rows, k), wit.x_odd, dtype=np.int32)
    x[:, 0::2] = wit.x_even
    w = np.full((k, cols), wit.w_even, dtype=np.int32)
    w[1::2, :] = wit.w_odd
    return x, w


# ---------------------------------------------------------------------------
# DSP48 outer-product model (PackingConfig)
# ---------------------------------------------------------------------------


def config_name(cfg: PackingConfig, scheme: str) -> str:
    """Stable plan id for a (config, scheme) pair, e.g.
    ``cfg-a4x4x4-w4-d-2-mr``."""
    aw = "x".join(str(w) for w in cfg.a_widths)
    ww = "x".join(str(w) for w in cfg.w_widths)
    return f"cfg-a{aw}-w{ww}-d{cfg.delta}-{scheme}"


@functools.lru_cache(maxsize=None)
def certify_config(
    cfg: PackingConfig,
    scheme: str,
    enumeration_limit: int = ENUMERATION_LIMIT,
    device: str = "cuda",
) -> PlanCertificate:
    """Certificate for a DSP48 outer-product packing under ``scheme``.

    Walks the result fields in offset order.  Field ``n``'s extraction
    reads ``floor(P / 2^off_n)`` (or the round-half-up variant), so its
    error decomposes into (a) the floor/rounding residue of the cumulative
    lower fields ``C_n = Σ_{m<n} r_m·2^off_m``, (b) unrestored overlap
    contamination from fields above (δ < 0), and (c) for ``approx`` the
    anticipated-sign bias bits.  The MR restore cancels the immediate
    neighbour's overlap exactly (mod ``2^width``), so for the mr schemes
    only non-adjacent reach (the contamination-reach clause) contaminates.
    The resulting interval is corner-tight (the all-max/all-min operand
    assignment minimizes every ``r_m`` at once); complete enumeration — a
    finite proof — refines MAE/EP/WCE to exact values when the operand
    space fits ``enumeration_limit`` and cross-checks interval soundness;
    the enumeration runs on ``device`` (default the card).
    """
    if scheme not in SCHEMES:
        raise ValueError(f"unknown scheme {scheme!r}; options: {SCHEMES}")
    uses_mr = scheme in ("mr", "mr+full")
    rhu = scheme in ("full", "mr+full")
    order = sorted(range(cfg.n_results), key=lambda n: (cfg.r_offsets[n], n))
    r_iv = []
    for n in range(cfg.n_results):
        i, j = cfg.result_operands(n)
        r_iv.append(
            Interval.unsigned(cfg.a_widths[i]) * Interval.signed(cfg.w_widths[j])
        )

    reach_ok = True
    wrap_ok = True
    stages: list[StageBound] = []
    field_err: dict[int, Interval] = {}
    for rank, n in enumerate(order):
        off, width = cfg.r_offsets[n], cfg.r_widths[n]
        cum = Interval.point(0)
        for m in order[:rank]:
            cum = cum + r_iv[m].shl(cfg.r_offsets[m])
        if scheme == "approx":
            # anticipated sign bits below this field ride inside the
            # cumulative lower value (they were added to the C port)
            for mrank in range(1, rank):
                cum = cum + Interval(0, 1).shl(cfg.r_offsets[order[mrank]])
        if off == 0:
            residue = Interval.point(0)
        elif rhu:
            residue = cum.round_half_up(off)
        else:
            residue = cum.ashr(off)
        err = residue
        if scheme == "approx" and rank >= 1:
            err = err + Interval(0, 1)  # this field's own anticipated bit
        for step, mrank in enumerate(range(rank + 1, len(order)), start=1):
            m = order[mrank]
            d = cfg.r_offsets[m] - off
            if d >= width:
                continue  # no overlap into this field
            if step >= 2:
                reach_ok = False  # beyond the MR restore's regime
            if uses_mr and step == 1:
                continue  # immediate neighbour: restored exactly (Eqns. 8/9)
            err = err + Interval.unsigned(width - d).shl(d)
            if scheme == "approx":
                err = err + Interval(0, 1).shl(d)  # its anticipated bit too
        if not (r_iv[n] + err).fits_signed(width):
            wrap_ok = False
            err = Interval.signed(width) - r_iv[n]
        field_err[n] = err
        stages.append(StageBound(
            f"field{n}@+{off}", err.lo, err.hi,
            f"width {width}, product {r_iv[n]}, cumulative-lower {cum}",
        ))

    clauses = [
        ClauseCheck(
            C.CLAUSE_DSP48_PORTS, cfg.fits_dsp48(),
            "packed operands and product within the DSP48E2 port budgets",
        ),
        ClauseCheck(
            C.CLAUSE_PRODUCT_WIDTH, cfg.product_bits() <= 63,
            f"product spans {cfg.product_bits()} bits (int64 simulation "
            "provides 63)",
        ),
        ClauseCheck(
            C.CLAUSE_CONTAMINATION_REACH, reach_ok,
            "overpacked overlap confined to the immediate neighbour "
            "(2·spacing >= result width)",
        ),
        ClauseCheck(
            C.CLAUSE_FIELD_WRAP, wrap_ok,
            "true product + bounded error representable in each field",
        ),
    ]

    interval_wce = [field_err[n].magnitude for n in range(cfg.n_results)]
    interval_exact = all(field_err[n].is_zero for n in range(cfg.n_results))

    n_total = 1
    for wd in (*cfg.a_widths, *cfg.w_widths):
        n_total *= 1 << wd
    derivation = "interval"
    mae: float | None = None
    ep: float | None = None
    mae_kind = "unavailable"
    wce = max(interval_wce)
    verdict = "exact" if interval_exact else "bounded"
    if interval_exact:
        mae, ep, mae_kind = 0.0, 0.0, "exact"
    elif n_total <= enumeration_limit:
        a, w = exhaustive_operands(cfg, device)
        stats = error_stats(
            outer_product_exact(cfg, a, w), simulate(cfg, a, w, scheme=scheme)
        )
        for n, bound in enumerate(interval_wce):
            if stats.wce[n] > bound:
                raise RuntimeError(
                    f"unsound certificate for {config_name(cfg, scheme)}: "
                    f"field {n} enumerated WCE {stats.wce[n]} exceeds the "
                    f"interval bound {bound}"
                )
        derivation = "enumeration"
        mae, ep, mae_kind = stats.mae_bar, stats.ep_bar / 100.0, "exact"
        wce = stats.wce_bar
        verdict = "exact" if wce == 0 and stats.mae_bar == 0.0 else "bounded"

    return PlanCertificate(
        plan=config_name(cfg, scheme),
        model="config",
        verdict=verdict,
        derivation=derivation,
        wce_per_extraction=wce,
        mae_per_extraction=mae,
        mae_kind=mae_kind,
        ep_per_extraction=ep,
        clauses=tuple(clauses),
        stages=tuple(stages),
    )


# ---------------------------------------------------------------------------
# addition packing (AddPackConfig)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def certify_addpack(cfg: AddPackConfig) -> PlanCertificate:
    """Certificate for a packed-adder lane layout (paper §VII).

    Walks lanes bottom-up: the carry into lane ``i`` of one packed add is
    ``floor(Σ_{m<i} (fx_m + fy_m)·2^off_m / 2^off_i)`` over the unsigned
    field representations; guard bits make it provably zero.  A nonzero
    carry corrupts the victim lane's LSB — error equal to the carry
    *modulo the lane width* (Table III's WCE 1), which the lane's
    two's-complement wrap can turn into a sign flip (the field-wrap
    clause records that hazard)."""
    offs = cfg.offsets

    def carry_in(i: int, n_adds: int) -> Interval:
        """Carry reaching lane ``i`` after ``n_adds`` accumulated packed
        lane vectors (unsigned field representations, worst case)."""
        below = Interval.point(0)
        for m in range(i):
            below = below + Interval(
                0, n_adds * ((1 << cfg.lane_widths[m]) - 1)
            ).shl(offs[m])
        return below.ashr(offs[i]) if i else Interval.point(0)

    stages: list[StageBound] = []
    carries = [carry_in(i, 2) for i in range(cfg.n_lanes)]
    for i, carry in enumerate(carries):
        stages.append(StageBound(
            f"lane{i}@+{offs[i]}", carry.lo, carry.hi,
            f"carry-in over one packed add (width {cfg.lane_widths[i]})",
        ))

    # largest power-of-two accumulation chunk that provably never carries
    # into ANY lane — this is the chunk `accumulate` may use exactly
    max_chunk = 1
    while max_chunk < (1 << 30) and all(
        carry_in(i, 2 * max_chunk).is_zero for i in range(cfg.n_lanes)
    ):
        max_chunk *= 2

    exact = all(c.is_zero for c in carries)
    wce = max(c.magnitude for c in carries)
    clauses = [
        ClauseCheck(
            C.CLAUSE_LANE_BUDGET, cfg.bits_used() <= cfg.total_bits,
            f"lanes use {cfg.bits_used()} of {cfg.total_bits} accumulator "
            "bits",
        ),
        ClauseCheck(
            C.CLAUSE_GUARD_CARRY,
            exact and max_chunk >= 1 << cfg.guard_bits,
            f"guard_bits={cfg.guard_bits}: single-add carries "
            f"{carries[-1]}"
            + (f"; max exact accumulation chunk {max_chunk}" if exact
               else " corrupt victim-lane LSBs"),
        ),
        ClauseCheck(
            C.CLAUSE_FIELD_WRAP, exact,
            "no carry reaches any lane" if exact else
            "a cross-lane carry can wrap a saturated victim lane "
            "(congruence WCE 1 mod the lane width, absolute up to "
            "2**width - 1)",
        ),
    ]
    return PlanCertificate(
        plan=(f"addpack-{'x'.join(map(str, cfg.lane_widths))}"
              f"-g{cfg.guard_bits}"),
        model="addpack",
        verdict="exact" if exact else "bounded",
        derivation="interval",
        wce_per_extraction=wce,
        mae_per_extraction=0.0 if exact else None,
        mae_kind="exact" if exact else "unavailable",
        ep_per_extraction=0.0 if exact else None,
        clauses=tuple(clauses),
        stages=tuple(stages),
    )


# ---------------------------------------------------------------------------
# CLI: certify the full enumerated plan set (the CI static-analysis gate)
# ---------------------------------------------------------------------------


def _check_spec_invariants(spec: PackedDotSpec, cert: PlanCertificate,
                           problems: list[str]) -> None:
    if not cert.ok:
        problems.append(
            f"{cert.plan}: constructed spec fails clauses "
            f"{cert.failed_clauses}"
        )
    if spec.provably_exact and not cert.exact:
        problems.append(
            f"{cert.plan}: provably_exact but certificate says "
            f"{cert.verdict}"
        )
    if cert.exact and cert.wce_per_extraction != 0:
        problems.append(f"{cert.plan}: exact verdict with nonzero WCE")
    if not cert.exact and (cert.mae_per_extraction is None
                           or cert.mae_per_extraction <= 0.0):
        problems.append(
            f"{cert.plan}: bounded dot plan must carry a positive MAE "
            f"bound, got {cert.mae_per_extraction}"
        )


def _check_witness(spec: PackedDotSpec, cert: PlanCertificate,
                   problems: list[str], device: torch.device) -> None:
    from ..kernels import ref

    x, w = (torch.from_numpy(t).to(device)
            for t in witness_operands(spec, n_extractions=2, rows=2, cols=2))
    got = ref.ref_packed_matmul(x, w, spec).cpu().numpy().astype(np.int64)
    want = ref.ref_quantized_matmul(x, w).cpu().numpy().astype(np.int64)
    err = got - want
    expected = 2 * cert.witness.per_extraction_error
    if not np.all(err == expected):
        problems.append(
            f"{cert.plan}: witness error {np.unique(err).tolist()} != "
            f"certified {expected}"
        )
    if np.abs(err).max() != 2 * cert.wce_per_extraction:
        problems.append(
            f"{cert.plan}: witness does not achieve the certified WCE "
            f"({np.abs(err).max()} vs {2 * cert.wce_per_extraction})"
        )


def main(argv=None) -> int:
    import argparse
    import json

    from ..device import resolve_device
    from ..tuning.plans import enumerate_packing_configs, enumerate_specs

    ap = argparse.ArgumentParser(
        description="certify every enumerated packing plan")
    ap.add_argument("--device", default="cuda",
                    help="where the witnesses and the config enumerations "
                         "run: cuda (the card) or cpu")
    ap.add_argument("--pairs", default="2,2 4,4 4,8 6,6 8,4 8,8",
                    help="space-separated a_bits,w_bits width pairs")
    ap.add_argument("--no-witnesses", action="store_true",
                    help="skip evaluating WCE witnesses against the plain "
                         "packed matmul")
    ap.add_argument("--no-configs", action="store_true",
                    help="skip the DSP48 outer-product config family")
    ap.add_argument("--json", default=None,
                    help="dump all certificates to this path")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    problems: list[str] = []
    certs: list[PlanCertificate] = []
    n_exact = 0
    for pair in args.pairs.split():
        a_bits, w_bits = (int(t) for t in pair.split(","))
        specs = enumerate_specs(a_bits, w_bits)
        for spec in specs:
            cert = certify_spec(spec)
            certs.append(cert)
            _check_spec_invariants(spec, cert, problems)
            n_exact += cert.exact
            if not cert.exact and not args.no_witnesses:
                _check_witness(spec, cert, problems, device)
            if args.verbose:
                print("  " + cert.summary())
        print(f"[verify] a{a_bits}w{w_bits}: {len(specs)} plans certified")

    if not args.no_configs:
        n_cfg = 0
        for a_bits, w_bits in ((4, 4), (8, 8)):
            for cfg in enumerate_packing_configs(a_bits, w_bits):
                for scheme in SCHEMES:
                    cert = certify_config(cfg, scheme, device=device.type)
                    certs.append(cert)
                    n_cfg += 1
                    legal_pairing = cfg.delta >= 0 or scheme in (
                        "mr", "mr+full")
                    if legal_pairing and not cert.ok:
                        problems.append(
                            f"{cert.plan}: enumerated config fails clauses "
                            f"{cert.failed_clauses}"
                        )
                    if not legal_pairing and C.CLAUSE_FIELD_WRAP not in \
                            cert.failed_clauses:
                        problems.append(
                            f"{cert.plan}: overpacked field overlap without "
                            "MR restore must be flagged as field-wrap"
                        )
                    if args.verbose:
                        print("  " + cert.summary())
        print(f"[verify] configs: {n_cfg} (config, scheme) pairs certified")

    for cfg in (
        AddPackConfig((9,) * 5),            # Table III: five 9-bit lanes
        AddPackConfig((8, 8), guard_bits=1),
        AddPackConfig((10,) * 4, guard_bits=2),
    ):
        cert = certify_addpack(cfg)
        certs.append(cert)
        if cfg.guard_bits >= 1 and not cert.exact:
            problems.append(f"{cert.plan}: guarded lanes must certify exact")
        if args.verbose:
            print("  " + cert.summary())

    n_bounded = sum(1 for c in certs if not c.exact)
    print(f"[verify] {len(certs)} certificates: "
          f"{sum(c.exact for c in certs)} exact, {n_bounded} bounded"
          + ("" if args.no_witnesses else "; spec WCE witnesses evaluated"))
    if args.json:
        with open(args.json, "w") as f:
            json.dump([c.to_json() for c in certs], f, indent=1)
        print(f"[verify] wrote {args.json}")
    for p in problems:
        print(f"[verify] FAIL {p}")
    return 1 if problems else 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
