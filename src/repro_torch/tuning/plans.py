"""Packing-plan enumeration (paper §IV/§VI generalized to a search space).

The port's copy of the reference's ``repro.tuning.plans``: the same
enumeration order over the port's :class:`PackedDotSpec` and
:class:`PackingConfig`, so that the plan names match one for one.

The paper's contribution is that DSP packing is a *family* of layouts —
any operand widths, any number of multiplications, any δ-spacing including
negative-δ Overpacking — not the two Xilinx app-note configs.  This module
materializes that family for both compute models in the repo:

* :func:`enumerate_specs` — every legal :class:`PackedDotSpec` for the
  pair-packed int32 path, for a requested ``(a_bits, w_bits)``.
  For exact-spacing schemes (``naive``/``full``) the minimal legal spacing
  is emitted per accumulation count (wider spacing only wastes bits: the
  error profile is independent of ``p`` once the middle field fits).  For
  the mr schemes every overpacked spacing down to ``max_mr_bits`` below the
  exact minimum is emitted — each trades error for packing density.  The
  multi-DSP *column* axis (``n_columns``) is searched on top: spreading one
  dot product across several packed words lifts the per-word int32 budget,
  so 8-bit operands — which admit NO single-word plan — get provably exact
  plans, at a cost the scorer charges per extra word.

* :func:`enumerate_packing_configs` — every legal :class:`PackingConfig`
  under the DSP48E2 port budgets (the hardware-truth simulation), over a
  δ range that includes Overpacking.  Negative δ is clamped so fields only
  ever overlap their immediate neighbour (``spacing >= ceil(width/2)``) —
  the regime the paper's MR restore (Eqns. 8/9) is defined for.
"""

from __future__ import annotations

import dataclasses

from ..core.packing import PackingConfig, intn_packing
from ..kernels.ref import CORRECTIONS, PackedDotSpec, min_exact_p

__all__ = [
    "min_exact_p",
    "enumerate_specs",
    "certified_plans",
    "enumerate_packing_configs",
    "spec_to_json",
    "spec_from_json",
    "DEFAULT_N_PAIRS",
    "DEFAULT_MAX_MR_BITS",
    "DEFAULT_N_COLUMNS",
]


def spec_to_json(spec: PackedDotSpec) -> dict:
    """Loss-free JSON form of a spec (plan-database persistence).

    Field-for-field ``asdict``: round-tripping through
    :func:`spec_from_json` re-runs the constructor's legality checks, so a
    stored plan that predates a tightened invariant fails loudly at load
    instead of serving an illegal layout."""
    return dataclasses.asdict(spec)


def spec_from_json(d: dict) -> PackedDotSpec:
    """Inverse of :func:`spec_to_json` (revalidates via ``__post_init__``)."""
    fields = {f.name for f in dataclasses.fields(PackedDotSpec)}
    unknown = set(d) - fields
    if unknown:
        raise ValueError(
            f"unknown PackedDotSpec fields {sorted(unknown)} — stale "
            "plan-database entry from a different schema; invalidate it"
        )
    return PackedDotSpec(**d)


DEFAULT_N_PAIRS = (1, 2, 4, 8, 16, 32)
DEFAULT_MAX_MR_BITS = 4
# Multi-DSP column counts searched per plan (the wide-datapath related
# work's missing axis): 1 = classic single-word packing; >1 spreads one dot
# product across several packed int32 words, lifting the per-word budget.
DEFAULT_N_COLUMNS = (1, 2, 4)


def enumerate_specs(
    a_bits: int,
    w_bits: int,
    corrections: tuple[str, ...] = CORRECTIONS,
    n_pairs_choices: tuple[int, ...] = DEFAULT_N_PAIRS,
    max_mr_bits: int = DEFAULT_MAX_MR_BITS,
    min_p: int = 2,
    n_columns_choices: tuple[int, ...] = DEFAULT_N_COLUMNS,
) -> tuple[PackedDotSpec, ...]:
    """Every legal pair-packed plan for ``(a_bits, w_bits)``.

    Legality is delegated to ``PackedDotSpec.__post_init__`` (the int32
    accumulator and field budgets, applied per column), so "the enumerator
    emits it" and "the kernel accepts it" are the same predicate by
    construction.  Column counts beyond the operand width, or yielding the
    same slice width as a smaller count, are skipped (identical plans).
    The result may still be empty for exotic width/choice combinations —
    callers are expected to handle that — but the column axis means every
    width pair up to a8w8 now has at least one provably exact plan.
    """
    specs: list[PackedDotSpec] = []
    seen_slice_widths: set[int] = set()
    for n_requested in n_columns_choices:
        if n_requested > a_bits:
            continue
        col_bits_a = -(-a_bits // n_requested)
        if col_bits_a in seen_slice_widths:
            continue  # same slice width: same plan, regardless of count
        seen_slice_widths.add(col_bits_a)
        # canonical count for this slice width — e.g. requesting 4 columns
        # of a 6-bit activation means 2-bit slices, which only need THREE
        # columns (the spec constructor rejects trailing-empty columns)
        n_columns = -(-a_bits // col_bits_a)
        for n_pairs in n_pairs_choices:
            p_exact = min_exact_p(a_bits, w_bits, n_pairs, n_columns)
            for correction in corrections:
                if correction in ("naive", "full"):
                    try:
                        specs.append(
                            PackedDotSpec(a_bits, w_bits, p_exact, n_pairs,
                                          correction, n_columns=n_columns)
                        )
                    except ValueError:
                        pass  # exceeds the int32 budget at this n_pairs
                else:  # mr / mr+full: squeeze spacing below the exact minimum
                    for mr_bits in range(1, max_mr_bits + 1):
                        p = p_exact - mr_bits
                        if p < min_p:
                            continue
                        try:
                            specs.append(
                                PackedDotSpec(
                                    a_bits, w_bits, p, n_pairs, correction,
                                    mr_bits, n_columns=n_columns,
                                )
                            )
                        except ValueError:
                            pass
    return tuple(specs)


def certified_plans(
    a_bits: int,
    w_bits: int,
    **enumerate_kwargs,
) -> tuple[tuple[PackedDotSpec, "object"], ...]:
    """Enumerated specs stamped with their static certificates.

    Every plan the enumerator emits is paired with the
    :class:`~repro_torch.analysis.verify.PlanCertificate` proving its legality
    and error bound (the verifier memoizes, so stamping is cheap).  The
    enumerator and constructor guarantee legality by construction; the
    certificate additionally carries the exact/bounded verdict, the tight
    per-extraction WCE with its witness, and the analytic MAE — consumers
    (the tuner's budget filter, benchmarks, the serving planner) read
    those instead of re-measuring."""
    from ..analysis.verify import certify_spec

    specs = enumerate_specs(a_bits, w_bits, **enumerate_kwargs)
    return tuple((spec, certify_spec(spec)) for spec in specs)


def enumerate_packing_configs(
    a_bits: int,
    w_bits: int,
    n_a_choices: tuple[int, ...] = (1, 2, 3),
    n_w_choices: tuple[int, ...] = (1, 2),
    deltas: tuple[int, ...] | range = range(-3, 5),
) -> tuple[PackingConfig, ...]:
    """Every legal DSP48E2 packing config for uniform ``(a_bits, w_bits)``.

    Filters by :meth:`PackingConfig.fits_dsp48` (the 17/26/47-bit port
    budgets) and restricts Overpacking to single-neighbour overlap —
    ``spacing >= ceil(result_width / 2)`` — which is the regime the MR
    restore handles (each field is only contaminated by the field directly
    above it).
    """
    width = a_bits + w_bits
    configs: list[PackingConfig] = []
    for n_a in n_a_choices:
        for n_w in n_w_choices:
            if n_a * n_w < 2:
                continue  # a single product is not a packing
            for delta in deltas:
                spacing = width + delta
                if delta < 0 and 2 * spacing < width:
                    continue  # would overlap beyond the adjacent field
                try:
                    cfg = intn_packing((a_bits,) * n_a, (w_bits,) * n_w, delta)
                except ValueError:
                    continue
                if cfg.fits_dsp48():
                    configs.append(cfg)
    return tuple(configs)
