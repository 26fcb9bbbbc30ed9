"""Certificate clause identifiers (the paper's error-source taxonomy).

The port's own copy of the reference's ``repro.analysis.clauses`` (the
port imports nothing of the reference): the same identifiers, so that a
certificate or a constructor's rejection reads the same in both packages.

Every :class:`~repro_torch.analysis.verify.PlanCertificate` is a list of clause
verdicts plus an error bound; the clause ids below are the machine-checkable
vocabulary shared by the verifier, the kernel constructors (whose legality
errors cite the violated clause) and the command line.  Each clause maps onto one
of the paper's error sources:

* **accumulator wrap** — :data:`CLAUSE_INT32_ACCUMULATOR`,
  :data:`CLAUSE_MIDDLE_FIELD`, :data:`CLAUSE_OUTPUT_ACCUMULATOR`,
  :data:`CLAUSE_PRODUCT_WIDTH`, :data:`CLAUSE_DSP48_PORTS`,
  :data:`CLAUSE_LANE_BUDGET` — a packed sum outgrowing the word that holds
  it (the paper's ``2**delta`` accumulation budget, §IV).
* **sign-extension contamination** — :data:`CLAUSE_EXTRACTION_ALIAS`,
  :data:`CLAUSE_FIELD_WRAP` — a lower/restored field's borrow or spill
  aliasing into the sign bits of the field being read back (§V, the MAE
  0.37 naive bias; §VI-B's restored-field representability).
* **field overlap** — :data:`CLAUSE_CONTAMINATION_REACH` — Overpacking
  (δ < 0) letting a field reach past its immediate neighbour, outside the
  regime the MR restore (Eqns. 8/9) is defined for (§VI).
* **carry corruption** — :data:`CLAUSE_GUARD_CARRY` — addition packing's
  cross-lane carry, absorbed by guard bits (§VII, Table III).

This module is imported by ``kernels.ref`` for its constructor messages, so
it must stay dependency-free (no torch, no sibling imports).
"""

from __future__ import annotations

__all__ = [
    "CLAUSE_INT32_ACCUMULATOR",
    "CLAUSE_MIDDLE_FIELD",
    "CLAUSE_EXTRACTION_ALIAS",
    "CLAUSE_COLUMN_COVERAGE",
    "CLAUSE_OUTPUT_ACCUMULATOR",
    "CLAUSE_DSP48_PORTS",
    "CLAUSE_PRODUCT_WIDTH",
    "CLAUSE_CONTAMINATION_REACH",
    "CLAUSE_FIELD_WRAP",
    "CLAUSE_LANE_BUDGET",
    "CLAUSE_GUARD_CARRY",
    "CLAUSE_DESCRIPTIONS",
]

# -- pair-packed dot path (PackedDotSpec) ---------------------------------
CLAUSE_INT32_ACCUMULATOR = "int32-accumulator"
CLAUSE_MIDDLE_FIELD = "middle-field-width"
CLAUSE_EXTRACTION_ALIAS = "extraction-aliasing"
CLAUSE_COLUMN_COVERAGE = "column-coverage"
CLAUSE_OUTPUT_ACCUMULATOR = "int32-output-accumulator"

# -- DSP48 outer-product model (PackingConfig) ----------------------------
CLAUSE_DSP48_PORTS = "dsp48-port-budget"
CLAUSE_PRODUCT_WIDTH = "product-width"
CLAUSE_CONTAMINATION_REACH = "contamination-reach"
CLAUSE_FIELD_WRAP = "field-wrap"

# -- addition packing (AddPackConfig) -------------------------------------
CLAUSE_LANE_BUDGET = "lane-budget"
CLAUSE_GUARD_CARRY = "guard-carry"

CLAUSE_DESCRIPTIONS: dict[str, str] = {
    CLAUSE_INT32_ACCUMULATOR: (
        "the accumulated packed partial sum (low + mid<<p + high<<2p over "
        "n_pairs products) fits the signed 32-bit accumulator, per column"
    ),
    CLAUSE_MIDDLE_FIELD: (
        "the accumulated dot-product (middle) field fits the bits the "
        "extraction reads back (p, or p + mr_bits after the MSB restore)"
    ),
    CLAUSE_EXTRACTION_ALIAS: (
        "the extracted value PLUS the low-field floor/rounding residue fits "
        "the signed extract width — otherwise the residue aliases into the "
        "sign bit and the sign-extension wraps the whole field"
    ),
    CLAUSE_COLUMN_COVERAGE: (
        "every multi-DSP column carries at least one activation bit"
    ),
    CLAUSE_OUTPUT_ACCUMULATOR: (
        "recombined int32 outputs stay exact up to the certified "
        "max_safe_k contraction length"
    ),
    CLAUSE_DSP48_PORTS: (
        "packed operand words and the product fit the DSP48E2 port budgets "
        "(A/B operand widths, 47-bit P)"
    ),
    CLAUSE_PRODUCT_WIDTH: (
        "the packed product fits the 63 value bits of the int64 simulation"
    ),
    CLAUSE_CONTAMINATION_REACH: (
        "overpacked fields only ever overlap their immediate neighbour "
        "(2·spacing >= result width) — the regime the MR restore handles"
    ),
    CLAUSE_FIELD_WRAP: (
        "the field's true product plus its bounded extraction error is "
        "representable in the field width (no two's-complement wrap)"
    ),
    CLAUSE_LANE_BUDGET: (
        "lane payloads plus guard bits fit the wide accumulator"
    ),
    CLAUSE_GUARD_CARRY: (
        "guard bits absorb every cross-lane carry for the certified "
        "accumulation chunk (2**guard_bits packed adds)"
    ),
}
