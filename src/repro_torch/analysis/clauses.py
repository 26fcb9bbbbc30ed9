"""Certificate clause identifiers cited by ``PackedDotSpec``'s rejections.

The port's own copy of the clause strings of the reference's
``repro.analysis.clauses`` (the port imports nothing of the reference):
the constructor's legality errors name the clause they violate, with the
same identifiers, so a rejection reads the same in both packages.
"""

from __future__ import annotations

__all__ = [
    "CLAUSE_INT32_ACCUMULATOR",
    "CLAUSE_MIDDLE_FIELD",
    "CLAUSE_EXTRACTION_ALIAS",
]

CLAUSE_INT32_ACCUMULATOR = "int32-accumulator"
CLAUSE_MIDDLE_FIELD = "middle-field-width"
CLAUSE_EXTRACTION_ALIAS = "extraction-aliasing"
