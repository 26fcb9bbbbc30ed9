"""Static analysis for the packing stack: plan certificates.

``clauses`` and ``domain`` are dependency-free and imported eagerly; the
verifier (which pulls in the packing modules and the kernels' plain
versions) is loaded lazily, so that ``kernels.ref`` can import
``analysis.clauses`` for its constructor messages without a cycle.
"""

from __future__ import annotations

from . import clauses  # noqa: F401  (dependency-free, eager)
from .domain import Interval  # noqa: F401

__all__ = [
    "Interval",
    "clauses",
    "PlanCertificate",
    "certify_spec",
    "certify_config",
    "certify_addpack",
    "witness_operands",
]

_LAZY = {
    "PlanCertificate": "verify",
    "certify_spec": "verify",
    "certify_config": "verify",
    "certify_addpack": "verify",
    "witness_operands": "verify",
}


def __getattr__(name: str):
    if name in _LAZY:
        import importlib

        mod = importlib.import_module(f".{_LAZY[name]}", __name__)
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
