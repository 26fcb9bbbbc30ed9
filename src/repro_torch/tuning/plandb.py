"""Persisted plan database: engine builds consult it before they search.

The port's copy of the reference's ``repro.tuning.plandb``: ``dsp_tuned``
plan tables (``"tuned"`` entries), ``dsp_mixed`` width allocations
(``"mixed"`` entries) and, beside either, the governor's tier plan tables
(a ``"tiers"`` record, fingerprinted by the governor settings that shape
them and merge-written by ``serving.engine._setup_governor``).  The engine computes a :func:`plan_key`
fingerprint, asks :class:`PlanDB` for it, and only falls back to
search-and-store on a miss, so a restarted engine builds without scoring
a single plan or running a single sensitivity probe.

Storage rides :class:`~repro_torch.checkpoint.checkpointer.Checkpointer`:

* **Whole-DB-per-step.**  Every ``put`` writes all entries as one new
  step (entries are small JSON), so the newest step is always the complete
  database and the ``keep`` GC of older steps never deletes an entry a
  live engine was built from.
* **Atomicity.**  A step is published by ``os.rename``; a crash mid-``put``
  leaves the previous step intact and a torn ``.tmp`` is never read.
* **Explicit invalidation.**  Entries sit in a ``{"schema":
  SCHEMA_VERSION, "entries": ...}`` envelope; another version (or a
  corrupt envelope) reads as empty and counts as stale, and
  :meth:`PlanDB.invalidate` drops keys on demand.  :func:`plan_key` folds
  in everything the search result depends on — the model config, the
  port's backend (``"torch-cuda"`` or ``"torch-cpu"``, so that an entry of
  the reference, keyed by its JAX backend, never warm-starts a torch
  engine), the packable (path, shape) coverage and every search setting.

Serialization round-trips the full :class:`~repro_torch.tuning.tuner.PlanReport`,
measured floats included, and for ``dsp_mixed`` the whole
:class:`~repro_torch.tuning.mixed.MixedAllocation` with its per-layer
sensitivities, under the reference's schema: an allocation the reference
wrote reads back here to an equal record (``tuning.mixed.PROBES`` stays
at zero on a warm build; ``serving.governor.TIER_SEARCHES`` likewise for
the tiers).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any

from ..checkpoint.checkpointer import Checkpointer
from .mixed import LayerSensitivity, MixedAllocation
from .plans import spec_from_json, spec_to_json
from .tuner import PlanReport

__all__ = [
    "SCHEMA_VERSION",
    "PlanDB",
    "plan_key",
    "report_to_json",
    "report_from_json",
    "allocation_to_json",
    "allocation_from_json",
]

# Bump whenever the serialized layout (report fields, envelope, key recipe)
# changes shape: old stores then read as empty and rebuild.
SCHEMA_VERSION = 2


# ---- (de)serialization -----------------------------------------------------


def report_to_json(report: PlanReport) -> dict:
    """Loss-free JSON form of a scored/timed plan (all measured floats
    ride along — a warm load re-runs no scoring)."""
    return {
        "spec": spec_to_json(report.spec),
        "mae": report.mae,
        "mae_per_extraction": report.mae_per_extraction,
        "ep": report.ep,
        "wce": report.wce,
        "cost_proxy": report.cost_proxy,
        "exhaustive": report.exhaustive,
        "block": report.block,
        "us_per_call": report.us_per_call,
        "decode_block": report.decode_block,
        "decode_us_per_call": report.decode_us_per_call,
    }


def report_from_json(d: dict) -> PlanReport:
    return PlanReport(
        spec=spec_from_json(d["spec"]),
        mae=d["mae"],
        mae_per_extraction=d["mae_per_extraction"],
        ep=d["ep"],
        wce=int(d["wce"]),
        cost_proxy=d["cost_proxy"],
        exhaustive=bool(d["exhaustive"]),
        block=d["block"],
        us_per_call=d["us_per_call"],
        decode_block=d["decode_block"],
        decode_us_per_call=d["decode_us_per_call"],
    )


def _bits_key(bits: tuple[int, int]) -> str:
    return f"{bits[0]},{bits[1]}"


def _bits_from_key(s: str) -> tuple[int, int]:
    a, w = s.split(",")
    return (int(a), int(w))


def allocation_to_json(alloc: MixedAllocation) -> dict:
    """Full mixed-allocation record, sensitivities included (so a warm
    engine exposes the same ``mixed_allocation`` a cold build would)."""
    return {
        "assignments": {p: list(b) for p, b in alloc.assignments.items()},
        "plans": {p: report_to_json(r) for p, r in alloc.plans.items()},
        "base_bits": list(alloc.base_bits),
        "budget": alloc.budget,
        "predicted_error": alloc.predicted_error,
        "cost": alloc.cost,
        "base_cost": alloc.base_cost,
        "sensitivities": [
            {
                "path": s.path,
                "n_values": s.n_values,
                "errors": {_bits_key(b): e for b, e in s.errors.items()},
            }
            for s in alloc.sensitivities
        ],
    }


def allocation_from_json(d: dict) -> MixedAllocation:
    return MixedAllocation(
        assignments={p: tuple(b) for p, b in d["assignments"].items()},
        plans={p: report_from_json(r) for p, r in d["plans"].items()},
        base_bits=tuple(d["base_bits"]),
        budget=d["budget"],
        predicted_error=d["predicted_error"],
        cost=d["cost"],
        base_cost=d["base_cost"],
        sensitivities=tuple(
            LayerSensitivity(
                path=s["path"],
                n_values=int(s["n_values"]),
                errors={_bits_from_key(k): v for k, v in s["errors"].items()},
            )
            for s in d["sensitivities"]
        ),
    )


# ---- keying ----------------------------------------------------------------


def _jsonable(obj: Any) -> Any:
    """Canonical JSON-able form for fingerprint material (tuples→lists,
    dataclasses→sorted dicts)."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return _jsonable(dataclasses.asdict(obj))
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in sorted(obj.items())}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    return obj


def plan_key(cfg, serve_cfg, params) -> str:
    """Fingerprint of everything the plan search's result depends on.

    ``cfg`` is the model config the engine serves (its ``quant`` already
    switched to the mode and the resolved ``use_kernel``), ``params`` the
    tree actually quantized (after any projection fusion; MoE expert
    stacks count per expert).  Sampling, slots and the like keep the key
    stable — they never alter plans."""
    from ..core.packed_params import iter_packable_weights, split_expert_stacks

    shapes = sorted({(path, tuple(leaf.shape))
                     for path, leaf in iter_packable_weights(split_expert_stacks(params))})
    device = params["embed"]["w"].device.type
    material = {
        "schema": SCHEMA_VERSION,
        "model": _jsonable(cfg),
        "backend": f"torch-{device}",
        "shapes": [[p, list(s)] for p, s in shapes],
        "search": {
            "quant_mode": serve_cfg.quant_mode,
            "plan_bits": _jsonable(serve_cfg.plan_bits),
            "error_budget": serve_cfg.error_budget,
            "autotune_plans": serve_cfg.autotune_plans,
            "mixed_budget": serve_cfg.mixed_budget,
            "width_candidates": _jsonable(serve_cfg.width_candidates),
            "calib_tokens": serve_cfg.calib_tokens,
            "seed": serve_cfg.seed,
            "use_kernel": cfg.quant.use_kernel,
            "fuse_projections": serve_cfg.fuse_projections,
            "tp": serve_cfg.tp,
        },
    }
    blob = json.dumps(material, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()


# ---- the database ----------------------------------------------------------


class PlanDB:
    """Plan store over a ``Checkpointer`` directory (see the module
    docstring).  Hit/miss/stale counters are plain attributes; the engine
    reports them in ``stats()["plan_db"]``."""

    def __init__(self, directory: str, keep: int = 3):
        self._ckpt = Checkpointer(directory, keep=keep)
        self.n_hits = 0
        self.n_misses = 0
        self.n_stale = 0

    @property
    def directory(self) -> str:
        return self._ckpt.directory

    def _load(self) -> dict[str, dict]:
        step = self._ckpt.latest_step()
        if step is None:
            return {}
        _, extra = self._ckpt.restore(step, like={})
        if not isinstance(extra, dict) or extra.get("schema") != SCHEMA_VERSION:
            # another schema (or a foreign directory) reads as empty:
            # rebuild and overwrite, never deserialize stale layouts
            self.n_stale += 1
            return {}
        entries = extra.get("entries", {})
        return entries if isinstance(entries, dict) else {}

    def _store(self, entries: dict[str, dict]) -> None:
        step = self._ckpt.latest_step()
        self._ckpt.save(0 if step is None else step + 1, {},
                        extra={"schema": SCHEMA_VERSION, "entries": entries})

    def get(self, key: str) -> dict | None:
        """The stored entry for ``key`` (a JSON dict as given to ``put``),
        or None on miss."""
        entry = self._load().get(key)
        if entry is None:
            self.n_misses += 1
            return None
        self.n_hits += 1
        return entry

    def put(self, key: str, entry: dict) -> None:
        """Store ``entry`` under ``key`` as a new atomic step carrying the
        whole database (read-modify-write; last writer wins per key)."""
        entries = self._load()
        entries[key] = entry
        self._store(entries)

    def invalidate(self, key: str | None = None) -> int:
        """Drop one key (or every key when ``key`` is None); returns the
        number of entries dropped, written as a new step."""
        entries = self._load()
        if key is None:
            dropped = len(entries)
            entries = {}
        else:
            dropped = int(key in entries)
            entries.pop(key, None)
        if dropped:
            self._store(entries)
        return dropped

    def keys(self) -> list[str]:
        return sorted(self._load())

    def __len__(self) -> int:
        return len(self._load())
