"""Plan selection: the fastest packing plan inside an error budget.

The port's copy of the reference's ``repro.tuning.tuner``: the same
ranking, ties and fallback, so that the port's engine picks the
reference's plan on every path.  Its measured ranking
(``autotune=True``) times the CUDA kernels on the card
(``tuning.autotune``); ``block``/``decode_block`` then name the winning
kernel variant per serving phase.

Mirrors how the related work (wide-datapath arithmetic packing, near-precise
DSP approximation) treats packing-shape choice: not a fixed scheme but a
search over an accuracy/throughput frontier.  The pipeline is

    enumerate (plans.enumerate_specs)
      → score error (score.spec_error_stats, Eqns. 10-12)
      → filter by the caller's MAE-per-extraction budget
      → rank by measured kernel time (autotune.autotune_block) or, when
        measurement is off (engine build time), by an arithmetic cost proxy
      → select per layer (plan_linear_layers)

The cost proxy (``score.plan_cost_proxy``) counts int32 dot-general work
per K element: one packed multiply per ``chunk`` K elements — times the
plan's ``n_columns`` (a multi-DSP column plan spends one word per column
per pair position) — plus half a multiply for the mr contamination dot.
Fewer extractions per K is the whole throughput story of longer
accumulation chains; wall-clock (``autotune=True``) is the measured
alternative.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch

from ..kernels.ref import INT4_EXACT, PackedDotSpec
from .autotune import autotune_block, autotune_phase_blocks
from .plans import enumerate_specs
from .score import SpecScore, plan_cost_proxy, spec_error_stats

__all__ = [
    "PlanReport",
    "DEFAULT_ERROR_BUDGET",
    "SCORED",
    "plan_report",
    "rank_plans",
    "select_plan",
    "plan_linear_layers",
    "linear_partition",
]

# MAE per extraction (paper-table normalization).  0.5 admits every scheme
# whose mean error stays below half a quantization step of the *packed*
# arithmetic — the regime where packed-vs-float logit drift is dominated by
# the 4-bit quantization itself, not the packing (tests/test_serving.py).
DEFAULT_ERROR_BUDGET = 0.5


@dataclasses.dataclass(frozen=True)
class PlanReport:
    """One scored (and optionally timed) packing plan."""

    spec: PackedDotSpec
    mae: float
    mae_per_extraction: float
    ep: float
    wce: int
    cost_proxy: float
    exhaustive: bool
    block: str | None = None
    us_per_call: float | None = None
    # per-phase tuning: decode GEMVs (M = slot count) and chunked prefill
    # (M = slots × chunk) may want different kernel variants — each phase
    # is swept on its own probe and recorded separately
    decode_block: str | None = None
    decode_us_per_call: float | None = None

    @property
    def name(self) -> str:
        return self.spec.name()

    @property
    def certificate(self):
        """Static :class:`~repro_torch.analysis.verify.PlanCertificate` for the
        plan (memoized at the verifier — cheap to re-read)."""
        from ..analysis.verify import certify_spec

        return certify_spec(self.spec)

    def to_json(self) -> dict:
        return {
            "plan": self.name,
            "bits_a": self.spec.bits_a,
            "bits_w": self.spec.bits_w,
            "p": self.spec.p,
            "delta": self.spec.delta,
            "n_pairs": self.spec.n_pairs,
            "correction": self.spec.correction,
            "mr_bits": self.spec.mr_bits,
            "n_columns": self.spec.n_columns,
            "provably_exact": self.spec.provably_exact,
            # self-describing error pedigree for BENCH_tuning.json rows
            "certificate": self.certificate.to_json_summary(),
            "mae_per_extraction": self.mae_per_extraction,
            "ep_percent": self.ep,
            "wce": self.wce,
            "cost_proxy": self.cost_proxy,
            "exhaustive_grid": self.exhaustive,
            "block": self.block,
            "us_per_call": self.us_per_call,
            "decode_block": self.decode_block,
            "decode_us_per_call": self.decode_us_per_call,
        }


def _report(score: SpecScore) -> PlanReport:
    return PlanReport(
        spec=score.spec,
        mae=score.mae,
        mae_per_extraction=score.mae_per_extraction,
        ep=score.ep,
        wce=score.wce,
        cost_proxy=plan_cost_proxy(score.spec),
        exhaustive=score.exhaustive,
    )


# Error scoring is deterministic per (spec, probe) and specs recur across
# layers and engine builds — memoize.  SCORED counts the scorings actually
# run (cache misses): a warm build from the plan database runs none.
_SCORE_CACHE: dict[tuple, PlanReport] = {}
SCORED = {"specs": 0}


def _scored(spec: PackedDotSpec, n_extractions: int, samples: int, seed: int):
    key = (spec, n_extractions, samples, seed)
    if key not in _SCORE_CACHE:
        _SCORE_CACHE[key] = _report(
            spec_error_stats(spec, n_extractions=n_extractions,
                             samples=samples, seed=seed)
        )
        SCORED["specs"] += 1
    return _SCORE_CACHE[key]


def plan_report(spec: PackedDotSpec) -> PlanReport:
    """The scored report of one given plan, on the tuner's default probe
    (what :func:`select_plan` returns for its ``INT4_EXACT`` fallback)."""
    return _scored(spec, 4, 4096, 0)


def rank_plans(
    a_bits: int,
    w_bits: int,
    error_budget: float = DEFAULT_ERROR_BUDGET,
    shape: tuple[int, int, int] | None = None,
    autotune: bool = False,
    specs: Sequence[PackedDotSpec] | None = None,
    timer: Callable[..., float] | None = None,
    device: str | torch.device = "cuda",
    n_extractions: int = 4,
    samples: int = 4096,
    seed: int = 0,
    decode_shape: tuple[int, int, int] | None = None,
    exact_first: bool = False,
    shard_groups: int = 1,
) -> list[PlanReport]:
    """Score every enumerated plan, keep those inside the error budget and
    return them fastest-first.

    ``autotune=True`` times each candidate on ``shape`` (required then)
    with the best kernel variant of the sweep, on ``device`` (the card by
    default; on the CPU the plain version); otherwise ranking uses the
    arithmetic cost proxy.  ``decode_shape`` additionally sweeps the
    variants at that shape for the head of the ranking, so prefill and
    decode tune independently — the report carries one variant per phase.
    ``exact_first`` prefers PROVEN-exact plans at equal-or-worse cost proxy:
    off the kernel path proven-exact plans run through the f32-GEMM
    shortcut (``DspTunedLeaf.w_f32``) at dense-float speed, so they are
    faster in wall-clock than the proxy's multiply count suggests — the
    serving engine switches this on whenever it serves the non-kernel path.
    Ties break toward lower error, then wider spacing (cheaper restore).

    ``shard_groups > 1`` plans for tensor-parallel row sharding (the
    reference's ``runtime.tp_packed``): the cross-device sum accumulates
    ``shard_groups`` shards' pair products in one packed word before
    extraction, so the arithmetic that actually runs is the WIDENED spec
    (``n_pairs`` multiplied by the shard count — ``ref.widen_for_shards``).
    The enumerator emits minimal-spacing plans, so no enumerated spec
    widens legally; instead each enumerated spec is treated as the
    widened (post-reduce) spec — it is scored and budget-filtered as
    such — and the report returned carries the LOCAL per-shard spec
    (``n_pairs / shard_groups``) that each device executes.  Column
    counts up to 8 are searched (a8w8 admits no 2-way-shardable plan on
    the default column grid)."""
    local_of: dict[PackedDotSpec, PackedDotSpec] = {}
    if shard_groups > 1:
        if specs is None:
            specs = enumerate_specs(a_bits, w_bits,
                                    n_columns_choices=(1, 2, 4, 8))
        shardable = []
        for s in specs:
            if s.n_pairs % shard_groups:
                continue
            try:
                local = dataclasses.replace(
                    s, n_pairs=s.n_pairs // shard_groups
                )
            except ValueError:  # pragma: no cover - narrowing is always legal
                continue
            shardable.append(s)
            local_of[s] = local
        specs = shardable
    elif specs is None:
        specs = enumerate_specs(a_bits, w_bits)
    reports = [_scored(s, n_extractions, samples, seed) for s in specs]
    within = [r for r in reports if r.mae_per_extraction <= error_budget]

    def _proven(r):
        # the certificate is the proof; an exhaustively-enumerated zero is
        # an equally valid finite proof (and cross-checks the certificate)
        return r.certificate.exact or (r.mae == 0 and r.exhaustive)

    def _localize(ranked):
        # shard_groups: scored as the widened (post-psum) spec, served as
        # the local per-shard spec — swap specs on the way out
        if not local_of:
            return ranked
        return [dataclasses.replace(r, spec=local_of[r.spec]) for r in ranked]

    if autotune:
        if shape is None:
            raise ValueError("autotune=True needs a probe shape (m, k, n)")
        timed = []
        for r in within:
            # time the serving profile: weights packed once outside the
            # timed region, the prepacked kernel entry inside it — the code
            # path apply_linear actually runs
            timings = autotune_block(
                r.spec, shape, timer=timer, seed=seed, device=device,
            )
            best = timings[0]
            timed.append(
                dataclasses.replace(
                    r, block=best.block, us_per_call=best.us_per_call
                )
            )
        # exact_first outranks wall-clock here too: the timings run the
        # kernels (or on the CPU their plain versions), which never see the
        # f32-GEMM shortcut that makes proven-exact plans the fastest path
        # off the kernels
        timed.sort(
            key=(lambda r: (not _proven(r), r.us_per_call,
                            r.mae_per_extraction))
            if exact_first
            else (lambda r: (r.us_per_call, r.mae_per_extraction))
        )
        if decode_shape is not None:
            # decode-phase sweep only for the prefill-ranked head (plans
            # outside it let the wrapper choose the variant by M at runtime)
            head = []
            for r in timed[:3]:
                phased = autotune_phase_blocks(
                    r.spec, {"decode": decode_shape},
                    timer=timer, seed=seed, device=device,
                )
                head.append(dataclasses.replace(
                    r, decode_block=phased["decode"].block,
                    decode_us_per_call=phased["decode"].us_per_call,
                ))
            timed = head + timed[3:]
        return _localize(timed)
    if exact_first:
        return _localize(sorted(
            within,
            key=lambda r: (not _proven(r), r.cost_proxy,
                           r.mae_per_extraction, -r.spec.p),
        ))
    return _localize(sorted(
        within,
        key=lambda r: (r.cost_proxy, r.mae_per_extraction, -r.spec.p),
    ))


def select_plan(
    a_bits: int = 4,
    w_bits: int = 4,
    error_budget: float = DEFAULT_ERROR_BUDGET,
    **kwargs,
) -> PlanReport:
    """The fastest plan inside the budget; falls back to the exact int4
    preset when the budget admits nothing (e.g. budget 0 with widths that
    have no exact plan raises — there is nothing correct to run).

    The INT4_EXACT fallback is gated on ``shard_groups == 1``: the preset
    packs at minimal spacing, so its widened form overflows the middle
    field — serving it row-sharded would be exactly the illegal layout
    the certificate clauses reject.  A shard count no plan supports
    (a8w8 8-way exceeds the int32 budget outright) raises instead."""
    ranked = rank_plans(a_bits, w_bits, error_budget=error_budget, **kwargs)
    if ranked:
        return ranked[0]
    shard_groups = kwargs.get("shard_groups", 1)
    if a_bits == 4 and w_bits == 4 and shard_groups == 1:
        return plan_report(INT4_EXACT)
    sharded = (
        f" with the contraction sharded {shard_groups} ways (the psum'd "
        "packed word must absorb every shard's products before extraction)"
        if shard_groups > 1 else ""
    )
    raise ValueError(
        f"no packing plan for a{a_bits}w{w_bits} fits error budget "
        f"{error_budget} (MAE per extraction){sharded}; raise the budget, "
        "change the operand widths or lower the tensor-parallel degree"
    )


def plan_linear_layers(
    params,
    a_bits: int = 4,
    w_bits: int = 4,
    error_budget: float = DEFAULT_ERROR_BUDGET,
    min_dim: int | None = None,
    shard_groups: int = 1,
    **kwargs,
) -> dict[str, PlanReport]:
    """Per-layer plan table for every packable matmul weight in ``params``.

    Keys are the same ``/``-joined tree paths ``quantize_for_serving`` uses
    (every layer of the port's per-layer list shares its path, and its
    plan), so the table routes straight into the serving conversion.
    Plans are selected per distinct weight shape (layers sharing a shape
    share the ranking work); with the cost proxy the winner is
    shape-independent, with ``autotune=True`` each shape is measured at its
    own (m, k, n) on ``device``.

    ``shard_groups`` is the tensor-parallel degree of the engine the table
    is built for.  Only ROW-partitioned linears (:func:`linear_partition`)
    accumulate across shards — their plans are selected with the
    widened-word constraint (see :func:`rank_plans`); column-partitioned
    and replicated linears run unmodified single-device arithmetic per
    shard and plan at ``shard_groups=1``."""
    from ..core.packed_params import MIN_DIM, iter_packable_weights

    if min_dim is None:
        min_dim = MIN_DIM
    table: dict[str, PlanReport] = {}
    by_shape: dict[tuple, PlanReport] = {}
    autotune = kwargs.get("autotune", False)
    for path, leaf in iter_packable_weights(params, min_dim=min_dim):
        d_in, d_out = leaf.shape[-2:]
        groups = (
            shard_groups if linear_partition(path) == "row" else 1
        )
        shape_key = (d_in, d_out, groups)
        if shape_key not in by_shape:
            call_kwargs = kwargs
            if autotune and "shape" not in kwargs:
                # probe each distinct weight shape per serving phase: a
                # prefill-like M (chunked grid) and a decode-like GEMV M —
                # the two phases tune to different blocks; a caller-supplied
                # shape overrides the prefill probe for all layers
                call_kwargs = dict(
                    kwargs,
                    shape=(128, d_in, d_out),
                    decode_shape=(8, d_in, d_out),
                )
            by_shape[shape_key] = select_plan(
                a_bits, w_bits, error_budget=error_budget,
                shard_groups=groups, **call_kwargs
            )
        table[path] = by_shape[shape_key]
    return table


# The Megatron partition conventions of the reference's
# ``repro.runtime.sharding`` (``COL_TOKENS``, ``ROW_TOKENS``,
# ``linear_partition``), copied here for ``plan_linear_layers`` until the
# port's tensor-parallel serving (ROADMAP queue 10) ports that module.
COL_TOKENS = frozenset({
    "wq", "wk", "wv", "wqkv", "up", "gate", "upgate", "in_proj", "wz",
    "wi", "wf", "wo_gate", "lm_head", "x_proj", "dt_proj", "patch_proj",
})
ROW_TOKENS = frozenset({"wo", "down", "out_proj"})


def linear_partition(path: str) -> str | None:
    """Partition kind of a linear weight's tree path: ``"col"`` (output
    dim sharded), ``"row"`` (contraction dim sharded, a reduction after
    the shard-local matmul) or None (replicated).  Tokens match the
    "/"-split path exactly, never by substring."""
    tokens = set(path.lower().split("/"))
    if tokens & COL_TOKENS:
        return "col"
    if tokens & ROW_TOKENS:
        return "row"
    return None
