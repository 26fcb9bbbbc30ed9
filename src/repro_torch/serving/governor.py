"""Load-adaptive precision governor: graceful degradation under load.

The port of the reference's ``repro.serving.governor``.  The paper's
central trade is a quality/throughput dial — exact plans against
Overpacking (more multiplications per packed word at a bounded, certified
MAE).  The engine holds two or three fully prebuilt weight allocations —
**tiers** — and a hysteresis controller swaps the active one at a step
boundary when the scheduler's signals say the engine is drowning (or has
recovered).

Tiers (built once at engine construction, from the same post-fusion float
weights the primary build quantized):

* ``primary`` — the allocation the engine was configured for (the
  ``dsp_mixed`` allocation, or the ``dsp_tuned`` table).
* ``narrow`` — every layer on the narrowest candidate's provably exact
  plan: the cheapest certified-exact serving point.
* ``emergency`` (optional) — every layer on an *overpacked* plan with a
  certified MAE bound: more multiplications per word than any exact
  layout permits, quality bounded by the plan certificate.

A swap repoints ``engine.params`` and ``engine.plan_table``: each
``DspTunedLeaf`` carries its own plan and the CUDA kernels take the plan
per call, and the KV cache does not depend on the weights, so the next
step simply runs the other arithmetic.  Tokens sampled before the swap
are the unswapped engine's; a request admitted after it matches an
engine built on the target tier.

The controller is deliberately boring: swaps need ``hold_steps``
consecutive out-of-band observations to fire, and the counters reset on
every swap, so the dwell between swaps is at least ``hold_steps``.
Under tensor parallelism the tiers plan row-partitioned layers for the
widened cross-rank word (``shard_groups``) and certify that spec, and the
engine partitions every tier onto its mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from ..kernels.ref import widen_for_shards
from ..runtime.sharding import linear_partition

__all__ = ["GovernorConfig", "Governor", "Tier", "TIER_SEARCHES",
           "build_tiers"]


@dataclasses.dataclass(frozen=True)
class GovernorConfig:
    # degrade when the queue holds at least this many waiting requests...
    queue_high: int = 8
    # ...and recover only when it has drained to at most this many
    # (the gap is the hysteresis band: in between, hold the current tier)
    queue_low: int = 1
    # escalate to the emergency tier (when built) at this queue depth
    emergency_queue_high: int = 24
    # optional extra degrade signals, each ignored when None: decode-step
    # rolling median (the StragglerDetector slow-step signal), request
    # arrival rate, and p99 time-per-output-token
    slow_step_ms: float | None = None
    arrival_rate_hz: float | None = None
    p99_tpot_ms: float | None = None
    # consecutive out-of-band observations required before any swap, and
    # the minimum dwell (in observations) between swaps
    hold_steps: int = 4
    # tier construction: the uniformly-narrow fallback's width pair, and
    # whether to also build the overpacked emergency tier with its
    # certified-MAE ceiling (MAE per extraction, paper-table units)
    narrow_bits: tuple[int, int] = (4, 4)
    emergency_tier: bool = False
    emergency_max_mae: float = 0.5
    # StragglerDetector window for the slow-step signal
    window: int = 16

    def __post_init__(self) -> None:
        if self.queue_low >= self.queue_high:
            raise ValueError(
                f"queue_low ({self.queue_low}) must be < queue_high "
                f"({self.queue_high}) — the gap IS the hysteresis band"
            )
        if self.emergency_queue_high <= self.queue_high:
            raise ValueError(
                f"emergency_queue_high ({self.emergency_queue_high}) must "
                f"be > queue_high ({self.queue_high})"
            )
        if self.hold_steps < 1:
            raise ValueError(f"hold_steps must be >= 1, got {self.hold_steps}")
        if self.window < 1:
            raise ValueError(f"window must be >= 1, got {self.window}")


@dataclasses.dataclass(frozen=True)
class Tier:
    """One prebuilt serving allocation: quantized weights + plan table."""

    name: str
    params: Any                  # fully prequantized weight tree
    plan_table: dict             # path -> PlanReport (what the tier serves)
    # worst certified per-extraction MAE over the tier's plans: 0.0 for a
    # fully exact tier; the emergency tier's quality contract otherwise
    max_certified_mae: float

    def summary(self) -> dict:
        return {
            "name": self.name,
            "n_planned_layers": len(self.plan_table),
            "max_certified_mae": self.max_certified_mae,
            "exact": self.max_certified_mae == 0.0,
        }


class _SearchCounter:
    """Counts tier plan searches (the expensive part of a governed build).
    The plan database's warm-build tests assert this stays at zero across
    a cache-hit governed build — the proof that persisted tier ladders
    skipped the search rather than re-running it and discarding the
    result (mirrors ``tuning.mixed.PROBES``)."""

    def __init__(self) -> None:
        self.count = 0

    def reset(self) -> int:
        """Zero the counter, returning the value it held."""
        prev, self.count = self.count, 0
        return prev


TIER_SEARCHES = _SearchCounter()


def _served_groups(path: str, shard_groups: int) -> int:
    """The shards a layer's packed word sums over: ``shard_groups`` for a
    row-partitioned layer under tensor parallelism, else 1."""
    if shard_groups > 1 and linear_partition(path) == "row":
        return shard_groups
    return 1


def _served_spec(report, path: str, shard_groups: int):
    """The spec whose arithmetic runs for this layer: the plan's own spec,
    widened for a tensor-parallel row layer (the cross-rank sum
    accumulates every shard's products in one word, ``runtime.tp_packed``)."""
    return widen_for_shards(report.spec, _served_groups(path, shard_groups))


def _table_mae(plan_table: dict, shard_groups: int = 1) -> float:
    """The worst certified MAE per extraction over a plan table (0.0 when
    every plan is exact), each layer's spec as it is served."""
    from ..analysis.verify import certify_spec

    out = 0.0
    for path, r in plan_table.items():
        cert = certify_spec(_served_spec(r, path, shard_groups))
        out = max(out, 0.0 if cert.exact else float(cert.mae_per_extraction))
    return out


def build_tiers(cfg, float_params, serve_cfg, primary_params,
                primary_table: dict, gcfg: GovernorConfig,
                tables: dict | None = None,
                shard_groups: int = 1) -> tuple[Tier, ...]:
    """Build the degradation ladder from the post-fusion float weights.

    ``float_params`` must be the tree ``primary_params`` was quantized
    from (same fusion), so that every tier's leaf paths line up and a swap
    changes arithmetic only.  ``cfg`` is the served config: its
    ``quant.use_kernel`` (the engine's resolved choice) ranks proven-exact
    plans first off the kernels, as the primary build does, and builds the
    tiers' leaves for the same path; ``serve_cfg.prepack`` as the primary.
    ``tables`` (``{"narrow": {path: PlanReport}, "emergency": {...}}``,
    from the plan database's ``"tiers"`` record) replaces the tier plan
    searches: quantization still runs, no search does
    (``TIER_SEARCHES.count`` stays flat).  ``shard_groups`` is the
    engine's tensor-parallel degree: tier searches pick shard-legal plans
    for row-partitioned layers as the primary build does."""
    from ..core.packed_params import quantize_for_serving
    from ..tuning import plan_linear_layers

    use_kernel = bool(cfg.quant.use_kernel)
    tables = tables or {}
    tiers = [Tier("primary", primary_params, dict(primary_table),
                  _table_mae(primary_table, shard_groups))]

    def quantized(table: dict):
        return quantize_for_serving(float_params, "dsp_tuned", plans=table,
                                    prepack=serve_cfg.prepack,
                                    use_kernel=use_kernel)

    a, w = gcfg.narrow_bits
    narrow_table = tables.get("narrow")
    if narrow_table is None:
        TIER_SEARCHES.count += 1
        narrow_table = plan_linear_layers(
            float_params, a_bits=a, w_bits=w, error_budget=0.0,
            exact_first=not use_kernel, shard_groups=shard_groups,
        )
    tiers.append(Tier("narrow", quantized(narrow_table), narrow_table,
                      _table_mae(narrow_table, shard_groups)))

    if gcfg.emergency_tier:
        emergency_table = tables.get("emergency")
        if emergency_table is None:
            TIER_SEARCHES.count += 1
            emergency_table = _emergency_table(a, w, gcfg, narrow_table,
                                               shard_groups)
        tiers.append(Tier("emergency", quantized(emergency_table),
                          emergency_table, _table_mae(emergency_table, shard_groups)))
    return tuple(tiers)


def _emergency_table(a: int, w: int, gcfg: GovernorConfig,
                     narrow_table: dict, shard_groups: int = 1) -> dict:
    """The cheapest overpacked plan whose CERTIFIED MAE fits the ceiling,
    on every path of ``narrow_table``: packing density beyond what
    exactness permits, quality bounded by the certificate (never by
    sampling luck).  Under tensor parallelism the pick is made per
    partition kind: a row layer's certificate is the widened spec's."""
    from ..analysis.verify import certify_spec
    from ..tuning import rank_plans

    picks = {}
    for groups in sorted({_served_groups(p, shard_groups) for p in narrow_table} or {1}):
        ranked = rank_plans(a, w, error_budget=gcfg.emergency_max_mae,
                            exact_first=False, shard_groups=groups)
        # gate on the certified bound of the served spec, not the sampled
        # MAE rank_plans filtered on: a lucky zero-measured sample must not
        # admit a plan whose certificate cannot honour the ceiling
        over = []
        for r in ranked:
            cert = certify_spec(widen_for_shards(r.spec, groups))
            if not cert.exact and float(cert.mae_per_extraction) <= gcfg.emergency_max_mae:
                over.append(r)
        if not over:
            sharded = f" at shard_groups={groups}" if groups > 1 else ""
            raise ValueError(
                f"no overpacked a{a}w{w} plan has certified MAE <= "
                f"{gcfg.emergency_max_mae}{sharded}; raise emergency_max_mae or "
                "disable emergency_tier"
            )
        picks[groups] = min(over, key=lambda r: (r.cost_proxy, r.mae_per_extraction))
    return {p: picks[_served_groups(p, shard_groups)] for p in narrow_table}


class Governor:
    """Hysteresis controller over the tier ladder.

    Call :meth:`observe` once per engine step with the current scheduler
    signals; it returns the tier index the engine should serve.  A swap
    fires only after ``hold_steps`` consecutive observations agree, and
    the counters reset on every swap — bounded flapping by construction.
    """

    def __init__(self, config: GovernorConfig, n_tiers: int):
        if n_tiers < 2:
            raise ValueError(f"governor needs >= 2 tiers, got {n_tiers}")
        self.config = config
        self.n_tiers = n_tiers
        self.active = 0
        self.n_swaps = 0
        self.steps = 0
        self._up = 0    # consecutive observations wanting a worse tier
        self._down = 0  # ... wanting a better tier
        # (step, from_tier, to_tier), one entry a swap
        self.history: list[tuple[int, int, int]] = []

    def _desired(self, queue_depth: int, slow_step_ms, arrival_rate_hz,
                 p99_tpot_ms) -> int:
        c = self.config
        hot = queue_depth >= c.queue_high
        if c.slow_step_ms is not None and slow_step_ms:
            hot = hot or slow_step_ms >= c.slow_step_ms
        if c.arrival_rate_hz is not None and arrival_rate_hz:
            hot = hot or arrival_rate_hz >= c.arrival_rate_hz
        if c.p99_tpot_ms is not None and p99_tpot_ms:
            hot = hot or p99_tpot_ms >= c.p99_tpot_ms
        if self.n_tiers > 2 and queue_depth >= c.emergency_queue_high:
            return self.n_tiers - 1
        if hot:
            return max(1, min(self.active, self.n_tiers - 1))
        if queue_depth <= c.queue_low:
            return 0
        return self.active  # hysteresis band: hold

    def observe(self, queue_depth: int, slow_step_ms: float | None = None,
                arrival_rate_hz: float | None = None,
                p99_tpot_ms: float | None = None) -> int:
        self.steps += 1
        desired = self._desired(
            queue_depth, slow_step_ms, arrival_rate_hz, p99_tpot_ms
        )
        if desired > self.active:
            self._up += 1
            self._down = 0
            if self._up >= self.config.hold_steps:
                self._swap(desired)
        elif desired < self.active:
            self._down += 1
            self._up = 0
            if self._down >= self.config.hold_steps:
                # recover one rung at a time: each step back toward full
                # quality re-earns its own hold_steps of calm
                self._swap(self.active - 1)
        else:
            self._up = self._down = 0
        return self.active

    def _swap(self, target: int) -> None:
        self.history.append((self.steps, self.active, target))
        self.active = target
        self.n_swaps += 1
        self._up = self._down = 0

    def stats(self) -> dict:
        return {
            "tier": self.active,
            "swaps": self.n_swaps,
            "observations": self.steps,
            "history": list(self.history),
        }
