"""Packing-plan subsystem: enumerate → score → autotune → select.

The port's copy of the reference's ``repro.tuning``: ``plans`` (the
enumerators), ``score`` (error metrics), ``autotune`` (the kernel-variant
sweep on the card), ``tuner`` (budgeted selection, per-layer tables),
``mixed`` (sensitivity-driven per-layer widths, the ``dsp_mixed`` serving
mode) and ``plandb`` (the persisted plan database).
"""

from .autotune import (
    BlockTiming,
    autotune_block,
    autotune_phase_blocks,
    candidate_blocks,
    default_timer,
)
from .mixed import (
    DEFAULT_MIXED_BUDGET,
    DEFAULT_WIDTH_CANDIDATES,
    NOISE_FLOOR,
    PROBES,
    LayerSensitivity,
    MixedAllocation,
    allocate_mixed_plans,
    measure_layer_sensitivity,
    mixed_precision_plan,
    suggest_budget,
)
from .plandb import (
    SCHEMA_VERSION,
    PlanDB,
    allocation_from_json,
    allocation_to_json,
    plan_key,
    report_from_json,
    report_to_json,
)
from .plans import (
    DEFAULT_MAX_MR_BITS,
    DEFAULT_N_COLUMNS,
    DEFAULT_N_PAIRS,
    enumerate_packing_configs,
    enumerate_specs,
    min_exact_p,
    spec_from_json,
    spec_to_json,
)
from .score import SpecScore, config_error_stats, plan_cost_proxy, spec_error_stats
from .tuner import (
    DEFAULT_ERROR_BUDGET,
    PlanReport,
    plan_linear_layers,
    rank_plans,
    select_plan,
)

__all__ = [
    "BlockTiming",
    "autotune_block",
    "autotune_phase_blocks",
    "candidate_blocks",
    "default_timer",
    "DEFAULT_MAX_MR_BITS",
    "DEFAULT_N_COLUMNS",
    "DEFAULT_N_PAIRS",
    "enumerate_packing_configs",
    "enumerate_specs",
    "min_exact_p",
    "SpecScore",
    "config_error_stats",
    "plan_cost_proxy",
    "spec_error_stats",
    "DEFAULT_ERROR_BUDGET",
    "SCHEMA_VERSION",
    "PlanDB",
    "plan_key",
    "report_to_json",
    "report_from_json",
    "allocation_to_json",
    "allocation_from_json",
    "DEFAULT_MIXED_BUDGET",
    "DEFAULT_WIDTH_CANDIDATES",
    "NOISE_FLOOR",
    "PROBES",
    "LayerSensitivity",
    "MixedAllocation",
    "allocate_mixed_plans",
    "measure_layer_sensitivity",
    "mixed_precision_plan",
    "suggest_budget",
    "spec_to_json",
    "spec_from_json",
    "PlanReport",
    "plan_linear_layers",
    "rank_plans",
    "select_plan",
]
