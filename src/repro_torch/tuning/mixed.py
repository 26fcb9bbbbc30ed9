"""Sensitivity-driven mixed-precision serving plans (per-layer widths).

The port's copy of the reference's ``repro.tuning.mixed``: the same two
stages, the same numbers out of the same inputs.

* :func:`measure_layer_sensitivity` — per packable weight path (the
  serving "layer": one layer role like ``/groups/mlp/up/w``, every layer
  of the stack at once, plus ``lm_head``; MoE experts one by one), quantize
  THAT path alone onto an exact packing plan at each candidate width pair
  and measure the model-level damage on calibration tokens: mean logit-KL
  (default) or relative logit MSE against the float forward.  The probe
  runs the real serving arithmetic (``DspTunedLeaf`` + per-path plan; the
  CUDA kernels where ``cfg.quant.use_kernel``), not a fake-quant proxy.

* :func:`allocate_mixed_plans` — greedy budgeted allocation: every layer
  starts at the reference (widest) candidate and the allocator repeatedly
  applies the demotion with the best cost-saved-per-error-added ratio
  that still fits the remaining budget.  Measured error deltas are
  floored at ``NOISE_FLOOR``, so ``mixed_budget=0`` is the uniform
  reference-width plan by construction.

The calibration tokens are the reference's draw,
``jax.random.randint(PRNGKey(seed), (calib_batch, n_calib_tokens), 2,
vocab_size)``, recomputed in numpy (``tuning._jax_prng``); divergences are
reduced in float64 numpy, as the reference reduces them.  The port's
parameter tree has no layer axis (a list adds no path component), so a
path comes up once per layer: the targets are the sorted unique paths and
a path's ``n_values`` is its size summed over the layers, the size of the
reference's stacked leaf.

The result's ``plans`` table is keyed by tree path and routes straight
into ``core.packed_params.quantize_for_serving``: the engine's
``quant_mode="dsp_mixed"`` is exactly this pipeline at build time.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..runtime.sharding import linear_partition
from . import _jax_prng
from .score import plan_cost_proxy
from .tuner import PlanReport, select_plan

__all__ = [
    "DEFAULT_WIDTH_CANDIDATES",
    "DEFAULT_MIXED_BUDGET",
    "NOISE_FLOOR",
    "LayerSensitivity",
    "MixedAllocation",
    "PROBES",
    "measure_layer_sensitivity",
    "allocate_mixed_plans",
    "suggest_budget",
    "mixed_precision_plan",
]


class _ProbeCounter:
    """Counts sensitivity-probe forwards (the expensive part of a mixed
    build); a warm build from the plan database runs none."""

    def __init__(self) -> None:
        self.count = 0

    def reset(self) -> int:
        """Zero the counter, returning the value it held."""
        prev, self.count = self.count, 0
        return prev


PROBES = _ProbeCounter()

# Candidate (a_bits, w_bits) pairs searched per layer; every pair has
# proven-exact plans, so the packing adds no error on top of the
# quantization the sensitivity pass measures.
DEFAULT_WIDTH_CANDIDATES = ((4, 4), (8, 4), (4, 8), (8, 8))

# Default model-level budget: total added mean logit-KL (nats, summed over
# demoted layers) the allocator may spend relative to the uniform
# reference-width plan.
DEFAULT_MIXED_BUDGET = 0.05

# Measured error deltas below this are sampling noise: every admitted
# demotion charges at least this much, so a zero budget admits none.
NOISE_FLOOR = 1e-9


def _widest(widths) -> tuple[int, int]:
    """The reference candidate: most total bits, activation bits breaking
    ties."""
    return max(widths, key=lambda b: (b[0] + b[1], b[0]))


@dataclasses.dataclass(frozen=True)
class LayerSensitivity:
    """Measured model-level damage of quantizing one layer alone."""

    path: str
    n_values: int  # weight element count over all layers — the cost weighting
    # (a_bits, w_bits) -> mean logit divergence vs the float forward
    errors: dict[tuple[int, int], float]

    def delta(self, bits: tuple[int, int], base: tuple[int, int]) -> float:
        """Error added by serving this layer at ``bits`` instead of
        ``base``, floored at the measurement noise floor."""
        return max(self.errors[bits] - self.errors[base], NOISE_FLOOR)


@dataclasses.dataclass(frozen=True)
class MixedAllocation:
    """The allocator's verdict: one width pair (and plan) per layer."""

    assignments: dict[str, tuple[int, int]]  # path -> (a_bits, w_bits)
    plans: dict[str, PlanReport]             # path -> selected plan
    base_bits: tuple[int, int]
    budget: float
    predicted_error: float  # sum of admitted per-layer error deltas
    cost: float             # proxy-weighted packed-word work, allocated
    base_cost: float        # same, uniform reference widths
    sensitivities: tuple[LayerSensitivity, ...]

    @property
    def distinct_widths(self) -> int:
        return len(set(self.assignments.values()))

    @property
    def cost_vs_uniform_base(self) -> float:
        """Allocated packed-word work relative to the uniform reference
        widths (1.0 when nothing was demoted, or nothing is packable)."""
        return self.cost / self.base_cost if self.base_cost else 1.0

    def summary(self) -> dict:
        """JSON-ready digest (the serve CLI's printout)."""
        return {
            "base_bits": list(self.base_bits),
            "budget": self.budget,
            "predicted_error": self.predicted_error,
            "cost_vs_uniform_base": self.cost_vs_uniform_base,
            "distinct_widths": self.distinct_widths,
            "assignments": {
                p: f"a{a}w{w}" for p, (a, w) in sorted(self.assignments.items())
            },
            # static pedigree of each layer's plan: exact vs bounded
            "certificates": {
                p: self.plans[p].certificate.to_json_summary()
                for p in sorted(self.plans)
            },
        }


def _log_softmax(x: np.ndarray) -> np.ndarray:
    m = x.max(axis=-1, keepdims=True)
    return x - m - np.log(np.exp(x - m).sum(axis=-1, keepdims=True))


def _divergence(base_logits, got_logits, metric: str) -> float:
    """Mean per-position divergence between two (B, S, V) logit arrays."""
    base = np.asarray(base_logits, np.float64)
    got = np.asarray(got_logits, np.float64)
    if metric == "mse":
        return float(np.mean((got - base) ** 2) / max(np.mean(base**2), 1e-12))
    if metric != "kl":
        raise ValueError(f"metric {metric!r} not in ('kl', 'mse')")
    lp, lq = _log_softmax(base), _log_softmax(got)
    return float(np.mean(np.sum(np.exp(lp) * (lp - lq), axis=-1)))


def measure_layer_sensitivity(
    params,
    cfg,
    widths=DEFAULT_WIDTH_CANDIDATES,
    n_calib_tokens: int = 32,
    calib_batch: int = 2,
    seed: int = 0,
    metric: str = "kl",
    exact_first: bool = True,
) -> list[LayerSensitivity]:
    """Per-layer quantization damage at each candidate width pair.

    For every packable weight path, quantize that path ALONE onto the
    selected exact plan at each ``(a_bits, w_bits)`` in ``widths`` and run
    the eager forward (``valid=None``: an MoE layer takes its capacity
    path) on the seeded calibration tokens; the recorded error is the mean
    logit-KL (or relative MSE) against the float forward.  ``cfg.quant``
    must route tuned leaves (the engine passes its ``dsp_tuned`` config);
    its ``use_kernel`` says where the probes run."""
    from ..core.packed_params import (
        iter_packable_weights,
        quantize_for_serving,
        split_expert_stacks,
    )
    from ..models import transformer as T

    if metric not in ("kl", "mse"):
        raise ValueError(f"metric {metric!r} not in ('kl', 'mse')")
    # per-expert sensitivity: expert stacks split into e<N> leaves
    params = split_expert_stacks(params)
    device = params["embed"]["w"].device
    # the reference's draw: jax.random.randint(PRNGKey(seed), ..., 2, vocab)
    tokens = torch.from_numpy(_jax_prng.randint(
        _jax_prng.prng_key(seed), (calib_batch, n_calib_tokens), 2, cfg.vocab_size,
    )).to(device=device, dtype=torch.int64)

    @torch.inference_mode()
    def fwd(p) -> np.ndarray:
        logits = T.forward(p, cfg, tokens)[0]
        return logits.to(torch.float64).cpu().numpy()

    base_logits = fwd(params)
    specs = {
        b: select_plan(b[0], b[1], error_budget=0.0, exact_first=exact_first)
        for b in widths
    }
    sizes: dict[str, int] = {}
    for p, leaf in iter_packable_weights(params):
        sizes[p] = sizes.get(p, 0) + leaf.numel()
    out = []
    for path in sorted(sizes):
        errors = {}
        for bits in widths:
            probe = quantize_for_serving(
                params, "dsp_tuned", plans={path: specs[bits]},
                only_planned=True, prepack=True, use_kernel=cfg.quant.use_kernel,
            )
            PROBES.count += 1
            errors[bits] = _divergence(base_logits, fwd(probe), metric)
            del probe
        out.append(LayerSensitivity(path, sizes[path], errors))
    return out


def _layer_costs(sens: LayerSensitivity, plans) -> dict[tuple[int, int], float]:
    """Packed-word work of serving this layer at each width: the plan's
    cost proxy (words per K element) times the weight element count."""
    return {
        bits: plan_cost_proxy(r.spec) * sens.n_values
        for bits, r in plans.items()
    }


def _plan_table(widths, error_budget, exact_first, shard_groups):
    """Per-width plan table at one shard count.  Widths with no shard-
    legal plan are absent; the allocator never assigns them to a sharded
    row layer."""
    table = {}
    for b in widths:
        try:
            table[b] = select_plan(
                b[0], b[1], error_budget=error_budget,
                exact_first=exact_first, shard_groups=shard_groups,
            )
        except ValueError:
            if shard_groups == 1:
                raise
    return table


def allocate_mixed_plans(
    sensitivities,
    mixed_budget: float = DEFAULT_MIXED_BUDGET,
    widths=DEFAULT_WIDTH_CANDIDATES,
    base_bits: tuple[int, int] | None = None,
    error_budget: float = 0.0,
    exact_first: bool = True,
    shard_groups: int = 1,
) -> MixedAllocation:
    """Greedy budgeted width allocation over measured sensitivities.

    Every layer starts at ``base_bits`` (default: the widest candidate).
    Each round considers every (layer, cheaper width) demotion whose
    floored error delta still fits the remaining budget and applies the
    one with the best cost-saved / error-added ratio (ties broken by the
    larger saving, then path name).  ``error_budget`` is the plan-level
    MAE budget forwarded to ``select_plan`` per width; 0 keeps every plan
    provably exact.  ``shard_groups > 1`` selects shard-legal plans for
    row-partitioned layers (``runtime.sharding.linear_partition``); a row
    layer whose ``base_bits`` has none starts at the widest servable
    candidate (forced, not charged against the budget, but counted in
    ``predicted_error``)."""
    if base_bits is None:
        base_bits = _widest(widths)
    if base_bits not in widths:
        raise ValueError(f"base_bits {base_bits} not among candidates {widths}")
    plans = _plan_table(widths, error_budget, exact_first, 1)
    if shard_groups > 1:
        plans_row = _plan_table(widths, error_budget, exact_first, shard_groups)

        def table_for(path):
            return plans_row if linear_partition(path) == "row" else plans
    else:
        def table_for(path):
            return plans

    # certified packed-arithmetic error prior per candidate width: zero for
    # certificate-exact plans, the certified per-extraction MAE otherwise
    def _prior(table):
        return {
            b: (0.0 if r.certificate.exact
                else float(r.certificate.mae_per_extraction))
            for b, r in table.items()
        }

    tables = {s.path: table_for(s.path) for s in sensitivities}
    priors = {s.path: _prior(tables[s.path]) for s in sensitivities}
    costs = {s.path: _layer_costs(s, tables[s.path]) for s in sensitivities}
    by_path = {s.path: s for s in sensitivities}
    current = {}
    starts = {}
    forced = 0.0
    for s in sensitivities:
        if base_bits in tables[s.path]:
            current[s.path] = base_bits
        else:
            cands = [b for b in widths if b in tables[s.path]]
            if not cands:
                raise ValueError(
                    f"no candidate width in {tuple(widths)} is servable for "
                    f"{s.path!r} at shard_groups={shard_groups}; lower the "
                    "tensor-parallel degree or narrow the candidates"
                )
            start = _widest(cands)
            current[s.path] = start
            forced += s.delta(start, base_bits)
        starts[s.path] = current[s.path]
    spent = 0.0
    while True:
        best = None  # (ratio, d_cost, path, bits, d_err)
        for path, sens in sorted(by_path.items()):
            cur = current[path]
            prior = priors[path]
            for bits in costs[path]:
                d_cost = costs[path][cur] - costs[path][bits]
                if d_cost <= 0:
                    continue
                d_err = max(sens.delta(bits, cur), prior[bits] - prior[cur])
                if spent + d_err > mixed_budget:
                    continue
                if best is None or (d_cost / d_err, d_cost) > (best[0], best[1]):
                    best = (d_cost / d_err, d_cost, path, bits, d_err)
        if best is None:
            break
        _, _, path, bits, d_err = best
        current[path] = bits
        spent += d_err
    return MixedAllocation(
        assignments=current,
        plans={p: tables[p][b] for p, b in current.items()},
        base_bits=base_bits,
        budget=mixed_budget,
        predicted_error=spent + forced,
        cost=sum(costs[p][b] for p, b in current.items()),
        base_cost=sum(costs[p][starts[p]] for p in current),
        sensitivities=tuple(sensitivities),
    )


def suggest_budget(
    sensitivities,
    widths=DEFAULT_WIDTH_CANDIDATES,
    base_bits: tuple[int, int] | None = None,
    fraction: float = 0.5,
) -> float:
    """A budget that lands on a genuinely mixed assignment: ``fraction`` of
    the error a full demotion would add, halved until the greedy
    allocation holds at least two distinct width pairs."""
    if base_bits is None:
        base_bits = _widest(widths)
    sensitivities = list(sensitivities)
    if len(sensitivities) < 2:
        raise ValueError(
            f"a mixed assignment needs at least two packable layers, got "
            f"{len(sensitivities)} — serve a uniform plan (dsp_tuned) "
            "instead"
        )
    cheapest = min(widths, key=lambda b: (b[0] + b[1], b))
    total = sum(s.delta(cheapest, base_bits) for s in sensitivities)
    budget = fraction * total
    for _ in range(12):
        alloc = allocate_mixed_plans(
            sensitivities, budget, widths=widths, base_bits=base_bits
        )
        if alloc.distinct_widths >= 2:
            return budget
        budget /= 2
    raise ValueError(
        "no mixed operating point found: every probed budget allocates a "
        "uniform width (layers are indistinguishable to the sensitivity "
        "pass — raise n_calib_tokens, or pick a mixed_budget by hand)"
    )


def mixed_precision_plan(
    params,
    cfg,
    mixed_budget: float = DEFAULT_MIXED_BUDGET,
    widths=DEFAULT_WIDTH_CANDIDATES,
    base_bits: tuple[int, int] | None = None,
    error_budget: float = 0.0,
    n_calib_tokens: int = 32,
    calib_batch: int = 2,
    seed: int = 0,
    metric: str = "kl",
    exact_first: bool = True,
    shard_groups: int = 1,
) -> MixedAllocation:
    """measure → allocate, end to end (the engine-build entry point).
    Sensitivity is measured unsharded; only the allocation's plan tables
    are shard-aware (see :func:`allocate_mixed_plans`)."""
    sens = measure_layer_sensitivity(
        params, cfg, widths=widths, n_calib_tokens=n_calib_tokens,
        calib_batch=calib_batch, seed=seed, metric=metric,
        exact_first=exact_first,
    )
    return allocate_mixed_plans(
        sens, mixed_budget=mixed_budget, widths=widths, base_bits=base_bits,
        error_budget=error_budget, exact_first=exact_first,
        shard_groups=shard_groups,
    )
