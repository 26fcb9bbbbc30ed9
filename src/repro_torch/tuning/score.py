"""Error scoring for packing plans (paper §VIII metrics over plan space).

The port's copy of the reference's ``repro.tuning.score``.  Two scorers,
one per compute model:

* :func:`spec_error_stats` — matmul-level error of a pair-packed
  :class:`PackedDotSpec`: the bit-accurate ``ref_packed_matmul`` against
  the exact integer matmul over an operand grid, reduced with
  ``correction.error_stats`` (Eqns. 10-12).  The grid is exhaustive when
  the per-extraction operand space is small enough (the matmul's rows ×
  columns cross product enumerates every (a-tuple, w-tuple) combination in
  one call), sampled otherwise.

* :func:`config_error_stats` — DSP48-level error of a
  :class:`PackingConfig` under a ``core.correction`` scheme, exhaustive
  when the paper's ``N`` is small, sampled otherwise.

Operands are drawn with numpy from the seed, exactly as the reference
draws them, and every product runs on the CPU (plain versions on int32 and
int64 tensors): the scores equal the reference's, float for float.

MAE grows linearly with the number of extractions for the biased schemes,
so plan comparison uses :attr:`SpecScore.mae_per_extraction` — the same
per-packed-multiply normalization as the paper's tables.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from ..core.correction import ErrorStats, error_stats, exhaustive_operands, simulate
from ..core.packing import PackingConfig, outer_product_exact
from ..kernels import ref
from ..kernels.ref import PackedDotSpec

__all__ = [
    "SpecScore",
    "spec_error_stats",
    "spec_operand_grid",
    "config_error_stats",
    "plan_cost_proxy",
]

# Exhaustive matmul probes are capped at this many rows/columns; beyond it
# the operand grid is sampled (the paper's exhaustive tables stop at 4-bit
# pairs for the same reason: 16^4 is tractable, 16^8 is not).
EXHAUSTIVE_LIMIT = 4096


def plan_cost_proxy(spec: PackedDotSpec) -> float:
    """Relative int32 multiply-accumulate work per K element (lower=faster).

    One packed multiply per ``chunk`` K elements — times ``n_columns``,
    because a multi-DSP column plan spends one packed word per column per
    pair position.  The mr restore adds half a multiply for its
    contamination dot, again per column.  Wall-clock
    (``tuner.rank_plans(autotune=True)``, the CUDA kernels timed on the
    card) is the measured alternative."""
    return spec.n_columns * (1.5 if spec.uses_mr else 1.0) / spec.chunk


@dataclasses.dataclass(frozen=True)
class SpecScore:
    """Error metrics of one plan over a probe matmul."""

    spec: PackedDotSpec
    stats: ErrorStats
    n_extractions: int
    exhaustive: bool
    n_samples: int = 4096  # measured output values behind the stats

    @property
    def certificate(self):
        """The plan's static :class:`~repro_torch.analysis.verify.PlanCertificate`
        (cached at the verifier)."""
        from ..analysis.verify import certify_spec

        return certify_spec(self.spec)

    @property
    def mae(self) -> float:
        return self.stats.mae_bar

    @property
    def mae_per_extraction(self) -> float:
        """MAE per packed multiply — certificate-backed for unproven zeros.

        A sampled grid observing zero error is evidence, not proof: when
        the measurement says zero but the plan is not certified exact, the
        certificate's analytic mean error (exact distribution convolution,
        see ``analysis.verify``) replaces the observation — it is provably
        positive for every non-exact dot plan, so an ``error_budget=0``
        selection admits exactly the certified-exact plans."""
        observed = self.stats.mae_bar / self.n_extractions
        if observed > 0.0 or self.exhaustive:
            return observed
        cert = self.certificate
        if cert.exact:
            return 0.0
        return float(cert.mae_per_extraction)

    @property
    def ep(self) -> float:
        return self.stats.ep_bar

    @property
    def wce(self) -> int:
        return self.stats.wce_bar


def _all_tuples(n_vals: int, length: int, lo: int) -> np.ndarray:
    """(n_vals**length, length) grid of every value tuple."""
    grids = np.meshgrid(*([np.arange(n_vals) + lo] * length), indexing="ij")
    return np.stack([g.reshape(-1) for g in grids], axis=-1)


def spec_operand_grid(
    spec: PackedDotSpec,
    n_extractions: int,
    samples: int,
    seed: int,
) -> tuple[np.ndarray, np.ndarray, bool]:
    """Probe operands (x (M, K), w (K, N)) for a spec, K = chunk·extractions.

    Exhaustive when one extraction's operand tuples fit ``EXHAUSTIVE_LIMIT``
    on each side (then ``n_extractions`` is forced to 1 and the matmul's
    M×N cross product covers every combination); sampled otherwise."""
    chunk = spec.chunk
    n_a_tuples = (1 << spec.bits_a) ** chunk
    n_w_tuples = (1 << spec.bits_w) ** chunk
    if n_a_tuples <= EXHAUSTIVE_LIMIT and n_w_tuples <= EXHAUSTIVE_LIMIT:
        x = _all_tuples(1 << spec.bits_a, chunk, 0)
        w = _all_tuples(1 << spec.bits_w, chunk, -(1 << (spec.bits_w - 1))).T
        return x.astype(np.int32), w.astype(np.int32), True
    rng = np.random.default_rng(seed)
    k = chunk * n_extractions
    m = n = max(8, int(np.sqrt(samples)))
    x = rng.integers(0, 1 << spec.bits_a, (m, k)).astype(np.int32)
    w = rng.integers(
        -(1 << (spec.bits_w - 1)), 1 << (spec.bits_w - 1), (k, n)
    ).astype(np.int32)
    return x, w, False


@contextlib.contextmanager
def _one_thread():
    """Run torch's CPU ops on one thread: a probe's products are a few
    thousand elements, where intra-op threads only add synchronisation
    (tens of times slower on a loaded host)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def spec_error_stats(
    spec: PackedDotSpec,
    n_extractions: int = 4,
    samples: int = 4096,
    seed: int = 0,
) -> SpecScore:
    """Matmul-level error of ``spec`` vs the exact integer matmul (CPU)."""
    x, w, exhaustive = spec_operand_grid(spec, n_extractions, samples, seed)
    if exhaustive:
        n_extractions = 1
    xt, wt = torch.from_numpy(x), torch.from_numpy(np.ascontiguousarray(w))
    with _one_thread():
        got = ref.ref_packed_matmul(xt, wt, spec)
        want = ref.ref_quantized_matmul(xt, wt)
        stats = error_stats(want.reshape(-1, 1), got.reshape(-1, 1))
    return SpecScore(spec, stats, n_extractions, exhaustive, got.numel())


def _sampled_operands(
    cfg: PackingConfig, samples: int, seed: int
) -> tuple[torch.Tensor, torch.Tensor]:
    rng = np.random.default_rng(seed)
    a = np.stack(
        [rng.integers(0, 1 << wd, size=samples) for wd in cfg.a_widths], axis=-1
    ).astype(np.int64)
    w = np.stack(
        [
            rng.integers(-(1 << (wd - 1)), 1 << (wd - 1), size=samples)
            for wd in cfg.w_widths
        ],
        axis=-1,
    ).astype(np.int64)
    return torch.from_numpy(a), torch.from_numpy(w)


def config_error_stats(
    cfg: PackingConfig,
    scheme: str,
    samples: int = 8192,
    seed: int = 0,
    exhaustive_limit: int = 1 << 16,
) -> ErrorStats:
    """DSP48-level error of a config under a correction scheme (CPU).

    Exhaustive over the paper's full operand space ``N`` when it fits
    ``exhaustive_limit`` (matching Tables I/II), sampled otherwise."""
    n_total = 1
    for wd in cfg.a_widths:
        n_total *= 1 << wd
    for wd in cfg.w_widths:
        n_total *= 1 << wd
    if n_total <= exhaustive_limit:
        a, w = exhaustive_operands(cfg, "cpu")
    else:
        a, w = _sampled_operands(cfg, samples, seed)
    expected = outer_product_exact(cfg, a, w)
    actual = simulate(cfg, a, w, scheme=scheme)
    return error_stats(expected, actual)
