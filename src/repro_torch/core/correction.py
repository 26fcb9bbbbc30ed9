"""Error-correction schemes for DSP packing (paper §V/§VI) + error metrics.

The port's counterpart of the reference's ``repro.core.correction``, on
int64 tensors (see :mod:`.packing`).  Together they reproduce the paper's
Tables I/II: :func:`scheme_stats` enumerates every operand combination of
a configuration on the device it is given and measures each scheme.

Schemes
  * ``naive``   — Xilinx white-paper extraction; biased by −1 whenever the
                  cumulative lower fields are negative (§V).
  * ``full``    — Full Error Correction: round-half-up at extraction
                  (Eqn. 7).  Exact for ``delta >= 0`` configs.
  * ``approx``  — Approximate Correction: pre-bias the product through the
                  accumulator (C port) with the anticipated sign of the
                  field below each result (Fig. 4).  No extra hardware.
  * ``mr``      — MR-Overpacking: for ``delta < 0``, restore each field's
                  corrupted MSBs by subtracting the exactly-computed LSBs of
                  the field above (Eqns. 8/9, Fig. 6).
  * ``mr+full`` — MR restore *and* round-half-up.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device
from .packing import (
    PackingConfig,
    as_int64,
    extract_fields,
    mul_lsbs,
    multiply_packed,
    outer_product_exact,
    sign_extend,
)

__all__ = [
    "SCHEMES",
    "approx_correction_word",
    "simulate",
    "mr_restore",
    "ErrorStats",
    "error_stats",
    "exhaustive_operands",
    "scheme_stats",
]


def _by_offset(cfg: PackingConfig) -> list[int]:
    """Result indices in ascending field offset (stable)."""
    return sorted(range(cfg.n_results), key=lambda n: cfg.r_offsets[n])


def approx_correction_word(cfg: PackingConfig, w) -> torch.Tensor:
    """The 48-bit C-port pre-bias of §V-B (Fig. 4).

    For every result field ``n >= 1`` the field below it (``n-1``) floors the
    extraction by −1 exactly when the cumulative lower value is negative.
    Its sign is *anticipated* from the sign bit of the signed operand
    ``w_{j(n-1)}`` that generates field ``n-1`` (the unsigned ``a`` operand
    cannot flip a sign).  The anticipated bit is added at offset
    ``r_offsets[n]`` *before* the product is formed, cancelling the bias.
    The anticipation fails only when the generating product is zero while
    ``w < 0`` (e.g. ``a_{i(n-1)} == 0``) — the residual 3 % of §V-B.
    """
    w = as_int64(w)
    word = torch.zeros(w.shape[:-1], dtype=torch.int64, device=w.device)
    order = _by_offset(cfg)
    for rank in range(1, cfg.n_results):
        _, j_below = cfg.result_operands(order[rank - 1])
        sign_bit = (w[..., j_below] < 0).to(torch.int64)
        word = word + (sign_bit << cfg.r_offsets[order[rank]])
    return word


def mr_restore(cfg: PackingConfig, fields, a, w) -> torch.Tensor:
    """Most-significant-bit Restoring Overpacking (§VI-B).

    With ``delta < 0`` adjacent fields overlap by ``|delta|`` bits: the LSBs
    of field ``n+1`` were *added* into the top ``|delta|`` bits of field
    ``n``.  Those LSBs are recomputed exactly from the operands (cheap in
    hardware — Eqns. 8/9) and subtracted after extraction.
    """
    fields = as_int64(fields)
    if cfg.delta >= 0:
        return fields
    a, w = as_int64(a), as_int64(w)
    out = fields.clone()
    order = _by_offset(cfg)
    for rank in range(cfg.n_results - 1):
        n, above = order[rank], order[rank + 1]
        shift = cfg.r_offsets[above] - cfg.r_offsets[n]
        if shift >= cfg.r_widths[n]:
            continue  # no overlap between these two fields
        i, j = cfg.result_operands(above)
        contam = mul_lsbs(a[..., i], w[..., j], cfg.r_widths[n] - shift)
        # field arithmetic is modulo 2**width: re-wrap after the subtraction
        out[..., n] = sign_extend(out[..., n] - (contam << shift), cfg.r_widths[n])
    return out


SCHEMES = ("naive", "full", "approx", "mr", "mr+full")


def simulate(
    cfg: PackingConfig,
    a,
    w,
    scheme: str = "naive",
    accumulate_correction=None,
) -> torch.Tensor:
    """End-to-end packed multiply → extraction under a correction scheme."""
    if scheme not in SCHEMES:
        raise ValueError(f"unknown scheme {scheme!r}; options: {sorted(SCHEMES)}")
    a, w = as_int64(a), as_int64(w)
    cword = None
    if scheme == "approx":
        cword = approx_correction_word(cfg, w)
    if accumulate_correction is not None:
        extra = as_int64(accumulate_correction)
        cword = extra if cword is None else cword + extra
    p = multiply_packed(cfg, a, w, correction_word=cword)
    fields = extract_fields(cfg, p, round_half_up=scheme in ("full", "mr+full"))
    if scheme in ("mr", "mr+full"):
        fields = mr_restore(cfg, fields, a, w)
    return fields


# ---- error metrics (paper §VIII, Eqns. 10-12) ---------------------------


@dataclasses.dataclass(frozen=True)
class ErrorStats:
    """EP (%), MAE, WCE — per result field and aggregated (bar accent)."""

    ep: tuple[float, ...]
    mae: tuple[float, ...]
    wce: tuple[int, ...]

    @property
    def ep_bar(self) -> float:
        return float(np.mean(self.ep))

    @property
    def mae_bar(self) -> float:
        return float(np.mean(self.mae))

    @property
    def wce_bar(self) -> int:
        return int(np.max(self.wce))

    def row(self) -> str:
        return f"MAE={self.mae_bar:.2f} EP={self.ep_bar:.2f}% WCE={self.wce_bar}"


def error_stats(expected, actual) -> ErrorStats:
    """Eqns. (10)-(12) over the leading axes, per result field.

    Counts and error sums are taken in int64 and divided once in float64,
    so the statistics do not depend on the device's summation order."""
    err = (as_int64(actual) - as_int64(expected)).abs()
    flat = err.reshape(-1, err.shape[-1])
    n = flat.shape[0]
    ep = tuple(c / n * 100.0 for c in (flat > 0).sum(0).tolist())
    mae = tuple(s / n for s in flat.sum(0).tolist())
    wce = tuple(int(x) for x in flat.amax(0).tolist())
    return ErrorStats(ep=ep, mae=mae, wce=wce)


def exhaustive_operands(
    cfg: PackingConfig, device: str | torch.device | None = "cuda"
) -> tuple[torch.Tensor, torch.Tensor]:
    """Every possible (a, w) combination for a config — the paper's ``N``.

    Returns int64 tensors of shape ``(N, n_a)`` and ``(N, n_w)`` on
    ``device`` (default the card).
    """
    dev = resolve_device(device)
    axes = [torch.arange(1 << width, dtype=torch.int64, device=dev)
            for width in cfg.a_widths]
    axes += [
        torch.arange(-(1 << (width - 1)), 1 << (width - 1), dtype=torch.int64, device=dev)
        for width in cfg.w_widths
    ]
    flat = [g.reshape(-1) for g in torch.meshgrid(*axes, indexing="ij")]
    return torch.stack(flat[: cfg.n_a], dim=-1), torch.stack(flat[cfg.n_a:], dim=-1)


def scheme_stats(
    cfg: PackingConfig, scheme: str, device: str | torch.device | None = "cuda"
) -> ErrorStats:
    """Exhaustive error statistics of ``scheme`` for ``cfg`` (Tables I/II),
    computed on ``device`` (default the card)."""
    a, w = exhaustive_operands(cfg, device)
    expected = outer_product_exact(cfg, a, w)
    actual = simulate(cfg, a, w, scheme=scheme)
    return error_stats(expected, actual)
