"""Token sampling for the serving engine.

Counterpart of the reference's ``repro.serving.sampling``: one batched
primitive, :func:`sample_tokens`, serves the prefill first-token draw and
every decode step, with per-row temperature, top-k and top-p.  Rows with
``temperature == 0`` take the argmax (greedy).

Randomness is stateless: the Gumbel noise of a row is drawn from a
``torch.Generator`` seeded by (engine seed, request id, position), so a
replayed request reproduces its tokens whatever the other rows do.  The
draws are not the reference's (``jax.random`` and torch generate different
numbers), so sampled tokens are held to determinism and to the top-k/top-p
set, not token for token.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["SamplingParams", "GREEDY", "row_seed", "sample_tokens"]

NEG_INF = -1e30  # mask value; dominates any temperature-scaled logit


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling controls.  ``temperature == 0`` means greedy;
    ``top_k == 0`` and ``top_p == 1.0`` disable the respective filters."""

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0

    def __post_init__(self) -> None:
        if self.temperature < 0:
            raise ValueError(f"temperature must be >= 0, got {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if not 0 < self.top_p <= 1:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")


GREEDY = SamplingParams()


def row_seed(seed: int, rid: int, position: int) -> int:
    """The generator seed of one draw: a hash of (seed, rid, position)."""
    state = np.random.SeedSequence([seed, rid, position]).generate_state(2)
    return int(state[0]) << 31 ^ int(state[1])


def keep_mask(logits: torch.Tensor, temperature: torch.Tensor,
              top_k: torch.Tensor, top_p: torch.Tensor) -> torch.Tensor:
    """(B, V) bool: the tokens the top-k / top-p filters keep, with the
    reference's formula (ties at the k-th value keep a few extra; the
    nucleus is the smallest sorted prefix reaching ``top_p``)."""
    v = logits.shape[-1]
    scaled = logits / torch.clamp_min(temperature, 1e-6)[:, None]
    desc = torch.sort(scaled, dim=-1, descending=True).values
    kth = torch.gather(desc, -1, (top_k - 1).clamp(0, v - 1)[:, None].long())
    keep = torch.where((top_k > 0)[:, None], scaled >= kth, True)
    probs = torch.softmax(scaled, dim=-1)
    sp = torch.sort(probs, dim=-1, descending=True).values
    csum = torch.cumsum(sp, dim=-1)
    n_keep = torch.clamp_min((csum - sp < top_p[:, None]).sum(-1), 1)
    thr = torch.gather(sp, -1, (n_keep - 1)[:, None])
    return keep & (probs >= thr)


def sample_tokens(
    logits: torch.Tensor,      # (B, V) float
    seeds: list[int],          # (B,) per-row seeds (row_seed of rid, pos)
    temperature: torch.Tensor,  # (B,) float32
    top_k: torch.Tensor,        # (B,) int, 0 = off
    top_p: torch.Tensor,        # (B,) float32, 1.0 = off
) -> torch.Tensor:
    """Draw one token per row (int64 (B,)).  Greedy rows take the argmax
    and consume no randomness."""
    logits = logits.to(torch.float32)
    greedy = torch.argmax(logits, dim=-1)
    sampled_rows = [i for i, t in enumerate(temperature.tolist()) if t > 0]
    if not sampled_rows:
        return greedy
    scaled = logits / torch.clamp_min(temperature, 1e-6)[:, None]
    masked = torch.where(keep_mask(logits, temperature, top_k, top_p),
                         scaled, NEG_INF)
    out = greedy.clone()
    v = logits.shape[-1]
    for i in sampled_rows:
        gen = torch.Generator(device=logits.device).manual_seed(seeds[i])
        u = torch.rand(v, generator=gen, device=logits.device,
                       dtype=torch.float32).clamp_(1e-20, 1.0)
        gumbel = -torch.log(-torch.log(u))
        out[i] = torch.argmax(masked[i] + gumbel)
    return out
