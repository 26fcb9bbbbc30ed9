"""Mixture-of-Experts FFN (dbrx / moonshot styles).

Counterpart of the reference's ``repro.models.moe``: a softmax router
picks each token's top-k experts, gates renormalized over the k; the
token→expert assignments are sorted stably by expert, and every expert
runs the SwiGLU FFN on the rows routed to it.

* **Dropless serving** (``valid`` given, the engines): every valid
  assignment is kept (the reference's capacity ``T·k``); padding lanes
  route to the virtual expert ``E``, which runs nothing and returns zeros,
  so a token's output is a function of its own hidden state alone.
* **The capacity path** (``valid=None``: the eager forward, the
  sensitivity pass's probes): ``cap = max(1, int(T·k/E·capacity_factor))``
  and an assignment whose rank inside its expert's group of the stable sort
  reaches ``cap`` is dropped, exactly as the reference drops it.

The reference runs every expert on a ``cap``-row buffer, mostly padding
(``T·k`` rows each when dropless).  Rows are independent (activations are
quantized per row), so here each expert runs only the rows routed to it,
and an expert with none is skipped: at most ``T·k`` rows in all, and no
launch for an idle expert.  The per-expert row counts cross to the host
once per MoE layer (:data:`HOST_READS` counts those reads).

Weights: ``router`` ``{"w": (d, E)}`` stays float; ``up``/``gate``
``(E, d, f)`` and ``down`` ``(E, f, d)``.  A stacked tensor (``native``)
is multiplied per expert in the compute dtype; per-expert leaves
(``core.packed_params.split_expert_stacks``, every quantizing mode) go
through :func:`core.packed_linear.apply_linear`, so each expert serves its
own plan.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.packed_linear import LinearSpec, apply_linear
from .config import ModelConfig
from .layers import Params

__all__ = ["init_moe", "moe_ffn", "HOST_READS"]

# device-to-host reads of the per-expert row counts (one per MoE layer call)
HOST_READS = {"count": 0}


def init_moe(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype,
             device: torch.device) -> Params:
    """Router and expert stacks with the reference's scales (N(0, 1/d_in))."""
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff

    def normal(*shape):
        w = torch.randn(shape, generator=gen, dtype=dtype, device=device)
        return w.mul_(shape[-2] ** -0.5)

    return {
        "router": {"w": normal(d, e)},
        "up": normal(e, d, f),
        "gate": normal(e, d, f),
        "down": normal(e, f, d),
    }


def _expert(params: Params, i: int, rows: torch.Tensor,
            spec: LinearSpec) -> torch.Tensor:
    """Expert ``i``'s SwiGLU on its rows, in the compute dtype."""
    up_w, gate_w, down_w = params["up"], params["gate"], params["down"]
    if isinstance(up_w, dict):
        key = f"e{i}"
        u = apply_linear({"w": up_w[key]}, rows, spec)
        g = apply_linear({"w": gate_w[key]}, rows, spec)
        return apply_linear({"w": down_w[key]}, F.silu(g) * u, spec)
    dt = rows.dtype  # float stacks (native): the stack is never quantized
    u = rows @ up_w[i].to(dt)
    g = rows @ gate_w[i].to(dt)
    return (F.silu(g) * u) @ down_w[i].to(dt)


def moe_ffn(params: Params, x: torch.Tensor, cfg: ModelConfig,
            spec: LinearSpec | None = None,
            valid: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(output, aux_load_balancing_loss)``; ``valid`` (B, S) bool
    selects dropless serving (module docstring)."""
    spec = spec if spec is not None else LinearSpec()
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.experts_per_token
    cap = t * k if valid is not None else int(max(1, (t * k / e) * cfg.capacity_factor))
    xt = x.reshape(t, d)

    logits = xt.to(torch.float32) @ params["router"]["w"].to(torch.float32)
    probs = torch.softmax(logits, dim=-1)  # (T, E)
    gate_vals, expert_idx = torch.topk(probs, k, dim=-1)  # (T, k)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)
    if valid is not None:
        # the virtual expert e: sorted after every real assignment, never run
        expert_idx = torch.where(valid.reshape(t)[:, None], expert_idx, e)

    # ---- sort-based dispatch: an expert's group in the stable sort, its
    # first ``cap`` entries kept
    flat_e = expert_idx.reshape(t * k)
    order = torch.argsort(flat_e, stable=True)  # sorted rank -> (token, choice)
    counts = torch.bincount(flat_e, minlength=e + 1)[:e]
    first = torch.cumsum(counts, 0) - counts
    starts, kept = torch.stack([first, counts.clamp(max=cap)]).tolist()
    HOST_READS["count"] += 1

    # ---- expert compute: each expert on the rows routed to it
    per_choice = x.new_zeros((t * k, d))
    for i in range(e):
        if kept[i] == 0:
            continue
        choice = order[starts[i]:starts[i] + kept[i]]
        rows = xt.index_select(0, torch.div(choice, k, rounding_mode="floor"))
        per_choice.index_copy_(0, choice, _expert(params, i, rows, spec).to(x.dtype))

    # ---- combine: gate-weighted sum over each token's k choices
    weighted = per_choice.reshape(t, k, d) * gate_vals[..., None].to(x.dtype)
    out = weighted.sum(dim=1).reshape(b, s, d)

    # Switch-style load-balance aux loss (the virtual expert counts nowhere)
    onehot = F.one_hot(expert_idx, e + 1)[..., :e].to(torch.float32)
    density = onehot.sum(dim=1).mean(dim=0)  # (E,)
    router_prob = probs.mean(dim=0)
    aux = e * torch.sum(density * router_prob) / k
    return out, aux
