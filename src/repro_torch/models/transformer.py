"""The decoder LM: parameters, decode cache and forward pass.

Counterpart of the reference's ``repro.models.transformer`` for the
``dense`` and ``moe`` families (a ``moe`` layer is attention and the
top-k MoE FFN of ``models.moe``).  The reference stacks its layers along
a leading ``groups`` axis and scans over it; here ``params["groups"]`` and
the cache are per-layer lists and the forward is a Python loop over
layers.  Other families raise, naming the roadmap queue that ports them.
"""

from __future__ import annotations

import torch

from ..core.packed_linear import apply_linear
from ..device import resolve_device
from .config import ModelConfig
from .layers import (
    Params,
    attention,
    init_attention,
    init_gelu_mlp,
    init_kv_cache,
    init_linear,
    init_mlp,
    init_rmsnorm,
    mlp,
    rmsnorm,
)
from .moe import init_moe, moe_ffn

__all__ = ["init_params", "init_cache", "forward", "compute_dtype"]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


PORTED_FAMILIES = ("dense", "moe")


def _require_ported(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"model family {cfg.family!r} ({cfg.name}) is not ported yet: the "
            "port serves the dense and moe families (ROADMAP queue 8 ports "
            "the others)"
        )


def init_params(cfg: ModelConfig, seed: int = 0, dtype: torch.dtype = torch.float32,
                device: str | torch.device = "cuda") -> Params:
    """Random parameters from a seeded ``torch.Generator`` on ``device``,
    with the reference's scales: N(0, 1/d_in) projections, N(0, 0.02**2)
    embeddings, unit norms, zero biases; a ``moe`` layer's router and
    expert stacks (``models.moe.init_moe``) in place of the MLP."""
    _require_ported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    d, v = cfg.d_model, cfg.vocab_size
    if cfg.family == "moe":
        ffn_name, make_ffn = "moe", init_moe
    else:
        ffn_name = "mlp"
        make_ffn = init_gelu_mlp if cfg.mlp_variant == "gelu" else init_mlp
    groups = [
        {
            "ln1": init_rmsnorm(d, dtype, dev),
            "attn": init_attention(gen, cfg, dtype, dev),
            "ln2": init_rmsnorm(d, dtype, dev),
            ffn_name: make_ffn(gen, cfg, dtype, dev),
        }
        for _ in range(cfg.n_layers)
    ]
    embed = torch.randn((v, d), generator=gen, dtype=dtype, device=dev).mul_(0.02)
    params: Params = {
        "embed": {"w": embed},
        "groups": groups,
        "final_norm": init_rmsnorm(d, dtype, dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = init_linear(gen, d, v, False, dtype, dev)
    return params


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: torch.dtype | None = None,
               device: str | torch.device = "cuda") -> list[Params]:
    """Per-layer dense KV cache; ``dtype=None`` takes the compute dtype."""
    _require_ported(cfg)
    dev = resolve_device(device)
    dtype = compute_dtype(cfg) if dtype is None else dtype
    return [{"attn": init_kv_cache(cfg, batch, max_len, dtype, dev)}
            for _ in range(cfg.n_layers)]


def forward(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,
    positions: torch.Tensor | None = None,
    cache: list[Params] | None = None,
    logits_dtype: torch.dtype = torch.float32,
    return_hidden: bool = False,
    valid: torch.Tensor | None = None,
) -> tuple[torch.Tensor, list[Params] | None, torch.Tensor]:
    """Token ids -> logits.  Returns ``(logits, new_cache, aux_loss)``: the
    MoE layers' load-balance losses summed (a zero for the dense family, as
    the reference's).

    Decode: ``tokens`` is (B, 1) with ``positions`` (B, 1) and the cache.
    ``return_hidden`` returns the post-final-norm hidden states instead of
    logits (serving prefill projects only the last prompt position).
    ``valid`` (B, S) bool is the serving engine's per-row mask: MoE layers
    then dispatch dropless and route masked tokens to no expert
    (``models.moe``); ``None`` keeps the capacity path.
    """
    _require_ported(cfg)
    x = params["embed"]["w"][tokens].to(compute_dtype(cfg))
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
    new_cache = None if cache is None else []
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, gp in enumerate(params["groups"]):
        h, new_kv = attention(
            gp["attn"], rmsnorm(gp["ln1"], x, cfg.norm_eps), cfg, positions,
            cache=None if cache is None else cache[i]["attn"],
        )
        x = x + h
        if "moe" in gp:
            y, layer_aux = moe_ffn(gp["moe"], rmsnorm(gp["ln2"], x, cfg.norm_eps), cfg,
                                   cfg.quant, valid=valid)
            x = x + y
            aux = aux + layer_aux
        else:
            x = x + mlp(gp["mlp"], rmsnorm(gp["ln2"], x, cfg.norm_eps), cfg.quant)
        if new_cache is not None:
            new_cache.append({"attn": new_kv})
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if return_hidden:
        return x, new_cache, aux
    if cfg.tie_embeddings:
        logits = x.to(logits_dtype) @ params["embed"]["w"].T.to(logits_dtype)
    else:
        logits = apply_linear(params["lm_head"], x, cfg.quant).to(logits_dtype)
    return logits, new_cache, aux
