"""The language model of every family: parameters, decode cache, forward.

Counterpart of the reference's ``repro.models.transformer``.  Layers are
organized into groups of one structure (``ModelConfig.group_size`` layers
each); the reference stacks the groups along a leading axis and scans over
it, here ``params["groups"]`` and the cache are lists of ``n_groups``
dicts and the forward is a Python loop.  Inside a group the reference's
inner stacks are lists too, so every parameter keeps the reference's path
(a list adds no path component).

Family -> group:
  dense   1 layer: attention + SwiGLU (or GELU) MLP; a sliding window
          (h2o-danube) masks and caches attention by its window
  moe     1 layer: attention + the top-k MoE FFN of ``models.moe``
  ssm     ``slstm_every`` layers: one sLSTM, then ``g - 1`` mLSTMs
          (``mlstm`` a list), no FFN
  hybrid  ``attn_every`` layers (jamba): attention at slot ``g // 2``,
          Mamba elsewhere (``mamba``, ``g - 1``); the MoE FFN on odd
          slots (``moe``, ``g // 2``), the MLP on even ones (``mlp``);
          per-slot norms ``ln_mix`` and ``ln_ffn`` ((g, d) scales)
  encdec  decoder group: self-attention, cross-attention (``xattn``) and a
          GELU MLP; :func:`encode` runs the encoder's groups
  vlm     the dense layers; ``patch_embeds`` go through ``patch_proj`` and
          are prepended to the sequence

Recurrent state (sLSTM, mLSTM, Mamba) is f32 in the cache whatever the
compute dtype; the ssm family's cache holds no KV.  The continuous
engine's paged cache (:func:`init_paged_cache`) holds page pools in place
of the dense K/V, read and written through ``forward``'s ``page_table``.

Under autograd without a cache (training), each group runs under one
``torch.utils.checkpoint`` when ``cfg.remat`` is ``"dots"`` or ``"full"``,
as the reference's ``_remat`` wraps its scan body: the group's forward is
recomputed in the backward and only its inputs are kept (the reference's
``"dots"`` also keeps its matmul outputs; a selective checkpoint here
costs a Python dispatch per op, which the recurrent scans' many small ops
cannot afford); ``"none"`` keeps everything.  It changes memory, not
values.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..core.packed_linear import apply_linear
from ..device import resolve_device
from ..runtime.act_sharding import checkpoint_contexts, constrain, constrain_group_params
from .config import ModelConfig
from .layers import (
    Params,
    attention,
    gelu_mlp,
    init_attention,
    init_gelu_mlp,
    init_kv_cache,
    init_linear,
    init_mlp,
    init_paged_kv_cache,
    init_rmsnorm,
    mlp,
    rmsnorm,
)
from .moe import init_moe, moe_ffn
from .ssm import (
    init_mamba,
    init_mamba_cache,
    init_mlstm,
    init_mlstm_cache,
    init_slstm,
    init_slstm_cache,
    mamba,
    mlstm,
    slstm,
)

__all__ = ["init_params", "init_cache", "init_paged_cache", "forward", "encode",
           "compute_dtype", "Model"]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
_F32 = torch.float32


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def _init_group(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype,
                dev: torch.device, cross_attn: bool) -> Params:
    fam, d = cfg.family, cfg.d_model
    if fam in ("dense", "vlm") or (fam == "encdec" and not cross_attn):
        gelu = fam == "encdec" or cfg.mlp_variant == "gelu"
        return {
            "ln1": init_rmsnorm(d, dtype, dev),
            "attn": init_attention(gen, cfg, dtype, dev),
            "ln2": init_rmsnorm(d, dtype, dev),
            "mlp": (init_gelu_mlp if gelu else init_mlp)(gen, cfg, dtype, dev),
        }
    if fam == "encdec":  # the decoder group
        return {
            "ln1": init_rmsnorm(d, dtype, dev),
            "attn": init_attention(gen, cfg, dtype, dev),
            "ln_x": init_rmsnorm(d, dtype, dev),
            "xattn": init_attention(gen, cfg, dtype, dev),
            "ln2": init_rmsnorm(d, dtype, dev),
            "mlp": init_gelu_mlp(gen, cfg, dtype, dev),
        }
    if fam == "moe":
        return {
            "ln1": init_rmsnorm(d, dtype, dev),
            "attn": init_attention(gen, cfg, dtype, dev),
            "ln2": init_rmsnorm(d, dtype, dev),
            "moe": init_moe(gen, cfg, dtype, dev),
        }
    g = cfg.group_size
    if fam == "ssm":
        return {
            "ln_s": init_rmsnorm(d, dtype, dev),
            "slstm": init_slstm(gen, cfg, dtype, dev),
            "ln_m": {"scale": torch.ones((g - 1, d), dtype=dtype, device=dev)},
            "mlstm": [init_mlstm(gen, cfg, dtype, dev) for _ in range(g - 1)],
        }
    if fam == "hybrid":
        n_moe = g // 2
        return {
            "ln_mix": {"scale": torch.ones((g, d), dtype=dtype, device=dev)},
            "ln_ffn": {"scale": torch.ones((g, d), dtype=dtype, device=dev)},
            "attn": init_attention(gen, cfg, dtype, dev),
            "mamba": [init_mamba(gen, cfg, dtype, dev) for _ in range(g - 1)],
            "moe": [init_moe(gen, cfg, dtype, dev) for _ in range(n_moe)],
            "mlp": [init_mlp(gen, cfg, dtype, dev) for _ in range(g - n_moe)],
        }
    raise ValueError(f"unknown family {fam!r}")


def init_params(cfg: ModelConfig, seed: int = 0, dtype: torch.dtype = torch.float32,
                device: str | torch.device = "cuda") -> Params:
    """Random parameters from a seeded ``torch.Generator`` on ``device``,
    with the reference's scales: N(0, 1/d_in) projections, N(0, 0.02**2)
    embeddings, unit norms, zero biases, Mamba's conv at N(0, 0.01) with
    ``a_log = log(1..d_state)``; the encoder's groups (encdec) and
    ``patch_proj`` (vlm) after the decoder's.  ``device="meta"`` gives the
    tree's shapes alone."""
    dev = resolve_device(device)
    # on the meta device (shapes only) there is no generator to seed
    gen = None if dev.type == "meta" else torch.Generator(device=dev).manual_seed(seed)
    d, v = cfg.d_model, cfg.vocab_size
    groups = [_init_group(gen, cfg, dtype, dev, cross_attn=cfg.family == "encdec")
              for _ in range(cfg.n_groups)]
    embed = torch.randn((v, d), generator=gen, dtype=dtype, device=dev).mul_(0.02)
    params: Params = {
        "embed": {"w": embed},
        "groups": groups,
        "final_norm": init_rmsnorm(d, dtype, dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = init_linear(gen, d, v, False, dtype, dev)
    if cfg.family == "encdec":
        params["encoder"] = {
            "groups": [_init_group(gen, cfg, dtype, dev, cross_attn=False)
                       for _ in range(cfg.n_encoder_layers)],
            "final_norm": init_rmsnorm(d, dtype, dev),
        }
    if cfg.family == "vlm":
        params["patch_proj"] = init_linear(gen, d, d, False, dtype, dev)
    return params


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: torch.dtype | None = None,
               device: str | torch.device = "cuda") -> list[Params]:
    """Per-group decode cache, every leaf with the batch (slot) axis first:
    dense K/V (a sliding window's ring) in ``dtype`` (None: the compute
    dtype), recurrent state in f32."""
    dev = resolve_device(device)
    dtype = compute_dtype(cfg) if dtype is None else dtype
    fam, g = cfg.family, cfg.group_size

    def group() -> Params:
        if fam == "ssm":
            return {"slstm": init_slstm_cache(cfg, batch, _F32, dev),
                    "mlstm": [init_mlstm_cache(cfg, batch, _F32, dev)
                              for _ in range(g - 1)]}
        kv = {"attn": init_kv_cache(cfg, batch, max_len, dtype, dev)}
        if fam == "hybrid":
            kv["mamba"] = [init_mamba_cache(cfg, batch, _F32, dev) for _ in range(g - 1)]
        elif fam not in ("dense", "vlm", "moe", "encdec"):
            raise ValueError(f"unknown family {fam!r}")
        return kv

    return [group() for _ in range(cfg.n_groups)]


def init_paged_cache(cfg: ModelConfig, n_pages: int, page_size: int,
                     dtype: torch.dtype | None = None, batch: int | None = None,
                     device: str | torch.device = "cuda") -> list[Params]:
    """Per-group paged decode cache of the continuous engine: each attention
    layer's K/V in ``(n_pages, page_size, n_kv, hd)`` pools of ``dtype``
    (None: the compute dtype), written and read through a per-lane page
    table (``serving.paged_cache``); a sliding window's pools hold its ring
    slots.  Recurrent state (ssm; hybrid's Mamba) has no positions to page:
    it is per-lane state with the lane axis first, f32, as in
    :func:`init_cache`, so ``batch`` (the lanes) is required for those
    families; the hybrid tree holds both kinds of leaf."""
    dev = resolve_device(device)
    dtype = compute_dtype(cfg) if dtype is None else dtype
    fam, g = cfg.family, cfg.group_size
    if fam in ("ssm", "hybrid") and batch is None:
        raise ValueError(
            f"family {fam!r} keeps per-lane recurrent state in its paged "
            "cache: pass batch=<n_lanes>"
        )
    if fam == "ssm":
        # no KV anywhere: the paged cache is the per-lane state alone
        return init_cache(cfg, batch, 1, dtype, dev)
    if fam not in ("dense", "vlm", "moe", "encdec", "hybrid"):
        raise ValueError(f"unknown family {fam!r}")

    def group() -> Params:
        kv = {"attn": init_paged_kv_cache(cfg, n_pages, page_size, dtype, dev)}
        if fam == "hybrid":
            kv["mamba"] = [init_mamba_cache(cfg, batch, _F32, dev) for _ in range(g - 1)]
        return kv

    return [group() for _ in range(cfg.n_groups)]


def _slot_norm(ln: Params, i: int) -> Params:
    return {"scale": ln["scale"][i]}


def _apply_group(gp: Params, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor, cache: Params | None,
                 encoder_out: torch.Tensor | None, causal: bool = True,
                 valid: torch.Tensor | None = None,
                 page_table: torch.Tensor | None = None):
    """One group: returns ``(x, new_cache, aux_loss)``.  ``valid`` (B, S)
    bool gates the recurrent mixers' state and makes MoE dispatch dropless
    (the serving engine's per-row mask); ``page_table`` routes the
    attention cache through a paged cache."""
    fam, spec, eps = cfg.family, cfg.quant, cfg.norm_eps
    aux = torch.zeros((), dtype=_F32, device=x.device)

    def attn(p, h, kv):
        return attention(p, h, cfg, positions, cache=kv, causal=causal,
                         page_table=page_table)

    if fam in ("dense", "vlm") or (fam == "encdec" and encoder_out is None
                                   and cache is None and not causal):
        h, new_kv = attn(gp["attn"], rmsnorm(gp["ln1"], x, eps),
                         None if cache is None else cache["attn"])
        x = x + h
        x = x + mlp(gp["mlp"], rmsnorm(gp["ln2"], x, eps), spec)
        return x, None if new_kv is None else {"attn": new_kv}, aux

    if fam == "moe":
        h, new_kv = attn(gp["attn"], rmsnorm(gp["ln1"], x, eps),
                         None if cache is None else cache["attn"])
        x = x + h
        y, aux = moe_ffn(gp["moe"], rmsnorm(gp["ln2"], x, eps), cfg, spec, valid=valid)
        return x + y, None if new_kv is None else {"attn": new_kv}, aux

    if fam == "encdec":  # the decoder group
        h, new_kv = attn(gp["attn"], rmsnorm(gp["ln1"], x, eps),
                         None if cache is None else cache["attn"])
        x = x + h
        # cross-attention: without encoder_out (the serving engine) it is
        # roped self-attention over this call's tokens, bidirectional, as
        # in the reference
        h, _ = attention(gp["xattn"], rmsnorm(gp["ln_x"], x, eps), cfg, positions,
                         causal=False, kv_x=encoder_out)
        x = x + h
        x = x + gelu_mlp(gp["mlp"], rmsnorm(gp["ln2"], x, eps), spec)
        return x, None if new_kv is None else {"attn": new_kv}, aux

    if fam == "ssm":
        h, new_s = slstm(gp["slstm"], rmsnorm(gp["ln_s"], x, eps), cfg,
                         cache=None if cache is None else cache["slstm"], valid=valid)
        x = x + h
        new_ml = []
        for i, sub in enumerate(gp["mlstm"]):
            h, nc = mlstm(sub, rmsnorm(_slot_norm(gp["ln_m"], i), x, eps), cfg,
                          cache=None if cache is None else cache["mlstm"][i],
                          valid=valid)
            x = x + h
            new_ml.append(nc)
        return x, None if cache is None else {"slstm": new_s, "mlstm": new_ml}, aux

    if fam == "hybrid":
        g = cfg.group_size
        mamba_i = moe_i = mlp_i = 0
        new_mam, new_kv = [], None
        for slot in range(g):
            h_in = rmsnorm(_slot_norm(gp["ln_mix"], slot), x, eps)
            if slot == g // 2:
                h, new_kv = attn(gp["attn"], h_in, None if cache is None else cache["attn"])
            else:
                h, nc = mamba(gp["mamba"][mamba_i], h_in, cfg,
                              cache=None if cache is None else cache["mamba"][mamba_i],
                              valid=valid)
                new_mam.append(nc)
                mamba_i += 1
            x = x + h
            h_in = rmsnorm(_slot_norm(gp["ln_ffn"], slot), x, eps)
            if slot % 2 == 1 and cfg.n_experts:
                y, a = moe_ffn(gp["moe"][moe_i], h_in, cfg, spec, valid=valid)
                aux = aux + a
                moe_i += 1
            else:
                y = mlp(gp["mlp"][mlp_i], h_in, spec)
                mlp_i += 1
            x = x + y
        return x, None if cache is None else {"attn": new_kv, "mamba": new_mam}, aux

    raise ValueError(f"unknown family {fam!r}")


def _any_requires_grad(tree) -> bool:
    if isinstance(tree, dict):
        return any(_any_requires_grad(v) for v in tree.values())
    if isinstance(tree, list):
        return any(_any_requires_grad(v) for v in tree)
    return isinstance(tree, torch.Tensor) and tree.requires_grad


def _run_group(gp: Params, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor,
               cache: Params | None, encoder_out: torch.Tensor | None,
               causal: bool = True, valid: torch.Tensor | None = None,
               page_table: torch.Tensor | None = None):
    """:func:`_group_body`, under ``cfg.remat``'s checkpoint when it is
    differentiated without a cache (module docstring)."""
    if (cache is not None or cfg.remat == "none" or not torch.is_grad_enabled()
            or not (x.requires_grad or _any_requires_grad(gp))):
        return _group_body(gp, x, cfg, positions, cache, encoder_out, causal,
                           valid=valid, page_table=page_table)
    if cfg.remat not in ("dots", "full"):
        raise ValueError(f"remat {cfg.remat!r} not in ('none', 'dots', 'full')")
    return checkpoint(_group_body, gp, x, cfg, positions, None, encoder_out, causal,
                      valid, page_table, use_reentrant=False,
                      context_fn=checkpoint_contexts)


def _group_body(gp: Params, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor,
                cache: Params | None, encoder_out: torch.Tensor | None,
                causal: bool = True, valid: torch.Tensor | None = None,
                page_table: torch.Tensor | None = None):
    """:func:`_apply_group` under the activation-sharding policy, as the
    reference's scan body: the group's weights re-pinned (gathered whole
    under a training mesh), the residual stream constrained."""
    y, new_c, aux = _apply_group(constrain_group_params(gp), constrain(x, "residual"), cfg,
                                 positions, cache, encoder_out, causal, valid=valid,
                                 page_table=page_table)
    return constrain(y, "residual"), new_c, aux


def _sinusoidal(length: int, d: int, device: torch.device) -> torch.Tensor:
    pos = torch.arange(length, dtype=_F32, device=device)[:, None]
    dim = torch.arange(0, d, 2, dtype=_F32, device=device)[None]
    angle = pos / torch.pow(10_000.0, dim / d)
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)


def encode(params: Params, cfg: ModelConfig, frames: torch.Tensor) -> torch.Tensor:
    """The whisper encoder over stub frame embeddings (B, T, d): sinusoidal
    positions, then the encoder's groups, bidirectional, and its norm."""
    x = frames.to(compute_dtype(cfg))
    t = x.shape[1]
    x = x + _sinusoidal(t, cfg.d_model, x.device)[None].to(x.dtype)
    positions = torch.arange(t, device=x.device)[None]
    for gp in params["encoder"]["groups"]:
        x, _, _ = _run_group(gp, x, cfg, positions, None, None, causal=False)
    return rmsnorm(params["encoder"]["final_norm"], x, cfg.norm_eps)


def forward(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,
    positions: torch.Tensor | None = None,
    cache: list[Params] | None = None,
    encoder_out: torch.Tensor | None = None,
    patch_embeds: torch.Tensor | None = None,
    logits_dtype: torch.dtype = torch.float32,
    return_hidden: bool = False,
    valid: torch.Tensor | None = None,
    page_table: torch.Tensor | None = None,
) -> tuple[torch.Tensor, list[Params] | None, torch.Tensor]:
    """Token ids -> logits.  Returns ``(logits, new_cache, aux_loss)``: the
    MoE layers' load-balance losses summed (zero without MoE, as the
    reference's).

    Decode: ``tokens`` is (B, 1) with ``positions`` (B, 1) and the cache.
    ``encoder_out`` (B, T, d) feeds the encdec decoder's cross-attention;
    ``patch_embeds`` (B, P, d) are projected and prepended (vlm).
    ``return_hidden`` returns the post-final-norm hidden states instead of
    logits (serving prefill projects only the last prompt position).
    ``valid`` (B, S) bool is the serving engine's per-row mask: recurrent
    state advances only on valid tokens, and MoE layers dispatch dropless
    and route masked tokens to no expert (``models.moe``); ``None`` keeps
    the chunked scans and the capacity path.  ``page_table`` (B,
    max_blocks) routes K/V writes and reads through a paged cache
    (:func:`init_paged_cache`) instead of per-row dense windows.
    """
    x = params["embed"]["w"][tokens].to(compute_dtype(cfg))
    if patch_embeds is not None:
        pe = apply_linear(params["patch_proj"], patch_embeds.to(x.dtype), cfg.quant)
        x = torch.cat([pe, x], dim=1)
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
    new_cache = None if cache is None else []
    aux = torch.zeros((), dtype=_F32, device=x.device)
    for i, gp in enumerate(params["groups"]):
        x, nc, a = _run_group(gp, x, cfg, positions,
                              None if cache is None else cache[i], encoder_out,
                              valid=valid, page_table=page_table)
        aux = aux + a
        if new_cache is not None:
            new_cache.append(nc)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if return_hidden:
        return x, new_cache, aux
    if cfg.tie_embeddings:
        logits = x.to(logits_dtype) @ params["embed"]["w"].T.to(logits_dtype)
    else:
        logits = apply_linear(params["lm_head"], x, cfg.quant).to(logits_dtype)
    return logits, new_cache, aux


class Model:
    """A thin object veneer over the functions above."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg

    def init(self, seed: int = 0, dtype: torch.dtype = torch.float32,
             device: str | torch.device = "cuda") -> Params:
        return init_params(self.cfg, seed, dtype, device)

    def init_cache(self, batch: int, max_len: int, dtype: torch.dtype | None = None,
                   device: str | torch.device = "cuda") -> list[Params]:
        return init_cache(self.cfg, batch, max_len, dtype, device)

    def __call__(self, params: Params, tokens: torch.Tensor, **kw):
        return forward(params, self.cfg, tokens, **kw)
