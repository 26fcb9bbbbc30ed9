"""Transformer layers, as functions on tensors.

Counterpart of the reference's ``repro.models.layers``: ``rmsnorm``,
``rope``, GQA ``attention`` (the no-cache branch, causal or not, chunked
online softmax under ``ModelConfig.attention_chunk``; the dense-cache
branch with per-row positions; the sliding window's causal window mask and
its ring cache written at ``pos % window``; cross-attention from
``kv_x``), the SwiGLU ``mlp`` and ``gelu_mlp``, each with the engine-build
fused projections (``wqkv``, ``upgate``).  Every projection goes through
:func:`core.packed_linear.apply_linear`.  Attention is plain PyTorch
(einsum and softmax), as it is jnp in the reference; the paged branch is
not ported yet and raises.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from ..core.packed_linear import LinearSpec, apply_linear
from .config import ModelConfig

__all__ = [
    "rmsnorm", "rope", "attention", "mlp", "gelu_mlp", "init_linear",
    "init_rmsnorm", "init_attention", "init_mlp", "init_gelu_mlp",
    "init_kv_cache",
]

Params = dict[str, Any]

NEG_INF = -1e9  # mask value safe in bf16


def init_linear(gen: torch.Generator, d_in: int, d_out: int, bias: bool,
                dtype: torch.dtype, device: torch.device) -> Params:
    w = torch.randn((d_in, d_out), generator=gen, dtype=dtype, device=device)
    params = {"w": w.mul_(d_in**-0.5)}
    if bias:
        params["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return params


def init_rmsnorm(d: int, dtype: torch.dtype, device: torch.device) -> Params:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(params: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    # variance in f32, normalization in the compute dtype (as the reference)
    xf = x.to(torch.float32)
    var = torch.einsum("...d,...d->...", xf, xf) / x.shape[-1]
    scale = torch.rsqrt(var + eps)[..., None].to(x.dtype)
    return x * scale * params["scale"].to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) or (S,).  Angles in f32, the
    rotation in the compute dtype."""
    hd = x.shape[-1]
    freqs = theta ** (
        -torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd
    )
    angles = positions[..., None].to(torch.float32) * freqs
    if angles.dim() == 2:
        angles = angles[None]
    cos = torch.cos(angles)[:, :, None, :].to(x.dtype)
    sin = torch.sin(angles)[:, :, None, :].to(x.dtype)
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def init_attention(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype,
                   device: torch.device) -> Params:
    d, hd = cfg.d_model, cfg.hd
    return {
        "wq": init_linear(gen, d, cfg.n_heads * hd, cfg.qkv_bias, dtype, device),
        "wk": init_linear(gen, d, cfg.n_kv_heads * hd, cfg.qkv_bias, dtype, device),
        "wv": init_linear(gen, d, cfg.n_kv_heads * hd, cfg.qkv_bias, dtype, device),
        "wo": init_linear(gen, cfg.n_heads * hd, d, False, dtype, device),
    }


def _repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    if n_rep == 1:
        return x
    b, s, kv, hd = x.shape
    return x[:, :, :, None, :].expand(b, s, kv, n_rep, hd).reshape(b, s, kv * n_rep, hd)


def attention(
    params: Params,
    x: torch.Tensor,
    cfg: ModelConfig,
    positions: torch.Tensor,
    cache: Params | None = None,
    causal: bool = True,
    kv_x: torch.Tensor | None = None,
) -> tuple[torch.Tensor, Params | None]:
    """GQA attention.  ``cache=None``: the full sequence, causal (within
    the sliding window, if the config has one) or not.  With a dense
    ``cache`` ({"k", "v"}: (B, window, n_kv, hd)): decode or cached chunked
    prefill; every row writes its K/V at its own position (at ``pos %
    window`` in a sliding window's ring, which takes one position a call)
    and attends over the cache.  ``kv_x`` is cross-attention: K and V come
    from ``kv_x``, without rope, and fused ``wqkv`` is never used.
    Returns ``(out, new_cache)``; the cache passed in is not modified (the
    engine merges rows, as the reference's)."""
    if cache is not None and "pages_k" in cache:
        raise NotImplementedError(
            "paged attention is not ported yet (ROADMAP queue 9)"
        )
    b, s, _ = x.shape
    hd, nh, nkv = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    spec = cfg.quant
    if "wqkv" in params:
        # engine-build fused projection (packed_params.fuse_projection_weights):
        # bit-identical per column to the three unfused ones; self-attention only
        if kv_x is not None:
            raise ValueError("fused wqkv is self-attention only")
        qkv = apply_linear(params["wqkv"], x, spec)
        q, k, v = qkv.split((nh * hd, nkv * hd, nkv * hd), dim=-1)
        q = q.reshape(b, s, nh, hd)
        k = k.reshape(b, s, nkv, hd)
        v = v.reshape(b, s, nkv, hd)
    else:
        src = x if kv_x is None else kv_x
        q = apply_linear(params["wq"], x, spec).reshape(b, s, nh, hd)
        k = apply_linear(params["wk"], src, spec).reshape(b, src.shape[1], nkv, hd)
        v = apply_linear(params["wv"], src, spec).reshape(b, src.shape[1], nkv, hd)
    if kv_x is None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)

    new_cache = None
    if cache is not None:
        window = cache["k"].shape[1]
        if positions.dim() == 2:
            row_pos = positions[:, 0]
        else:
            row_pos = positions.reshape(-1)[:1].expand(b)
        # a sliding window's ring takes position pos at slot pos % window;
        # the update slice is clamped to fit the window, as
        # lax.dynamic_update_slice clamps its start index
        slot = row_pos % window if cfg.sliding_window else row_pos
        start = slot.clamp(0, window - s)
        idx = (start[:, None] + torch.arange(s, device=x.device)[None])
        idx = idx[:, :, None, None].expand(b, s, nkv, hd)
        k_all = cache["k"].scatter(1, idx, k.to(cache["k"].dtype))
        v_all = cache["v"].scatter(1, idx, v.to(cache["v"].dtype))
        new_cache = {"k": k_all, "v": v_all}
        k, v = k_all, v_all
        cache_positions = torch.arange(window, device=x.device)
        qidx = torch.arange(s, device=x.device)
        if cfg.sliding_window:
            # the ring: every slot written so far is inside the window
            valid = ((cache_positions[None, :] <= slot[:, None])
                     | (row_pos[:, None] >= window))
            valid = valid[:, None, :].expand(b, s, window)
        else:
            valid = (cache_positions[None, None, :]
                     <= row_pos[:, None, None] + qidx[None, :, None])
        mask = torch.where(valid[:, None, :, :], 0.0, NEG_INF)
    elif causal:
        ii = positions if positions.dim() == 2 else positions[None]
        ok = ii[:, None, :] <= ii[:, :, None]
        if cfg.sliding_window:
            ok &= ii[:, None, :] > ii[:, :, None] - cfg.sliding_window
        mask = torch.where(ok[:, None, :, :], 0.0, NEG_INF)
    else:
        mask = None

    k = _repeat_kv(k, nh // nkv)
    v = _repeat_kv(v, nh // nkv)
    chunk = cfg.attention_chunk
    if (cache is None and kv_x is None and causal and chunk and s > chunk
            and s % chunk == 0):
        window = (cfg.sliding_window,) if cfg.sliding_window else ()
        out = _chunked_causal_attention(q, k, v, chunk, *window)
    else:
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32) * hd**-0.5
        if mask is not None:
            scores = scores + mask
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
    out = out.reshape(b, s, nh * hd)
    return apply_linear(params["wo"], out, spec), new_cache


def _chunked_causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              chunk: int, window: int | None = None) -> torch.Tensor:
    """Online-softmax causal attention over key chunks, the reference's
    ``_chunked_causal_attention``: the S x S scores never exist at once,
    only (B, H, S, chunk).  Running max, denominator and accumulator in
    f32, masked scores ``NEG_INF``, division by ``max(l, 1e-30)``; a
    ``window`` masks keys at or before ``q - window``.  Query positions are
    the standard ``arange(S)``.  (B, S, H, hd) in and out."""
    b, s, h, hd = q.shape
    scale = hd**-0.5
    q_pos = torch.arange(s, device=q.device)
    m = torch.full((b, h, s), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, s), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, s, hd), dtype=torch.float32, device=q.device)
    for i in range(s // chunk):
        keys = slice(i * chunk, (i + 1) * chunk)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k[:, keys]).to(torch.float32) * scale
        ok = q_pos[keys][None, :] <= q_pos[:, None]
        if window:
            ok &= q_pos[keys][None, :] > q_pos[:, None] - window
        scores = torch.where(ok, scores, NEG_INF)
        m_new = torch.maximum(m, scores.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(scores - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p, v[:, keys].to(torch.float32))
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                  dtype: torch.dtype, device: torch.device) -> Params:
    """Dense K/V of ``max_len`` positions, or of a sliding window's ring
    (``min(max_len, window)`` slots)."""
    window = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    shape = (batch, window, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_mlp(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype,
             device: torch.device) -> Params:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "up": init_linear(gen, d, f, False, dtype, device),
        "gate": init_linear(gen, d, f, False, dtype, device),
        "down": init_linear(gen, f, d, False, dtype, device),
    }


def mlp(params: Params, x: torch.Tensor, spec: LinearSpec) -> torch.Tensor:
    if "upgate" in params:
        # engine-build fused up|gate: one matmul, bit-identical per column
        up, gate = apply_linear(params["upgate"], x, spec).chunk(2, dim=-1)
        return apply_linear(params["down"], F.silu(gate) * up, spec)
    if "gate" not in params:  # 2-matrix GELU variant
        return gelu_mlp(params, x, spec)
    up = apply_linear(params["up"], x, spec)
    gate = apply_linear(params["gate"], x, spec)
    return apply_linear(params["down"], F.silu(gate) * up, spec)


def init_gelu_mlp(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype,
                  device: torch.device) -> Params:
    return {
        "up": init_linear(gen, cfg.d_model, cfg.d_ff, False, dtype, device),
        "down": init_linear(gen, cfg.d_ff, cfg.d_model, False, dtype, device),
    }


def gelu_mlp(params: Params, x: torch.Tensor, spec: LinearSpec) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    hidden = apply_linear(params["up"], x, spec)
    return apply_linear(params["down"], F.gelu(hidden, approximate="tanh"), spec)
