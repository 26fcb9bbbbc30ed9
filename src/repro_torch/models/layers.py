"""Transformer layers, as functions on tensors.

Counterpart of the reference's ``repro.models.layers``: ``rmsnorm``,
``rope``, GQA ``attention`` (the no-cache branch, causal or not, chunked
online softmax under ``ModelConfig.attention_chunk``; the dense-cache
branch with per-row positions; the sliding window's causal window mask and
its ring cache written at ``pos % window``; the paged branch of the
continuous engine's cache; cross-attention from ``kv_x``), the SwiGLU
``mlp`` and ``gelu_mlp``, each with the engine-build fused projections
(``wqkv``, ``upgate``).  Every projection goes through
:func:`core.packed_linear.apply_linear`.  Attention is plain PyTorch
(einsum and softmax, the paged branch's write and gather indexing), as it
is jnp in the reference.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from ..core.packed_linear import LinearSpec, apply_linear
from ..runtime.act_sharding import constrain
from .config import ModelConfig

__all__ = [
    "rmsnorm", "rope", "attention", "mlp", "gelu_mlp", "init_linear",
    "init_rmsnorm", "init_attention", "init_mlp", "init_gelu_mlp",
    "init_kv_cache", "init_paged_kv_cache",
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
    page_table: torch.Tensor | None = None,
) -> tuple[torch.Tensor, Params | None]:
    """GQA attention.  ``cache=None``: the full sequence, causal (within
    the sliding window, if the config has one) or not.  With a dense
    ``cache`` ({"k", "v"}: (B, window, n_kv, hd)): decode or cached chunked
    prefill; every row writes its K/V at its own position (at ``pos %
    window`` in a sliding window's ring, which takes one position a call)
    and attends over the cache.  ``kv_x`` is cross-attention: K and V come
    from ``kv_x``, without rope, and fused ``wqkv`` is never used.
    A paged ``cache`` ({"pages_k", "pages_v"}: (n_pages, page_size, n_kv,
    hd) pools) needs ``page_table`` (B, max_blocks), each lane's logical
    blocks mapped to physical pages; entries equal to ``n_pages`` mark
    unallocated blocks and masked lanes (:func:`_paged_write_gather`).
    Returns ``(out, new_cache)``; the cache passed in is not modified (the
    engine merges rows, as the reference's)."""
    if cache is not None and "pages_k" in cache and page_table is None:
        raise ValueError("a paged cache needs a page_table")
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
        q = constrain(q.reshape(b, s, nh, hd), "heads")
        k = constrain(k.reshape(b, s, nkv, hd), "heads")
        v = constrain(v.reshape(b, s, nkv, hd), "heads")
    else:
        src = x if kv_x is None else kv_x
        q = constrain(apply_linear(params["wq"], x, spec).reshape(b, s, nh, hd), "heads")
        k = constrain(apply_linear(params["wk"], src, spec)
                      .reshape(b, src.shape[1], nkv, hd), "heads")
        v = constrain(apply_linear(params["wv"], src, spec)
                      .reshape(b, src.shape[1], nkv, hd), "heads")
    if kv_x is None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)

    new_cache = None
    if cache is not None and "pages_k" in cache:
        k, v, new_cache, valid = _paged_write_gather(cache, page_table, k, v, cfg,
                                                     positions)
        mask = torch.where(valid[:, None, :, :], 0.0, NEG_INF)
    elif cache is not None:
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
        if cache is not None:
            scores = constrain(scores, "scores_decode")
        if mask is not None:
            scores = scores + mask
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
    out = out.reshape(b, s, nh * hd)
    return apply_linear(params["wo"], out, spec), new_cache


def _paged_write_gather(cache: Params, page_table: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor):
    """The paged branch: write this call's K/V through the lanes' page
    table, gather each lane's logical window back, and the validity mask.

    Position ``p`` of a lane sits in logical block ``slot // page_size`` at
    offset ``slot % page_size`` (``slot = p % window`` in a sliding
    window's ring, which the engines fill one position a call; else ``p``);
    positions past the table's ``max_blocks`` go to the sentinel.  JAX
    drops scatter writes to the sentinel page ``n_pages`` and clamps the
    gather there; torch would raise on both, so the port does each by
    hand: the writes go through the pools extended by one scratch page at
    index ``n_pages``, which is then cut off, and the gather clamps the
    table to ``n_pages - 1``.  The mask discards what a sentinel entry
    reads (its ``NEG_INF`` scores give probability 0, and the pools hold
    finite K/V only: they start as zeros).  Returns ``(k, v, new_cache,
    valid)``: k and v (B, window, n_kv, hd) with ``window = max_blocks *
    page_size``, ``valid`` (B, S, window)."""
    pages_k, pages_v = cache["pages_k"], cache["pages_v"]
    n_pages, ps = pages_k.shape[0], pages_k.shape[1]
    b, s = k.shape[0], k.shape[1]
    max_blocks = page_table.shape[1]
    dev = k.device
    if positions.dim() == 2:
        row_pos = positions[:, 0]
    else:
        row_pos = positions.reshape(-1)[:1].expand(b)
    pos = row_pos[:, None] + torch.arange(s, device=dev)[None]       # (B, S)
    slot = pos % cfg.sliding_window if cfg.sliding_window else pos
    blk = slot // ps
    page = page_table.long().gather(1, blk.clamp(0, max_blocks - 1))
    # positions past the logical window must not clamp into a live block
    page = torch.where(blk < max_blocks, page, n_pages)
    off = slot % ps
    scratch = (1,) + tuple(pages_k.shape[1:])
    ext_k = torch.cat([pages_k, pages_k.new_zeros(scratch)])
    ext_v = torch.cat([pages_v, pages_v.new_zeros(scratch)])
    ext_k[page, off] = k.to(ext_k.dtype)
    ext_v[page, off] = v.to(ext_v.dtype)
    pages_k, pages_v = ext_k[:n_pages], ext_v[:n_pages]
    window = max_blocks * ps
    table = page_table.long().clamp(max=n_pages - 1)
    k_all = pages_k[table].reshape(b, window, *pages_k.shape[2:])
    v_all = pages_v[table].reshape(b, window, *pages_v.shape[2:])
    cache_positions = torch.arange(window, device=dev)
    if cfg.sliding_window:
        # every written ring slot is inside the window; gathered slots past
        # the ring are never written
        ring = cfg.sliding_window
        valid = (((cache_positions[None, None, :] <= slot[:, :, None])
                  | (pos[:, :, None] >= ring))
                 & (cache_positions[None, None, :] < ring))
    else:
        valid = cache_positions[None, None, :] <= pos[:, :, None]
    new_cache = {"pages_k": pages_k, "pages_v": pages_v}
    return k_all, v_all, new_cache, valid


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


def init_paged_kv_cache(cfg: ModelConfig, n_pages: int, page_size: int,
                        dtype: torch.dtype, device: torch.device) -> Params:
    """One attention layer's physical page pools, zeros: every serving
    lane's K/V lives in fixed-size pages mapped through a per-lane page
    table (``serving.paged_cache.PageAllocator`` owns the mapping)."""
    shape = (n_pages, page_size, cfg.n_kv_heads, cfg.hd)
    return {"pages_k": torch.zeros(shape, dtype=dtype, device=device),
            "pages_v": torch.zeros(shape, dtype=dtype, device=device)}


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
        ug = constrain(apply_linear(params["upgate"], x, spec), "hidden")
        up, gate = ug.chunk(2, dim=-1)
        return apply_linear(params["down"], F.silu(gate) * up, spec)
    if "gate" not in params:  # 2-matrix GELU variant
        return gelu_mlp(params, x, spec)
    up = constrain(apply_linear(params["up"], x, spec), "hidden")
    gate = constrain(apply_linear(params["gate"], x, spec), "hidden")
    return apply_linear(params["down"], F.silu(gate) * up, spec)


def init_gelu_mlp(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype,
                  device: torch.device) -> Params:
    return {
        "up": init_linear(gen, cfg.d_model, cfg.d_ff, False, dtype, device),
        "down": init_linear(gen, cfg.d_ff, cfg.d_model, False, dtype, device),
    }


def gelu_mlp(params: Params, x: torch.Tensor, spec: LinearSpec) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    hidden = constrain(apply_linear(params["up"], x, spec), "hidden")
    return apply_linear(params["down"], F.gelu(hidden, approximate="tanh"), spec)
