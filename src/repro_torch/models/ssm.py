"""Recurrent mixers: Mamba (jamba) and xLSTM's sLSTM and mLSTM.

Counterpart of the reference's ``repro.models.ssm``.  Each mixer takes
``(params, x, cfg, cache=None, valid=None)`` and returns ``(out,
new_cache)``; every projection goes through
:func:`core.packed_linear.apply_linear`.

Two branches per mixer, as in the reference:

* ``valid is None`` (the eager forward): Mamba and mLSTM run the chunked
  scan, chunks of ``CHUNK`` tokens with the parallel math inside a chunk;
  sLSTM is sequential anyway.
* ``valid`` given ((B, S) bool, the serving engine's per-row prefix mask):
  a strictly sequential per-token scan of the chunk math at length 1,
  whose carried state is gated ``where(valid_t, new, old)``, so a row's
  state advances by its valid tokens only and a prefill chunk of C tokens
  equals C chunk-1 steps.

Recurrent state is f32 whatever the compute dtype (``init_*_cache``), and
so are Mamba's ``a_log`` and ``d_skip``.  Softplus is
``logaddexp(x, 0)``, as ``jax.nn.softplus`` computes it
(``F.softplus`` turns into the identity above its threshold).  Mamba's
in-chunk scan is a sequential recurrence where the reference runs
``lax.associative_scan``: the same sums in another order, so the eager
branch agrees within a tolerance, not bitwise.  mLSTM's head width is
``d_model // n_heads``, not ``cfg.hd``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.packed_linear import apply_linear
from .config import ModelConfig
from .layers import Params, init_linear, init_rmsnorm, rmsnorm

CHUNK = 256

__all__ = [
    "CHUNK",
    "init_mamba", "mamba", "init_mamba_cache",
    "init_mlstm", "mlstm", "init_mlstm_cache",
    "init_slstm", "slstm", "init_slstm_cache",
]

_F32 = torch.float32


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _gate(ok: torch.Tensor, new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    """``new`` on the rows where ``ok`` ((B,) bool), ``old`` elsewhere."""
    return torch.where(ok.reshape((-1,) + (1,) * (new.dim() - 1)), new, old)


def _chunks(length: int) -> tuple[int, int]:
    """(number of chunks, chunk length) of the eager scan."""
    n = max(1, length // CHUNK)
    cl = length // n
    if cl * n != length:
        raise ValueError(f"sequence length {length} is not a whole number of "
                         f"chunks of about {CHUNK}")
    return n, cl


# ---- Mamba (selective SSM) -------------------------------------------------


def _dt_rank(cfg: ModelConfig) -> int:
    return max(1, cfg.d_model // 16)


def init_mamba(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype,
               device: torch.device) -> Params:
    d = cfg.d_model
    di = d * cfg.mamba_expand
    ds, dc, dr = cfg.mamba_d_state, cfg.mamba_d_conv, _dt_rank(cfg)
    a = torch.arange(1, ds + 1, dtype=_F32, device=device).expand(di, ds)
    conv_w = torch.randn((dc, di), generator=gen, dtype=dtype, device=device)
    return {
        "in_proj": init_linear(gen, d, 2 * di, False, dtype, device),
        "conv_w": conv_w.mul_(0.1),
        "conv_b": torch.zeros((di,), dtype=dtype, device=device),
        "x_proj": init_linear(gen, di, dr + 2 * ds, False, dtype, device),
        "dt_proj": init_linear(gen, dr, di, True, dtype, device),
        "a_log": torch.log(a).contiguous(),
        "d_skip": torch.ones((di,), dtype=_F32, device=device),
        "out_proj": init_linear(gen, di, d, False, dtype, device),
    }


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                     device: torch.device) -> Params:
    di = cfg.d_model * cfg.mamba_expand
    return {
        "conv": torch.zeros((batch, cfg.mamba_d_conv - 1, di), dtype=dtype, device=device),
        "h": torch.zeros((batch, di, cfg.mamba_d_state), dtype=dtype, device=device),
    }


def _mamba_chunk(h: torch.Tensor, a: torch.Tensor, dt_c, b_c, c_c, u_c):
    """One chunk of the selective scan from state ``h`` (B, di, ds): returns
    the state after the chunk and y (B, C, di)."""
    decay = torch.exp(dt_c[..., None] * a[None, None])          # (B, C, di, ds)
    drive = (dt_c * u_c)[..., None] * b_c[:, :, None, :]         # (B, C, di, ds)
    states = []
    for t in range(decay.shape[1]):
        h = decay[:, t] * h + drive[:, t]
        states.append(h)
    h_t = torch.stack(states, dim=1)
    y = torch.einsum("bcds,bcs->bcd", h_t, c_c)
    return h, y


def mamba(params: Params, x: torch.Tensor, cfg: ModelConfig,
          cache: Params | None = None,
          valid: torch.Tensor | None = None) -> tuple[torch.Tensor, Params | None]:
    b, l, d = x.shape
    di = d * cfg.mamba_expand
    ds, dc, dr = cfg.mamba_d_state, cfg.mamba_d_conv, _dt_rank(cfg)
    spec = cfg.quant

    xin, z = apply_linear(params["in_proj"], x, spec).chunk(2, dim=-1)
    prev = (cache["conv"] if cache is not None
            else torch.zeros((b, dc - 1, di), dtype=xin.dtype, device=x.device))
    # depthwise causal conv over [prev ++ xin], in their promoted dtype
    cdt = torch.promote_types(prev.dtype, xin.dtype)
    xp = torch.cat([prev.to(cdt), xin.to(cdt)], dim=1)
    w = params["conv_w"].to(xin.dtype)
    xc = 0
    for i in range(dc):
        xc = xc + xp[:, i:i + l, :] * w[i][None, None, :]
    xc = F.silu(xc + params["conv_b"].to(xin.dtype)[None, None, :])

    proj = apply_linear(params["x_proj"], xc, spec).to(_F32)
    dt_in, bmat, cmat = proj.split([dr, ds, ds], dim=-1)
    dt = _softplus(apply_linear(params["dt_proj"], dt_in.to(x.dtype), spec).to(_F32))
    a = -torch.exp(params["a_log"])
    h = (cache["h"].to(_F32) if cache is not None
         else torch.zeros((b, di, ds), dtype=_F32, device=x.device))
    xf = xc.to(_F32)

    ys = []
    if valid is not None:
        # one chunk step per token, the carry gated per row
        for t in range(l):
            tok = slice(t, t + 1)
            h_new, y = _mamba_chunk(h, a, dt[:, tok], bmat[:, tok], cmat[:, tok],
                                    xf[:, tok])
            h = _gate(valid[:, t], h_new, h)
            ys.append(y)
        # the conv window after each row's last valid token: xp[n : n + dc - 1]
        n_valid = valid.sum(dim=1)
        idx = n_valid[:, None] + torch.arange(dc - 1, device=x.device)[None]
        conv_state = torch.gather(xp, 1, idx[:, :, None].expand(b, dc - 1, di))
    else:
        n_chunks, cl = _chunks(l)
        for ci in range(n_chunks):
            c = slice(ci * cl, (ci + 1) * cl)
            h, y = _mamba_chunk(h, a, dt[:, c], bmat[:, c], cmat[:, c], xf[:, c])
            ys.append(y)
        conv_state = xp[:, xp.shape[1] - (dc - 1):, :]
    y = torch.cat(ys, dim=1) + xf * params["d_skip"][None, None, :]
    out = apply_linear(params["out_proj"], y.to(x.dtype) * F.silu(z), spec)
    new_cache = None
    if cache is not None:
        new_cache = {"conv": conv_state.to(prev.dtype), "h": h.to(cache["h"].dtype)}
    return out, new_cache


# ---- mLSTM (matrix-memory LSTM, chunkwise) ---------------------------------


def init_mlstm(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype,
               device: torch.device) -> Params:
    d, h = cfg.d_model, cfg.n_heads
    return {
        "wq": init_linear(gen, d, d, False, dtype, device),
        "wk": init_linear(gen, d, d, False, dtype, device),
        "wv": init_linear(gen, d, d, False, dtype, device),
        "wi": init_linear(gen, d, h, True, dtype, device),
        "wf": init_linear(gen, d, h, True, dtype, device),
        "wo": init_linear(gen, d, d, False, dtype, device),
        "norm": init_rmsnorm(d, dtype, device),
    }


def init_mlstm_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                     device: torch.device) -> Params:
    h = cfg.n_heads
    hd = cfg.d_model // h
    return {
        "c": torch.zeros((batch, h, hd, hd), dtype=dtype, device=device),
        "n": torch.zeros((batch, h, hd), dtype=dtype, device=device),
        "m": torch.zeros((batch, h), dtype=dtype, device=device),
    }


def _mlstm_chunk(carry, q_c, k_c, v_c, i_c, lf_c):
    """One chunk (B, H, C, .) of the stabilized chunkwise mLSTM: returns the
    carry (c, n, m) after the chunk and y (B, H, C, hd)."""
    c, n, m = carry
    cl = q_c.shape[2]
    csum = torch.cumsum(lf_c, dim=-1)
    total = csum[..., -1]
    # per-position stabilizer g_j = max(m, cummax_{t<=j}(i_t - csum_t))
    g = torch.maximum(m[..., None], torch.cummax(i_c - csum, dim=-1).values)
    dec_q = torch.exp(m[..., None] - g)
    y_inter = torch.einsum("bhcd,bhde->bhce", q_c, c) * dec_q[..., None]
    n_inter = torch.einsum("bhcd,bhd->bhc", q_c, n) * dec_q
    gates = (i_c - csum)[:, :, None, :] - g[..., None]
    mask = torch.tril(torch.ones((cl, cl), dtype=torch.bool, device=q_c.device))
    # masked before the exp: above the diagonal a gate can overflow to inf,
    # and where(mask, exp(gates), 0) would carry 0 * inf = nan into the
    # gradient (the values are the same)
    w_att = torch.exp(torch.where(mask[None, None], gates, -torch.inf))
    scores = torch.einsum("bhcd,bhed->bhce", q_c, k_c) * w_att
    y_intra = torch.einsum("bhce,bhed->bhcd", scores, v_c)
    n_intra = scores.sum(dim=-1)
    denom = torch.maximum(torch.abs(n_inter + n_intra), torch.exp(-g - csum))
    y = (y_inter + y_intra) / denom[..., None]
    g_last = g[..., -1]
    dec_c = torch.exp(m - g_last)
    add_w = torch.exp(i_c - csum - g_last[..., None])
    c_new = c * dec_c[..., None, None] + torch.einsum(
        "bhc,bhcd,bhce->bhde", add_w, k_c, v_c)
    n_new = n * dec_c[..., None] + torch.einsum("bhc,bhcd->bhd", add_w, k_c)
    return (c_new, n_new, g_last + total), y


def _mlstm_scan(carry, q, k, v, ig, lf):
    """The chunkwise scan over the whole sequence from ``carry``: the carry
    after it and y (B, H, L, hd)."""
    n_chunks, cl = _chunks(q.shape[2])
    ys = []
    for ci in range(n_chunks):
        c = slice(ci * cl, (ci + 1) * cl)
        carry, y = _mlstm_chunk(carry, q[:, :, c], k[:, :, c], v[:, :, c], ig[..., c], lf[..., c])
        ys.append(y)
    return carry, torch.cat(ys, dim=2)


def mlstm(params: Params, x: torch.Tensor, cfg: ModelConfig,
          cache: Params | None = None,
          valid: torch.Tensor | None = None) -> tuple[torch.Tensor, Params | None]:
    """Chunkwise stabilized mLSTM: C_t = f C_{t-1} + i v k^T,
    y = C q / max(|n . q|, exp(-m))."""
    b, l, d = x.shape
    h = cfg.n_heads
    hd = d // h
    spec = cfg.quant
    q, k, v = (apply_linear(params[n], x, spec) for n in ("wq", "wk", "wv"))

    def heads(t):
        return t.reshape(b, l, h, hd).transpose(1, 2).to(_F32)  # (B, H, L, hd)

    q, k, v = heads(q) * hd**-0.5, heads(k) * hd**-0.5, heads(v)
    ig = apply_linear(params["wi"], x, spec).to(_F32).transpose(1, 2)  # (B, H, L)
    fg = apply_linear(params["wf"], x, spec).to(_F32).transpose(1, 2)
    logf = -_softplus(-fg)  # log sigmoid
    if cache is not None:
        carry = tuple(cache[n].to(_F32) for n in ("c", "n", "m"))
    else:
        carry = (torch.zeros((b, h, hd, hd), dtype=_F32, device=x.device),
                 torch.zeros((b, h, hd), dtype=_F32, device=x.device),
                 torch.full((b, h), -30.0, dtype=_F32, device=x.device))

    if valid is not None:
        ys = []
        for t in range(l):
            tok = slice(t, t + 1)
            new, y = _mlstm_chunk(carry, q[:, :, tok], k[:, :, tok], v[:, :, tok],
                                  ig[..., tok], logf[..., tok])
            carry = tuple(_gate(valid[:, t], nw, old) for nw, old in zip(new, carry))
            ys.append(y)
        y = torch.cat(ys, dim=2)
    else:
        carry, y = _mlstm_scan(carry, q, k, v, ig, logf)
    y = y.transpose(1, 2).reshape(b, l, d).to(x.dtype)
    out = apply_linear(params["wo"], rmsnorm(params["norm"], y), spec)
    new_cache = None
    if cache is not None:
        new_cache = {n: t.to(cache[n].dtype) for n, t in zip(("c", "n", "m"), carry)}
    return out, new_cache


# ---- sLSTM (scalar-memory LSTM, sequential) --------------------------------


def init_slstm(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype,
               device: torch.device) -> Params:
    d = cfg.d_model
    return {
        "wz": init_linear(gen, d, d, True, dtype, device),
        "wi": init_linear(gen, d, d, True, dtype, device),
        "wf": init_linear(gen, d, d, True, dtype, device),
        "wo_gate": init_linear(gen, d, d, True, dtype, device),
        "wo": init_linear(gen, d, d, False, dtype, device),
        "norm": init_rmsnorm(d, dtype, device),
    }


def init_slstm_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                     device: torch.device) -> Params:
    d = cfg.d_model
    return {
        "c": torch.zeros((batch, d), dtype=dtype, device=device),
        "n": torch.zeros((batch, d), dtype=dtype, device=device),
        "m": torch.full((batch, d), -30.0, dtype=dtype, device=device),
    }


def _slstm_scan(z, ig, fg, og, carry, valid):
    """The per-token recurrence over (B, L, d) gates from ``carry`` ``(c, n,
    m)``: h (B, L, d) and the carry after it (gated per row by ``valid``
    where given)."""
    c, n, m = carry
    hs = []
    for t in range(z.shape[1]):
        logf = -_softplus(-fg[:, t])  # the exponential gate through log sigmoid
        m_new = torch.maximum(logf + m, ig[:, t])
        i_s = torch.exp(ig[:, t] - m_new)
        f_s = torch.exp(logf + m - m_new)
        c_new = f_s * c + i_s * z[:, t]
        n_new = f_s * n + i_s
        hs.append(og[:, t] * c_new / torch.clamp_min(n_new, 1.0))
        if valid is not None:
            ok = valid[:, t]
            c_new, n_new, m_new = (_gate(ok, nw, old) for nw, old in
                                   ((c_new, c), (n_new, n), (m_new, m)))
        c, n, m = c_new, n_new, m_new
    return torch.stack(hs, dim=1), (c, n, m)


def slstm(params: Params, x: torch.Tensor, cfg: ModelConfig,
          cache: Params | None = None,
          valid: torch.Tensor | None = None) -> tuple[torch.Tensor, Params | None]:
    b, l, d = x.shape
    spec = cfg.quant
    z = torch.tanh(apply_linear(params["wz"], x, spec)).to(_F32)
    ig = apply_linear(params["wi"], x, spec).to(_F32)
    fg = apply_linear(params["wf"], x, spec).to(_F32)
    og = torch.sigmoid(apply_linear(params["wo_gate"], x, spec)).to(_F32)
    if cache is not None:
        c, n, m = (cache[k].to(_F32) for k in ("c", "n", "m"))
    else:
        c = torch.zeros((b, d), dtype=_F32, device=x.device)
        n = torch.zeros((b, d), dtype=_F32, device=x.device)
        m = torch.full((b, d), -30.0, dtype=_F32, device=x.device)

    h, (c, n, m) = _slstm_scan(z, ig, fg, og, (c, n, m), valid)
    y = h.to(x.dtype)
    out = apply_linear(params["wo"], rmsnorm(params["norm"], y), spec)
    new_cache = None
    if cache is not None:
        new_cache = {k: t.to(cache[k].dtype) for k, t in zip(("c", "n", "m"), (c, n, m))}
    return out, new_cache
