"""Causal flash-attention forward: wrapper of two CUDA kernels, one per dtype.

Counterpart of the reference's ``repro.kernels.flash_attention``: q, k, v
(B, H, S, hd) with the same H for all three (no grouped heads inside the
kernel) -> (B, H, S, hd) in q's dtype.  The reference kernel's arithmetic,
which the plain version repeats: q, k and v are upcast to f32, q is
multiplied by ``hd**-0.5`` before the product, keys past the query are
masked with ``-1e30`` (not ``-inf``), the softmax runs online over key tiles
with the tiles past the diagonal skipped, and the sum is divided by
``max(l, 1e-30)``.  ``bq``/``bk`` are the reference's tiling contract
(``S % bq == S % bk == bq % bk == 0``); the CUDA kernels pick their own
tiles.

Routes: bf16 runs on the tensor cores (``csrc/flash_attention_sm90.cu``:
wgmma, TMA), f32 on the CUDA cores (``csrc/flash_attention.cu``).  Both
are instantiated at hd 64 and 128 and take any hd that is a multiple of 8
up to 128 at the next of them: they read the head's true columns and see
zeros past them (the bf16 kernel's TMA boxes zero-fill, the f32 kernel
masks its loads), which add nothing to Q Kᵀ and give output columns that
are never stored.  Nothing is copied; the products run at the
instantiated width.  The tensor-core kernel applies the scale after the
product and splits P into
two bf16 terms for P V; :func:`emulate_tensor_core_flash` repeats that
rounding in PyTorch, for the tests and the card's checks only.

A CUDA tensor launches its route's kernel (or raises); a CPU tensor runs
:func:`plain_flash_attention`, which is the only reason it ever does.
:func:`ref_attention` is the reference's oracle, which runs its products
in the input dtype before it upcasts.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from ._launch import require
from .ops import pin_full_f32

__all__ = ["flash_attention", "plain_flash_attention", "emulate_tensor_core_flash",
           "ref_attention", "NEG_INF", "ROUTES"]

NEG_INF = -1e30
# dtype -> the source stem of the kernel that takes it
ROUTES = {torch.bfloat16: "flash_attention_sm90", torch.float32: "flash_attention"}
MAX_HEAD_DIM = 128              # the CUDA kernels take hd % 8 == 0 up to this
_TC_BK = 64                     # the tensor-core kernel's key tile
_SCORE_BYTES = 1 << 30          # plain version: f32 scores held at once

_argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bq: int, bk: int) -> None:
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            "flash_attention wants q, k, v of one shape (B, H, S, hd), got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    s = q.shape[2]
    if bq <= 0 or bk <= 0 or s % bq or s % bk or bq % bk:
        raise ValueError(f"need S % bq == S % bk == bq % bk == 0, got S={s} bq={bq} bk={bk}")
    if q.dtype not in ROUTES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"q, k, v must share one dtype of float32 or bfloat16, got "
            f"{q.dtype}, {k.dtype}, {v.dtype}"
        )


def plain_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel's arithmetic (see the module
    docstring), one softmax over all keys instead of tiles, run over
    groups of heads so that at most ``_SCORE_BYTES`` of scores exist."""
    if q.is_cuda:
        pin_full_f32()
    b, h, s, hd = q.shape
    scale = hd**-0.5
    qf, kf, vf = (t.reshape(b * h, s, hd) for t in (q, k, v))
    out = torch.empty((b * h, s, hd), dtype=q.dtype, device=q.device)
    causal = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    step = max(1, _SCORE_BYTES // (4 * s * s))
    for i in range(0, b * h, step):
        sl = slice(i, i + step)
        scores = (qf[sl].float() * scale) @ kf[sl].float().transpose(1, 2)
        scores = torch.where(causal, scores, NEG_INF)
        p = torch.exp(scores - scores.amax(-1, keepdim=True))
        acc = p @ vf[sl].float()
        out[sl] = (acc / p.sum(-1, keepdim=True).clamp_min(1e-30)).to(q.dtype)
    return out.reshape(b, h, s, hd)


def emulate_tensor_core_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              split: bool = True) -> torch.Tensor:
    """What the bf16 tensor-core kernel computes, in PyTorch: products of
    bf16 values (exact in f32) summed in f32 with the scale applied after
    them, the online softmax over the kernel's 64-key tiles, and P V as
    ``P_hi V + P_lo V`` with ``P_hi = bf16(P)``, ``P_lo = bf16(P - P_hi)``.
    ``split=False`` rounds P to bf16 once instead, the design the split
    replaces.  The exponential is ``torch.exp`` (the kernel's ``ex2`` of
    log2(e)-scaled scores differs by a few f32 ulps).  Tiles past a row's
    diagonal add exactly nothing (p = 0, alpha = 1), so every row runs over
    every tile."""
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise TypeError(f"the tensor-core kernel takes bf16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.is_cuda:
        pin_full_f32()
    b, h, s, hd = q.shape
    scale = hd**-0.5
    qf, kf, vf = (t.reshape(b * h, s, hd).float() for t in (q, k, v))
    pos = torch.arange(s, device=q.device)
    m = torch.full((b * h, s, 1), NEG_INF, device=q.device)
    l = torch.zeros((b * h, s, 1), device=q.device)
    acc = torch.zeros((b * h, s, hd), device=q.device)
    for k0 in range(0, s, _TC_BK):
        tile = slice(k0, k0 + _TC_BK)
        scores = (qf @ kf[:, tile].transpose(1, 2)) * scale
        scores = torch.where(pos[tile] <= pos[:, None], scores, NEG_INF)
        m_new = torch.maximum(m, scores.amax(-1, keepdim=True))
        p = torch.exp(scores - m_new)
        alpha = torch.exp(m - m_new)
        m = m_new
        l = l * alpha + p.sum(-1, keepdim=True)
        p_hi = p.to(torch.bfloat16).float()
        acc = acc * alpha + p_hi @ vf[:, tile]
        if split:
            acc = acc + (p - p_hi).to(torch.bfloat16).float() @ vf[:, tile]
    return (acc / l.clamp_min(1e-30)).to(torch.bfloat16).reshape(b, h, s, hd)


def ref_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The reference's causal attention oracle: products in the input
    dtype, softmax in f32."""
    s, hd = q.shape[2], q.shape[3]
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * hd**-0.5
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    probs = torch.softmax(torch.where(mask, scores, NEG_INF), dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v.float()).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bq: int = 256, bk: int = 256) -> torch.Tensor:
    """Causal attention.  q, k, v: (B, H, S, hd) -> (B, H, S, hd), hd a
    multiple of 8 up to 128 on the card.  Counts every launch in
    ``launches`` and in ``route_launches[ROUTES[dtype]]``."""
    _check(q, k, v, bq, bk)
    if not q.is_cuda:
        return plain_flash_attention(q, k, v)
    dev = q.device
    b, h, s, hd = q.shape
    if hd % 8 or not 0 < hd <= MAX_HEAD_DIM:
        raise ValueError(f"the CUDA kernels take hd a multiple of 8 up to "
                         f"{MAX_HEAD_DIM}, got {hd}")
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        require(t, name, q.dtype, dev, 4)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    route = ROUTES[q.dtype]
    fn = getattr(build.library(route), f"{route}_launch")
    fn.argtypes, fn.restype = _argtypes, ctypes.c_int
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b * h, s, hd,
             hd**-0.5, torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, route)
    flash_attention.launches += 1
    flash_attention.route_launches[route] += 1
    return out


flash_attention.launches = 0
flash_attention.route_launches = dict.fromkeys(ROUTES.values(), 0)
