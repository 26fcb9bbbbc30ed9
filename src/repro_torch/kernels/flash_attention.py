"""Causal flash-attention forward: wrapper of the CUDA kernels, one route per dtype.

Counterpart of the reference's ``repro.kernels.flash_attention``: q, k, v
(B, H, S, hd) with the same H for all three (no grouped heads inside the
kernel) -> (B, H, S, hd) in q's dtype, for float32, bfloat16, float16 and
float64 inputs; float64 runs the f32 route on copies rounded to f32, as
the reference's upcast computes it, and returns float64.  The reference
kernel's arithmetic, which the plain version repeats: q, k and v are
upcast to f32, q is multiplied by ``hd**-0.5`` before the product, keys
past the query are masked with ``-1e30`` (not ``-inf``), the softmax runs
online over key tiles with the tiles past the diagonal skipped, and the sum
is divided by ``max(l, 1e-30)``.  ``bq``/``bk`` are the reference's tiling
contract (``S % bq == S % bk == bq % bk == 0``); the CUDA kernels pick
their own tiles.

Routes (:data:`ROUTES`), all on the tensor cores in
``csrc/flash_attention_sm90.cu`` (wgmma, TMA):

* bf16 and f16: the products of the input values (exact in f32) summed in
  f32, the scale applied after the product, and P V as ``P_hi V + P_lo V``
  with P split into two terms of the input type;
* f32: a pre-pass splits ``q * scale`` (the scale before the product, as
  the reference), k and v each into three bf16 terms
  (``x = t0 + t1 + t2`` exactly), and every product runs as the six term
  products of order at most 2**-16 (``i + j <= 2``), P split into three
  bf16 terms likewise, on 32-key tiles.

Each route is instantiated at hd 64 and 128 and takes any hd that is a
multiple of 8 up to 128 at the next of them: the TMA boxes read the head's
true columns and zero-fill past them, which add nothing to Q Kᵀ and give
output columns that are never stored.  Nothing is copied besides the f32
route's split terms.  :func:`emulate_tensor_core_flash` (bf16, f16) and
:func:`emulate_split_f32_flash` (f32) repeat each route's rounding in
PyTorch, for the tests and the card's checks only.  The f32 kernel of
PR 12 on the CUDA cores (``csrc/flash_attention.cu``) stays callable as
``KERNELS["flash_attention"]``, for timing beside the new route.

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
           "emulate_split_f32_flash", "split_terms", "ref_attention", "NEG_INF",
           "ROUTES", "KERNELS", "SOURCES", "TC_DESIGN"]

NEG_INF = -1e30
# dtype -> the route's kernel, named by its C entry ``<name>_launch``
ROUTES = {torch.bfloat16: "flash_attention_sm90",
          torch.float16: "flash_attention_sm90_f16",
          torch.float32: "flash_attention_sm90_f32"}
# every kernel -> the ``csrc`` source stem it is built from; the CUDA-core
# f32 kernel is on no route
SOURCES = {"flash_attention_sm90": "flash_attention_sm90",
           "flash_attention_sm90_f16": "flash_attention_sm90",
           "flash_attention_sm90_f32": "flash_attention_sm90",
           "flash_attention": "flash_attention"}
# the tensor-core design per input dtype: (key tile, terms per input
# value, terms of P); csrc ``Design``
TC_DESIGN = {torch.bfloat16: (64, 1, 2), torch.float16: (64, 1, 2),
             torch.float32: (32, 3, 3)}
MAX_HEAD_DIM = 128              # the CUDA kernels take hd % 8 == 0 up to this
_SCORE_BYTES = 1 << 30          # plain version: f32 scores held at once

# the C entries' arguments after their pointers (q, k, v, out and, but for
# the CUDA-core kernel's, terms): BH, S, hd, scale, stream
_dims = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bq: int, bk: int) -> None:
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            "flash_attention wants q, k, v of one shape (B, H, S, hd), got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    s = q.shape[2]
    if bq <= 0 or bk <= 0 or s % bq or s % bk or bq % bk:
        raise ValueError(f"need S % bq == S % bk == bq % bk == 0, got S={s} bq={bq} bk={bk}")
    taken = q.dtype in ROUTES or q.dtype == torch.float64
    if not taken or not q.dtype == k.dtype == v.dtype:
        raise TypeError(
            f"q, k, v must share one dtype of float32, bfloat16, float16 or float64, got "
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


def split_terms(x: torch.Tensor, n: int, dtype: torch.dtype = torch.bfloat16) -> list:
    """``x`` (f32) as ``n`` terms of ``dtype``, each held in f32:
    ``t0 = dtype(x)``, ``t1 = dtype(x - t0)``, ...  Every difference is
    exact in f32; three bf16 terms hold any normal f32 value exactly."""
    terms, rest = [], x.float()
    for _ in range(n):
        t = rest.to(dtype).float()
        terms.append(t)
        rest = rest - t
    return terms


def _emulate(qt: list, kt: list, vt: list, scale: float, bk: int, p_terms: int,
             p_dtype: torch.dtype, out_dtype: torch.dtype, shape: tuple) -> torch.Tensor:
    """The tensor-core kernels' online softmax over ``bk``-key tiles: the
    scores are the sum of the term products ``qt[i] ktᵀ[j]`` with ``i + j <
    len(qt)`` (f32 sums of exact products), times ``scale``; P is split into
    ``p_terms`` terms of ``p_dtype``, and P V sums ``P_i vt[j]`` over ``i +
    j < p_terms``.  The exponential is ``torch.exp`` (the kernels' ``ex2``
    of log2(e)-scaled scores differs by a few f32 ulps).  Tiles past a
    row's diagonal add exactly nothing (p = 0, alpha = 1), so every row runs
    over every tile."""
    b, h, s, hd = shape
    dev = qt[0].device
    # the kernels' order: the smallest term products first
    qk = sorted(((i, j) for i in range(len(qt)) for j in range(len(kt)) if i + j < len(qt)),
                key=lambda ij: -sum(ij))
    pv = sorted(((i, j) for i in range(p_terms) for j in range(len(vt)) if i + j < p_terms),
                key=lambda ij: -sum(ij))
    pos = torch.arange(s, device=dev)
    m = torch.full((b * h, s, 1), NEG_INF, device=dev)
    l = torch.zeros((b * h, s, 1), device=dev)
    acc = torch.zeros((b * h, s, hd), device=dev)
    for k0 in range(0, s, bk):
        tile = slice(k0, k0 + bk)
        scores = sum(qt[i] @ kt[j][:, tile].transpose(1, 2) for i, j in qk)
        scores = torch.where(pos[tile] <= pos[:, None], scores * scale, NEG_INF)
        m_new = torch.maximum(m, scores.amax(-1, keepdim=True))
        p = torch.exp(scores - m_new)
        alpha = torch.exp(m - m_new)
        m = m_new
        l = l * alpha + p.sum(-1, keepdim=True)
        pt = split_terms(p, p_terms, p_dtype)
        acc = acc * alpha + sum(pt[i] @ vt[j][:, tile] for i, j in pv)
    return (acc / l.clamp_min(1e-30)).to(out_dtype).reshape(b, h, s, hd)


def emulate_tensor_core_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              split: bool = True) -> torch.Tensor:
    """What the bf16 and f16 tensor-core routes compute, in PyTorch:
    products of the input values (exact in f32) summed in f32 with the
    scale applied after them, the online softmax over the kernel's 64-key
    tiles, and P V as ``P_hi V + P_lo V`` with ``P_hi`` = P rounded to the
    input type and ``P_lo`` = ``P - P_hi`` rounded likewise.
    ``split=False`` rounds P once instead, the design the split replaces."""
    if q.dtype not in (torch.bfloat16, torch.float16) or not q.dtype == k.dtype == v.dtype:
        raise TypeError("the single-term tensor-core routes take bf16 or f16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.is_cuda:
        pin_full_f32()
    b, h, s, hd = q.shape
    bk, _, p_terms = TC_DESIGN[q.dtype]
    qt, kt, vt = ([t.reshape(b * h, s, hd).float()] for t in (q, k, v))
    return _emulate(qt, kt, vt, hd**-0.5, bk, p_terms if split else 1, q.dtype, q.dtype,
                    q.shape)


def emulate_split_f32_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            terms: int = 3) -> torch.Tensor:
    """What the f32 tensor-core route computes, in PyTorch: ``q * scale``
    (f32, the scale before the product), k and v split into ``terms`` bf16
    terms each, the scores and P V as the term products ``i + j < terms``,
    P split into ``terms`` bf16 terms, over the kernel's 32-key tiles.
    ``terms=2`` emulates the design the route's three terms replace.  Each
    tile's P V is summed apart here; the kernel adds it into O on the
    tensor cores, which moves its outputs a few 1e-6 from these."""
    if not q.dtype == k.dtype == v.dtype == torch.float32:
        raise TypeError(f"the f32 route takes f32, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.is_cuda:
        pin_full_f32()
    b, h, s, hd = q.shape
    qt = split_terms(q.reshape(b * h, s, hd) * hd**-0.5, terms)
    kt, vt = (split_terms(t.reshape(b * h, s, hd), terms) for t in (k, v))
    return _emulate(qt, kt, vt, 1.0, TC_DESIGN[torch.float32][0], terms, torch.bfloat16,
                    torch.float32, q.shape)


def ref_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The reference's causal attention oracle: products in the input
    dtype, softmax in f32."""
    s, hd = q.shape[2], q.shape[3]
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * hd**-0.5
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    probs = torch.softmax(torch.where(mask, scores, NEG_INF), dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v.float()).to(q.dtype)


def _launch(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Launch kernel ``name`` on CUDA tensors (B, H, S, hd) of its dtype;
    counts the launch in ``flash_attention.launches`` and
    ``flash_attention.route_launches[name]``."""
    dev = q.device
    b, h, s, hd = q.shape
    if hd % 8 or not 0 < hd <= MAX_HEAD_DIM:
        raise ValueError(f"the CUDA kernels take hd a multiple of 8 up to "
                         f"{MAX_HEAD_DIM}, got {hd}")
    for t, label in ((q, "q"), (k, "k"), (v, "v")):
        require(t, label, q.dtype, dev, 4)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    # the f32 route's split terms: (3, 3, B*H, S, hd) bf16, q's scaled
    terms = (torch.empty((3, 3) + tuple(q.shape), dtype=torch.bfloat16, device=dev)
             if name == "flash_attention_sm90_f32" else None)
    fn = getattr(build.library(SOURCES[name]), f"{name}_launch")
    ptrs = [q, k, v, out] + ([] if name == "flash_attention" else [terms])
    fn.argtypes, fn.restype = [ctypes.c_void_p] * len(ptrs) + _dims, ctypes.c_int
    err = fn(*(None if t is None else t.data_ptr() for t in ptrs), b * h, s, hd, hd**-0.5,
             torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, name)
    flash_attention.launches += 1
    flash_attention.route_launches[name] += 1
    return out


def _kernel(name: str, dtype: torch.dtype):
    def run(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        if not q.dtype == k.dtype == v.dtype == dtype:
            raise TypeError(f"{name} takes {dtype}, got {q.dtype}, {k.dtype}, {v.dtype}")
        return _launch(name, q, k, v)
    run.__name__ = name
    return run


# every kernel by name, each launching it directly on CUDA tensors of its dtype
KERNELS = {name: _kernel(name, dtype) for dtype, name in ROUTES.items()}
KERNELS["flash_attention"] = _kernel("flash_attention", torch.float32)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bq: int = 256, bk: int = 256) -> torch.Tensor:
    """Causal attention.  q, k, v: (B, H, S, hd) -> (B, H, S, hd), hd a
    multiple of 8 up to 128 on the card.  Counts every launch in
    ``launches`` and in ``route_launches[ROUTES[dtype]]``; float64 counts
    under the f32 route, which it runs on copies rounded to f32."""
    _check(q, k, v, bq, bk)
    if q.dtype == torch.float64:
        return flash_attention(q.float(), k.float(), v.float(), bq, bk).double()
    if not q.is_cuda:
        return plain_flash_attention(q, k, v)
    return _launch(ROUTES[q.dtype], q, k, v)


flash_attention.launches = 0
flash_attention.route_launches = dict.fromkeys(KERNELS, 0)
