"""Pair-packed "DSP-sim" matmul: wrappers of ``csrc/packed_matmul.cu``.

Counterparts of the reference's ``repro.kernels.packed_matmul``:

* :func:`packed_matmul_prepacked` — activations x weights packed once by
  :func:`ref.pack_weight_words` -> (M, N) int32.  With ``x_scale``/``x_zp``
  the f32 activations are quantized offset-binary inside the kernel (the
  integer activations never stage through device memory).
* :func:`packed_matmul` — (M, K) unsigned ints x (K, N) signed ints, the
  weights packed into words as the kernel reads them.

Both serve any legal :class:`ref.PackedDotSpec`.  A CUDA tensor launches
the kernel (or raises); a CPU tensor runs the plain version beside each
wrapper, which is the only reason it ever does.
"""

from __future__ import annotations

import ctypes

import torch

from . import build, ref
from ._launch import require, split_k
from .ref import INT4_EXACT, PackedDotSpec

__all__ = [
    "packed_matmul",
    "packed_matmul_plain",
    "packed_matmul_prepacked",
    "packed_matmul_prepacked_plain",
]

_THREADS = 128           # output columns per block (csrc kThreads)
_SMEM_BUDGET = 24 * 1024  # staged activation words per K tile (~8 blocks/SM)


class _Params(ctypes.Structure):
    """Mirror of ``struct PackedParams`` in ``csrc/packed_matmul.cu``."""

    _fields_ = [(name, ctypes.c_int) for name in (
        "M", "K", "N", "kw", "n_chunks", "n_pairs", "p", "n_columns",
        "col_bits_a", "mr_bits", "rounds_half_up", "uses_mr", "zp",
        "tile_chunks", "chunks_per_split",
    )]


def _geometry(m: int, n: int, n_chunks: int, spec: PackedDotSpec,
              device: torch.device) -> tuple[int, int, int, int]:
    """(bm, tile_chunks, chunks_per_split, splits) for one launch."""
    bm = 4 if m <= 4 else 8 if m <= 8 else 16
    per_chunk = 2 * spec.n_columns * spec.n_pairs * bm * 4  # bytes staged
    tile = max(1, min(n_chunks, _SMEM_BUDGET // per_chunk))
    blocks = -(-m // bm) * -(-n // _THREADS)
    per = split_k(blocks, n_chunks, device)
    return bm, tile, per, -(-n_chunks // per)


def _params(spec: PackedDotSpec, m: int, k: int, n: int, kw: int,
            n_chunks: int, zp: int, tile: int, per: int) -> _Params:
    return _Params(
        M=m, K=k, N=n, kw=kw, n_chunks=n_chunks, n_pairs=spec.n_pairs,
        p=spec.p, n_columns=spec.n_columns, col_bits_a=spec.col_bits_a,
        mr_bits=spec.mr_bits, rounds_half_up=int(spec.rounds_half_up),
        uses_mr=int(spec.uses_mr), zp=zp, tile_chunks=tile,
        chunks_per_split=per,
    )


def _out(m: int, n: int, splits: int, device: torch.device) -> torch.Tensor:
    # split-K blocks meet with atomicAdd: the output starts at zero
    return (torch.zeros if splits > 1 else torch.empty)(
        (m, n), dtype=torch.int32, device=device
    )


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# ---- prepacked entry -------------------------------------------------------


def quantize_rows(x: torch.Tensor, x_scale: torch.Tensor, x_zp: int) -> torch.Tensor:
    """The fused prologue as plain PyTorch: ``round(x / scale) + zp``
    (half to even), clipped to ``[0, 2 * zp - 1]``, as int32."""
    q = (x / x_scale.reshape(-1, 1)).round_().add_(x_zp)
    return q.clamp_(0, 2 * x_zp - 1).to(torch.int32)


def packed_matmul_prepacked_plain(
    x: torch.Tensor,
    words: torch.Tensor,
    wsc: torch.Tensor | None = None,
    spec: PackedDotSpec = INT4_EXACT,
    x_scale: torch.Tensor | None = None,
    x_zp: int | None = None,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`packed_matmul_prepacked`."""
    if x_scale is not None:
        # pad K with f32 zeros BEFORE quantizing, as the reference kernel
        # does: a padded position quantizes to the zero point
        kw = words.shape[0] * spec.chunk
        if x.shape[1] < kw:
            x = torch.nn.functional.pad(x, (0, kw - x.shape[1]))
        x = quantize_rows(x, x_scale, x_zp)
    return ref.ref_packed_matmul_prepacked(
        x, ref.PackedWeightWords(words, wsc), spec
    )


def packed_matmul_prepacked(
    x: torch.Tensor,
    words: torch.Tensor,
    wsc: torch.Tensor | None = None,
    spec: PackedDotSpec = INT4_EXACT,
    x_scale: torch.Tensor | None = None,
    x_zp: int | None = None,
) -> torch.Tensor:
    """(M, K) activations x prepacked words (n_chunks, n_pairs, N) -> (M, N)
    int32.

    ``x_scale`` ((M, 1) or (M,) f32, the row absmax scale over the full K)
    and ``x_zp`` fuse the activation quantize: ``x`` is then the raw f32
    activation.  Without them ``x`` holds unsigned integers.  ``wsc`` is
    required for mr plans.  ``K`` may be shorter than the words' K.
    """
    if x.dim() != 2 or words.dim() != 3 or words.shape[1] != spec.n_pairs:
        raise ValueError(
            f"packed_matmul_prepacked wants (M, K) x (n_chunks, "
            f"{spec.n_pairs}, N) words, got {tuple(x.shape)} x "
            f"{tuple(words.shape)}"
        )
    n_chunks, _, n = words.shape
    m, k = x.shape
    if k > n_chunks * spec.chunk:
        raise ValueError(
            f"activation K={k} exceeds packed weights' K={n_chunks * spec.chunk}"
        )
    if (x_scale is None) != (x_zp is None):
        raise ValueError("fused quantize needs both x_scale and x_zp")
    if spec.uses_mr and wsc is None:
        raise ValueError(
            f"{spec.name()} is an mr plan: packed_matmul_prepacked needs "
            "the wsc contamination operands from pack_weight_words"
        )
    if not x.is_cuda:
        return packed_matmul_prepacked_plain(x, words, wsc, spec, x_scale, x_zp)
    dev = x.device
    fused = x_scale is not None
    if fused:
        require(x, "x", torch.float32, dev, 2)
        if x_scale.numel() != m:
            raise ValueError(f"x_scale has {x_scale.numel()} entries for {m} rows")
        require(x_scale.reshape(m), "x_scale", torch.float32, dev, 1)
    else:
        require(x, "x", torch.int32, dev, 2)
    require(words, "words", torch.int32, dev, 3)
    if spec.uses_mr:
        require(wsc, "wsc", torch.int32, dev, 4)
        if tuple(wsc.shape) != (n_chunks, spec.n_pairs, 2, n):
            raise ValueError(f"wsc has shape {tuple(wsc.shape)}, expected "
                             f"{(n_chunks, spec.n_pairs, 2, n)}")
    bm, tile, per, splits = _geometry(m, n, n_chunks, spec, dev)
    prm = _params(spec, m, k, n, n_chunks * spec.chunk, n_chunks,
                  x_zp or 0, tile, per)
    out = _out(m, n, splits, dev)
    fn = build.library("packed_matmul").packed_matmul_prepacked_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.POINTER(_Params), ctypes.c_int,
                                           ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(x.data_ptr(), x_scale.data_ptr() if fused else None,
             words.data_ptr(), wsc.data_ptr() if spec.uses_mr else None,
             out.data_ptr(), ctypes.byref(prm), bm, splits, _stream(dev))
    build.check(err, "packed_matmul_prepacked")
    packed_matmul_prepacked.launches += 1
    return out


packed_matmul_prepacked.launches = 0


# ---- per-call entry ----------------------------------------------------------


def packed_matmul_plain(x_u: torch.Tensor, w_s: torch.Tensor,
                        spec: PackedDotSpec = INT4_EXACT) -> torch.Tensor:
    """Plain PyTorch version of :func:`packed_matmul`."""
    return ref.ref_packed_matmul(x_u, w_s, spec)


def packed_matmul(x_u: torch.Tensor, w_s: torch.Tensor,
                  spec: PackedDotSpec = INT4_EXACT) -> torch.Tensor:
    """(M, K) unsigned ints x (K, N) signed ints -> (M, N) int32 via pair
    packing; ragged K is handled as zero pairs (bit-transparent)."""
    if x_u.dim() != 2 or w_s.dim() != 2 or x_u.shape[1] != w_s.shape[0]:
        raise ValueError(
            f"packed_matmul wants (M, K) x (K, N), got {tuple(x_u.shape)} x "
            f"{tuple(w_s.shape)}"
        )
    if not x_u.is_cuda:
        return packed_matmul_plain(x_u, w_s, spec)
    dev = x_u.device
    m, k = x_u.shape
    n = w_s.shape[1]
    if x_u.dtype != torch.int32:
        x_u = x_u.to(torch.int32)
    if w_s.dtype != torch.int8:
        w_s = w_s.to(torch.int8)  # plan grids have bits_w <= 8
    require(x_u, "x_u", torch.int32, dev, 2)
    require(w_s, "w_s", torch.int8, dev, 2)
    n_chunks = -(-k // spec.chunk)
    bm, tile, per, splits = _geometry(m, n, n_chunks, spec, dev)
    prm = _params(spec, m, k, n, k, n_chunks, 0, tile, per)
    out = _out(m, n, splits, dev)
    fn = build.library("packed_matmul").packed_matmul_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.POINTER(_Params), ctypes.c_int,
                                           ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(x_u.data_ptr(), w_s.data_ptr(), out.data_ptr(), ctypes.byref(prm),
             bm, splits, _stream(dev))
    build.check(err, "packed_matmul")
    packed_matmul.launches += 1
    return out


packed_matmul.launches = 0
