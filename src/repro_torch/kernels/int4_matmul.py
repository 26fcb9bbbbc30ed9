"""Packed-storage int4 matmul: wrapper of ``csrc/int4_matmul.cu``.

(M, K) int8 activations x (K//2, N) uint8 weights, two signed nibbles per
byte -> (M, N) int32.  Counterpart of the reference's
``repro.kernels.int4_matmul.int4_matmul``.  Two CUDA kernels share the
entry, chosen by M (:data:`VARIANTS`): ``int4_matmul`` (dp4a on the CUDA
cores, 8 columns a thread at M <= 8 where N allows:
:func:`decode_geometry`) for M <= 16, the decode GEMV, and
``int4_matmul_tc`` (int8 tensor cores, ``mma.sync`` m16n8k32) above, the
prefill chunks.  A CUDA tensor
launches one of them (or raises); a CPU tensor runs the plain version
:func:`int4_matmul_plain`, which is the only reason it ever does.
:data:`KERNELS` maps each variant to its launcher (CUDA tensors of the
entry's shapes), so that the two can be timed at one shape.
"""

from __future__ import annotations

import ctypes

import torch

from . import build, ref
from ._launch import require, sm_count, split_k

__all__ = ["int4_matmul", "int4_matmul_plain", "variant_for", "decode_geometry", "KERNELS",
           "VARIANTS", "TC_MIN_M"]

VARIANTS = ("int4_matmul", "int4_matmul_tc")
TC_MIN_M = 17      # the tensor-core kernel takes M >= TC_MIN_M
_TC_BK, _TC_BN, _TC_BM = 64, 128, 64  # csrc tc::kBK, kBN, kBM

_DECODE_ACC = 64          # accumulators a thread of the dp4a kernel (bm x cpt)
_DECODE_COLS = 512         # its block's columns (csrc kThreads / (cpt / 4) * cpt)
_DECODE_BLOCKS_PER_SM = 4  # its split-K target ...
_DECODE_MIN_GROUPS = 32    # ... with at least this many groups of four k a split
_MAX_GROUPS = 16384        # groups of four k a split may hold (csrc kMaxGroups)
_argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_tc_argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def variant_for(m: int) -> str:
    """The kernel :func:`int4_matmul` launches for ``m`` rows by default."""
    return VARIANTS[m >= TC_MIN_M]


def decode_geometry(m: int, n: int) -> tuple[int, int]:
    """(bm, cols_per_thread) of the dp4a kernel for ``m`` rows and ``n``
    columns (``n`` a multiple of 4): the M tile, and 8 columns a thread
    (8-byte loads of each packed row) where ``n % 8 == 0`` and the ``bm x 8``
    accumulators fit ``_DECODE_ACC``, else 4.  A block covers
    ``_DECODE_COLS`` columns either way (in slices over K)."""
    bm = 4 if m <= 4 else 8 if m <= 8 else 16
    return bm, 8 if n % 8 == 0 and bm * 8 <= _DECODE_ACC else 4


def int4_matmul_plain(x_q: torch.Tensor, w_packed: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: unpack the nibbles, exact integer matmul."""
    return ref.ref_int4_matmul(x_q, w_packed)


def int4_matmul(x_q: torch.Tensor, w_packed: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 x (K//2, N) packed-nibble uint8 -> (M, N) int32.  Every
    launch counts in ``launches`` and in ``variant_launches[variant]``."""
    if x_q.dim() != 2 or w_packed.dim() != 2 or x_q.shape[1] != 2 * w_packed.shape[0]:
        raise ValueError(
            f"int4_matmul wants (M, K) x (K//2, N), got {tuple(x_q.shape)} "
            f"x {tuple(w_packed.shape)}"
        )
    if not x_q.is_cuda:
        return int4_matmul_plain(x_q, w_packed)
    return KERNELS[variant_for(x_q.shape[0])](x_q, w_packed)


def _int4_matmul_dp4a(x_q: torch.Tensor, w_packed: torch.Tensor) -> torch.Tensor:
    """The dp4a kernel, any M: :func:`decode_geometry`'s columns a thread."""
    dev = x_q.device
    m, k = x_q.shape
    n = w_packed.shape[1]
    # the kernel takes K and N in multiples of 4: pad with zero activations
    # and zero nibbles (bit-transparent); the main path's shapes never pad
    pad_k, pad_n = (-k) % 4, (-n) % 4
    if pad_k or pad_n:
        x_q = torch.nn.functional.pad(x_q, (0, pad_k))
        w_packed = torch.nn.functional.pad(w_packed, (0, pad_n, 0, pad_k // 2))
    require(x_q, "x_q", torch.int8, dev, 2)
    require(w_packed, "w_packed", torch.uint8, dev, 2)
    kp, np_ = k + pad_k, n + pad_n
    bm, cpt = decode_geometry(m, np_)
    blocks = -(-m // bm) * -(-np_ // _DECODE_COLS)
    per = split_k(blocks, kp // 4, dev, min_units=_DECODE_MIN_GROUPS,
                  per_sm=_DECODE_BLOCKS_PER_SM, max_units=_MAX_GROUPS)
    splits = -(-(kp // 4) // per)
    out = (torch.zeros if splits > 1 else torch.empty)(
        (m, np_), dtype=torch.int32, device=dev
    )
    fn = build.library("int4_matmul").int4_matmul_launch
    fn.argtypes, fn.restype = _argtypes, ctypes.c_int
    err = fn(x_q.data_ptr(), w_packed.data_ptr(), out.data_ptr(), m, kp, np_,
             bm, cpt, splits, torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "int4_matmul")
    int4_matmul.launches += 1
    int4_matmul.variant_launches["int4_matmul"] += 1
    return out[:, :n] if pad_n else out


def _int4_matmul_tc(x_q: torch.Tensor, w_packed: torch.Tensor) -> torch.Tensor:
    """The tensor-core kernel, any M: K padded to a multiple of 64 and N of 16
    with zero activations and zero nibbles (bit-transparent; the main
    path's shapes never pad)."""
    dev = x_q.device
    m, k = x_q.shape
    n = w_packed.shape[1]
    pad_k, pad_n = (-k) % _TC_BK, (-n) % 16
    if pad_k or pad_n:
        x_q = torch.nn.functional.pad(x_q, (0, pad_k))
        w_packed = torch.nn.functional.pad(w_packed, (0, pad_n, 0, pad_k // 2))
    require(x_q, "x_q", torch.int8, dev, 2)
    require(w_packed, "w_packed", torch.uint8, dev, 2)
    kp, np_ = k + pad_k, n + pad_n
    # split K until about two blocks per SM are in flight, four stages each
    blocks = -(-np_ // _TC_BN) * -(-m // _TC_BM)
    tiles = kp // _TC_BK
    splits = max(1, min(-(-2 * sm_count(dev.index or 0) // blocks), tiles // 4))
    out = (torch.zeros if splits > 1 else torch.empty)(
        (m, np_), dtype=torch.int32, device=dev
    )
    fn = build.library("int4_matmul").int4_matmul_tc_launch
    fn.argtypes, fn.restype = _tc_argtypes, ctypes.c_int
    err = fn(x_q.data_ptr(), w_packed.data_ptr(), out.data_ptr(), m, kp, np_,
             splits, torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "int4_matmul_tc")
    int4_matmul.launches += 1
    int4_matmul.variant_launches["int4_matmul_tc"] += 1
    return out[:, :n] if pad_n else out


KERNELS = {"int4_matmul": _int4_matmul_dp4a, "int4_matmul_tc": _int4_matmul_tc}
int4_matmul.launches = 0
int4_matmul.variant_launches = dict.fromkeys(VARIANTS, 0)
