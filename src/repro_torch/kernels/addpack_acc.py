"""Addition-packing accumulator (paper §VII): wrapper of ``csrc/addpack_acc.cu``.

Counterpart of the reference's ``repro.kernels.addpack_acc``.  Two narrow
accumulators live in one int32 word (``LANE_BITS`` payload + ``GUARD_BITS``
carry catcher each), so one add advances two integrations.  The guard bit
bounds how many packed adds may run between extractions
(``2**GUARD_BITS``); the lanes are extracted at exactly that cadence, so
sums whose 2-term chunks fit the signed 14-bit lane are exact (the
guard-bit variant of Fig. 8).  Chunks that leave that range wrap per chunk,
as the reference kernel's do.

Layout: terms (T, 2, N) int32, output (2, N) int32 lane sums.  SNN usage:
``terms[t] = W @ spikes[t]`` slices.  A CUDA tensor launches the kernel
(or raises); a CPU tensor runs :func:`plain_addpack_accumulate`, which is
the only reason it ever does.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from ._launch import require
from .ref import _sext

__all__ = [
    "addpack_accumulate",
    "plain_addpack_accumulate",
    "ref_addpack_accumulate",
    "LANE_BITS",
    "GUARD_BITS",
    "BLOCK_N",
]

LANE_BITS = 14  # payload bits per lane
GUARD_BITS = 1  # carries absorbed between extractions
BLOCK_N = 256   # the reference's tiling contract: N % block_n == 0

_argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def _check(terms: torch.Tensor, block_n: int) -> None:
    if terms.dim() != 3 or terms.shape[1] != 2:
        raise ValueError(
            f"terms must be (T, 2, N): two lanes per int32 word, got {tuple(terms.shape)}"
        )
    if terms.dtype != torch.int32:
        raise TypeError(f"terms has dtype {terms.dtype}, expected torch.int32")
    if terms.shape[2] % block_n:
        raise ValueError(f"N={terms.shape[2]} not a multiple of block_n={block_n}")


def plain_addpack_accumulate(terms: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel's arithmetic, on int32 words.

    Per chunk of ``2**GUARD_BITS`` steps each lane is masked to
    ``LANE_BITS``, the chunk's words ``lo | (hi << (LANE_BITS + GUARD_BITS))``
    are summed, and both fields are sign-extended out of the sum.  A ragged
    last chunk is padded with zero terms, which add nothing to its word.
    """
    field = LANE_BITS + GUARD_BITS
    mask = (1 << LANE_BITS) - 1
    chunk = 1 << GUARD_BITS
    t, _, n = terms.shape
    pad = (-t) % chunk
    if pad:
        terms = torch.cat([terms, terms.new_zeros((pad, 2, n))])
    words = (terms[:, 0] & mask) | ((terms[:, 1] & mask) << field)  # (T', N)
    acc = words.reshape(-1, chunk, n).sum(1, dtype=torch.int32)  # per chunk
    lo = _sext(acc, LANE_BITS).sum(0)
    hi = _sext(acc >> field, LANE_BITS).sum(0)
    return torch.stack([lo, hi]).to(torch.int32)


def ref_addpack_accumulate(terms: torch.Tensor) -> torch.Tensor:
    """Oracle: plain per-lane integer sums (int32, wrapping)."""
    return terms.sum(0, dtype=torch.int64).to(torch.int32)


def addpack_accumulate(terms: torch.Tensor, block_n: int = BLOCK_N) -> torch.Tensor:
    """(T, 2, N) int32 narrow values -> (2, N) int32 lane sums.

    ``block_n`` is the reference's tiling contract only (``N % block_n``
    must be 0); the CUDA kernel picks its own tiling."""
    _check(terms, block_n)
    if not terms.is_cuda:
        return plain_addpack_accumulate(terms)
    dev = terms.device
    require(terms, "terms", torch.int32, dev, 3)
    t, _, n = terms.shape
    out = torch.empty((2, n), dtype=torch.int32, device=dev)
    if n == 0:
        return out
    fn = build.library("addpack_acc").addpack_acc_launch
    fn.argtypes, fn.restype = _argtypes, ctypes.c_int
    err = fn(terms.data_ptr(), out.data_ptr(), t, n, LANE_BITS, GUARD_BITS,
             torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "addpack_accumulate")
    addpack_accumulate.launches += 1
    return out


addpack_accumulate.launches = 0
