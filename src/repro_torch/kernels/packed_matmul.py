"""Pair-packed "DSP-sim" matmul: wrappers of ``csrc/packed_matmul.cu``.

Counterparts of the reference's ``repro.kernels.packed_matmul``:

* :func:`packed_matmul_prepacked` — activations x weights packed once by
  :func:`ref.pack_weight_words` -> (M, N) int32.  With ``x_scale``/``x_zp``
  the f32 activations are quantized offset-binary inside the kernel (the
  integer activations never stage through device memory).  Two kernels
  share this entry too, chosen by M (:data:`PREPACKED_VARIANTS`,
  :func:`prepacked_variant_for`, :data:`PREPACKED_KERNELS`): the
  one-column kernel at M <= 16 and ``packed_matmul_prepacked_tiled`` (the
  tiled design on the stored words, the quantize fused per stage) above.
  Both derive the mr contamination's even weights from the pair words
  where ``bits_w <= p`` (:func:`even_lane`) and read ``wsc`` only for the
  other mr plans.  ``variant=`` launches a given one of them, where its
  stage fits (:func:`prepacked_variants`): the tuner's block sweep
  (``tuning.autotune``) times them and a tuned leaf carries the winner.
* :func:`packed_matmul` — (M, K) unsigned ints x (K, N) signed ints, the
  weights packed into words as the kernel reads them.  Two kernels share
  this entry, chosen by M (:data:`VARIANTS`): ``packed_matmul`` (at most
  16 rows per block; 8 output columns a thread read with 8-byte loads of
  each weight row where :func:`raw_cols_per_thread` allows, one column
  elsewhere) for M <= 16, the decode GEMV, and ``packed_matmul_tiled``
  (64 x 128 block tiles, 8 x 4 register tiles per thread) above, the
  prefill chunks; :data:`KERNELS` maps each to its launcher, so that the
  two can be timed at one shape.

Both serve any legal :class:`ref.PackedDotSpec`.  A CUDA tensor launches
the kernel (or raises); a CPU tensor runs the plain version beside each
wrapper, which is the only reason it ever does.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import build, ref
from ._launch import require, sm_count, split_k
from .ref import INT4_EXACT, PackedDotSpec

__all__ = [
    "KERNELS",
    "VARIANTS",
    "PREPACKED_KERNELS",
    "PREPACKED_VARIANTS",
    "PREPACKED_PLAIN",
    "TILED_MIN_M",
    "variant_for",
    "prepacked_variant_for",
    "prepacked_variants",
    "derives_even_lane",
    "even_lane",
    "raw_cols_per_thread",
    "packed_matmul",
    "packed_matmul_plain",
    "packed_matmul_prepacked",
    "packed_matmul_prepacked_plain",
]

_THREADS = 128           # threads per block (csrc kThreads)
_SMEM_BUDGET = 24 * 1024  # staged activation words per K tile (~8 blocks/SM)
_WIDE_ACC = 64            # accumulators per array a thread of the wide kernel
_WIDE_COLS = 512          # its block's columns (csrc kThreads / kWideSlices * kWideCols)
_WIDE_BLOCKS_PER_SM = 8   # split-K target of the wide kernel ...
_WIDE_MIN_K = 64          # ... with at least this many k a split

VARIANTS = ("packed_matmul", "packed_matmul_tiled")
PREPACKED_VARIANTS = ("packed_matmul_prepacked", "packed_matmul_prepacked_tiled")
PREPACKED_PLAIN = "packed_matmul_prepacked_plain"  # the one choice on the CPU
TILED_MIN_M = 17            # the tiled kernel takes M >= TILED_MIN_M
_TILE_M, _TILE_N, _TILE_STAGES = 64, 128, 3  # csrc tiled::kBM, kBN, kStages
_TILE_SMEM = 200 * 1024     # larger plans (very long chunks) keep the first kernel


class _Params(ctypes.Structure):
    """Mirror of ``struct PackedParams`` in ``csrc/packed_matmul.cu``."""

    _fields_ = [(name, ctypes.c_int) for name in (
        "M", "K", "N", "kw", "n_chunks", "n_pairs", "p", "n_columns",
        "col_bits_a", "mr_bits", "rounds_half_up", "uses_mr", "zp",
        "tile_chunks", "chunks_per_split", "reads_wsc", "cols_per_thread",
    )]


def raw_cols_per_thread(bm: int, n: int, spec: PackedDotSpec) -> int:
    """Output columns a thread of the per-call entry's M <= 16 kernel: 8
    (an 8-byte load of each weight row) where N % 8 == 0 and the
    accumulators fit (n_columns x bm x 8, twice for an mr plan, at most
    ``_WIDE_ACC``); else 1, the one-column form."""
    acc = spec.n_columns * bm * (2 if spec.uses_mr else 1)
    return 8 if n % 8 == 0 and acc * 8 <= _WIDE_ACC else 1


def _geometry(m: int, n: int, n_chunks: int, spec: PackedDotSpec,
              device: torch.device, prepacked: bool = False) -> tuple[int, int, int, int, int]:
    """(bm, tile_chunks, chunks_per_split, splits, cols_per_thread) for one
    launch of an M <= 16 kernel: four output columns a thread for prepacked
    words at M <= 4 (16-byte word loads) where N % 4 == 0; the per-call
    entry's :func:`raw_cols_per_thread`, whose wide kernel's block covers
    ``_WIDE_COLS`` columns."""
    bm = 4 if m <= 4 else 8 if m <= 8 else 16
    cpt = (4 if bm == 4 and n % 4 == 0 else 1) if prepacked else raw_cols_per_thread(bm, n, spec)
    wide = not prepacked and cpt > 1
    per_chunk = 2 * spec.n_columns * spec.n_pairs * bm * 4  # bytes staged
    tile = max(1, min(n_chunks, _SMEM_BUDGET // per_chunk))
    blocks = -(-m // bm) * -(-n // (_WIDE_COLS if wide else _THREADS * cpt))
    per = split_k(blocks, n_chunks, device,
                  min_units=-(-_WIDE_MIN_K // spec.chunk) if wide else 1,
                  per_sm=_WIDE_BLOCKS_PER_SM if wide else 8)
    return bm, tile, per, -(-n_chunks // per), cpt


def _params(spec: PackedDotSpec, m: int, k: int, n: int, kw: int,
            n_chunks: int, zp: int, tile: int, per: int, cpt: int = 1) -> _Params:
    return _Params(
        M=m, K=k, N=n, kw=kw, n_chunks=n_chunks, n_pairs=spec.n_pairs,
        p=spec.p, n_columns=spec.n_columns, col_bits_a=spec.col_bits_a,
        mr_bits=spec.mr_bits, rounds_half_up=int(spec.rounds_half_up),
        uses_mr=int(spec.uses_mr), zp=zp, tile_chunks=tile,
        chunks_per_split=per,
        reads_wsc=int(spec.uses_mr and not derives_even_lane(spec)),
        cols_per_thread=cpt,
    )


def _out(m: int, n: int, splits: int, device: torch.device) -> torch.Tensor:
    # split-K blocks meet with atomicAdd: the output starts at zero
    return (torch.zeros if splits > 1 else torch.empty)(
        (m, n), dtype=torch.int32, device=device
    )


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# ---- prepacked entry -------------------------------------------------------


def derives_even_lane(spec: PackedDotSpec) -> bool:
    """Whether the kernels derive an mr plan's contamination weights
    ``w_even mod 2**mr_bits`` from the pair words instead of reading
    ``wsc``: where ``bits_w <= p`` (the odd lane fits the word's low p bits
    signed) and ``p + mr_bits <= 32``."""
    return spec.uses_mr and spec.bits_w <= spec.p and spec.p + spec.mr_bits <= 32


def even_lane(words: torch.Tensor, spec: PackedDotSpec) -> torch.Tensor:
    """``w_even mod 2**mr_bits`` from pair words ``w_odd + (w_even << p)``
    (int32, wrapping), as the kernels derive it: ``w_odd = sext_p(word mod
    2**p)`` and ``(word - w_odd) >> p``.  Equals ``wsc[..., 0, :] & mask``
    wherever :func:`derives_even_lane` holds."""
    if not derives_even_lane(spec):
        raise ValueError(f"{spec.name()}: the even lane is not recoverable from its words "
                         "(needs an mr plan with bits_w <= p and p + mr_bits <= 32)")
    w = words.to(torch.int64)
    sign = 1 << (spec.p - 1)
    odd = ((w & ((1 << spec.p) - 1)) ^ sign) - sign
    return (((w - odd) >> spec.p) & ref.contamination_mask(spec)).to(torch.int32)


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
    variant: str | None = None,
) -> torch.Tensor:
    """(M, K) activations x prepacked words (n_chunks, n_pairs, N) -> (M, N)
    int32.

    ``x_scale`` ((M, 1) or (M,) f32, the row absmax scale over the full K)
    and ``x_zp`` fuse the activation quantize: ``x`` is then the raw f32
    activation.  Without them ``x`` holds unsigned integers.  ``wsc`` is
    required for mr plans.  ``K`` may be shorter than the words' K.
    ``variant`` names the kernel to launch (one of
    :func:`prepacked_variants`; default :func:`prepacked_variant_for`); on
    CPU tensors only :data:`PREPACKED_PLAIN` is one.  Every launch counts in
    ``launches`` and in ``variant_launches[variant]``.
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
    if variant is not None and variant not in prepacked_variants(spec, x.device):
        raise ValueError(
            f"variant {variant!r} cannot run {spec.name()} on {x.device}; "
            f"choices: {prepacked_variants(spec, x.device)}"
        )
    if not x.is_cuda:
        return packed_matmul_prepacked_plain(x, words, wsc, spec, x_scale, x_zp)
    variant = variant or prepacked_variant_for(m, spec)
    return PREPACKED_KERNELS[variant](x, words, wsc, spec, x_scale, x_zp)


def _prepacked_operands(x, words, wsc, spec, x_scale) -> bool:
    """Check what the prepacked kernels are handed; returns whether the
    activation quantize is fused."""
    dev = x.device
    m = x.shape[0]
    n_chunks, _, n = words.shape
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
    return fused


def _prepacked_columns(x, words, wsc, spec, x_scale=None, x_zp=None) -> torch.Tensor:
    """The one-column prepacked kernel (one output column a thread, four at
    M <= 4), any M."""
    fused = _prepacked_operands(x, words, wsc, spec, x_scale)
    dev = x.device
    m, k = x.shape
    n_chunks, _, n = words.shape
    bm, tile, per, splits, cpt = _geometry(m, n, n_chunks, spec, dev, prepacked=True)
    prm = _params(spec, m, k, n, n_chunks * spec.chunk, n_chunks,
                  x_zp or 0, tile, per, cpt)
    out = _out(m, n, splits, dev)
    fn = build.library("packed_matmul").packed_matmul_prepacked_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.POINTER(_Params), ctypes.c_int,
                                           ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(x.data_ptr(), x_scale.data_ptr() if fused else None,
             words.data_ptr(), wsc.data_ptr() if prm.reads_wsc else None,
             out.data_ptr(), ctypes.byref(prm), bm, splits, _stream(dev))
    build.check(err, "packed_matmul_prepacked")
    packed_matmul_prepacked.launches += 1
    packed_matmul_prepacked.variant_launches["packed_matmul_prepacked"] += 1
    return out


def _prepacked_tiled(x, words, wsc, spec, x_scale=None, x_zp=None) -> torch.Tensor:
    """The tiled prepacked kernel, any M: x's K padded to a multiple of 4
    (f32 zeros before the fused quantize, as the reference pads, or integer
    zeros), the words' N (and wsc's, where read) to a multiple of 4 with
    zero words (bit-transparent; the main path's shapes never pad)."""
    fused = _prepacked_operands(x, words, wsc, spec, x_scale)
    dev = x.device
    m, k = x.shape
    n_chunks, _, n = words.shape
    tile_chunks = _prepacked_tiled_geometry(spec)[0]
    reads_wsc = spec.uses_mr and not derives_even_lane(spec)
    pad_k, pad_n = (-k) % 4, (-n) % 4
    if pad_k:
        x = torch.nn.functional.pad(x, (0, pad_k))
    if pad_n:
        words = torch.nn.functional.pad(words, (0, pad_n))
        if reads_wsc:
            wsc = torch.nn.functional.pad(wsc, (0, pad_n))
    np_ = n + pad_n
    blocks = -(-np_ // _TILE_N) * -(-m // _TILE_M)
    stages = -(-n_chunks // tile_chunks)
    splits = max(1, min(-(-4 * sm_count(dev.index or 0) // blocks), stages // 8))
    per = -(-stages // splits) * tile_chunks
    splits = -(-n_chunks // per)
    prm = _params(spec, m, k + pad_k, np_, n_chunks * spec.chunk, n_chunks,
                  x_zp or 0, tile_chunks, per)
    out = _out(m, np_, splits, dev)
    fn = build.library("packed_matmul").packed_matmul_prepacked_tiled_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.POINTER(_Params), ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(x.data_ptr(), x_scale.data_ptr() if fused else None, words.data_ptr(),
             wsc.data_ptr() if reads_wsc else None, out.data_ptr(), ctypes.byref(prm),
             splits, _stream(dev))
    build.check(err, "packed_matmul_prepacked_tiled")
    packed_matmul_prepacked.launches += 1
    packed_matmul_prepacked.variant_launches["packed_matmul_prepacked_tiled"] += 1
    return out[:, :n] if pad_n else out


@functools.cache
def _prepacked_tiled_geometry(spec: PackedDotSpec) -> tuple[int, int]:
    """(tile_chunks, shared bytes) of the tiled prepacked kernel: the
    stage of :func:`_tiled_geometry`, with csrc ``tiled::PrepackedLayout``'s
    shared-memory plan."""
    per = _tiled_geometry(spec)[0]
    sp = per * spec.n_pairs
    mr = spec.uses_mr
    ring = _TILE_M * (2 * sp + 4) + sp * _TILE_N * (2 if mr and not derives_even_lane(spec)
                                                    else 1)
    words = (_TILE_STAGES * ring + (sp * _TILE_N if mr else 0)
             + (2 if mr else 1) * spec.n_columns * sp * _TILE_M)
    return per, 4 * words


def _tiled_stage_fits(spec: PackedDotSpec) -> bool:
    return _prepacked_tiled_geometry(spec)[1] <= _TILE_SMEM


def prepacked_variant_for(m: int, spec: PackedDotSpec) -> str:
    """The kernel :func:`packed_matmul_prepacked` launches for ``m`` rows:
    the tiled one above 16 rows, unless the plan's stage would not fit."""
    return PREPACKED_VARIANTS[m >= TILED_MIN_M and _tiled_stage_fits(spec)]


def prepacked_variants(spec: PackedDotSpec, device) -> tuple[str, ...]:
    """The kernels :func:`packed_matmul_prepacked` can launch for ``spec``
    at any M on ``device``: on the card the M <= 16 kernel, and the tiled
    one where its stage fits; on the CPU the plain version alone."""
    if torch.device(device).type != "cuda":
        return (PREPACKED_PLAIN,)
    return PREPACKED_VARIANTS if _tiled_stage_fits(spec) else PREPACKED_VARIANTS[:1]


PREPACKED_KERNELS = {"packed_matmul_prepacked": _prepacked_columns,
                     "packed_matmul_prepacked_tiled": _prepacked_tiled}


packed_matmul_prepacked.launches = 0
packed_matmul_prepacked.variant_launches = dict.fromkeys(PREPACKED_VARIANTS, 0)


# ---- per-call entry ----------------------------------------------------------


def packed_matmul_plain(x_u: torch.Tensor, w_s: torch.Tensor,
                        spec: PackedDotSpec = INT4_EXACT) -> torch.Tensor:
    """Plain PyTorch version of :func:`packed_matmul`."""
    return ref.ref_packed_matmul(x_u, w_s, spec)


@functools.cache
def _tiled_geometry(spec: PackedDotSpec) -> tuple[int, int]:
    """(tile_chunks, shared bytes) of the tiled kernel: whole chunks per
    stage, at least 16 pairs and a multiple of 8 (16-byte aligned k), with
    csrc ``tiled::Layout``'s shared-memory plan."""
    per = math.lcm(spec.n_pairs, 8) // spec.n_pairs
    while per * spec.n_pairs < 16:
        per *= 2
    sp = per * spec.n_pairs
    kt = 2 * sp
    mr = 2 if spec.uses_mr else 1
    words = (_TILE_STAGES * (_TILE_M * (kt + 4) + kt * _TILE_N // 4)
             + mr * sp * _TILE_N + mr * spec.n_columns * sp * _TILE_M)
    return per, 4 * words


def variant_for(m: int, spec: PackedDotSpec) -> str:
    """The kernel :func:`packed_matmul` launches for ``m`` rows by default:
    the tiled one above 16 rows, unless the plan's stage would not fit."""
    return VARIANTS[m >= TILED_MIN_M and _tiled_geometry(spec)[1] <= _TILE_SMEM]


def packed_matmul(x_u: torch.Tensor, w_s: torch.Tensor,
                  spec: PackedDotSpec = INT4_EXACT) -> torch.Tensor:
    """(M, K) unsigned ints x (K, N) signed ints -> (M, N) int32 via pair
    packing; ragged K is handled as zero pairs (bit-transparent).  Every
    launch counts in ``launches`` and in ``variant_launches[variant]``."""
    if x_u.dim() != 2 or w_s.dim() != 2 or x_u.shape[1] != w_s.shape[0]:
        raise ValueError(
            f"packed_matmul wants (M, K) x (K, N), got {tuple(x_u.shape)} x "
            f"{tuple(w_s.shape)}"
        )
    if not x_u.is_cuda:
        return packed_matmul_plain(x_u, w_s, spec)
    return KERNELS[variant_for(x_u.shape[0], spec)](x_u, w_s, spec)


def _int_operands(x_u: torch.Tensor, w_s: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernels' operand types: int32 activations, int8 weights (plan
    grids have bits_w <= 8), checked."""
    dev = x_u.device
    if x_u.dtype != torch.int32:
        x_u = x_u.to(torch.int32)
    if w_s.dtype != torch.int8:
        w_s = w_s.to(torch.int8)
    require(x_u, "x_u", torch.int32, dev, 2)
    require(w_s, "w_s", torch.int8, dev, 2)
    return x_u, w_s


def _packed_matmul_columns(x_u: torch.Tensor, w_s: torch.Tensor,
                           spec: PackedDotSpec) -> torch.Tensor:
    """The M <= 16 kernel, any M: several columns a thread with wide weight
    loads where :func:`raw_cols_per_thread` allows, one column elsewhere."""
    x_u, w_s = _int_operands(x_u, w_s)
    dev = x_u.device
    m, k = x_u.shape
    n = w_s.shape[1]
    n_chunks = -(-k // spec.chunk)
    bm, tile, per, splits, cpt = _geometry(m, n, n_chunks, spec, dev)
    prm = _params(spec, m, k, n, k, n_chunks, 0, tile, per, cpt)
    out = _out(m, n, splits, dev)
    fn = build.library("packed_matmul").packed_matmul_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.POINTER(_Params), ctypes.c_int,
                                           ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(x_u.data_ptr(), w_s.data_ptr(), out.data_ptr(), ctypes.byref(prm),
             bm, splits, _stream(dev))
    build.check(err, "packed_matmul")
    packed_matmul.launches += 1
    packed_matmul.variant_launches["packed_matmul"] += 1
    return out


def _packed_matmul_tiled(x_u: torch.Tensor, w_s: torch.Tensor,
                         spec: PackedDotSpec) -> torch.Tensor:
    """The tiled kernel, any M: x's K padded to a multiple of 4 with zero
    activations, N to a multiple of 16 with zero weights (bit-transparent;
    the main path's shapes never pad)."""
    x_u, w_s = _int_operands(x_u, w_s)
    dev = x_u.device
    m, k = x_u.shape
    n = w_s.shape[1]
    n_chunks = -(-k // spec.chunk)
    tile_chunks = _tiled_geometry(spec)[0]
    pad_k, pad_n = (-k) % 4, (-n) % 16
    if pad_k:
        x_u = torch.nn.functional.pad(x_u, (0, pad_k))
    if pad_n:
        w_s = torch.nn.functional.pad(w_s, (0, pad_n))
    np_ = n + pad_n
    # split the chunks until about four blocks per SM are launched, each
    # split whole stages, at least eight of them
    blocks = -(-np_ // _TILE_N) * -(-m // _TILE_M)
    stages = -(-n_chunks // tile_chunks)
    splits = max(1, min(-(-4 * sm_count(dev.index or 0) // blocks), stages // 8))
    per = -(-stages // splits) * tile_chunks
    splits = -(-n_chunks // per)
    prm = _params(spec, m, k + pad_k, np_, k, n_chunks, 0, tile_chunks, per)
    out = _out(m, np_, splits, dev)
    fn = build.library("packed_matmul").packed_matmul_tiled_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.POINTER(_Params), ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(x_u.data_ptr(), w_s.data_ptr(), out.data_ptr(), ctypes.byref(prm),
             splits, _stream(dev))
    build.check(err, "packed_matmul_tiled")
    packed_matmul.launches += 1
    packed_matmul.variant_launches["packed_matmul_tiled"] += 1
    return out[:, :n] if pad_n else out


KERNELS = {"packed_matmul": _packed_matmul_columns, "packed_matmul_tiled": _packed_matmul_tiled}
packed_matmul.launches = 0
packed_matmul.variant_launches = dict.fromkeys(VARIANTS, 0)
