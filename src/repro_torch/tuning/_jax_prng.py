"""``jax.random.randint`` in numpy, bit for bit, for the calibration tokens.

The sensitivity pass of ``tuning.mixed`` draws its calibration tokens as
the reference does, ``jax.random.randint(jax.random.PRNGKey(seed),
(batch, n), 2, vocab_size, jnp.int32)``: the allocation is a greedy choice
over errors measured on those tokens, so other tokens give another
allocation.  This module recomputes that draw without JAX, as JAX 0.9.0
computes it under its defaults (``jax_default_prng_impl`` =
``threefry2x32``, ``jax_threefry_partitionable`` = True):

* the key of a seed is its two 32-bit halves, high first;
* Threefry-2x32 (20 rounds, rotations 13 15 26 6 / 17 29 16 24, key
  schedule ``k0, k1, k0 ^ k1 ^ 0x1BD11BDA``) hashes a counter pair;
* a split, and the random bits of a shape, hash the 64-bit iota of the
  shape (high and low words as the counter pair); a split keeps both
  output words as the new key, 32 random bits are their XOR;
* ``randint`` splits its key in two, draws 32 bits from each and folds
  them into ``[minval, maxval)`` by the modulus of ``jax._src.random._randint``
  (in wrapping uint32 arithmetic).

All arithmetic is in numpy ``uint64`` masked to 32 bits.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["prng_key", "threefry2x32", "split", "random_bits", "randint"]

_M32 = np.uint64(0xFFFFFFFF)
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def prng_key(seed: int) -> tuple[int, int]:
    """``jax.random.PRNGKey(seed)``'s two words (high, low)."""
    seed = int(seed)
    if seed < 0:
        seed &= (1 << 64) - 1
    return (seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return ((x << np.uint64(r)) | (x >> np.uint64(32 - r))) & _M32


def threefry2x32(key: tuple[int, int], x0: np.ndarray,
                 x1: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 hash of the counter pairs ``(x0, x1)`` under
    ``key``; returns the two output words (uint32 arrays)."""
    k0, k1 = (np.uint64(k) for k in key)
    ks = (k0, k1, k0 ^ k1 ^ np.uint64(0x1BD11BDA))
    x = [(np.asarray(x0, np.uint64) + ks[0]) & _M32,
         (np.asarray(x1, np.uint64) + ks[1]) & _M32]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & _M32
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & _M32
        x[1] = (x[1] + ks[(i + 2) % 3] + np.uint64(i + 1)) & _M32
    return x[0].astype(np.uint32), x[1].astype(np.uint32)


def _iota_2x32(shape: tuple[int, ...]) -> tuple[np.ndarray, np.ndarray]:
    n = np.arange(math.prod(shape), dtype=np.uint64).reshape(shape)
    return n >> np.uint64(32), n & _M32


def split(key: tuple[int, int], num: int = 2) -> list[tuple[int, int]]:
    """``jax.random.split(key, num)`` (the fold-like split)."""
    b0, b1 = threefry2x32(key, *_iota_2x32((num,)))
    return [(int(b0[i]), int(b1[i])) for i in range(num)]


def random_bits(key: tuple[int, int], shape: tuple[int, ...]) -> np.ndarray:
    """32 random bits per element of ``shape`` (uint32)."""
    b0, b1 = threefry2x32(key, *_iota_2x32(tuple(shape)))
    return b0 ^ b1


def randint(key: tuple[int, int], shape: tuple[int, ...], minval: int,
            maxval: int) -> np.ndarray:
    """``jax.random.randint(key, shape, minval, maxval, jnp.int32)`` for
    ``minval < maxval`` within int32."""
    if not (-(1 << 31) <= minval < maxval <= (1 << 31) - 1):
        raise ValueError(f"randint needs int32 bounds with minval < maxval, got "
                         f"[{minval}, {maxval})")
    k1, k2 = split(key)
    higher = random_bits(k1, shape).astype(np.uint64)
    lower = random_bits(k2, shape).astype(np.uint64)
    span = np.uint64((maxval - minval) & 0xFFFFFFFF)
    multiplier = np.uint64(1 << 16) % span
    multiplier = ((multiplier * multiplier) & _M32) % span
    offset = ((((higher % span) * multiplier) & _M32) + lower % span) & _M32
    offset = offset % span
    return (np.int64(minval) + offset.astype(np.int64)).astype(np.int32)
