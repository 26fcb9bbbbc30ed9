"""Port parity: the plain versions of ``addpack_accumulate`` and
``flash_attention`` (what their CUDA kernels compute) against the
reference's Pallas kernels in interpret mode.

On the CPU the wrappers run these plain versions; ``chip_smoke.py`` holds
the CUDA kernels against them on the card.  Integer paths are bit-exact
(tolerance 0), wrapped out-of-range chunks included.  Attention in f32 is
held to the reference's own tolerance (``atol 5e-6``, as its kernel test
holds the Pallas kernel to its oracle); in bf16 both sides compute in f32
and round once to bf16, so they may differ by one bf16 rounding step:
``rtol 2**-7`` (one unit in the last place of bf16's 8-bit significand).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.addpack import AddPackConfig as JAddPackConfig
from repro.core.addpack import accumulate as j_accumulate
from repro.kernels.addpack_acc import addpack_accumulate as j_addpack
from repro.kernels.addpack_acc import ref_addpack_accumulate as j_addpack_ref
from repro.kernels.flash_attention import flash_attention as j_flash
from repro.kernels.flash_attention import ref_attention as j_ref_attention
from repro_torch.core.addpack import AddPackConfig, accumulate
from repro_torch.kernels import addpack_acc as tadd
from repro_torch.kernels import flash_attention as tfa


def _eq(t: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(t.numpy(), np.asarray(want))


# ---- addpack_accumulate ---------------------------------------------------


def test_constants_match_reference():
    from repro.kernels import addpack_acc as ja

    assert (tadd.LANE_BITS, tadd.GUARD_BITS, tadd.BLOCK_N) == (
        ja.LANE_BITS, ja.GUARD_BITS, ja.BLOCK_N)


@pytest.mark.parametrize("t,n,lim", [
    (64, 256, 2000),     # the reference kernel test's shape
    (1, 256, 4096),
    (2, 512, 4096),
    (3, 256, 4096),      # odd T: a final 1-term chunk
    (7, 768, 4096),
    (48, 256, 4096),
    (5, 256, 1 << 15),   # out of range: chunks wrap per lane
    (16, 512, 1 << 20),
])
def test_addpack_plain_matches_pallas(t, n, lim):
    rng = np.random.default_rng(t * 1000 + n)
    terms = rng.integers(-lim, lim, (t, 2, n)).astype(np.int32)
    want = j_addpack(jnp.asarray(terms), interpret=True)
    got = tadd.addpack_accumulate(torch.from_numpy(terms))
    assert got.dtype == torch.int32 and got.shape == (2, n)
    _eq(got, want)
    _eq(tadd.plain_addpack_accumulate(torch.from_numpy(terms)), want)
    _eq(tadd.ref_addpack_accumulate(torch.from_numpy(terms)), j_addpack_ref(jnp.asarray(terms)))
    if lim <= 4096:  # 2-term chunks fit the signed 14-bit lane: exact sums
        _eq(got, terms.astype(np.int64).sum(0))


@pytest.mark.parametrize("t", [1, 2, 3, 4, 8])
def test_addpack_plain_matches_core_accumulate(t):
    """The two-lane int32 layout equals ``core.addpack.accumulate`` on
    ``AddPackConfig((14, 14), 1, total_bits=32)`` in both packages, for
    half-range terms (as the reference's property test)."""
    rng = np.random.default_rng(40 + t)
    lim = 1 << (tadd.LANE_BITS - 2)
    terms = rng.integers(-lim, lim, (t, 2, 256)).astype(np.int32)
    got = tadd.addpack_accumulate(torch.from_numpy(terms), block_n=256)
    lanes = (tadd.LANE_BITS, tadd.LANE_BITS)
    core = accumulate(AddPackConfig(lanes, tadd.GUARD_BITS, total_bits=32),
                      torch.from_numpy(terms).permute(2, 0, 1))
    _eq(got, core.T)
    j_core = j_accumulate(JAddPackConfig(lanes, tadd.GUARD_BITS, total_bits=32),
                          terms.transpose(2, 0, 1))
    _eq(got, j_core.T)


@pytest.mark.parametrize("shape,dtype,err", [
    ((4, 2, 300), torch.int32, ValueError),   # N % block_n
    ((4, 3, 256), torch.int32, ValueError),   # three lanes
    ((2, 256), torch.int32, ValueError),      # not 3-D
    ((4, 2, 256), torch.int64, TypeError),
])
def test_addpack_contract_errors(shape, dtype, err):
    with pytest.raises(err):
        tadd.addpack_accumulate(torch.zeros(shape, dtype=dtype))


def test_addpack_block_n_is_only_a_check():
    terms = torch.from_numpy(np.random.default_rng(1).integers(-99, 99, (3, 2, 96)).astype(np.int32))
    _eq(tadd.addpack_accumulate(terms, block_n=32), terms.sum(0))
    with pytest.raises(ValueError, match="not a multiple of block_n=64"):
        tadd.addpack_accumulate(terms, block_n=64)


def test_cpu_tensors_never_count_a_launch():
    before = (tadd.addpack_accumulate.launches, tfa.flash_attention.launches)
    tadd.addpack_accumulate(torch.zeros((2, 2, 256), dtype=torch.int32))
    tfa.flash_attention(*(torch.zeros((1, 1, 64, 64)) for _ in range(3)), bq=64, bk=64)
    assert (tadd.addpack_accumulate.launches, tfa.flash_attention.launches) == before


def test_snn_layer_matches_reference():
    """The slice's path at a small size: a spiking layer's weighted spike
    drive accumulated by ``addpack_accumulate`` (the SNN usage of the
    reference kernel), through the reference and the port, with the same
    neurons over the threshold."""
    rng = np.random.default_rng(0)
    f_in, n, steps, threshold = 64, 256, 32, 64
    w = rng.integers(-8, 8, (f_in, 2 * n))
    spikes = rng.random((steps, f_in)) < 0.15
    drive = spikes.astype(np.int64) @ w  # (T, 2N); lane 0 = first half
    terms = drive.reshape(steps, 2, n).astype(np.int32)
    want = np.asarray(j_addpack(jnp.asarray(terms), interpret=True)).reshape(2 * n)
    t_drive = torch.from_numpy(spikes.astype(np.float32)) @ torch.from_numpy(w.astype(np.float32))
    got = tadd.addpack_accumulate(t_drive.reshape(steps, 2, n).to(torch.int32)).reshape(2 * n)
    _eq(got, want)
    _eq(got, drive.sum(0))
    assert int((got > threshold).sum()) == int((want > threshold).sum())


# ---- flash_attention --------------------------------------------------------


def _qkv(shape, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(dtype) for _ in range(3)]


@pytest.mark.parametrize("shape", [(1, 2, 512, 64, 256, 128), (2, 1, 256, 128, 128, 128)])
def test_flash_plain_matches_pallas_f32(shape):
    b, h, s, hd, bq, bk = shape
    q, k, v = _qkv((b, h, s, hd), seed=5)
    want = np.asarray(j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              bq=bq, bk=bk, interpret=True))
    got = tfa.flash_attention(*map(torch.from_numpy, (q, k, v)), bq=bq, bk=bk)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=5e-6, rtol=0)
    np.testing.assert_allclose(tfa.ref_attention(*map(torch.from_numpy, (q, k, v))).numpy(),
                               np.asarray(j_ref_attention(q, k, v)), atol=5e-6, rtol=0)


def test_flash_plain_matches_pallas_bf16():
    q, k, v = (jnp.asarray(x).astype(jnp.bfloat16) for x in _qkv((1, 2, 256, 64), seed=8))
    want = np.asarray(j_flash(q, k, v, bq=128, bk=64, interpret=True).astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16)
                  for x in (q, k, v))
    got = tfa.flash_attention(tq, tk, tv, bq=128, bk=64)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=1e-6, rtol=2**-7)


def test_flash_causality():
    q, k, v = _qkv((1, 1, 256, 64), seed=6)
    base = tfa.flash_attention(*map(torch.from_numpy, (q, k, v)), bq=128, bk=128)
    k[:, :, -1] = 50.0
    v[:, :, -1] = 50.0
    pert = tfa.flash_attention(*map(torch.from_numpy, (q, k, v)), bq=128, bk=128)
    np.testing.assert_allclose(base[:, :, :-1].numpy(), pert[:, :, :-1].numpy(), atol=1e-6)
    assert not np.allclose(base[:, :, -1].numpy(), pert[:, :, -1].numpy())


@pytest.mark.parametrize("shapes,bq,bk,err", [
    (((1, 1, 200, 64),) * 3, 128, 128, ValueError),       # S % bq
    (((1, 1, 256, 64),) * 3, 128, 256, ValueError),       # bq % bk
    (((1, 1, 256, 64),) * 3, 256, 96, ValueError),        # S % bk
    (((1, 4, 256, 64), (1, 2, 256, 64), (1, 2, 256, 64)), 128, 128, ValueError),  # GQA
    (((256, 64),) * 3, 128, 128, ValueError),             # not (B, H, S, hd)
])
def test_flash_contract_errors(shapes, bq, bk, err):
    q, k, v = (torch.zeros(s) for s in shapes)
    with pytest.raises(err):
        tfa.flash_attention(q, k, v, bq=bq, bk=bk)


def test_flash_dtype_errors():
    q = torch.zeros((1, 1, 64, 64))
    with pytest.raises(TypeError):
        tfa.flash_attention(q.int(), q.int(), q.int(), bq=64, bk=64)
    with pytest.raises(TypeError):
        tfa.flash_attention(q, q.bfloat16(), q, bq=64, bk=64)
