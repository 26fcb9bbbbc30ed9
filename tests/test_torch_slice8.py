"""Port slice 8 on the CPU: float64 attention, and the geometry of the two
redesigned decode kernels.

* ``flash_attention`` on float64 q, k, v against the reference's Pallas
  kernel in interpret mode under ``jax.enable_x64(True)`` (scoped: the test
  shares its worker with others): the reference upcasts to f32 inside its
  body and writes float64, so both compute the f32 function on f32-rounded
  inputs; ``atol 1e-5`` (f32's tolerance, ``ATTN_TOL["float32"]``).  On the
  CPU the port's float64 output is the plain version on f32 copies, bit for
  bit.  Other dtypes, and float64 mixed with another, raise by name.
* ``packed_matmul``'s M <= 16 kernel: 8 columns a thread (8-byte weight
  loads) where N and the accumulator budget allow, one column elsewhere;
  ``int4_matmul``'s: 8 or 4 columns a thread; both in slices over K so
  that a block covers 512 columns.  Every choice the wrappers can make has
  a kernel instantiated in its source, and the kernel choice by M is
  unchanged.  Pure Python: no card is needed.
"""

from __future__ import annotations

import itertools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as j_flash
from repro_torch.kernels import _launch, build
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import int4_matmul as ti4
from repro_torch.kernels import packed_matmul as tpm
from repro_torch.kernels import ref as tref

F32_ATOL = 1e-5  # ATTN_TOL["float32"]: both sides compute in f32
PLANS = [tref.INT4_EXACT, tref.INT4_NAIVE, tref.INT4_MR_OVERPACKED,
         tref.spec_from_name("a8w8-p11-n1-full-c4"),
         tref.spec_from_name("a4w4-p10-n32-mr+full-c2"),
         tref.spec_from_name("a4w4-p11-n16-full-c2")]


def _qkv64(hd: int, seed: int) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((1, 2, 64, hd)) for _ in range(3)]


# ---- flash_attention: float64 ------------------------------------------------


@pytest.mark.parametrize("hd", [16, 40])
def test_float64_matches_reference_pallas(hd):
    qkv = _qkv64(hd, seed=hd)
    with jax.enable_x64(True):
        want = j_flash(*(jnp.asarray(a) for a in qkv), bq=64, bk=64, interpret=True)
        assert want.dtype == jnp.float64
        want = np.asarray(want)
    got = tfa.flash_attention(*(torch.from_numpy(a) for a in qkv), bq=64, bk=64)
    assert got.dtype == torch.float64 and got.shape == (1, 2, 64, hd)
    assert np.abs(got.numpy() - want).max() <= F32_ATOL


@pytest.mark.parametrize("hd", [16, 128])
def test_float64_is_the_f32_route_on_f32_copies(hd):
    q, k, v = (torch.from_numpy(a) for a in _qkv64(hd, seed=7))
    before = (tfa.flash_attention.launches, dict(tfa.flash_attention.route_launches))
    got = tfa.flash_attention(q, k, v, bq=64, bk=64)
    want = tfa.plain_flash_attention(q.float(), k.float(), v.float())
    assert torch.equal(got, want.double())
    # a CPU tensor: the plain version, no launch; the routes stay as they were
    assert (tfa.flash_attention.launches, tfa.flash_attention.route_launches) == before
    assert torch.float64 not in tfa.ROUTES


@pytest.mark.parametrize("dtypes", [(torch.int32,) * 3, (torch.float64, torch.float32,
                                                         torch.float32),
                                    (torch.float32, torch.float64, torch.float64)],
                         ids=["int32", "f64-q-f32-kv", "f32-q-f64-kv"])
def test_non_float_and_mixed_dtypes_raise_by_name(dtypes):
    q, k, v = (torch.zeros((1, 1, 64, 16), dtype=dt) for dt in dtypes)
    with pytest.raises(TypeError, match="float32, bfloat16, float16 or float64"):
        tfa.flash_attention(q, k, v, bq=64, bk=64)


# ---- the decode kernels' geometry -------------------------------------------


@pytest.fixture
def card_of_132_sms(monkeypatch):
    """The split-K choice reads the card's SM count: an H100's, here."""
    monkeypatch.setattr(_launch, "sm_count", lambda index: 132)
    return torch.device("cpu")


@pytest.mark.parametrize("spec", PLANS, ids=lambda s: s.name())
@pytest.mark.parametrize("m", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("n", [49152, 1024, 312, 304, 300, 129])
def test_raw_geometry_columns_a_thread(spec, m, n, card_of_132_sms):
    k = 8192
    n_chunks = -(-k // spec.chunk)
    bm, tile, per, splits, cpt = tpm._geometry(m, n, n_chunks, spec, card_of_132_sms)
    assert bm == (4 if m <= 4 else 8 if m <= 8 else 16)
    acc = spec.n_columns * bm * (2 if spec.uses_mr else 1)
    want = 8 if n % 8 == 0 and acc * 8 <= 64 else 1
    assert cpt == want == tpm.raw_cols_per_thread(bm, n, spec)
    if n in (300, 129):
        assert cpt == 1  # no multiple of 8: the one-column form
    if spec == tref.INT4_EXACT and bm <= 8 and n % 8 == 0:
        assert cpt == 8  # dsp_packed's decode at every main-path N
    # the splits cover the chunks, none empty, each whole K tiles' worth
    assert (splits - 1) * per < n_chunks <= splits * per and 1 <= tile <= n_chunks


@pytest.mark.parametrize("m", [1, 4, 8, 16])
@pytest.mark.parametrize("n", [1024, 312, 300, 129])
def test_prepacked_geometry_unchanged(m, n, card_of_132_sms):
    spec = tref.spec_from_name("a4w4-p10-n32-mr+full-c2")
    cpt = tpm._geometry(m, n, 256, spec, card_of_132_sms, prepacked=True)[4]
    assert cpt == (4 if m <= 4 and n % 4 == 0 else 1)


@pytest.mark.parametrize("m", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("n", [49152, 1024, 312, 304, 300, 132])
def test_int4_decode_geometry(m, n):
    bm, cpt = ti4.decode_geometry(m, n)
    assert bm == (4 if m <= 4 else 8 if m <= 8 else 16)
    assert cpt == (8 if n % 8 == 0 and bm <= 8 else 4)
    if bm == 4:
        assert cpt == (4 if n in (300, 132) else 8)  # 8 at every main-path N


def test_every_wide_choice_has_a_kernel():
    """Each (M tile, columns, column streams, mr) the packed wrapper can pick
    over the legal plans' shapes is instantiated in ``dispatch_wide``, and
    each (M tile, columns) of ``decode_geometry`` in ``int4_matmul_launch``."""
    src = (build.CSRC / "packed_matmul.cu").read_text()
    made = {(int(b), 8, int(nc), mr == "true") for b, nc, mr in
            re.findall(r"launch_wide<(\d+), (\d+), (true|false)>\(", src)}
    assert "constexpr int kWideCols = 8;" in src and "constexpr int kWideSlices = 2;" in src
    assert tpm._WIDE_COLS == 128 // 2 * 8  # kThreads / kWideSlices * kWideCols
    specs = [tref.PackedDotSpec(a, w, p, n_pairs, corr, mr_bits, cols)
             for a, w, p, n_pairs, corr, mr_bits, cols in itertools.product(
                 (1, 2, 4, 8), (2, 4, 8), (10, 11), (1, 4, 16), tref.CORRECTIONS, (0, 3),
                 (1, 2, 4))
             if _legal(a, w, p, n_pairs, corr, mr_bits, cols)]
    assert any(s.uses_mr for s in specs) and any(s.n_columns > 1 for s in specs)
    picked = set()
    for spec, bm, n in itertools.product(specs, (4, 8, 16), (1024, 312)):
        cpt = tpm.raw_cols_per_thread(bm, n, spec)
        if cpt > 1:
            picked.add((bm, cpt, spec.n_columns, spec.uses_mr))
    assert picked == made
    src = (build.CSRC / "int4_matmul.cu").read_text()
    made = {(int(b), int(c)) for b, c in re.findall(r"launch<(\d+), (\d+)>\(", src)}
    assert {ti4.decode_geometry(m, n) for m in (4, 8, 16) for n in (1024, 312, 300)} == made


def _legal(*fields) -> bool:
    try:
        tref.PackedDotSpec(*fields)
    except ValueError:
        return False
    return True


def test_int4_split_bound_keeps_the_sum_exact(card_of_132_sms):
    """The dp4a kernel sums the weights times 16: a split of at most
    ``_MAX_GROUPS`` groups of four k keeps |sum| <= 2**30 (int8 x int8*16),
    and the wrapper's split never holds more."""
    src = (build.CSRC / "int4_matmul.cu").read_text()
    assert f"kMaxGroups = {ti4._MAX_GROUPS};" in src
    assert ti4._MAX_GROUPS * 4 * 128 * 128 <= 2**30
    for groups in (8, 2048, 16384, 16385, 40000):  # one block: the fewest splits
        per = _launch.split_k(10**6, groups, card_of_132_sms, min_units=32,
                              per_sm=ti4._DECODE_BLOCKS_PER_SM, max_units=ti4._MAX_GROUPS)
        assert per <= ti4._MAX_GROUPS and -(-groups // per) * per >= groups


@pytest.mark.parametrize("m", [1, 4, 16, 17, 64])
def test_variant_by_m_unchanged(m):
    want = "tiled" if m >= 17 else None
    assert ti4.variant_for(m) == ("int4_matmul_tc" if want else "int4_matmul")
    for spec in PLANS[:4]:
        assert tpm.variant_for(m, spec) == ("packed_matmul_tiled" if want else "packed_matmul")
        assert tpm.prepacked_variant_for(m, spec) == (
            "packed_matmul_prepacked_tiled" if want else "packed_matmul_prepacked")
