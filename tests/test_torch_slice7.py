"""Port slice 7 on the CPU: f16 attention, the f32 attention route's split
onto the tensor cores, and the prepacked matmul's derived even lane and
kernel choice.

* The port's plain f16 attention (what every route's kernel is held to on
  the card) against the reference's Pallas kernel in interpret mode, at f16
  inputs: ``atol 1e-5, rtol 2**-10`` (``ATTN_TOL["float16"]``): both compute
  in f32 and round once to f16, so they may sit one f16 step apart.
* The f16 and f32 tensor-core emulations (the rounding each CUDA route
  does) against the Pallas kernel and the plain version, within
  ``ATTN_TOL`` (f32: ``atol 1e-5, rtol 0``).  The designs they replace fall
  outside: P rounded once to f16, and f32 operands split into two bf16
  terms instead of three.
* The even lane ``w_even mod 2**mr_bits`` derived from pair words, bit-exact
  (tolerance 0) against ``wsc[..., 0, :] & mask`` over a seeded sample of
  the reference's legal mr plans with ``bits_w <= p``.
* ``prepacked_variant_for``: the one-column kernel at M <= 16 and where the
  tiled kernel's stage does not fit; the tiled one above.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as j_flash
from repro.tuning.plans import enumerate_specs
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import packed_matmul as tpm
from repro_torch.kernels import ref as tref

ATTN_TOL = {torch.float16: (1e-5, 2**-10), torch.float32: (1e-5, 0.0)}
MAIN_PLAN = "a4w4-p10-n32-mr+full-c2"
# the reference tests' shapes (B, H, S, hd, bq, bk), then hd 16 and 120
SHAPES = [(1, 2, 512, 64, 256, 128), (2, 1, 256, 128, 128, 128),
          (1, 2, 256, 16, 128, 128), (1, 2, 256, 120, 128, 128)]


def _qkv(shape, dtype, seed):
    """q, k, v drawn from a seeded numpy generator, rounded to ``dtype``."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)
            for _ in range(3)]


def _pallas(q, k, v, bq, bk):
    jdt = jnp.float16 if q.dtype == torch.float16 else jnp.float32
    jq, jk, jv = (jnp.asarray(t.float().numpy()).astype(jdt) for t in (q, k, v))
    out = j_flash(jq, jk, jv, bq=bq, bk=bk, interpret=True)
    assert out.dtype == jdt
    return np.asarray(out.astype(jnp.float32))


def _outside(got: torch.Tensor, want, dtype) -> int:
    atol, rtol = ATTN_TOL[dtype]
    g, w = got.float().numpy(), np.asarray(want, dtype=np.float32)
    return int((np.abs(g - w) > atol + rtol * np.abs(w)).sum())


# ---- flash_attention: f16 ---------------------------------------------------


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_f16_matches_pallas(shape):
    *dims, bq, bk = shape
    q, k, v = _qkv(dims, torch.float16, seed=sum(dims))
    got = tfa.flash_attention(q, k, v, bq=bq, bk=bk)  # a CPU tensor: the plain version
    assert got.dtype == torch.float16 and got.shape == q.shape
    atol, rtol = ATTN_TOL[torch.float16]
    np.testing.assert_allclose(got.float().numpy(), _pallas(q, k, v, bq, bk),
                               atol=atol, rtol=rtol)


@pytest.mark.parametrize("shape", SHAPES[:2])
def test_f16_emulation_matches_pallas_and_plain(shape):
    *dims, bq, bk = shape
    q, k, v = _qkv(dims, torch.float16, seed=7)
    got = tfa.emulate_tensor_core_flash(q, k, v)
    assert got.dtype == torch.float16
    want = tfa.plain_flash_attention(q, k, v).float().numpy()
    assert _outside(got, _pallas(q, k, v, bq, bk), torch.float16) == 0
    assert _outside(got, want, torch.float16) == 0
    # P rounded once to f16 (11 significant bits) instead of split in two
    once = tfa.emulate_tensor_core_flash(q, k, v, split=False)
    assert _outside(once, want, torch.float16) > q.numel() // 100


def test_f16_p_split_keeps_small_p():
    """P below f16's normal range (2**-14) survives the split: a key
    scored 12 below the row's best has P = e**-12 ~ 6e-6, and the pair
    keeps it within 2**-25 absolutely."""
    p = torch.tensor([1.0, 0.3, 2.0**-14, 6.1e-6, 3e-8, 1e-9])
    hi, lo = tfa.split_terms(p, 2, torch.float16)
    assert float((hi + lo - p).abs().max()) <= 2.0**-25


# ---- flash_attention: f32 on the tensor cores -------------------------------


@pytest.mark.parametrize("shape", SHAPES)
def test_f32_split_emulation_matches_pallas_and_plain(shape):
    *dims, bq, bk = shape
    q, k, v = _qkv(dims, torch.float32, seed=11)
    got = tfa.emulate_split_f32_flash(q, k, v)
    assert got.dtype == torch.float32
    assert _outside(got, _pallas(q, k, v, bq, bk), torch.float32) == 0
    assert _outside(got, tfa.plain_flash_attention(q, k, v), torch.float32) == 0


@pytest.mark.parametrize("shape", SHAPES[:2])
def test_f32_two_terms_fall_outside_the_tolerance(shape):
    """Why three bf16 terms: two (16 significant bits) miss atol 1e-5."""
    *dims, _, _ = shape
    q, k, v = _qkv(dims, torch.float32, seed=11)
    want = tfa.plain_flash_attention(q, k, v)
    assert _outside(tfa.emulate_split_f32_flash(q, k, v, terms=2), want, torch.float32) > 0


def test_split_terms_are_exact_in_three_bf16():
    rng = np.random.default_rng(3)
    x = torch.from_numpy((rng.standard_normal(4096) * 10.0 ** rng.integers(-30, 30, 4096))
                         .astype(np.float32))
    terms = tfa.split_terms(x, 3)
    assert all(torch.equal(t, t.bfloat16().float()) for t in terms)
    assert torch.equal(terms[0] + terms[1] + terms[2], x)


def test_tc_design_matches_routes():
    assert set(tfa.TC_DESIGN) == set(tfa.ROUTES)
    assert tfa.TC_DESIGN[torch.float32] == (32, 3, 3)
    assert tfa.TC_DESIGN[torch.float16] == tfa.TC_DESIGN[torch.bfloat16] == (64, 1, 2)


# ---- packed_matmul_prepacked: the even lane and the kernel choice ----------


def _port_spec(s) -> tref.PackedDotSpec:
    return tref.PackedDotSpec(s.bits_a, s.bits_w, s.p, s.n_pairs, s.correction,
                              s.mr_bits, s.n_columns)


def _derivable_mr_plans(count: int, seed: int) -> list:
    plans = [_port_spec(s) for a in range(1, 9) for w in range(2, 9)
             for s in enumerate_specs(a, w) if s.uses_mr and s.bits_w <= s.p]
    rng = np.random.default_rng(seed)
    pick = [plans[i] for i in rng.choice(len(plans), size=count, replace=False)]
    return [tref.spec_from_name(MAIN_PLAN)] + pick


@pytest.mark.parametrize("spec", _derivable_mr_plans(12, seed=18), ids=lambda s: s.name())
def test_even_lane_from_words_matches_wsc(spec):
    assert tpm.derives_even_lane(spec)
    rng = np.random.default_rng(spec.p * 100 + spec.n_pairs)
    lo = -(1 << (spec.bits_w - 1))
    k, n = 3 * spec.chunk + 2, 37  # ragged k: zero pairs pad the last chunk
    w = rng.integers(lo, -lo, (k, n)).astype(np.int32)
    w[0], w[1] = lo, -lo - 1  # both ends of the range in every column
    packed = tref.pack_weight_words(torch.from_numpy(w), spec)
    want = packed.wsc[..., 0, :] & tref.contamination_mask(spec)
    got = tpm.even_lane(packed.words, spec)
    assert got.dtype == torch.int32
    assert torch.equal(got, want)


def test_even_lane_refuses_plans_that_read_wsc():
    wsc_plan = tref.spec_from_name("a4w8-p7-n2-mr+full-c4")  # bits_w 8 > p 7
    assert wsc_plan.uses_mr and not tpm.derives_even_lane(wsc_plan)
    assert not tpm.derives_even_lane(tref.INT4_EXACT)  # no mr correction
    words = torch.zeros((1, wsc_plan.n_pairs, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        tpm.even_lane(words, wsc_plan)


@pytest.mark.parametrize("name", [MAIN_PLAN, "a4w8-p7-n2-mr+full-c4", "a4w4-p11-n4-full",
                                  "a8w8-p11-n1-full-c4"])
def test_prepacked_variant_by_m(name):
    spec = tref.spec_from_name(name)
    assert tpm.prepacked_variant_for(1, spec) == "packed_matmul_prepacked"
    assert tpm.prepacked_variant_for(16, spec) == "packed_matmul_prepacked"
    assert tpm.prepacked_variant_for(17, spec) == "packed_matmul_prepacked_tiled"
    assert tpm.prepacked_variant_for(64, spec) == "packed_matmul_prepacked_tiled"


def test_prepacked_variant_by_stage_size():
    # 64 pairs a chunk: a stage of 128 activations and 64 word rows needs
    # more shared memory than the tiled kernel takes
    big = tref.PackedDotSpec(1, 2, 10, 64, "naive")
    assert tpm._prepacked_tiled_geometry(big)[1] > tpm._TILE_SMEM
    assert tpm.prepacked_variant_for(64, big) == "packed_matmul_prepacked"
    main = tref.spec_from_name(MAIN_PLAN)
    per, nbytes = tpm._prepacked_tiled_geometry(main)
    assert per * main.n_pairs % 8 == 0 and nbytes <= tpm._TILE_SMEM


def test_prepacked_variants_and_counts():
    assert tpm.PREPACKED_VARIANTS == tuple(tpm.PREPACKED_KERNELS)
    assert set(tpm.packed_matmul_prepacked.variant_launches) == set(tpm.PREPACKED_VARIANTS)
    spec = tref.spec_from_name(MAIN_PLAN)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((33, 70)).astype(np.float32))
    w = torch.from_numpy(rng.integers(-8, 8, (70, 24)).astype(np.int32))
    packed = tref.pack_weight_words(w, spec)
    scale = x.abs().amax(-1, keepdim=True) / 7
    before = (tpm.packed_matmul_prepacked.launches,
              dict(tpm.packed_matmul_prepacked.variant_launches))
    got = tpm.packed_matmul_prepacked(x, packed.words, packed.wsc, spec, scale, 8)
    want = tpm.packed_matmul_prepacked_plain(x, packed.words, packed.wsc, spec, scale, 8)
    assert torch.equal(got, want)  # a CPU tensor: the plain version, no launch
    assert (tpm.packed_matmul_prepacked.launches,
            tpm.packed_matmul_prepacked.variant_launches) == before
