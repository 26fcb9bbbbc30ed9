"""Port parity: the paper's packing arithmetic (§III–VII) in
``repro_torch.core`` against the reference's numpy modules.

The same seeded numpy operands go through ``repro.core.{packing,
correction,addpack}`` and their ports.  Every integer output is bit-exact
(tolerance 0), and the exhaustive error statistics of Tables I/II
(``scheme_stats``) are equal field by field.  The port computes on the CPU
here (``device="cpu"``); ``chip_smoke.py`` runs the same calls on the card
and holds them against the CPU.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import addpack as ja
from repro.core import correction as jc
from repro.core import packing as jp
from repro.kernels import ref as jref
from repro_torch.core import addpack as ta
from repro_torch.core import correction as tc
from repro_torch.core import packing as tp
from repro_torch.kernels import ref as tref

# the survey's three configurations: INT4 (delta 3), INT4 overpacked
# (delta -2, Fig. 6), six 4x5-bit products per DSP (§VI)
CONFIGS = {
    "int4": lambda m: m.int4_packing(3),
    "int4-over": lambda m: m.int4_packing(-2),
    "six": lambda m: m.intn_packing((4, 4, 4), (5, 5), -2),
}
# configurations for random-operand checks: the above plus INT8 and an
# asymmetric one with a non-uniform field grid
ALL = dict(CONFIGS, int8=lambda m: m.int8_packing(2),
           ragged=lambda m: m.PackingConfig((3, 5), (4,), (0, 9), (0,), 1))


def _eq(t: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(t.numpy(), np.asarray(want))


def _operands(cfg, n: int, seed: int):
    rng = np.random.default_rng(seed)
    a = np.stack([rng.integers(0, 1 << w, n) for w in cfg.a_widths], -1)
    w = np.stack([rng.integers(-(1 << (b - 1)), 1 << (b - 1), n) for b in cfg.w_widths], -1)
    return a, w


@pytest.mark.parametrize("scheme", jc.SCHEMES)
@pytest.mark.parametrize("name", list(CONFIGS))
def test_scheme_stats_equal_field_by_field(name, scheme):
    want = jc.scheme_stats(CONFIGS[name](jp), scheme)
    got = tc.scheme_stats(CONFIGS[name](tp), scheme, device="cpu")
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert (got.ep_bar, got.mae_bar, got.wce_bar, got.row()) == (
        want.ep_bar, want.mae_bar, want.wce_bar, want.row())


@pytest.mark.parametrize("name", list(ALL))
def test_config_algebra_matches(name):
    j, t = ALL[name](jp), ALL[name](tp)
    assert dataclasses.astuple(t) == dataclasses.astuple(j)
    for attr in ("n_a", "n_w", "n_results", "r_offsets", "r_widths"):
        assert getattr(t, attr) == getattr(j, attr), attr
    assert t.product_bits() == j.product_bits()
    assert t.fits_dsp48() == j.fits_dsp48()
    assert t.packing_density() == j.packing_density()
    assert t.max_accumulations() == j.max_accumulations()


@pytest.mark.parametrize("scheme", jc.SCHEMES)
@pytest.mark.parametrize("name", list(ALL))
def test_simulate_bit_exact(name, scheme):
    jcfg, tcfg = ALL[name](jp), ALL[name](tp)
    a, w = _operands(jcfg, 3000, seed=len(name) * 7 + jc.SCHEMES.index(scheme))
    _eq(tc.simulate(tcfg, torch.from_numpy(a), torch.from_numpy(w), scheme),
        jc.simulate(jcfg, a, w, scheme))
    # a carried accumulator word (the C port) on top of the scheme's own
    c = np.random.default_rng(3).integers(-1000, 1000, a.shape[0])
    _eq(tc.simulate(tcfg, a, w, scheme, accumulate_correction=torch.from_numpy(c)),
        jc.simulate(jcfg, a, w, scheme, accumulate_correction=c))


@pytest.mark.parametrize("name", list(ALL))
def test_packing_primitives_bit_exact(name):
    jcfg, tcfg = ALL[name](jp), ALL[name](tp)
    a, w = _operands(jcfg, 2000, seed=11)
    ta_, tw_ = torch.from_numpy(a), torch.from_numpy(w)
    _eq(tp.pack_activations(tcfg, ta_), jp.pack_activations(jcfg, a))
    _eq(tp.pack_weights(tcfg, tw_), jp.pack_weights(jcfg, w))
    p = jp.multiply_packed(jcfg, a, w)
    _eq(tp.multiply_packed(tcfg, ta_, tw_), p)
    for rhu in (False, True):
        _eq(tp.extract_fields(tcfg, torch.from_numpy(p), round_half_up=rhu),
            jp.extract_fields(jcfg, p, round_half_up=rhu))
    _eq(tp.outer_product_exact(tcfg, ta_, tw_), jp.outer_product_exact(jcfg, a, w))
    _eq(tc.approx_correction_word(tcfg, tw_), jc.approx_correction_word(jcfg, w))
    fields = jp.extract_fields(jcfg, p)
    _eq(tc.mr_restore(tcfg, torch.from_numpy(fields), ta_, tw_),
        jc.mr_restore(jcfg, fields, a, w))


def test_scalar_helpers_bit_exact():
    rng = np.random.default_rng(5)
    v = rng.integers(-(1 << 40), 1 << 40, 500)
    for width in (1, 4, 9, 17, 33):
        _eq(tp.sign_extend(torch.from_numpy(v), width), jp.sign_extend(v, width))
    a, w = rng.integers(0, 16, 500), rng.integers(-8, 8, 500)
    for nbits in (1, 2, 5):
        _eq(tp.mul_lsbs(a, w, nbits), jp.mul_lsbs(a, w, nbits))


def test_error_stats_and_operands_match():
    rng = np.random.default_rng(9)
    exp, act = rng.integers(-50, 50, (400, 6)), rng.integers(-50, 50, (400, 6))
    got = tc.error_stats(torch.from_numpy(exp), torch.from_numpy(act))
    assert dataclasses.astuple(got) == dataclasses.astuple(jc.error_stats(exp, act))
    cfg = jp.int4_packing()
    ja_, jw_ = jc.exhaustive_operands(cfg)
    ta_, tw_ = tc.exhaustive_operands(tp.int4_packing(), device="cpu")
    _eq(ta_, ja_)
    _eq(tw_, jw_)


@pytest.mark.parametrize("bad", [
    ("a", 16, "a[1] out of unsigned 4-bit range"),
    ("a", -1, "a[1] out of unsigned 4-bit range"),
    ("w", 8, "w[1] out of signed 4-bit range"),
    ("w", -9, "w[1] out of signed 4-bit range"),
])
def test_range_checks_raise_like_reference(bad):
    which, value, msg = bad
    a, w = np.array([[1, 2]]), np.array([[3, -4]])
    (a if which == "a" else w)[0, 1] = value
    for mod in (jp, tp):
        with pytest.raises(ValueError, match=msg.replace("[", r"\[").replace("]", r"\]")):
            mod.multiply_packed(mod.int4_packing(), a, w)


def test_shape_and_scheme_errors_match():
    for mod in (jp, tp):
        with pytest.raises(ValueError, match="a last dim 3 != 2"):
            mod.multiply_packed(mod.int4_packing(), np.array([[1, 2, 3]]), np.array([[1, 2]]))
    for mod in (jc, tc):
        with pytest.raises(ValueError, match="unknown scheme 'exact'"):
            mod.simulate(jp.int4_packing() if mod is jc else tp.int4_packing(),
                         np.array([[1, 2]]), np.array([[3, -4]]), "exact")


@pytest.mark.parametrize("args", [
    ((4,), (4,), (0, 1), (0,), 0),          # lengths differ
    ((4, 4), (4,), (8, 0), (0,), 0),        # offsets not ascending
    ((30, 30), (4,), (0, 30), (0,), 0),     # beyond the int64 budget
])
def test_config_errors_match(args):
    for mod in (jp, tp):
        with pytest.raises(ValueError):
            mod.PackingConfig(*args)
        with pytest.raises(ValueError, match="spacing must be positive"):
            mod.intn_packing((1,), (1,), -len(args[0]) - 1)


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tc.scheme_stats(tp.int4_packing(), "naive")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tc.exhaustive_operands(tp.int4_packing())


# ---- addition packing (§VII) ---------------------------------------------

ADD_CONFIGS = [((9,) * 5, 0), ((10,) * 4, 2), ((12,) * 4, 0), ((14, 14), 1), ((5, 11, 7), 1)]


@pytest.mark.parametrize("widths,guard", ADD_CONFIGS)
def test_addpack_lane_ops_bit_exact(widths, guard):
    jcfg, tcfg = ja.AddPackConfig(widths, guard), ta.AddPackConfig(widths, guard)
    assert dataclasses.astuple(tcfg) == dataclasses.astuple(jcfg)
    assert (tcfg.offsets, tcfg.bits_used(), tcfg.packing_density()) == (
        jcfg.offsets, jcfg.bits_used(), jcfg.packing_density())
    rng = np.random.default_rng(sum(widths) + guard)
    lim = 1 << (min(widths) - 1)
    x, y = (rng.integers(-lim, lim, (300, len(widths))) for _ in range(2))
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    _eq(ta.pack_lanes(tcfg, tx), ja.pack_lanes(jcfg, x))
    p, q = ja.pack_lanes(jcfg, x), ja.pack_lanes(jcfg, y)
    _eq(ta.packed_add(tcfg, torch.from_numpy(p), torch.from_numpy(q)), ja.packed_add(jcfg, p, q))
    _eq(ta.extract_lanes(tcfg, torch.from_numpy(p)), ja.extract_lanes(jcfg, p))
    _eq(ta.packed_lane_add(tcfg, tx, ty), ja.packed_lane_add(jcfg, x, y))
    _eq(ta.lane_add_expected(tcfg, tx, ty), ja.lane_add_expected(jcfg, x, y))
    unsigned = ta.AddPackConfig(widths, guard, signed=False)
    _eq(ta.packed_lane_add(unsigned, tx, ty),
        ja.packed_lane_add(ja.AddPackConfig(widths, guard, signed=False), x, y))


@pytest.mark.parametrize("headroom", [None, 0, 1])
@pytest.mark.parametrize("widths,guard", ADD_CONFIGS)
def test_addpack_accumulate_bit_exact(widths, guard, headroom):
    jcfg, tcfg = ja.AddPackConfig(widths, guard), ta.AddPackConfig(widths, guard)
    rng = np.random.default_rng(len(widths) * 10 + guard)
    lim = 1 << (min(widths) - 2)
    terms = rng.integers(-lim, lim, (6, 13, len(widths)))  # (groups, T, lanes)
    _eq(ta.accumulate(tcfg, torch.from_numpy(terms), headroom_bits=headroom),
        ja.accumulate(jcfg, terms, headroom_bits=headroom))


def test_addpack_config_errors_and_paper_example():
    for mod in (ja, ta):
        with pytest.raises(ValueError, match="lanes need 50 bits > accumulator 48"):
            mod.AddPackConfig((10,) * 5, guard_bits=0)
        with pytest.raises(ValueError, match="lanes need 31 bits > accumulator 30"):
            mod.AddPackConfig((14, 14), guard_bits=3, total_bits=30)
        with pytest.raises(ValueError, match="x last dim 2 != 5"):
            mod.pack_lanes(mod.five_by_nine(), np.zeros((1, 2), np.int64))
    assert dataclasses.astuple(ta.five_by_nine()) == dataclasses.astuple(ja.five_by_nine())
    assert ta.AddPackConfig((9,)).total_bits == 48


# ---- the quickstart through the port -------------------------------------


def test_quickstart_sections_match_reference():
    """``examples/quickstart.py`` sections 1–5, each through the reference
    and the port: bit-exact fields, equal statistics, and the packed
    matmul equal to the exact integer matmul in both."""
    a, w = np.array([[3, 10]]), np.array([[-7, 5]])
    for scheme in ("naive", "full", "approx"):
        _eq(tc.simulate(tp.int4_packing(), a, w, scheme),
            jc.simulate(jp.int4_packing(), a, w, scheme))
    six_j, six_t = jp.intn_packing((4, 4, 4), (5, 5), -2), tp.intn_packing((4, 4, 4), (5, 5), -2)
    assert six_t.packing_density() == six_j.packing_density() == 1.125
    apc_j, apc_t = ja.AddPackConfig((9,) * 5, 0), ta.AddPackConfig((9,) * 5, 0)
    x = np.array([[100, -200, 5, 17, -9]])
    y = np.array([[-50, 130, 25, -4, 77]])
    _eq(ta.packed_lane_add(apc_t, x, y), ja.packed_lane_add(apc_j, x, y))
    rng = np.random.default_rng(0)
    x_q = rng.integers(0, 16, (8, 32)).astype(np.int8)
    w_q = rng.integers(-8, 8, (32, 8)).astype(np.int8)
    want = jref.ref_quantized_matmul(jnp.asarray(x_q), jnp.asarray(w_q))
    got = tref.ref_quantized_matmul(torch.from_numpy(x_q), torch.from_numpy(w_q))
    assert got.dtype == torch.int32
    _eq(got, want)
    spec = tref.INT4_EXACT
    _eq(tref.ref_packed_matmul(torch.from_numpy(x_q), torch.from_numpy(w_q), spec), want)


@pytest.mark.parametrize("shape", [(3, 5, 4), (17, 64, 9)])
def test_ref_quantized_matmul_bit_exact(shape):
    m, k, n = shape
    rng = np.random.default_rng(m)
    x = rng.integers(0, 256, (m, k)).astype(np.int32)
    w = rng.integers(-128, 128, (k, n)).astype(np.int32)
    _eq(tref.ref_quantized_matmul(torch.from_numpy(x), torch.from_numpy(w)),
        jref.ref_quantized_matmul(jnp.asarray(x), jnp.asarray(w)))
