"""Port parity: the packed-arithmetic core of ``repro_torch`` against the
JAX reference, bit for bit.

The same seeded numpy inputs go through ``repro.kernels.ref`` /
``repro.core.quantize`` and their ``repro_torch`` counterparts.  Integer
results must be bit-exact (tolerance 0); quantizer payloads and scales too,
including half-to-even ties and the a8 upper half stored as uint8.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantize as jq
from repro.kernels import ref as jref
from repro.tuning.plans import enumerate_specs
from repro_torch.convert import spec_from_dict
from repro_torch.core import quantize as tq
from repro_torch.kernels import ref as tref


def _sample_plans(seed: int = 0) -> list:
    """The main path's plans and the int4 presets, completed by a seeded pick
    of an enumerated a4w4 plan of every kind (naive, full, mr, mr+full,
    single- and multi-column) not yet covered, and one a2w2 plan."""
    rng = np.random.default_rng(seed)
    plans = [jref.PackedDotSpec(4, 4, 10, 32, "mr+full", 2, 2),
             jref.PackedDotSpec(4, 4, 11, 16, "full", 0, 2),
             jref.PackedDotSpec(8, 8, 11, 1, "full", 0, 4),
             jref.INT4_EXACT, jref.INT4_NAIVE, jref.INT4_MR_OVERPACKED]
    kinds = {(s.correction, s.n_columns > 1) for s in plans}
    by_kind: dict = {}
    for s in enumerate_specs(4, 4):
        by_kind.setdefault((s.correction, s.n_columns > 1), []).append(s)
    for kind, group in by_kind.items():
        if kind not in kinds:
            plans.append(group[int(rng.integers(len(group)))])
    specs = enumerate_specs(2, 2)
    plans.append(specs[int(rng.integers(len(specs)))])
    return plans


PLANS = _sample_plans()


def test_plan_sample_covers_every_scheme():
    kinds = {(s.correction, s.n_columns > 1) for s in PLANS}
    for corr in ("naive", "full", "mr", "mr+full"):
        assert (corr, False) in kinds and (corr, True) in kinds


@pytest.mark.parametrize("spec", PLANS, ids=lambda s: s.name())
def test_spec_fields_names_and_properties(spec):
    port = spec_from_dict(dataclasses.asdict(spec))
    assert port.name() == spec.name()
    assert tref.spec_from_name(spec.name()) == port
    for prop in ("chunk", "col_bits_a", "extract_width", "uses_mr",
                 "rounds_half_up", "provably_exact"):
        assert getattr(port, prop) == getattr(spec, prop), prop
    for j in range(spec.n_columns):
        assert port.column_shift(j) == spec.column_shift(j)


def test_spec_rejections_agree():
    """Over a seeded grid of field combinations, the two constructors accept
    and reject the same specs, with the same message (clauses included)."""
    rng = np.random.default_rng(1)
    corrections = ("naive", "full", "mr", "mr+full", "bogus")
    n_checked = n_rejected = 0
    for _ in range(400):
        kw = dict(
            bits_a=int(rng.integers(0, 9)), bits_w=int(rng.integers(1, 9)),
            p=int(rng.integers(0, 16)), n_pairs=int(rng.integers(0, 70)),
            correction=corrections[int(rng.integers(len(corrections)))],
            mr_bits=int(rng.integers(0, 5)), n_columns=int(rng.integers(0, 5)),
        )
        try:
            jspec, jerr = jref.PackedDotSpec(**kw), None
        except ValueError as e:
            jspec, jerr = None, str(e)
        try:
            tspec, terr = tref.PackedDotSpec(**kw), None
        except ValueError as e:
            tspec, terr = None, str(e)
        assert terr == jerr, kw
        if jspec is not None:
            assert tspec.name() == jspec.name()
        n_checked += 1
        n_rejected += jerr is not None
    assert 0 < n_rejected < n_checked


def test_presets_match():
    for name in ("INT4_EXACT", "INT4_NAIVE", "INT4_MR_OVERPACKED", "INT2_EXACT"):
        assert dataclasses.asdict(getattr(tref, name)) == dataclasses.asdict(
            getattr(jref, name))


def _operands(spec, m: int, k: int, n: int, seed: int):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 1 << spec.bits_a, size=(m, k)).astype(np.int32)
    lo = -(1 << (spec.bits_w - 1))
    w = rng.integers(lo, -lo, size=(k, n)).astype(np.int32)
    return x, w


def _eq(t: torch.Tensor, j) -> None:
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@functools.partial(jax.jit, static_argnames="spec")
def _jax_packed(x, w, xpad, spec):
    """The reference's pack stage and its three matmuls, in one program."""
    jp = jref.pack_weight_words(w, spec)
    return (jp.words, jp.wsc, jref.ref_packed_matmul(x, w, spec),
            jref.ref_packed_matmul_prepacked(x, jp, spec),
            jref.packed_tile_matmul_prepacked(xpad, jp.words, jp.wsc, spec))


@pytest.mark.parametrize("spec", PLANS, ids=lambda s: s.name())
def test_packing_and_matmuls_bit_exact(spec):
    # one shape for every plan; K=130 is ragged for every chunk above 2
    k = 130
    x, w = _operands(spec, m=3, k=k, n=37, seed=spec.p * 131 + spec.n_pairs)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    tp = tref.pack_weight_words(wt, spec)
    xpad = np.pad(x, ((0, 0), (0, tp.k - k)))
    words, wsc, mm, mm_pre, tile = _jax_packed(x, w, xpad, spec)
    _eq(tp.words, words)
    if spec.uses_mr:
        _eq(tp.wsc, wsc)
    else:
        assert tp.wsc is None and wsc is None
    _eq(tref.ref_packed_matmul(xt, wt, spec), mm)
    _eq(tref.ref_packed_matmul_prepacked(xt, tp, spec), mm_pre)
    _eq(tref.packed_tile_matmul_prepacked(torch.from_numpy(xpad), tp.words,
                                          tp.wsc, spec), tile)


def test_extraction_and_contamination_bit_exact():
    spec = jref.INT4_MR_OVERPACKED
    port = spec_from_dict(dataclasses.asdict(spec))
    rng = np.random.default_rng(2)
    partial = rng.integers(-(1 << 31), (1 << 31) - 1, size=(4, 3, 5)).astype(np.int32)
    contam = rng.integers(0, 1 << spec.mr_bits, size=(4, 3, 5)).astype(np.int32)
    _eq(tref.extract_accumulated_field(torch.from_numpy(partial), port,
                                       torch.from_numpy(contam)),
        jref.extract_accumulated_field(jnp.asarray(partial), spec,
                                       jnp.asarray(contam)))
    xa = rng.integers(0, 16, size=(3, 2, spec.n_pairs, 2)).astype(np.int32)
    ws = rng.integers(-8, 8, size=(2, spec.n_pairs, 2, 5)).astype(np.int32)
    _eq(tref.contamination_terms(torch.from_numpy(xa), torch.from_numpy(ws), port),
        jref.contamination_terms(jnp.asarray(xa), jnp.asarray(ws), spec))
    x_u = rng.integers(0, 256, size=(3, 8)).astype(np.int32)
    col = tref.PackedDotSpec(8, 8, 11, 1, "full", n_columns=4)
    for j in range(4):
        _eq(tref.slice_column(torch.from_numpy(x_u), col, j),
            jref.slice_column(jnp.asarray(x_u), jref.PackedDotSpec(
                8, 8, 11, 1, "full", n_columns=4), j))


def test_int4_pack_unpack_matmul_bit_exact():
    rng = np.random.default_rng(3)
    w = rng.integers(-8, 8, size=(64, 24)).astype(np.int8)
    x = rng.integers(-128, 128, size=(5, 64)).astype(np.int8)
    tp = tref.pack_int4_weights(torch.from_numpy(w))
    jp = jref.pack_int4_weights(w)
    _eq(tp, jp)
    assert tp.dtype == torch.uint8
    _eq(tref.unpack_int4_weights(tp), jref.unpack_int4_weights(jp))
    _eq(tref.ref_int4_matmul(torch.from_numpy(x), tp),
        jref.ref_int4_matmul(jnp.asarray(x), jp))
    for k, ma, mw in ((1000, 255, 128), (1 << 20, 127, 8), (10, 1 << 20, 2)):
        assert tref.exact_int_matmul_fits_f32(k, ma, mw) == \
            jref.exact_int_matmul_fits_f32(k, ma, mw)


def _quant_inputs() -> list[np.ndarray]:
    rng = np.random.default_rng(4)
    # exact ties: amax 7 makes the 4-bit signed scale 1.0, so x/scale lands
    # on .5 and the rounding must be half to even
    ties = np.array([[7.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5]], np.float32)
    zeros = np.zeros((1, 8), np.float32)  # all-zero row: the 1e-8 scale floor
    return [ties, zeros, rng.standard_normal((1, 8)).astype(np.float32) * 3]


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_quantizers_bit_exact(bits):
    for x in _quant_inputs():
        xt = torch.from_numpy(x)
        for axis in (-1, 0):
            t, j = tq.quantize_signed(xt, bits, axis), jq.quantize_signed(
                jnp.asarray(x), bits, axis)
            assert t.values.dtype == torch.int8
            _eq(t.values, j.values)
            _eq(t.scale, j.scale)
            t, j = tq.quantize_unsigned(xt, bits, axis), jq.quantize_unsigned(
                jnp.asarray(x), bits, axis)
            assert t.values.dtype == torch.uint8 and t.zero_point == j.zero_point
            _eq(t.values, j.values)
            _eq(t.scale, j.scale)
        wq = np.array(jq.quantize_signed(jnp.asarray(x), bits, 0).values)
        _eq(tq.zero_point_correction(torch.from_numpy(wq), 1 << (bits - 1)),
            jq.zero_point_correction(jnp.asarray(wq), 1 << (bits - 1)))


def test_a8_upper_half_survives_uint8():
    x = np.linspace(-1.0, 1.0, 64, dtype=np.float32)[None]
    q = tq.quantize_unsigned(torch.from_numpy(x), bits=8)
    assert int(q.values.max()) == 255 and int(q.values.min()) == 1
    _eq(q.values, jq.quantize_unsigned(jnp.asarray(x), bits=8).values)
