"""Port parity: the static verifier (``repro_torch.analysis``) against the
reference's ``repro.analysis``.

* ``Interval``: every transfer function on seeded intervals gives the
  reference's endpoints and predicates.
* ``certify_spec``: ``to_json`` equal field for field on a seeded sample of
  ``enumerate_specs`` for a4w4, a8w8 and a2w2, and ``DspTunedLeaf.exact``
  (no verdict given) equal to the certificate's verdict; the witnesses
  equal.
* ``certify_config`` (the config enumeration on the CPU) and
  ``certify_addpack`` on the paper's INT4 configurations and lane layouts.
* ``python -m repro_torch.analysis.verify`` on the CPU: exit 0, and the
  certificates it writes equal the reference's.

Tolerance 0 throughout: certificates are integers, strings and floats
from the same numpy convolutions.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch

from repro.analysis import domain as jdom
from repro.analysis import verify as jv
from repro.core import addpack as ja
from repro.core import packing as jp
from repro.tuning import plans as jplans
from repro_torch.analysis import domain as tdom
from repro_torch.analysis import verify as tv
from repro_torch.core import addpack as ta
from repro_torch.core import packed_params as TP
from repro_torch.core import packing as tp
from repro_torch.tuning import plans as tplans

PAIRS = ((4, 4), (8, 8), (2, 2))
PER_PAIR = 8


def _sample(a_bits: int, w_bits: int, seed: int) -> list:
    specs = jplans.enumerate_specs(a_bits, w_bits)
    idx = np.random.default_rng(seed).choice(len(specs), min(PER_PAIR, len(specs)),
                                             replace=False)
    return [specs[i] for i in sorted(idx)]


SAMPLE = [s for i, (a, w) in enumerate(PAIRS) for s in _sample(a, w, 20 + i)]


def _port(spec):
    return tplans.spec_from_json(jplans.spec_to_json(spec))


def _intervals(seed: int, n: int = 40):
    rng = np.random.default_rng(seed)
    lo = rng.integers(-5000, 5000, n)
    return [(int(a), int(a + b)) for a, b in zip(lo, rng.integers(0, 4000, n))]


def _iv(mod, pair):
    return mod.Interval(*pair)


def _ends(iv) -> tuple[int, int]:
    return iv.lo, iv.hi


def test_interval_arithmetic_matches_reference():
    pairs = _intervals(0)
    ints = np.random.default_rng(1).integers(-300, 300, len(pairs)).tolist()
    for (x, y), k in zip(zip(pairs, pairs[1:] + pairs[:1]), ints):
        jx, jy, tx, ty = _iv(jdom, x), _iv(jdom, y), _iv(tdom, x), _iv(tdom, y)
        for op in (lambda a, b: a + b, lambda a, b: a - b, lambda a, b: a * b,
                   lambda a, b: a + k, lambda a, b: a * k, lambda a, b: k + a,
                   lambda a, b: k * a, lambda a, b: a - k,
                   lambda a, b: -a):
            assert _ends(op(tx, ty)) == _ends(op(jx, jy))
        shift = abs(k) % 12
        for name, arg in (("sum_n", abs(k)), ("shl", shift), ("ashr", shift),
                          ("round_half_up", shift + 1), ("wrap_signed", shift + 2)):
            assert _ends(getattr(tx, name)(arg)) == _ends(getattr(jx, name)(arg)), name
        for bits in (4, 11, 13, 16):
            assert tx.fits_signed(bits) == jx.fits_signed(bits)
        assert (tx.magnitude, tx.is_zero, tx.contains(k), repr(tx)) == (
            jx.magnitude, jx.is_zero, jx.contains(k), repr(jx))
    for bits in (1, 4, 9):
        assert _ends(tdom.Interval.signed(bits)) == _ends(jdom.Interval.signed(bits))
        assert _ends(tdom.Interval.unsigned(bits)) == _ends(jdom.Interval.unsigned(bits))
    with pytest.raises(ValueError, match="empty interval"):
        tdom.Interval(3, 2)
    with pytest.raises(ValueError, match="round_half_up needs"):
        tdom.Interval(0, 1).round_half_up(0)


def test_enumerate_specs_names_match_reference():
    for a, w in PAIRS + ((4, 8), (8, 4), (6, 6)):
        assert [s.name() for s in tplans.enumerate_specs(a, w)] == [
            s.name() for s in jplans.enumerate_specs(a, w)]


@pytest.mark.parametrize("spec", SAMPLE, ids=lambda s: s.name())
def test_certify_spec_equal_field_for_field(spec):
    tspec = _port(spec)
    want, got = jv.certify_spec(spec), tv.certify_spec(tspec)
    assert got.to_json() == want.to_json()
    assert (got.exact, got.ok, got.failed_clauses, got.summary(), got.to_json_summary()) == (
        want.exact, want.ok, want.failed_clauses, want.summary(), want.to_json_summary())
    if want.witness is not None:
        for t, j in zip(tv.witness_operands(tspec, 3, rows=2, cols=5),
                        jv.witness_operands(spec, 3, rows=2, cols=5)):
            np.testing.assert_array_equal(t, j)
    # the tuned leaf takes its verdict from the certificate
    rng = np.random.default_rng(3)
    values = rng.integers(-(1 << (spec.bits_w - 1)), 1 << (spec.bits_w - 1),
                          (2 * spec.chunk, 8)).astype(np.int8)
    leaf = TP.DspTunedLeaf(torch.from_numpy(values), torch.ones((1, 8)), tspec,
                           prepack=False)
    assert leaf.exact == want.exact


def test_exact_certificates_cover_provably_exact():
    """The certificate proves exactness for a superset of the constructor's
    ``provably_exact``, in the port as in the reference."""
    for a, w in PAIRS:
        specs = tplans.enumerate_specs(a, w)
        proven = [s.name() for s in specs if tv.certify_spec(s).exact]
        assert {s.name() for s in specs if s.provably_exact} <= set(proven)
        assert proven == [s.name() for s in jplans.enumerate_specs(a, w)
                          if jv.certify_spec(s).exact]


CONFIGS = {
    "int4": lambda m: m.int4_packing(3),
    "int4-over": lambda m: m.int4_packing(-2),
    "six": lambda m: m.intn_packing((4, 4, 4), (5, 5), -2),
}


@pytest.mark.parametrize("scheme", ("naive", "full", "approx", "mr", "mr+full"))
@pytest.mark.parametrize("name", list(CONFIGS))
def test_certify_config_equal_on_paper_configs(name, scheme):
    want = jv.certify_config(CONFIGS[name](jp), scheme)
    got = tv.certify_config(CONFIGS[name](tp), scheme, device="cpu")
    assert got.to_json() == want.to_json()
    assert tv.config_name(CONFIGS[name](tp), scheme) == jv.config_name(
        CONFIGS[name](jp), scheme)


@pytest.mark.parametrize("lanes, guard", [((9,) * 5, 0), ((8, 8), 1), ((10,) * 4, 2),
                                          ((14, 14), 0), ((7, 9, 11), 1)])
def test_certify_addpack_equal(lanes, guard):
    want = jv.certify_addpack(ja.AddPackConfig(lanes, guard_bits=guard))
    got = tv.certify_addpack(ta.AddPackConfig(lanes, guard_bits=guard))
    assert got.to_json() == want.to_json()


def test_certify_config_rejects_unknown_scheme():
    with pytest.raises(ValueError, match="unknown scheme"):
        tv.certify_config(tp.int4_packing(3), "exact", device="cpu")


def test_verify_cli_on_cpu_writes_reference_certificates(tmp_path):
    out = tmp_path / "certs.json"
    rc = tv.main(["--device", "cpu", "--pairs", "2,2 4,4", "--no-configs",
                  "--json", str(out)])
    assert rc == 0
    certs = json.loads(out.read_text())
    by_name = {c["plan"]: c for c in certs}
    for a, w in ((2, 2), (4, 4)):
        for spec in jplans.enumerate_specs(a, w):
            assert by_name[spec.name()] == jv.certify_spec(spec).to_json()
    addpack = [c for c in certs if c["model"] == "addpack"]
    assert [c["plan"] for c in addpack] == [
        "addpack-9x9x9x9x9-g0", "addpack-8x8-g1", "addpack-10x10x10x10-g2"]


def test_port_spec_round_trips_reference_fields():
    for spec in SAMPLE:
        assert dataclasses.asdict(_port(spec)) == dataclasses.asdict(spec)
        assert _port(spec).delta == spec.delta
