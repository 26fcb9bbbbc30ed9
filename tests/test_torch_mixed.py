"""Port parity: the ``dsp_mixed`` serving mode (``repro_torch.tuning.mixed``,
the plan database's ``"mixed"`` entries, the engine and its knobs) and
``quant_mode="none"``, against the reference.

* The numpy ``jax.random.randint`` (``tuning._jax_prng``) is bit-exact
  against JAX's, under ``jax_threefry_partitionable=True`` (JAX 0.9.0's
  default; the flag's value is asserted, so that an upgrade that flips it
  fails here loudly).
* ``allocate_mixed_plans`` and ``suggest_budget`` fed the reference's own
  ``LayerSensitivity`` list give identical assignments, plans,
  ``predicted_error``, ``cost`` and ``base_cost`` (exact: a pure function
  of the same numbers), at budgets 0, ``DEFAULT_MIXED_BUDGET`` and
  ``suggest_budget``'s, and on a four-width seeded ladder unsharded and at
  ``shard_groups=2``.
* The port's own sensitivity pass on qwen smoke (two widths, 8 calibration
  tokens) within ``rtol 1e-3, atol 1e-7`` of the reference's per path,
  with the same sizes and the same allocation.
* An allocation the reference wrote (``allocation_to_json``) reads back in
  the port to an equal record and writes back to the same JSON.
* ``dsp_mixed`` greedy tokens equal the reference engine's on one
  allocation carried across as JSON, on qwen smoke and moonshot smoke; a
  warm plan-database build runs no probe; ``plan_bits="auto"`` promotes,
  ``autotune_plans`` with ``dsp_mixed`` raises.
* ``quant_mode="none"`` emits the reference's ``"none"`` tokens and the
  port's ``"native"`` ones.

One reference sensitivity pass per module, cached; no pass at the four
default widths on the CPU.
"""

from __future__ import annotations

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as JT
from repro.models.registry import get_config as j_get_config
from repro.serving import Engine as JEngine
from repro.serving import ServeConfig as JServeConfig
from repro.tuning import mixed as jmixed
from repro.tuning import plandb as jdb
from repro_torch.convert import params_from_numpy
from repro_torch.core import packed_params as TP
from repro_torch.models.registry import get_config as t_get_config
from repro_torch.serving import Engine, ServeConfig
from repro_torch.tuning import _jax_prng
from repro_torch.tuning import mixed as tmixed
from repro_torch.tuning import plandb as tdb

QWEN, MOONSHOT = "qwen1.5-110b", "moonshot-v1-16b-a3b"
PROMPTS = [[5, 17, 33, 2, 9], [40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50], [7, 8, 9]]
KW = dict(n_slots=2, max_len=32, prefill_chunk=4, max_new=6)
WIDTHS = ((4, 4), (8, 8))
CALIB = dict(widths=WIDTHS, n_calib_tokens=8)
MIXED_KW = dict(width_candidates=WIDTHS, calib_tokens=8)
SENS_RTOL, SENS_ATOL = 1e-3, 1e-7


def numpy_params(jcfg, seed: int = 0) -> dict:
    """Seeded numpy weights in the reference's layout."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: JT.init_params(jax.random.PRNGKey(0), jcfg))

    def leaf(path, s):
        name = path[-1].key
        if name == "scale":
            return (1 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        if name == "b":
            return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        std = 0.02 if path[0].key == "embed" else s.shape[-2] ** -0.5
        return (std * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


_WEIGHTS: dict = {}


def weights(arch: str):
    """(jcfg, tcfg, reference params, port params) at float32, built once."""
    if arch not in _WEIGHTS:
        jcfg = dataclasses.replace(j_get_config(arch, smoke=True), dtype="float32")
        tcfg = dataclasses.replace(t_get_config(arch, smoke=True), dtype="float32")
        tree = numpy_params(jcfg)
        _WEIGHTS[arch] = (jcfg, tcfg, jax.tree.map(jnp.asarray, tree),
                          params_from_numpy(tree, tcfg))
    return _WEIGHTS[arch]


def _quant(cfg):
    return dataclasses.replace(cfg, quant=dataclasses.replace(cfg.quant, mode="dsp_tuned"))


@pytest.fixture(scope="module")
def ref_sens():
    """The reference's sensitivity pass on qwen smoke (two widths)."""
    jcfg, _, jparams, _ = weights(QWEN)
    return jmixed.measure_layer_sensitivity(jparams, _quant(jcfg), **CALIB)


def _port_sens(ref_list):
    return [tmixed.LayerSensitivity(s.path, s.n_values, dict(s.errors)) for s in ref_list]


def _synthetic(paths, widths, seed: int):
    """A seeded sensitivity ladder: wider pairs hurt less, as measured ones do."""
    rng = np.random.default_rng(seed)
    out = []
    for i, p in enumerate(paths):
        base = float(rng.uniform(1e-4, 5e-2))
        errors = {b: base * float(rng.uniform(0.5, 2.0)) / (b[0] * b[1]) for b in widths}
        out.append((p, 64 * (i + 1) * 32, errors))
    return out


def _same_allocation(got, want) -> None:
    assert got.assignments == want.assignments
    assert {p: r.name for p, r in got.plans.items()} == \
        {p: r.name for p, r in want.plans.items()}
    assert (got.predicted_error, got.cost, got.base_cost, got.base_bits, got.budget) == \
        (want.predicted_error, want.cost, want.base_cost, want.base_bits, want.budget)


# ---- the calibration draw ----------------------------------------------------


@pytest.mark.parametrize("maxval", [256, 163840, 152064])
@pytest.mark.parametrize("shape", [(2, 8), (2, 32)])
@pytest.mark.parametrize("seed", [0, 1, 12345])
def test_randint_bit_exact_threefry_partitionable_true(seed, shape, maxval):
    """Pinned to ``jax_threefry_partitionable=True`` and the threefry2x32
    implementation, JAX 0.9.0's defaults."""
    assert jax.config.jax_threefry_partitionable is True
    assert jax.config.jax_default_prng_impl == "threefry2x32"
    want = np.asarray(jax.random.randint(jax.random.PRNGKey(seed), shape, 2, maxval,
                                         jnp.int32))
    got = _jax_prng.randint(_jax_prng.prng_key(seed), shape, 2, maxval)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


# ---- the allocator -------------------------------------------------------------


@pytest.mark.parametrize("budget", ["zero", "default", "suggested"])
def test_allocator_identical_on_reference_sensitivities(ref_sens, budget):
    sens = _port_sens(ref_sens)
    if budget == "suggested":
        b = jmixed.suggest_budget(ref_sens, widths=WIDTHS)
        assert tmixed.suggest_budget(sens, widths=WIDTHS) == b
    else:
        b = 0.0 if budget == "zero" else jmixed.DEFAULT_MIXED_BUDGET
    want = jmixed.allocate_mixed_plans(ref_sens, b, widths=WIDTHS)
    got = tmixed.allocate_mixed_plans(sens, b, widths=WIDTHS)
    _same_allocation(got, want)
    assert got.distinct_widths == want.distinct_widths
    assert got.cost_vs_uniform_base == want.cost_vs_uniform_base
    if budget == "zero":
        assert set(got.assignments.values()) == {(8, 8)}


@pytest.mark.parametrize("shard_groups", [1, 2])
def test_allocator_identical_on_a_four_width_ladder(ref_sens, shard_groups):
    widths = tmixed.DEFAULT_WIDTH_CANDIDATES
    assert widths == jmixed.DEFAULT_WIDTH_CANDIDATES
    rows = _synthetic([s.path for s in ref_sens], widths, 7)
    jsens = [jmixed.LayerSensitivity(*r) for r in rows]
    tsens = [tmixed.LayerSensitivity(*r) for r in rows]
    for budget in (jmixed.DEFAULT_MIXED_BUDGET, jmixed.suggest_budget(jsens)):
        want = jmixed.allocate_mixed_plans(jsens, budget, shard_groups=shard_groups)
        got = tmixed.allocate_mixed_plans(tsens, budget, shard_groups=shard_groups)
        _same_allocation(got, want)


def test_sensitivity_pass_matches_reference(ref_sens):
    _, tcfg, _, tparams = weights(QWEN)
    n0 = tmixed.PROBES.count
    got = tmixed.measure_layer_sensitivity(tparams, _quant(tcfg), **CALIB)
    assert tmixed.PROBES.count - n0 == len(ref_sens) * len(WIDTHS)
    assert [s.path for s in got] == [s.path for s in ref_sens]
    for g, w in zip(got, ref_sens):
        assert g.n_values == w.n_values
        assert set(g.errors) == set(w.errors)
        for bits in WIDTHS:
            np.testing.assert_allclose(g.errors[bits], w.errors[bits], rtol=SENS_RTOL,
                                       atol=SENS_ATOL, err_msg=f"{g.path} {bits}")
    want = jmixed.allocate_mixed_plans(ref_sens, widths=WIDTHS)
    assert tmixed.allocate_mixed_plans(got, widths=WIDTHS).assignments == want.assignments


def test_reference_allocation_json_reads_back_equal(ref_sens):
    jalloc = jmixed.allocate_mixed_plans(ref_sens, widths=WIDTHS)
    blob = json.loads(json.dumps(jdb.allocation_to_json(jalloc)))
    got = tdb.allocation_from_json(blob)
    assert got == tmixed.allocate_mixed_plans(_port_sens(ref_sens), widths=WIDTHS)
    assert json.loads(json.dumps(tdb.allocation_to_json(got))) == blob
    assert got.summary() == jalloc.summary()


def test_only_planned_converts_exactly_one_path():
    _, _, _, tparams = weights(QWEN)
    plan = tmixed.select_plan(8, 8, error_budget=0.0, exact_first=True)
    probe = TP.quantize_for_serving(tparams, "dsp_tuned", plans={"/lm_head/w": plan},
                                    only_planned=True)
    assert TP.is_dsp_tuned_leaf(probe["lm_head"]["w"])
    assert probe["lm_head"]["w"].spec == plan.spec
    assert all(isinstance(leaf, torch.Tensor) for p, leaf in TP.iter_packable_weights(probe)
               if p != "/lm_head/w")


# ---- the engine ----------------------------------------------------------------


def test_dsp_mixed_qwen_tokens_identical_on_the_reference_allocation(ref_sens):
    jcfg, tcfg, jparams, tparams = weights(QWEN)
    jalloc = jmixed.allocate_mixed_plans(ref_sens, widths=WIDTHS)
    assert jalloc.distinct_widths >= 2
    talloc = tdb.allocation_from_json(json.loads(json.dumps(jdb.allocation_to_json(jalloc))))
    want = JEngine(jcfg, jparams, JServeConfig(quant_mode="dsp_mixed", **KW, **MIXED_KW),
                   mixed_allocation=jalloc).generate(PROMPTS)
    n0 = tmixed.PROBES.count
    eng = Engine(tcfg, tparams, ServeConfig(device="cpu", quant_mode="dsp_mixed", **KW,
                                            **MIXED_KW), mixed_allocation=talloc)
    assert tmixed.PROBES.count == n0  # a given allocation runs no probe
    assert eng.mixed_allocation is talloc
    assert eng.generate(PROMPTS) == want


def test_dsp_mixed_moonshot_tokens_identical_on_the_port_allocation(tmp_path):
    jcfg, tcfg, jparams, tparams = weights(MOONSHOT)
    scfg = ServeConfig(device="cpu", quant_mode="dsp_mixed", plan_db=str(tmp_path),
                       **KW, **MIXED_KW)
    n0 = tmixed.PROBES.count
    cold = Engine(tcfg, tparams, scfg)
    n_paths = len(cold.mixed_allocation.assignments)
    assert tmixed.PROBES.count - n0 == n_paths * len(WIDTHS)
    assert any("/moe/down/e" in p for p in cold.mixed_allocation.assignments)
    tokens = cold.generate(PROMPTS)
    # the reference engine, on the port's allocation carried across as JSON
    blob = json.loads(json.dumps(tdb.allocation_to_json(cold.mixed_allocation)))
    want = JEngine(jcfg, jparams, JServeConfig(quant_mode="dsp_mixed", **KW, **MIXED_KW),
                   mixed_allocation=jdb.allocation_from_json(blob)).generate(PROMPTS)
    assert tokens == want
    # a warm build from the plan database runs no probe, serves the same
    n0 = tmixed.PROBES.count
    warm = Engine(tcfg, tparams, scfg)
    assert tmixed.PROBES.count == n0
    assert warm.stats()["plan_db"]["hits"] == 1
    assert cold.stats()["plan_db"]["misses"] == 1
    assert warm.mixed_allocation == cold.mixed_allocation
    assert warm.generate(PROMPTS) == tokens


def test_mixed_knobs_plan_bits_auto_and_autotune():
    assert ServeConfig(device="cpu", quant_mode="dsp_tuned",
                       plan_bits="auto").quant_mode == "dsp_mixed"
    assert ServeConfig(device="cpu", quant_mode="dsp_mixed",
                       plan_bits="auto").quant_mode == "dsp_mixed"
    with pytest.raises(ValueError, match="plan_bits"):
        ServeConfig(device="cpu", quant_mode="int8", plan_bits="auto")
    with pytest.raises(ValueError, match="autotune_plans is not supported with dsp_mixed"):
        ServeConfig(device="cpu", quant_mode="dsp_mixed", autotune_plans=True)
    with pytest.raises(ValueError, match="autotune_plans is not supported with dsp_mixed"):
        ServeConfig(device="cpu", plan_bits="auto", quant_mode="dsp_tuned",
                    autotune_plans=True)
    with pytest.raises(ValueError, match="mixed_budget"):
        ServeConfig(device="cpu", quant_mode="dsp_mixed", mixed_budget=-0.1)
    _, tcfg, _, tparams = weights(QWEN)
    alloc = tmixed.allocate_mixed_plans(
        [tmixed.LayerSensitivity(*r) for r in _synthetic(["/lm_head/w"], WIDTHS, 1)],
        widths=WIDTHS)
    with pytest.raises(ValueError, match="mixed_allocation"):
        Engine(tcfg, tparams, ServeConfig(device="cpu", quant_mode="dsp_tuned"),
               mixed_allocation=alloc)


def test_quant_mode_none_serves_as_native():
    jcfg, tcfg, jparams, tparams = weights(QWEN)
    want = JEngine(jcfg, jparams, JServeConfig(quant_mode="none", **KW)).generate(PROMPTS)
    none = Engine(tcfg, tparams, ServeConfig(device="cpu", quant_mode="none", **KW))
    native = Engine(tcfg, tparams, ServeConfig(device="cpu", quant_mode="native", **KW))
    assert none.params is tparams and none.plan_table == {}
    assert none.generate(PROMPTS) == want == native.generate(PROMPTS)
