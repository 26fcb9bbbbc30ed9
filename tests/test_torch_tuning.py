"""Port parity: the plan search (``repro_torch.tuning``) and the plan
database against the reference's ``repro.tuning``.

* ``spec_error_stats`` (MAE, EP, WCE, grid kind) and ``config_error_stats``
  equal on samples; ``enumerate_packing_configs`` equal.
* ``rank_plans(4, 4, ·)``: the same order, and ``to_json`` of every report
  equal, at budgets 0.5 and 0, with ``exact_first`` both ways and with
  ``shard_groups=2``; ``select_plan``'s fallback and its errors.
* ``plan_linear_layers`` on the smoke qwen tree, unfused and fused
  ``"all"``: the same plan per path; ``report_to_json`` equal.
* ``autotune_block`` on the CPU: the plain version is the one candidate,
  and a measured ranking sorts by time.
* ``PlanDB``: round trip, stale schema, invalidation; a warm engine build
  runs no scoring (``tuner.SCORED``); the port's ``plan_key`` differs from
  the reference's for the same configuration.
* The engine with no table: the same plan name per path as the reference
  engine (``exact_first`` both ways) and identical greedy tokens.

Rankings are computed once per module and the scorers cache per process,
as the reference's do.
"""

from __future__ import annotations

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import packing as jp
from repro.models import transformer as JT
from repro.models.registry import get_config as j_get_config
from repro.serving import Engine as JEngine
from repro.serving import ServeConfig as JServeConfig
from repro.tuning import plandb as jdb
from repro.tuning import plans as jplans
from repro.tuning import score as jscore
from repro.tuning import tuner as jtuner
from repro_torch.checkpoint import Checkpointer
from repro_torch.convert import params_from_numpy
from repro_torch.core import packing as tp
from repro_torch.core.packed_params import fuse_projection_weights
from repro_torch.kernels import packed_matmul as tpm
from repro_torch.models.registry import get_config as t_get_config
from repro_torch.serving import Engine, ServeConfig
from repro_torch.serving import engine as tengine
from repro_torch.tuning import autotune as tauto
from repro_torch.tuning import plandb as tdb
from repro_torch.tuning import plans as tplans
from repro_torch.tuning import score as tscore
from repro_torch.tuning import tuner as ttuner

ARCH = "qwen1.5-110b"
PROMPTS = [[5, 17, 33, 2, 9], [40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50], [7, 8, 9]]
KW = dict(n_slots=2, max_len=32, prefill_chunk=4, max_new=6, quant_mode="dsp_tuned")
RANKINGS = [(b, ef, sg) for b in (0.5, 0.0) for ef in (False, True) for sg in (1, 2)]


def _port(spec):
    return tplans.spec_from_json(jplans.spec_to_json(spec))


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


@pytest.fixture(scope="module")
def weights():
    jcfg = dataclasses.replace(j_get_config(ARCH, smoke=True), dtype="float32")
    tcfg = dataclasses.replace(t_get_config(ARCH, smoke=True), dtype="float32")
    np_tree = numpy_params(jcfg)
    return jcfg, tcfg, jax.tree.map(jnp.asarray, np_tree), params_from_numpy(np_tree, tcfg)


@pytest.fixture(scope="module")
def rankings():
    """(budget, exact_first, shard_groups) -> (reference ranking, port's)."""
    return {key: (jtuner.rank_plans(4, 4, error_budget=key[0], exact_first=key[1],
                                    shard_groups=key[2]),
                  ttuner.rank_plans(4, 4, error_budget=key[0], exact_first=key[1],
                                    shard_groups=key[2]))
            for key in RANKINGS}


# ---- scoring ----------------------------------------------------------------


def _score_sample(seed: int) -> list:
    out = []
    for i, (a, w) in enumerate(((4, 4), (8, 8), (2, 2))):
        specs = jplans.enumerate_specs(a, w)
        idx = np.random.default_rng(seed + i).choice(len(specs), 4, replace=False)
        out += [specs[j] for j in sorted(idx)]
    return out


@pytest.mark.parametrize("spec", _score_sample(40), ids=lambda s: s.name())
def test_spec_error_stats_equal(spec):
    want = jscore.spec_error_stats(spec)
    got = tscore.spec_error_stats(_port(spec))
    assert (got.mae, got.ep, got.wce, got.exhaustive, got.n_extractions, got.n_samples,
            got.mae_per_extraction) == (
        want.mae, want.ep, want.wce, want.exhaustive, want.n_extractions,
        want.n_samples, want.mae_per_extraction)
    assert tscore.plan_cost_proxy(_port(spec)) == jscore.plan_cost_proxy(spec)


@pytest.mark.parametrize("scheme", ("naive", "full", "mr+full"))
@pytest.mark.parametrize("delta", (3, -2))
def test_config_error_stats_equal(delta, scheme):
    want = jscore.config_error_stats(jp.int4_packing(delta), scheme)
    got = tscore.config_error_stats(tp.int4_packing(delta), scheme)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    six = ((4, 4, 4), (5, 5), -2)  # sampled: 2**22 operand points
    want = jscore.config_error_stats(jp.intn_packing(*six), scheme, samples=2048)
    got = tscore.config_error_stats(tp.intn_packing(*six), scheme, samples=2048)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)


def test_enumerate_packing_configs_equal():
    for a, w in ((4, 4), (8, 8), (4, 8)):
        assert [dataclasses.astuple(c) for c in tplans.enumerate_packing_configs(a, w)] == [
            dataclasses.astuple(c) for c in jplans.enumerate_packing_configs(a, w)]


# ---- ranking and selection -------------------------------------------------------


@pytest.mark.parametrize("key", RANKINGS, ids=lambda k: f"budget{k[0]}-ef{k[1]}-tp{k[2]}")
def test_rank_plans_same_order_and_reports(rankings, key):
    want, got = rankings[key]
    assert want, key
    assert [r.name for r in got] == [r.name for r in want]
    for t, j in zip(got, want):
        assert t.to_json() == j.to_json()
        assert tdb.report_to_json(t) == jdb.report_to_json(j)


def test_rank_plans_heads(rankings):
    """The plans the engines serve: mr on the kernels, proven-exact off."""
    assert rankings[(0.5, False, 1)][1][0].name == "a4w4-p10-n32-mr+full-c2"
    assert rankings[(0.5, True, 1)][1][0].name == "a4w4-p11-n16-full-c2"
    assert all(r.certificate.exact for r in rankings[(0.0, False, 1)][1])


def test_select_plan_fallback_and_errors():
    got = ttuner.select_plan(4, 4, error_budget=-1.0)
    want = jtuner.select_plan(4, 4, error_budget=-1.0)
    assert got.name == want.name == "a4w4-p11-n4-full"
    assert got.to_json() == want.to_json()
    for kwargs in (dict(a_bits=2, w_bits=2, error_budget=-1.0),
                   dict(a_bits=2, w_bits=2, error_budget=-1.0, shard_groups=2)):
        with pytest.raises(ValueError) as terr:
            ttuner.select_plan(**kwargs)
        with pytest.raises(ValueError) as jerr:
            jtuner.select_plan(**kwargs)
        assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="needs a probe shape"):
        ttuner.rank_plans(4, 4, autotune=True, device="cpu")


@pytest.mark.parametrize("fuse", ["none", "all"])
@pytest.mark.parametrize("exact_first", [False, True])
def test_plan_linear_layers_match_reference(weights, fuse, exact_first):
    _, _, jparams, tparams = weights
    if fuse == "all":
        from repro.core.packed_params import fuse_projection_weights as j_fuse

        jparams = j_fuse(jparams)
        tparams = fuse_projection_weights(tparams)
    want = jtuner.plan_linear_layers(jparams, exact_first=exact_first)
    got = ttuner.plan_linear_layers(tparams, exact_first=exact_first)
    assert sorted(got) == sorted(want)
    assert {p: tdb.report_to_json(r) for p, r in got.items()} == {
        p: jdb.report_to_json(r) for p, r in want.items()}
    assert ttuner.linear_partition("/groups/attn/wo/w") == "row"
    assert ttuner.linear_partition("/groups/mlp/upgate/w") == "col"


# ---- the block sweep -------------------------------------------------------------


def test_autotune_block_on_cpu_has_one_candidate():
    spec = _port(jtuner.select_plan(4, 4).spec)
    assert tauto.candidate_blocks(spec, device="cpu") == [tpm.PREPACKED_PLAIN]
    timings = tauto.autotune_block(spec, (4, 128, 48), device="cpu")
    assert [t.block for t in timings] == [tpm.PREPACKED_PLAIN]
    assert timings[0].us_per_call > 0
    x = torch.zeros((2, 128))
    words = torch.zeros((128 // spec.chunk, spec.n_pairs, 8), dtype=torch.int32)
    wsc = torch.zeros((128 // spec.chunk, spec.n_pairs, 2, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="cannot run"):
        tpm.packed_matmul_prepacked(x.to(torch.int32), words, wsc, spec,
                                    variant="packed_matmul_prepacked")


def test_autotuned_ranking_sorts_by_time():
    calls = []

    def timer(fn, warmup, iters):  # later probes time faster
        calls.append(fn)
        return 1000.0 - len(calls)

    ranked = ttuner.rank_plans(4, 4, autotune=True, shape=(4, 64, 32),
                               decode_shape=(2, 64, 32), device="cpu", timer=timer)
    assert len(ranked) == len(ttuner.rank_plans(4, 4))
    times = [r.us_per_call for r in ranked]
    assert times == sorted(times)
    assert {r.block for r in ranked} == {tpm.PREPACKED_PLAIN}
    assert all(r.decode_block == tpm.PREPACKED_PLAIN for r in ranked[:3])
    assert all(r.decode_block is None for r in ranked[3:])
    back = tdb.report_from_json(json.loads(json.dumps(tdb.report_to_json(ranked[0]))))
    assert back == ranked[0]


# ---- the plan database -----------------------------------------------------------


def test_plandb_round_trip_stale_and_invalidate(tmp_path):
    reports = ttuner.rank_plans(4, 4)[:3]
    db = tdb.PlanDB(str(tmp_path / "db"), keep=2)
    assert db.get("k") is None and db.n_misses == 1
    db.put("k", {"kind": "tuned", "plans": {"/w": tdb.report_to_json(reports[0])}})
    db.put("k2", {"kind": "tuned", "plans": {"/w": tdb.report_to_json(reports[1])}})
    entry = tdb.PlanDB(db.directory).get("k")
    assert tdb.report_from_json(entry["plans"]["/w"]) == reports[0]
    assert db.keys() == ["k", "k2"] and len(db) == 2
    assert Checkpointer(db.directory).all_steps() == [0, 1]
    db.put("k3", {})
    assert Checkpointer(db.directory).all_steps() == [1, 2]  # keep=2
    os.makedirs(os.path.join(db.directory, "step_00000009.tmp"))  # a torn write
    assert db.keys() == ["k", "k2", "k3"]
    assert db.invalidate("k2") == 1 and db.keys() == ["k", "k3"]
    assert db.invalidate() == 2 and len(db) == 0
    Checkpointer(db.directory).save(7, {"schema": tdb.SCHEMA_VERSION - 1,
                                        "entries": {"k": {}}})
    stale = tdb.PlanDB(db.directory)
    assert stale.get("k") is None and stale.n_stale == 1
    with pytest.raises(ValueError, match="stale plan-database entry"):
        tdb.report_from_json(dict(tdb.report_to_json(reports[0]),
                                  spec={**tdb.report_to_json(reports[0])["spec"],
                                        "block_m": 8}))


def test_plan_key_is_the_ports_own(weights):
    jcfg, tcfg, jparams, tparams = weights
    jcfg_q = dataclasses.replace(jcfg, quant=dataclasses.replace(
        jcfg.quant, mode="dsp_tuned", use_kernel=False))
    tcfg_q = dataclasses.replace(tcfg, quant=dataclasses.replace(
        tcfg.quant, mode="dsp_tuned", use_kernel=False))
    scfg = ServeConfig(device="cpu", **KW)
    key = tdb.plan_key(tcfg_q, scfg, tparams)
    assert key == tdb.plan_key(tcfg_q, scfg, tparams)
    assert key != jdb.plan_key(jcfg_q, JServeConfig(**KW), jparams)
    assert key != tdb.plan_key(tcfg_q, dataclasses.replace(scfg, error_budget=0.0),
                               tparams)
    assert key != tdb.plan_key(tcfg_q, scfg, fuse_projection_weights(tparams))


def test_warm_build_from_plandb_runs_no_scoring(weights, tmp_path):
    _, tcfg, _, tparams = weights
    scfg = ServeConfig(device="cpu", plan_db=str(tmp_path / "db"), **KW)
    runs = []
    for _ in range(2):
        ttuner._SCORE_CACHE.clear()
        before = ttuner.SCORED["specs"]
        eng = Engine(tcfg, tparams, scfg)
        runs.append((ttuner.SCORED["specs"] - before, eng.stats()["plan_db"],
                     {p: r.to_json() for p, r in eng.plan_table.items()},
                     eng.generate(PROMPTS)))
    (cold, cold_db, cold_plans, cold_toks), (warm, warm_db, warm_plans, warm_toks) = runs
    assert cold > 0 and (cold_db["hits"], cold_db["misses"]) == (0, 1)
    assert warm == 0 and (warm_db["hits"], warm_db["misses"]) == (1, 0)
    assert warm_plans == cold_plans and warm_toks == cold_toks


# ---- the engine with no table ------------------------------------------------------


@pytest.mark.parametrize("fuse", ["none", "all"])
def test_engine_without_table_matches_reference_engine(weights, fuse):
    """use_kernel=False on both: exact_first, the proven-exact plan; greedy
    tokens identical."""
    jcfg, tcfg, jparams, tparams = weights
    kw = dict(KW, fuse_projections=fuse)
    jeng = JEngine(jcfg, jparams, JServeConfig(**kw))
    teng = Engine(tcfg, tparams, ServeConfig(device="cpu", **kw))
    assert {p: r.name for p, r in teng.plan_table.items()} == {
        p: r.name for p, r in jeng.plan_table.items()}
    assert {r.name for r in teng.plan_table.values()} == {"a4w4-p11-n16-full-c2"}
    assert teng.generate(PROMPTS) == jeng.generate(PROMPTS)


def test_engine_build_on_the_kernel_path_picks_reference_plans(weights):
    """use_kernel=True (exact_first off): the reference engine built with its
    Pallas kernels against the port's build path with the CUDA kernels, the
    same plan on every path (the build runs no kernel)."""
    jcfg, tcfg, jparams, tparams = weights
    jeng = JEngine(jcfg, jparams, JServeConfig(use_kernel=True, **KW))
    _, _, table, _, db = tengine._prepare_serving_params(
        tcfg, tparams, ServeConfig(device="cpu", use_kernel=True, **KW),
        use_kernel=True, device=torch.device("cpu"), plan_table=None)
    assert db is None
    assert {p: r.name for p, r in table.items()} == {
        p: r.name for p, r in jeng.plan_table.items()}
    assert {r.name for r in table.values()} == {"a4w4-p10-n32-mr+full-c2"}


def test_plan_table_override_wraps_specs(weights):
    _, tcfg, _, tparams = weights
    spec = _port(jtuner.rank_plans(4, 4)[0].spec)
    paths = sorted(ttuner.plan_linear_layers(tparams))
    table = {p: spec for p in paths[:1]}
    eng = Engine(tcfg, tparams, ServeConfig(device="cpu", **KW), plan_table=table)
    assert eng.plan_table[paths[0]].name == spec.name()
    assert eng.plan_table[paths[0]].to_json() == ttuner.plan_report(spec).to_json()
    assert {eng.plan_table[p].name for p in paths[1:]} == {"a4w4-p11-n4-full"}
    assert "plan_db" not in eng.stats()


def test_unported_mixed_knobs_name_the_next_slice():
    # the dsp_mixed knobs are ported now: each is accepted as the
    # reference accepts it, and plan_bits="auto" promotes dsp_tuned
    for kwargs in (dict(quant_mode="dsp_tuned", plan_bits="auto"),
                   dict(quant_mode="dsp_mixed"), dict(mixed_budget=0.1),
                   dict(calib_tokens=8), dict(width_candidates=((4, 4),))):
        scfg = ServeConfig(device="cpu", **kwargs)
        for name, value in kwargs.items():
            if name != "quant_mode":
                assert getattr(scfg, name) == value
    assert ServeConfig(device="cpu", quant_mode="dsp_tuned",
                       plan_bits="auto").quant_mode == "dsp_mixed"
    with pytest.raises(ValueError, match="plan_bits"):
        ServeConfig(device="cpu", plan_bits="4,4")
    with pytest.raises(ValueError, match="plan_bits"):  # native has no widths
        ServeConfig(device="cpu", plan_bits="auto")
