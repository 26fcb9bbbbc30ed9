"""Port parity: the precision governor, its tiers and plan-database
records, and ``ReplicaFront``.

* The hysteresis controller: the port's ``Governor`` and the reference's
  fed the same observation sequences return the same tier at every step
  and record the same swaps; ``GovernorConfig`` rejects what the
  reference's rejects, with its messages.
* ``build_tiers`` through the engines (qwen1.5-110b smoke, f32,
  ``dsp_tuned``, the emergency tier on): tier names, each path's plan,
  the certified MAE per tier equal the reference engine's; the governed
  engines' greedy tokens equal.
* Swaps: a same-width swap mid-stream changes no token; a request
  admitted after a swap emits what an engine built on the target tier
  emits (both engines); the queue depth swaps to the narrow tier and back.
* The plan database's ``"tiers"`` record: merged beside the ``"tuned"``
  record on a cold build, and a warm build runs no tier search
  (``TIER_SEARCHES``) and serves the same tables.
* ``ReplicaFront``: join-shortest-queue routes (``replica_of``) and tokens
  equal the reference front's for the same submissions and steps.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import numpy as np
import pytest

from repro.models import transformer as JT
from repro.models.registry import get_config as j_get_config
from repro.serving import ContinuousEngine as JContinuous
from repro.serving import Governor as JGovernor
from repro.serving import GovernorConfig as JGovernorConfig
from repro.serving import ReplicaFront as JReplicaFront
from repro.serving import ServeConfig as JServeConfig
from repro_torch.convert import params_from_numpy
from repro_torch.models.registry import get_config as t_get_config
from repro_torch.serving import (
    ContinuousEngine,
    Engine,
    Governor,
    GovernorConfig,
    ReplicaFront,
    ServeConfig,
)
from repro_torch.serving.governor import TIER_SEARCHES
from repro_torch.tuning import PlanDB

KW = dict(n_slots=2, max_len=32, prefill_chunk=4, max_new=6, page_size=8)
PROMPTS = [[5, 17, 33, 2, 9], list(range(40, 51)), [7, 8, 9]]


@functools.lru_cache(maxsize=None)
def weights():
    jcfg = dataclasses.replace(j_get_config("qwen1.5-110b", smoke=True), dtype="float32")
    tcfg = dataclasses.replace(t_get_config("qwen1.5-110b", smoke=True), dtype="float32")
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jparams, params_from_numpy(jax.tree.map(np.array, jparams), tcfg)


def _port(engine_cls=ContinuousEngine, **kw):
    _, tcfg, _, tparams = weights()
    return engine_cls(tcfg, tparams, ServeConfig(device="cpu", **{**KW, **kw}))


# ---- the controller ----------------------------------------------------------

# (config, tiers, observations: queue depths or (depth, slow_step_ms))
SEQUENCES = {
    "hold_steps": (dict(queue_high=4, hold_steps=3), 2, [10] * 4),
    "noise_below_hold": (dict(queue_high=4, hold_steps=3), 2, [10, 10, 0] * 10),
    "hysteresis_band": (dict(queue_high=8, queue_low=2, hold_steps=2), 2,
                        [9, 9] + [5] * 20 + [1, 1]),
    "one_rung_at_a_time": (dict(queue_high=4, emergency_queue_high=10, hold_steps=2), 3,
                           [20, 20, 0, 0, 0, 0]),
    "slow_step": (dict(queue_high=100, emergency_queue_high=200, slow_step_ms=5.0,
                       hold_steps=2), 2, [(0, 50.0), (0, 50.0), (0, 0.0), (0, 0.0)]),
    "min_dwell": (dict(queue_high=4, hold_steps=3), 2, [10, 10, 10, 0, 0, 0]),
    "ramp": (dict(queue_high=3, queue_low=1, emergency_queue_high=6, hold_steps=2), 3,
             [0, 3, 4, 7, 7, 7, 2, 2, 0, 0, 0, 0, 5, 5, 1]),
}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_controller_swaps_equal_reference(name):
    kw, n_tiers, seq = SEQUENCES[name]
    port, ref = Governor(GovernorConfig(**kw), n_tiers), JGovernor(JGovernorConfig(**kw), n_tiers)
    for obs in seq:
        depth, slow = obs if isinstance(obs, tuple) else (obs, None)
        assert port.observe(depth, slow_step_ms=slow) == ref.observe(depth, slow_step_ms=slow)
    assert port.stats() == ref.stats()
    assert port.n_swaps == ref.n_swaps


@pytest.mark.parametrize("kw", [dict(queue_high=2, queue_low=2),
                                dict(queue_high=8, emergency_queue_high=8),
                                dict(hold_steps=0), dict(window=0)],
                         ids=["band", "emergency", "hold", "window"])
def test_config_validation_equals_reference(kw):
    with pytest.raises(ValueError) as want:
        JGovernorConfig(**kw)
    with pytest.raises(ValueError) as got:
        GovernorConfig(**kw)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="2 tiers"):
        Governor(GovernorConfig(), n_tiers=1)
    with pytest.raises(ValueError, match="governor needs quant_mode"):
        ServeConfig(device="cpu", governor=True, quant_mode="native")


# ---- the tiers ----------------------------------------------------------------

LADDER = dict(quant_mode="dsp_tuned", governor=GovernorConfig(emergency_tier=True))


def _ladder(engine) -> list:
    return [(t.name, {p: r.name for p, r in t.plan_table.items()}, t.max_certified_mae,
             t.summary()) for t in engine.tiers]


def test_tiers_and_tokens_equal_reference_engine():
    jcfg, tcfg, jparams, tparams = weights()
    ref = JContinuous(jcfg, jparams, JServeConfig(
        **KW, quant_mode="dsp_tuned", governor=JGovernorConfig(emergency_tier=True)))
    port = ContinuousEngine(tcfg, tparams, ServeConfig(device="cpu", **KW, **LADDER))
    assert [t[0] for t in _ladder(port)] == ["primary", "narrow", "emergency"]
    assert _ladder(port) == _ladder(ref)
    emergency = port.tiers[2]
    assert 0.0 < emergency.max_certified_mae <= 0.5
    assert port.tiers[0].max_certified_mae == port.tiers[1].max_certified_mae == 0.0
    assert port.generate(PROMPTS) == ref.generate(PROMPTS)
    assert port.stats()["governor"]["tier_name"] == "primary"


def test_set_tier_validation():
    with pytest.raises(RuntimeError, match="governor"):
        _port(quant_mode="dsp_tuned").set_tier(1)
    gov = _port(Engine, quant_mode="dsp_tuned", governor=True)
    with pytest.raises(ValueError, match="out of range"):
        gov.set_tier(5)
    gov.set_tier(0)
    assert gov.active_tier == 0


@pytest.mark.parametrize("engine_cls", [Engine, ContinuousEngine], ids=["slot", "cont"])
def test_same_width_swap_is_bit_identical_mid_stream(engine_cls):
    """Both tiers hold exact a4w4 plans, so a swap after three steps
    changes no token of the stream."""
    prompt = [5, 6, 7, 8]
    want = _port(engine_cls, quant_mode="dsp_tuned").generate([prompt], max_new=8)[0]
    eng = _port(engine_cls, quant_mode="dsp_tuned",
                governor=GovernorConfig(hold_steps=10_000))
    rid = eng.submit(prompt, max_new=8)
    for _ in range(3):
        eng.step()
    assert eng.outputs[rid] == want[:len(eng.outputs[rid])]
    eng.governor.active = 1  # pinned: hold_steps keeps the controller quiet
    eng.set_tier(1)
    while eng.active.any() or eng.scheduler.n_queued:
        eng.step()
    assert eng.outputs[rid] == want and eng.stats()["governor"]["tier_name"] == "narrow"


@pytest.mark.parametrize("engine_cls", [Engine, ContinuousEngine], ids=["slot", "cont"])
def test_post_swap_admission_matches_target_tier_engine(engine_cls):
    """Primary a8w8, narrow a4w4: a request admitted after the swap runs on
    the narrow tier alone and emits what an engine built on exact a4w4
    plans emits."""
    prompt = [9, 10, 11]
    want = _port(engine_cls, quant_mode="dsp_tuned", plan_bits=(4, 4),
                 error_budget=0.0).generate([prompt], max_new=8)[0]
    eng = _port(engine_cls, quant_mode="dsp_tuned", plan_bits=(8, 8),
                governor=GovernorConfig(hold_steps=10_000, narrow_bits=(4, 4)))
    eng.governor.active = 1
    eng.set_tier(1)
    assert eng.generate([prompt], max_new=8)[0] == want


def test_queue_depth_swaps_to_narrow_and_back():
    """queue_high 3, hold 2: a burst of eight requests on two lanes backs
    the queue up and the engine swaps to the narrow tier; once the queue
    drains it swaps back.  Every request completes."""
    eng = _port(quant_mode="dsp_tuned", governor=GovernorConfig(
        queue_high=3, queue_low=1, emergency_queue_high=20, hold_steps=2))
    rids = [eng.submit([5 + i, 6, 7], max_new=4, admit=False) for i in range(8)]
    tiers = []
    while eng.active.any() or eng.scheduler.n_queued:
        eng.step()
        tiers.append(eng.active_tier)
    for _ in range(3):  # idle steps: the calm observations recover the tier
        eng.step()
        tiers.append(eng.active_tier)
    g = eng.stats()["governor"]
    assert 1 in tiers and tiers[-1] == 0
    assert g["swaps"] == 2 and [h[1:] for h in g["history"]] == [(0, 1), (1, 0)]
    assert all(len(eng.outputs[r]) == 4 for r in rids)


def test_plan_db_tiers_record_and_warm_build(tmp_path):
    db = str(tmp_path / "plandb")
    TIER_SEARCHES.reset()
    cold = _port(Engine, plan_db=db, **LADDER)
    assert TIER_SEARCHES.count == 2  # narrow and emergency
    entry = PlanDB(db).get(cold.plan_db_stats["key"])
    assert entry["kind"] == "tuned" and set(entry["plans"]) == set(cold.plan_table)
    assert set(entry["tiers"]["tables"]) == {"narrow", "emergency"}
    assert entry["tiers"]["fingerprint"]["emergency_tier"] is True
    TIER_SEARCHES.reset()
    warm = _port(Engine, plan_db=db, **LADDER)
    assert TIER_SEARCHES.count == 0
    assert warm.stats()["plan_db"]["hits"] == 1
    assert _ladder(warm) == _ladder(cold)
    assert warm.generate(PROMPTS) == cold.generate(PROMPTS)


# ---- replicas -----------------------------------------------------------------


def _drive(front) -> tuple[list[int], dict]:
    """Seven submissions of several lengths with steps between some of
    them, so that queues differ when each request is routed."""
    rng = np.random.default_rng(0)
    grids = []
    for i in range(7):
        grids.append(front.submit([int(t) for t in rng.integers(2, 200, 3 + 2 * i)],
                                  max_new=3 + i % 3))
        if i % 3 == 2:
            front.step()
    while any(r.active.any() or r.scheduler.n_queued for r in front.replicas):
        front.step()
    return [front.replica_of(g) for g in grids], front.outputs


def test_replica_routes_and_tokens_equal_reference():
    jcfg, tcfg, jparams, tparams = weights()
    kw = dict(n_slots=2, max_len=32, prefill_chunk=4)
    want_routes, want = _drive(JReplicaFront(jcfg, jparams, JServeConfig(**kw), n_replicas=2))
    port = ReplicaFront(tcfg, tparams, ServeConfig(device="cpu", **kw), n_replicas=2)
    got_routes, got = _drive(port)
    assert got_routes == want_routes and set(got_routes) == {0, 1}
    assert got == want
    st = port.stats()
    assert st["n_replicas"] == 2 and st["finished"] == 7
    with pytest.raises(ValueError, match="n_replicas"):
        ReplicaFront(tcfg, tparams, ServeConfig(device="cpu", **kw), n_replicas=0)
