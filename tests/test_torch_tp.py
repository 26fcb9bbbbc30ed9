"""Port parity: tensor-parallel packed serving on ``torch.distributed``.

* ``widen_for_shards`` against the reference's on the enumerated plans of
  three width pairs at 1, 2, 4 and 8 shards: the same spec, or a
  ``ValueError`` citing the same certificate clause.
* The row word path (``tp_packed._row_words``), each rank's shard built by
  ``shard_leaf`` and the collectives replaced by hand-written sums over
  the ranks (threads of this process): bit-identical to the reference's
  ``ref_packed_matmul`` under ``widen_for_shards(spec, S)`` for S = 2, 4,
  on the shard-aware mr plan and on a non-mr plan narrowed by 2 (as
  ``tests/test_tp_packed.py`` holds the reference's own algebra).
* The other apply paths (``_tuned_col``, the exact-f32 ``_tuned_row``,
  ``_int4_col``, ``_int4_row``) through ``apply_linear`` on the same
  hand-summed ranks: bit-equal to the unsharded ``apply_linear``.
* The build's legality surface: an illegal row sharding (the one-device
  table) names the leaf and ``int32-accumulator``; ``use_kernel=True``
  and ``tp < 1`` raise; ``tp`` past the ranks started raises.
* One spawned gloo world of 2 ranks on the CPU, on the reference's seeded
  qwen1.5-110b smoke weights in f32: greedy tokens at ``tp=2`` equal
  ``tp=1`` in native, int4_packed, dsp_tuned and dsp_mixed (widths
  (4, 4)), the reference's matrix; ``ContinuousEngine``; a ``--replicas
  2`` front of tp=2 engines; a clock that runs differently on each rank
  (deadline sheds, the governor's slow-step signal) splits no step.
  ``tp=1`` equals the reference ``Engine`` on the same weights.
"""

from __future__ import annotations

import dataclasses
import fcntl
import functools
import itertools
import json
import os
import pickle
import re
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.convert import params_from_numpy
from repro_torch.core.packed_linear import LinearSpec, apply_linear
from repro_torch.core.packed_params import DspTunedLeaf, quantize_for_serving
from repro_torch.kernels import ref
from repro_torch.launch.mesh import init_serving_world, make_serving_mesh
from repro_torch.models.registry import get_config as t_get_config
from repro_torch.runtime import tp_packed
from repro_torch.runtime.tp_packed import TpLinear, shard_leaf, shard_params_tp
from repro_torch.serving import (
    ContinuousEngine,
    Engine,
    GovernorConfig,
    ReplicaFront,
    ServeConfig,
)
from repro_torch.tuning import enumerate_specs, plan_linear_layers, select_plan

KW = dict(n_slots=2, max_len=32, prefill_chunk=4, device="cpu")
PROMPTS = [[3, 5, 7], [2, 4], [9, 11, 13, 15]]
MODES = {
    "native": {},
    "int4_packed": {},
    "dsp_tuned": {},
    "dsp_mixed": dict(plan_bits="auto", width_candidates=((4, 4),), calib_tokens=8),
}


def _tcfg():
    return dataclasses.replace(t_get_config("qwen1.5-110b", smoke=True), dtype="float32")


@functools.lru_cache(maxsize=None)
def weights():
    """The reference's seeded smoke weights: (its config, its params, the
    numpy tree, the port's params)."""
    import jax

    from repro.models import transformer as JT
    from repro.models.registry import get_config as j_get_config

    jcfg = dataclasses.replace(j_get_config("qwen1.5-110b", smoke=True), dtype="float32")
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.array, jparams)
    return jcfg, jparams, tree, params_from_numpy(tree, _tcfg())


def _port_spec(j_spec):
    return ref.PackedDotSpec(**dataclasses.asdict(j_spec))


# ---- widen_for_shards ----------------------------------------------------------


def _widen_outcome(widen, spec, shards):
    try:
        return dataclasses.astuple(widen(spec, shards))
    except ValueError as e:
        return re.findall(r"certificate clause: ([\w-]+)", str(e))


@pytest.mark.parametrize("shards", [1, 2, 4, 8])
def test_widen_for_shards_matches_reference(shards):
    from repro.kernels import ref as jref
    from repro.tuning import enumerate_specs as j_enumerate_specs

    # the enumerated plans sit at the one-word ceiling (every widening of
    # them is rejected); each narrowed by the shard count widens back
    ceiling = [s for bits in ((4, 4), (2, 2), (8, 8)) for s in j_enumerate_specs(*bits)]
    ceiling += [jref.INT4_EXACT, jref.INT4_MR_OVERPACKED, jref.INT2_EXACT]
    narrowed = [dataclasses.replace(s, n_pairs=s.n_pairs // shards) for s in ceiling
                if s.n_pairs % shards == 0]
    rng = np.random.default_rng(shards)
    sample = [specs[i] for specs in (ceiling, narrowed)
              for i in rng.choice(len(specs), size=min(20, len(specs)), replace=False)]
    legal = 0
    for j_spec in sample:
        want = _widen_outcome(jref.widen_for_shards, j_spec, shards)
        got = _widen_outcome(ref.widen_for_shards, _port_spec(j_spec), shards)
        assert got == want, j_spec.name()
        legal += isinstance(want, tuple)
    assert legal  # the sample holds legal widenings, not only rejections


def test_widen_for_shards_rejections_cite_the_clause():
    assert ref.widen_for_shards(ref.INT4_EXACT, 1) is ref.INT4_EXACT
    with pytest.raises(ValueError, match="n_shards"):
        ref.widen_for_shards(ref.INT4_EXACT, 0)
    for spec in (ref.INT4_EXACT, ref.INT4_MR_OVERPACKED, ref.INT2_EXACT):
        with pytest.raises(ValueError) as e:
            ref.widen_for_shards(spec, 2)
        assert "cannot be row-sharded 2 ways" in str(e.value)
        assert "certificate clause" in str(e.value)


# ---- ranks as threads, collectives summed by hand ---------------------------------


class _World:
    """``S`` ranks as threads of this process; :meth:`exchange` hands every
    rank every rank's tensor, in rank order."""

    def __init__(self, S: int):
        self.S = S
        self._barrier = threading.Barrier(S, timeout=60)
        self._slots = [None] * S

    def exchange(self, rank: int, t: torch.Tensor) -> list:
        self._slots[rank] = t
        self._barrier.wait()
        parts = list(self._slots)
        self._barrier.wait()
        return parts


class _Rank:
    """One rank's view of a :class:`_World`, shaped like a ServingMesh."""

    def __init__(self, world: _World, rank: int):
        self.world, self.rank, self.n_shards = world, rank, world.S
        self.shape = {"data": 1, "model": world.S}


def _sum_over_ranks(t, mesh):
    parts = mesh.world.exchange(mesh.rank, t)
    out = parts[0]
    for p in parts[1:]:
        out = out + p  # int32 wraps, as the collective's sum
    return out


def _cat_over_ranks(t, mesh):
    return torch.cat(mesh.world.exchange(mesh.rank, t), dim=1)


@pytest.fixture
def hand_summed(monkeypatch):
    monkeypatch.setattr(tp_packed, "all_reduce_sum", _sum_over_ranks)
    monkeypatch.setattr(tp_packed, "all_gather_cols", _cat_over_ranks)


def _on_ranks(S: int, fn) -> list:
    world = _World(S)
    with ThreadPoolExecutor(S) as ex:
        return list(ex.map(lambda r: fn(_Rank(world, r)), range(S)))


def _word_case(spec, shards, k, seed):
    from repro.kernels import ref as jref

    rng = np.random.default_rng(seed)
    x_u = rng.integers(0, 2 ** spec.bits_a, (5, k)).astype(np.int32)
    w_s = rng.integers(-(2 ** (spec.bits_w - 1)), 2 ** (spec.bits_w - 1),
                       (k, 7)).astype(np.int32)
    j_spec = jref.PackedDotSpec(**dataclasses.asdict(spec))
    want = np.asarray(jref.ref_packed_matmul(x_u, w_s, jref.widen_for_shards(j_spec, shards)))
    leaf = DspTunedLeaf(torch.from_numpy(w_s), torch.ones(1, 7), spec)
    outs = _on_ranks(shards, lambda mesh: tp_packed._row_words(
        shard_leaf(leaf, "/groups/mlp/down/w", mesh), torch.from_numpy(x_u)))
    for r, got in enumerate(outs):
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"rank {r}")


@pytest.mark.parametrize("shards", [2, 4])
def test_word_path_equals_reference_widened_spec(shards, hand_summed):
    """Per-rank word accumulation, one summed word, one extraction ==
    the widened plan on one device, bit for bit, mr composition included
    (the shard-aware pick at 4,4 is an mr plan); K whole and ragged."""
    from repro.tuning import select_plan as j_select_plan

    spec = select_plan(4, 4, shard_groups=shards).spec
    assert spec.name() == j_select_plan(4, 4, shard_groups=shards).spec.name()
    assert spec.uses_mr
    _word_case(spec, shards, shards * spec.chunk * 2, 0)
    _word_case(spec, shards, shards * spec.chunk * 2 + 6, 1)


def test_word_path_non_mr_plan_narrowed(hand_summed):
    """An exact-spacing plan at the one-word ceiling, narrowed by 2: the
    rank-summed word equals the enumerated (widened) plan's."""
    wide = next(s for s in enumerate_specs(4, 4) if not s.uses_mr and s.n_pairs % 2 == 0)
    spec = dataclasses.replace(wide, n_pairs=wide.n_pairs // 2)
    assert ref.widen_for_shards(spec, 2) == wide
    _word_case(spec, 2, 2 * spec.chunk * 3, 1)


# ---- the apply paths against the unsharded apply_linear ---------------------------


def _tuned_leaf(spec, w, keep_w_f32):
    from repro_torch.core.quantize import quantize_signed

    q = quantize_signed(w, bits=spec.bits_w, axis=0)
    return DspTunedLeaf(q.values, q.scale, spec, keep_w_f32=keep_w_f32)


def _apply_case(name, shards):
    """(leaf, tree path, linear mode, whether the exact-f32 shard runs)."""
    rng = np.random.default_rng(shards)
    w = torch.from_numpy(rng.standard_normal((64, 48)).astype(np.float32))
    if name.startswith("int4"):
        tree = quantize_for_serving({"mlp": {"up": {"w": w}}}, "int4_packed")
        path = "/groups/mlp/up/w" if name == "int4_col" else "/groups/mlp/down/w"
        return tree["mlp"]["up"]["w"], path, "int4_packed"
    exact = select_plan(4, 4, error_budget=0.0, exact_first=True,
                        shard_groups=shards if name == "tuned_row_exact" else 1).spec
    if name == "tuned_col_exact":
        return _tuned_leaf(exact, w, True), "/groups/attn/wq/w", "dsp_tuned"
    if name == "tuned_col_words":
        return (_tuned_leaf(ref.spec_from_name("a4w4-p10-n32-mr+full-c2"), w, False),
                "/lm_head/w", "dsp_tuned")
    return _tuned_leaf(exact, w, True), "/groups/attn/wo/w", "dsp_tuned"


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("name", ["tuned_col_exact", "tuned_col_words", "tuned_row_exact",
                                  "int4_col", "int4_row"])
def test_apply_paths_equal_unsharded(name, shards, hand_summed):
    leaf, path, mode = _apply_case(name, shards)
    x = torch.from_numpy(np.random.default_rng(7).standard_normal((5, 64)).astype(np.float32))
    spec = LinearSpec(mode=mode)
    want = apply_linear({"w": leaf}, x, spec)

    def rank(mesh):
        wrapped = shard_leaf(leaf, path, mesh)
        assert isinstance(wrapped, TpLinear)
        assert wrapped.kind == ("row" if "row" in name else "col")
        if name == "tuned_row_exact":
            assert wrapped.inner.w_f32 is not None  # the f32 shard path runs
        return apply_linear({"w": wrapped}, x, spec)

    for r, got in enumerate(_on_ranks(shards, rank)):
        assert torch.equal(got, want), (name, r, (got - want).abs().max())


# ---- legality at build ------------------------------------------------------------


def test_illegal_row_sharding_names_leaf_and_clause():
    """The one-device table sits at the int32 accumulation ceiling: row
    sharding it must fail at build, naming the leaf and the clause."""
    params = weights()[3]
    table = plan_linear_layers(params, a_bits=4, w_bits=4, error_budget=0.0,
                               shard_groups=1)
    q = quantize_for_serving(params, "dsp_tuned", plans=table)
    mesh = _Rank(_World(2), 0)
    with pytest.raises(ValueError) as e:
        shard_params_tp(q, mesh)
    msg = str(e.value)
    assert re.search(r"illegal row sharding for '/groups/\w+/(wo|down)/w'", msg), msg
    assert "certificate clause" in msg and "int32-accumulator" in msg, msg
    with pytest.raises(ValueError, match="use_kernel"):
        shard_params_tp(q, mesh, use_kernel=True)


def test_tp_config_and_mesh_rejections():
    with pytest.raises(ValueError, match="tp must be >= 1"):
        ServeConfig(tp=0)
    with pytest.raises(ValueError, match="use_kernel"):
        ServeConfig(tp=2, use_kernel=True)
    with pytest.raises(ValueError, match="tp must be >= 1"):
        make_serving_mesh(0, "cpu")
    with pytest.raises(ValueError, match="exceeds the 1 rank"):
        make_serving_mesh(2, "cpu")
    with pytest.raises(ValueError, match="kind"):
        TpLinear({}, kind="diag", mesh=None, n_shards=2)
    assert make_serving_mesh(1, "cpu").n_shards == 1


# ---- a spawned gloo world of 2 ranks ----------------------------------------------


def _scfg(**kw):
    return ServeConfig(**{**KW, **kw})


def _tokens(out: dict) -> list:
    return [out[r] for r in sorted(out)]


def _rank_clocks(tcfg, params, rank: int, world: int) -> dict:
    """Deadline sheds and governor swaps under clocks that differ per rank:
    rank 0's clock advances one second a read and reports 1 s decode steps,
    rank 1's stands still and reports none.  Rank 0's decisions must
    govern both ranks."""
    eng = Engine(tcfg, params, _scfg(quant_mode="int4_packed", tp=world))
    counter = itertools.count()
    eng.scheduler._clock = (lambda: float(next(counter))) if rank == 0 else (lambda: 0.0)
    rids = [eng.submit(p, max_new=6, deadline_ms=d, admit=False)
            for p, d in zip(PROMPTS, (None, 3000.0, None))]
    while eng.active.any() or eng.scheduler.n_queued:
        eng.step()
    shed = {"tokens": [eng.outputs.get(r, []) for r in rids],
            "reasons": [eng.scheduler.requests[r].finish_reason for r in rids]}
    gov = ContinuousEngine(tcfg, params, _scfg(
        quant_mode="dsp_tuned", tp=world, page_size=8,
        governor=GovernorConfig(queue_high=100, emergency_queue_high=200,
                                slow_step_ms=5.0, hold_steps=2)))
    gov.straggler.rolling_median = (lambda: 1.0) if rank == 0 else (lambda: 0.0)
    toks = gov.generate(PROMPTS, max_new=6)
    return dict(shed=shed, governed=_tokens(toks), history=gov.governor.stats()["history"])


def _rank_world(rank: int, world: int, init_method: str, outdir: str) -> None:
    init_serving_world(rank, world, init_method, device="cpu", timeout_s=120)
    try:
        tcfg = _tcfg()
        with open(os.path.join(outdir, "weights.pkl"), "rb") as f:
            params = params_from_numpy(pickle.load(f), tcfg)
        out = {mode: _tokens(Engine(tcfg, params, _scfg(quant_mode=mode, tp=world, **kw))
                             .generate(PROMPTS, max_new=6))
               for mode, kw in MODES.items()}
        out["continuous"] = _tokens(ContinuousEngine(
            tcfg, params, _scfg(quant_mode="int4_packed", tp=world, page_size=8))
            .generate(PROMPTS, max_new=6))
        front = ReplicaFront(tcfg, params, _scfg(quant_mode="int4_packed", tp=world),
                             n_replicas=2)
        out["replicas"] = _tokens(front.generate(PROMPTS, max_new=6))
        out["routes"] = [front.replica_of(g) for g in range(len(PROMPTS))]
        out["clocks"] = _rank_clocks(tcfg, params, rank, world)
        with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """Every rank's results of one spawned gloo world of 2 ranks, run once
    a test session: xdist workers share it through their common base
    directory, under a file lock."""
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent
    outdir = base / "tp_world2"
    with open(base / "tp_world2.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not (outdir / "rank1.json").exists():
            outdir.mkdir(exist_ok=True)
            with open(outdir / "weights.pkl", "wb") as f:
                pickle.dump(weights()[2], f)
            torch.multiprocessing.start_processes(
                _rank_world, args=(2, f"file://{outdir / 'store'}", str(outdir)),
                nprocs=2, start_method="spawn")
    return [json.loads((outdir / f"rank{r}.json").read_text()) for r in range(2)]


@functools.lru_cache(maxsize=None)
def tp1_tokens(mode: str) -> list:
    return _tokens(Engine(_tcfg(), weights()[3], _scfg(quant_mode=mode, **MODES[mode]))
                   .generate(PROMPTS, max_new=6))


@pytest.mark.parametrize("mode", list(MODES))
def test_tp2_tokens_equal_tp1(world2, mode):
    for rank in world2:
        assert rank[mode] == tp1_tokens(mode), mode


@pytest.mark.parametrize("mode", list(MODES))
def test_tp1_equals_reference_engine(mode):
    from repro.serving import Engine as JEngine
    from repro.serving import ServeConfig as JServeConfig

    jcfg, jparams, _, _ = weights()
    kw = {k: v for k, v in KW.items() if k != "device"}
    want = JEngine(jcfg, jparams, JServeConfig(quant_mode=mode, **kw, **MODES[mode]))
    assert tp1_tokens(mode) == _tokens(want.generate(PROMPTS, max_new=6))


def test_tp2_continuous_and_replicas_equal_tp1(world2):
    want = tp1_tokens("int4_packed")
    solo = _tokens(ContinuousEngine(_tcfg(), weights()[3], _scfg(
        quant_mode="int4_packed", page_size=8)).generate(PROMPTS, max_new=6))
    assert solo == want
    for rank in world2:
        assert rank["continuous"] == want
        assert rank["replicas"] == want
        assert rank["routes"] == [0, 1, 0]


def test_rank_local_clocks_cannot_split_the_ranks(world2):
    """Rank 0's clock sheds the second request and its slow steps swap the
    governor to the narrow tier; rank 1, whose own clock would do neither,
    follows: tokens, finish reasons and swaps agree."""
    r0, r1 = (rank["clocks"] for rank in world2)
    assert r0 == r1
    assert r0["shed"]["reasons"][1] == "deadline"
    assert r0["shed"]["reasons"][0] == r0["shed"]["reasons"][2] == "length"
    assert r0["history"] and r0["history"][0][1:] == [0, 1]
