"""Port parity: sharded training on ``torch.distributed`` (one spawned gloo
world of 4 CPU ranks).

The world runs once a test session on the reference's seeded qwen1.5-110b
smoke weights in f32 (carried across by ``params_from_numpy``); xdist
workers share its results through a file lock, as ``tests/test_torch_tp.py``
shares its world.  Each rank also runs the mesh-free port on the same
inputs, so every comparison below is one process's.

* Train steps at mesh ``(2, 2)`` ("data", "model"; FSDP over "data", the
  reference's placement of every leaf), with and without
  ``compress_grads``: 3 steps equal the mesh-free step's, losses within
  rtol 1e-5 and grad norms within rtol 1e-4 each step; step 1's gathered
  gradients within atol 1e-6; the parameters after 3 steps within atol
  1e-5 at lr 1e-6 (Adam's first steps move a weight by about lr whatever
  its gradient's size, so at a larger lr a rounding-level sign flip of a
  near-zero gradient opens a gap of 2 lr).  Each rank holds only its shard
  of a sharded leaf.
* The GPipe pipeline at ``(2, 2, 1)`` ("pod", "data", "model"), 3
  microbatches of 2 x 16: bit-equal to the port's sequential ``forward``
  per microbatch, and within the reference's 2e-3 of the reference's
  ``T.forward`` on the same tokens.
* Re-sharded restore: a checkpoint written mesh-free, restored with
  ``shardings=`` onto the (2, 2) mesh, is bit-equal to each rank's slices;
  one written from the mesh restores mesh-free bit-equal.
* Prefill and serve steps under the mesh (the serving placement: fsdp
  stripped) equal the mesh-free ones: the same greedy tokens, logits and
  cache within atol 1e-5 (the mesh runs each rank's batch shard: other
  matmul shapes).
* The train CLI under ``--mesh local`` on the 4 ranks, 3 steps then a
  relaunch that resumes to 5 (async checkpoints at steps 2 and 4, each
  gathered and written by rank 0): its step-5 parameters within atol 1e-5 of
  the mesh-free CLI's at lr 1e-6, its moments within 2% of each leaf's
  absmax (the CLI's smoke config computes in bf16).
* MoE under the (2, 2) mesh: moonshot-v1-16b-a3b's smoke config in f32 (the
  reference's seeded weights), its capacity factor cut to 0.5 so that the
  mesh-free step drops assignments: one train step's loss and ``aux``
  within rtol 1e-5 of the mesh-free step's, its grad norm within rtol
  1e-4, the router's gathered gradient within atol 1e-6, and every MoE
  layer keeps the same set of (token, choice) assignments of the global
  batch (capacity and load-balance statistics are the global batch's, as
  the reference's ``jit`` computes them).
* The dry run's accounting: rank 0 counts the result bytes of its mesh's
  collectives over one dense (2, 2) train step, and those equal
  ``launch.dryrun.DryRunMesh((2, 2))``'s for the same step on meta tensors,
  key for key; the rank's state shards and batch equal the dry run's
  ``argument_size_in_bytes``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import fcntl
import functools
import io
import os
import pickle

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.checkpoint import Checkpointer
from repro_torch.convert import params_from_numpy
from repro_torch.data import DataConfig, SyntheticStream
from repro_torch.launch import train as train_cli
from repro_torch.launch.mesh import init_serving_world, make_local_mesh, make_mesh
from repro_torch.launch.steps import (
    loss_and_grads,
    make_prefill_step,
    make_serve_step,
    make_train_step,
)
from repro_torch.launch.dryrun import COLLECTIVES, DryRunMesh, lower_cell, measure
from repro_torch.launch.shapes import ShapeSpec
from repro_torch.launch.train import state_shardings
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.models.registry import get_config as t_get_config
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.runtime.compression import init_error_feedback
from repro_torch.runtime.pipeline import pipeline_forward, split_stages
from repro_torch.runtime.sharding import param_shardings
from repro_torch.tree import keyed_leaves, tree_leaves, tree_map

WORLD = 4
LR = 1e-6
STEPS = 3
CLI_ARGS = ["--arch", "qwen1.5-110b", "--smoke", "--global-batch", "4", "--seq-len", "16",
            "--device", "cpu", "--log-every", "1", "--lr", str(LR), "--ckpt-every", "2"]


def _tcfg():
    return dataclasses.replace(t_get_config("qwen1.5-110b", smoke=True), dtype="float32")


MOE_ARCH = "moonshot-v1-16b-a3b"
MOE_CAPACITY = 0.5  # low enough that the mesh-free step drops assignments


def _moe_cfg():
    return dataclasses.replace(t_get_config(MOE_ARCH, smoke=True), dtype="float32",
                               capacity_factor=MOE_CAPACITY)


@functools.lru_cache(maxsize=None)
def weights(arch: str = "qwen1.5-110b"):
    """The reference's seeded smoke weights of ``arch``: (its config, its
    params, the numpy tree)."""
    import jax

    from repro.models import transformer as JT
    from repro.models.registry import get_config as j_get_config

    jcfg = dataclasses.replace(j_get_config(arch, smoke=True), dtype="float32")
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, jparams, jax.tree.map(np.array, jparams)


def _batches(cfg, n: int) -> list[dict]:
    data = SyntheticStream(DataConfig(cfg.vocab_size, 17, 4, seed=1))
    return [{k: torch.from_numpy(v) for k, v in data.batch_at(i).items()} for i in range(n)]


def _pipeline_tokens(cfg) -> torch.Tensor:
    rng = np.random.default_rng(3)
    return torch.from_numpy(rng.integers(0, cfg.vocab_size, (3, 2, 16)))


def _numpy(tree) -> dict:
    return {"/".join(map(str, path)): leaf.detach().numpy().copy()
            for path, _, _, _, leaf in keyed_leaves(tree)}


def _gather(tree, shardings):
    return tree_map(lambda t, sh: sh.gather(t.detach()), tree, shardings)


# ---- one rank of the spawned world ----------------------------------------------


def _train(cfg, fresh, mesh, p_shard, compress: bool, batches) -> dict:
    """STEPS train steps (mesh-free where ``mesh`` is None); the records,
    step 1's gradients and the final parameters, whole."""
    params = fresh() if mesh is None else tree_map(lambda t, sh: sh.place(t), fresh(),
                                                   p_shard)
    _, _, grads = loss_and_grads(params, cfg, batches[0], mesh, p_shard)
    state = {"params": params, "opt": adamw_init(params)}
    if compress:
        state["error_buf"] = init_error_feedback(params)
    step = make_train_step(cfg, AdamWConfig(lr=LR), mesh, compress_grads=compress,
                           grad_shardings=p_shard)
    records = []
    for b in batches:
        state, m = step(state, b)
        records.append((float(m["loss"]), float(m["grad_norm"])))
    out = {"records": records}
    if mesh is not None:
        whole = tree_leaves(fresh())
        out["local_shapes"] = [(tuple(t.shape), sh.shard_shape(tuple(w.shape)), tuple(w.shape))
                               for t, sh, w in zip(tree_leaves(state["params"]),
                                                   tree_leaves(p_shard), whole)]
        grads, state["params"] = _gather(grads, p_shard), _gather(state["params"], p_shard)
    out["grads"], out["params"] = _numpy(grads), _numpy(state["params"])
    return out, state


def _moe_step(cfg, fresh, mesh, p_shard, batch) -> dict:
    """One MoE train step (mesh-free where ``mesh`` is None): its loss,
    aux and grad norm, the router's gradient whole, and each MoE layer's
    kept assignments as global (token·k + choice) indices."""
    kept, real = [], M._dispatch

    def spy(flat_e, e, cap, m):
        order, starts, n_kept = real(flat_e, e, cap, m)
        off = 0 if m is None else m.coord["data"] * flat_e.numel()
        kept.append(sorted(off + int(j) for i in range(e)
                           for j in order[starts[i]:starts[i] + n_kept[i]]))
        return order, starts, n_kept

    params = fresh() if mesh is None else tree_map(lambda t, sh: sh.place(t), fresh(), p_shard)
    _, _, grads = loss_and_grads(params, cfg, batch, mesh, p_shard)
    router = grads["groups"][0]["moe"]["router"]["w"]
    if mesh is not None:
        router = p_shard["groups"][0]["moe"]["router"]["w"].gather(router)
    M._dispatch = spy
    try:
        state = {"params": params, "opt": adamw_init(params)}
        step = make_train_step(cfg, AdamWConfig(lr=LR), mesh, grad_shardings=p_shard)
        _, m = step(state, batch)
    finally:
        M._dispatch = real
    return {"loss": float(m["loss"]), "aux": float(m["aux"]),
            "grad_norm": float(m["grad_norm"]), "router_grad": router.detach().numpy(),
            "kept": kept[:cfg.n_groups], "assignments": batch["tokens"].numel()
            * cfg.experts_per_token}


def _count_collectives(mesh, fn) -> dict:
    """``fn()`` with the result bytes of ``mesh``'s collectives counted
    under the reference's keys (only calls over more than one rank)."""
    counts = dict.fromkeys(COLLECTIVES, 0)

    def counted(name, kind_of):
        orig = getattr(mesh, name)

        def call(t, *args, **kw):
            out = orig(t, *args, **kw)
            axes = args[0] if args else kw.get("axes")
            if mesh.group(axes) is not None:
                counts[kind_of] += out.numel() * out.element_size()
            return out
        return call

    mesh.all_gather = counted("all_gather", "all-gather")
    mesh.all_reduce = counted("all_reduce", "all-reduce")
    try:
        fn()
    finally:
        del mesh.all_gather, mesh.all_reduce
    counts["total"] = sum(counts.values())
    return counts


def _rank_world(rank: int, world: int, init_method: str, outdir: str) -> None:
    torch.set_num_threads(1)
    init_serving_world(rank, world, init_method, device="cpu", timeout_s=120)
    try:
        cfg = _tcfg()
        with open(os.path.join(outdir, "weights.pkl"), "rb") as f:
            tree = pickle.load(f)

        def fresh():
            return params_from_numpy(tree, cfg)

        out: dict = {"rank": rank}
        mesh = make_local_mesh(data=2, model=2)
        p_shard = param_shardings(fresh(), mesh)
        batches = _batches(cfg, STEPS)

        # one dense (2, 2) step with rank 0's collectives counted, and the
        # bytes of the rank's state shards and batch
        params = tree_map(lambda t, sh: sh.place(t), fresh(), p_shard)
        state = {"params": params, "opt": adamw_init(params)}
        step = make_train_step(cfg, AdamWConfig(lr=LR), mesh, grad_shardings=p_shard)
        held = sum(t.numel() * t.element_size()
                   for t in tree_leaves(state) + list(batches[0].values()))
        if rank == 0:
            out["dryrun"] = {"collectives": _count_collectives(
                mesh, lambda: step(state, batches[0])), "argument_bytes": held}
        else:
            step(state, batches[0])

        # MoE at (2, 2) against the mesh-free step
        mcfg = _moe_cfg()
        with open(os.path.join(outdir, "moe_weights.pkl"), "rb") as f:
            mtree = pickle.load(f)

        def mfresh():
            return params_from_numpy(mtree, mcfg)

        mbatch = _batches(mcfg, 1)[0]
        out["moe"] = {"free": _moe_step(mcfg, mfresh, None, None, mbatch),
                      "mesh": _moe_step(mcfg, mfresh, mesh, param_shardings(mfresh(), mesh),
                                        mbatch)}
        free_state = None
        for compress in (False, True):
            free, state = _train(cfg, fresh, None, None, compress, batches)
            free_state = free_state or state
            out[f"train compress={compress}"] = {
                "free": free, "mesh": _train(cfg, fresh, mesh, p_shard, compress, batches)[0]}

        # the pipeline: 2 stages over "pod"
        mesh3 = make_mesh((2, 2, 1), ("pod", "data", "model"))
        toks = _pipeline_tokens(cfg)
        with torch.no_grad():
            got = pipeline_forward(split_stages(fresh(), 2), cfg, toks, mesh3)
            params = fresh()
            seq = torch.stack([T.forward(params, cfg, toks[i])[0] for i in range(len(toks))])
        out["pipeline"] = {"bit_equal": bool(torch.equal(got, seq)),
                           "max_diff": float((got - seq).abs().max()), "logits": got.numpy()}

        # re-sharded restore: mesh-free -> (2, 2), and back
        s_shard = state_shardings(p_shard)
        free_dir, mesh_dir = os.path.join(outdir, "ck_free"), os.path.join(outdir, "ck_mesh")
        if rank == 0:
            Checkpointer(free_dir).save(STEPS, free_state, extra={"train_step": STEPS})
        mesh.barrier()
        like = {"params": tree_map(lambda t, sh: sh.place(t), fresh(), p_shard)}
        like["opt"] = adamw_init(like["params"])
        restored, extra = Checkpointer(free_dir).restore(STEPS, like, shardings=s_shard)
        want = tree_map(lambda t, sh: t if sh is None else sh.place(t), free_state, s_shard)
        out["restore"] = {
            "extra": extra,
            "bit_equal": all(torch.equal(a, b) for a, b in
                             zip(tree_leaves(restored), tree_leaves(want))),
            "shard_shapes": all(tuple(a.shape) == tuple(b.shape) for a, b in
                                zip(tree_leaves(restored), tree_leaves(want)))}
        Checkpointer(mesh_dir).save(STEPS, restored, shardings=s_shard)
        mesh.barrier()
        back, _ = Checkpointer(mesh_dir).restore(STEPS, free_state)
        out["restore"]["back_bit_equal"] = all(
            torch.equal(a, b) for a, b in zip(tree_leaves(back), tree_leaves(free_state)))

        # prefill and serve under the serving placement
        serve_shard = param_shardings(fresh(), mesh, serving=True)
        placed = tree_map(lambda t, sh: sh.place(t), fresh(), serve_shard)
        toks = _batches(cfg, 1)[0]["tokens"]
        with torch.no_grad():
            pf = [make_prefill_step(cfg)(fresh(), {"tokens": toks}),
                  make_prefill_step(cfg, mesh, serve_shard)(placed, {"tokens": toks})]
            pos = torch.full((4, 1), 16, dtype=torch.long)
            nxt = pf[0].argmax(-1)[:, None]
            served = []
            for m, ps, p in ((None, None, fresh()), (mesh, serve_shard, placed)):
                cache = T.init_cache(cfg, 4, 32, device="cpu")
                _, cache, _ = T.forward(fresh(), cfg, toks, cache=cache)
                served.append(make_serve_step(cfg, m, ps)(
                    p, cache, {"tokens": nxt, "positions": pos}))
        out["prefill"] = [x.numpy() for x in pf]
        out["serve"] = [(t.tolist(), _numpy(c)) for t, c in served]

        # the CLI under --mesh local on the 4 ranks, then a relaunch
        cli_dir = os.path.join(outdir, "cli")
        lines = io.StringIO()
        with contextlib.redirect_stdout(lines):
            train_cli.main(CLI_ARGS + ["--steps", "3", "--ckpt-dir", cli_dir])
            train_cli.main(CLI_ARGS + ["--steps", "5", "--ckpt-dir", cli_dir])
        out["cli"] = lines.getvalue().splitlines()
        with open(os.path.join(outdir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    """Every rank's results of one spawned gloo world of 4 ranks, run once a
    test session: xdist workers share it through their common base
    directory, under a file lock."""
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent
    outdir = base / "mesh_world4"
    with open(base / "mesh_world4.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not (outdir / f"rank{WORLD - 1}.pkl").exists():
            outdir.mkdir(exist_ok=True)
            with open(outdir / "weights.pkl", "wb") as f:
                pickle.dump(weights()[2], f)
            with open(outdir / "moe_weights.pkl", "wb") as f:
                pickle.dump(weights(MOE_ARCH)[2], f)
            torch.multiprocessing.start_processes(
                _rank_world, args=(WORLD, f"file://{outdir / 'store'}", str(outdir)),
                nprocs=WORLD, start_method="spawn")
    ranks = []
    for r in range(WORLD):
        with open(outdir / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return ranks, outdir


# ---- the tests ----------------------------------------------------------------------


@pytest.mark.parametrize("compress", [False, True])
def test_sharded_train_steps_equal_mesh_free(world4, compress):
    for rank in world4[0]:
        run = rank[f"train compress={compress}"]
        free, mesh = run["free"], run["mesh"]
        for i, ((fl, fg), (ml, mg)) in enumerate(zip(free["records"], mesh["records"])):
            np.testing.assert_allclose(ml, fl, rtol=1e-5, err_msg=f"loss, step {i}")
            np.testing.assert_allclose(mg, fg, rtol=1e-4, err_msg=f"grad norm, step {i}")
        for k, want in free["grads"].items():
            np.testing.assert_allclose(mesh["grads"][k], want, rtol=0, atol=1e-6, err_msg=k)
        for k, want in free["params"].items():
            np.testing.assert_allclose(mesh["params"][k], want, rtol=0, atol=1e-5, err_msg=k)


def test_each_rank_holds_only_its_shard(world4):
    smaller = 0
    for rank in world4[0]:
        for local, shard, whole in rank["train compress=False"]["mesh"]["local_shapes"]:
            assert local == shard
            smaller += local != whole
    # the (2, 2) mesh shards every matrix: qkv/up over (data, model), the
    # embedding over (model, data)
    assert smaller >= 4 * 9


def test_pipeline_bit_equal_to_sequential_and_near_reference(world4):
    import jax.numpy as jnp

    from repro.models import transformer as JT

    jcfg, jparams, _ = weights()
    toks = _pipeline_tokens(_tcfg()).numpy()
    want = np.stack([np.asarray(JT.forward(jparams, jcfg, jnp.asarray(t))[0]) for t in toks])
    for rank in world4[0]:
        pipe = rank["pipeline"]
        assert pipe["bit_equal"], pipe["max_diff"]
        assert float(np.abs(pipe["logits"] - want).max()) < 2e-3


def test_resharded_restore_is_bit_equal(world4):
    for rank in world4[0]:
        r = rank["restore"]
        assert r["extra"] == {"train_step": STEPS}
        assert r["bit_equal"] and r["shard_shapes"] and r["back_bit_equal"]


def test_prefill_and_serve_steps_under_the_mesh(world4):
    for rank in world4[0]:
        free, mesh = rank["prefill"]
        assert mesh.shape == free.shape == (4, _tcfg().vocab_size)
        np.testing.assert_allclose(mesh, free, rtol=0, atol=1e-5)
        (ft, fc), (mt, mc) = rank["serve"]
        assert mt == ft
        for k, want in fc.items():
            np.testing.assert_allclose(mc[k], want, rtol=0, atol=1e-5, err_msg=k)


def test_train_cli_mesh_local_resumes_and_matches_mesh_free(world4, tmp_path):
    ranks, outdir = world4
    out = ranks[0]["cli"]
    assert out[0].startswith("[train] mesh {'data': 4, 'model': 1} over 4 ranks, backend gloo")
    assert "[train] resumed from step 3" in out and out[-1] == "[train] done"
    assert all(not r["cli"] for r in ranks[1:])  # only rank 0 prints
    assert Checkpointer(str(outdir / "cli")).all_steps() == [3, 4, 5]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            for steps in ("3", "5"):
                train_cli.main(CLI_ARGS + ["--steps", steps, "--ckpt-dir", str(tmp_path)])
    finally:
        torch.set_num_threads(threads)
    with np.load(tmp_path / "step_00000005" / "arrays.npz") as want, \
            np.load(outdir / "cli" / "step_00000005" / "arrays.npz") as got:
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            # the CLI's smoke config computes in bf16: the moments carry bf16
            # gradients (reduced over the ranks in f32, against the whole
            # batch's in bf16), held within 2% of each leaf's absmax; the
            # parameters move by about lr a step either way
            atol = 2e-2 * float(np.abs(want[k]).max()) if k.startswith("opt/") else 1e-5
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=atol, err_msg=k)


def test_moe_under_the_mesh_equals_mesh_free(world4):
    ranks = world4[0]
    free = ranks[0]["moe"]["free"]
    # the mesh-free step drops assignments at this capacity factor
    assert any(len(layer) < free["assignments"] for layer in free["kept"])
    for rank in ranks:
        got = rank["moe"]["mesh"]
        np.testing.assert_allclose(got["loss"], free["loss"], rtol=1e-5)
        np.testing.assert_allclose(got["aux"], free["aux"], rtol=1e-5)
        np.testing.assert_allclose(got["grad_norm"], free["grad_norm"], rtol=1e-4)
        np.testing.assert_allclose(got["router_grad"], free["router_grad"], rtol=0, atol=1e-6)
    # the kept assignments of the global batch: the union of the data ranks'
    # (ranks 0 and 2 are model coordinate 0 of data 0 and 1)
    for layer, want in enumerate(free["kept"]):
        union = sorted(ranks[0]["moe"]["mesh"]["kept"][layer]
                       + ranks[2]["moe"]["mesh"]["kept"][layer])
        assert union == want, layer


def test_dryrun_mesh_counts_what_rank_0_moved_and_held(world4):
    got = world4[0][0]["dryrun"]
    mesh = DryRunMesh((2, 2), ("data", "model"))
    lowered, _, _ = lower_cell("qwen1.5-110b", "train_4k", False, smoke=True,
                               shape=ShapeSpec("train_16", 16, 4, "train"), mesh=mesh,
                               cfg=_tcfg())
    want = measure(lowered, mesh)
    assert want["collectives"] == got["collectives"]
    assert got["collectives"]["all-gather"] > 0 and got["collectives"]["all-reduce"] > 0
    assert want["memory"]["argument_size_in_bytes"] == got["argument_bytes"]
