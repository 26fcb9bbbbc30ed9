"""Port parity: checkpoints, resume and the train CLI.

A train state written by the reference's ``Checkpointer`` restores into the
port (every array bit-equal to the reference's state) and a port
checkpoint restores into the reference; the port's own resume is bit-exact
on the CPU (the reference's ``test_checkpoint_resume_bit_exact``); the
torn-write behaviour of the reference's tests holds for the port's
``Checkpointer``; the train CLI at ``--smoke --device cpu`` finishes and
resumes; heartbeats and the restart policy behave as the reference's.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.models import transformer as JT
from repro.models.registry import get_config as j_get_config
from repro.optim.adamw import AdamWConfig as JAdamW
from repro.optim.adamw import adamw_init as j_adamw_init
from repro.optim.adamw import adamw_update as j_adamw_update
from repro_torch.checkpoint import Checkpointer
from repro_torch.checkpoint import checkpointer as C
from repro_torch.convert import state_to_numpy
from repro_torch.data import DataConfig, SyntheticStream
from repro_torch.launch import train as train_cli
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.launch.steps import make_train_step
from repro_torch.launch.train import build_state
from repro_torch.models.registry import get_config as t_get_config
from repro_torch.optim import AdamWConfig
from repro_torch.runtime import HeartbeatMonitor, Heartbeat, RestartPolicy
from repro_torch.runtime.sharding import NamedSharding
from repro_torch.tree import tree_leaves
from repro_torch.tuning import plandb

ARCH = "xlstm-1.3b"  # inner stacks (mlstm) inside the stacked groups


def configs():
    jcfg = dataclasses.replace(j_get_config(ARCH, smoke=True), dtype="float32")
    tcfg = dataclasses.replace(t_get_config(ARCH, smoke=True), dtype="float32")
    return jcfg, tcfg


def batches(cfg, start: int, n: int):
    data = SyntheticStream(DataConfig(cfg.vocab_size, 17, 2, seed=1))
    return [data.batch_at(i) for i in range(start, start + n)]


def flat(tree) -> dict[str, np.ndarray]:
    return {"/".join(str(p.key) for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def assert_states_equal(port_state, ref_state):
    got, want = flat(state_to_numpy(port_state)), flat(ref_state)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def port_run(state, step_fn, cfg, start: int, n: int):
    for b in batches(cfg, start, n):
        state, _ = step_fn(state, {k: torch.from_numpy(v) for k, v in b.items()})
    return state


def test_reference_checkpoint_restores_into_the_port_and_back(tmp_path):
    jcfg, tcfg = configs()
    params = JT.init_params(jax.random.PRNGKey(0), jcfg)
    # a reference train state two AdamW updates in (seeded gradients), with
    # an error-feedback buffer
    rng = np.random.default_rng(0)
    opt = j_adamw_init(params)
    update = jax.jit(lambda p, g, o: j_adamw_update(p, g, o, JAdamW(lr=1e-3)))
    for _ in range(2):
        grads = jax.tree.map(lambda p: jnp.asarray(
            rng.standard_normal(p.shape, dtype=np.float32)), params)
        params, opt, _ = update(params, grads, opt)
    jstate = {"params": params, "opt": opt, "error_buf": jax.tree.map(
        lambda p: jnp.asarray(rng.standard_normal(p.shape, dtype=np.float32)), params)}
    JCheckpointer(str(tmp_path / "ref")).save(2, jstate, extra={"train_step": 2})

    # reference -> port: every array bit-equal, the extra carried
    like = build_state(tcfg, seed=1, compress_grads=True, device="cpu")
    tstate, extra = Checkpointer(str(tmp_path / "ref")).restore(2, like)
    assert extra == {"train_step": 2}
    assert_states_equal(tstate, jstate)
    assert isinstance(tstate["params"]["groups"], list)
    assert isinstance(tstate["params"]["groups"][0]["mlstm"], list)

    # the port continues, saves, and the reference restores it bit-equal
    tstep = make_train_step(tcfg, AdamWConfig(lr=1e-3), compress_grads=True)
    tstate = port_run(tstate, tstep, tcfg, 0, 1)
    Checkpointer(str(tmp_path / "port")).save(3, tstate, extra={"train_step": 3})
    back, extra = JCheckpointer(str(tmp_path / "port")).restore(3, jstate)
    assert extra == {"train_step": 3}
    assert_states_equal(tstate, back)
    assert int(back["opt"]["step"]) == 3


def test_port_resume_bit_exact(tmp_path):
    _, tcfg = configs()
    step = make_train_step(tcfg, AdamWConfig(lr=1e-3))
    ck = Checkpointer(str(tmp_path))
    state5 = port_run(build_state(tcfg, device="cpu"), step, tcfg, 0, 5)
    ck.save(5, state5, extra={"data": {"step": 5, "seed": 1}})
    state10 = port_run(state5, step, tcfg, 5, 5)  # continues in place
    restored, extra = ck.restore(5, build_state(tcfg, seed=7, device="cpu"))
    assert extra["data"]["step"] == 5
    state10b = port_run(restored, step, tcfg, 5, 5)
    for a, b in zip(tree_leaves(state10), tree_leaves(state10b)):
        assert torch.equal(a, b)


def test_checkpointer_atomicity_gc_and_async(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3):
        ck.save(s, {"w": torch.arange(8.0)})
    assert ck.all_steps() == [2, 3] and ck.latest_step() == 3
    assert not any(f.endswith(".tmp") for f in os.listdir(tmp_path))
    ck.save_async(7, {"w": [torch.ones(4), torch.zeros(4)]})
    ck.wait()
    assert ck.latest_step() == 7
    tree, _ = ck.restore(7, {"w": [torch.empty(4), torch.empty(4, dtype=torch.float64)]})
    assert torch.equal(tree["w"][0], torch.ones(4))
    assert tree["w"][1].dtype == torch.float64
    # restore under a placement: a mesh of one rank holds every leaf whole
    mesh = make_local_mesh()
    tree, _ = ck.restore(7, {"w": [torch.empty(4), torch.empty(4)]}, shardings={
        "w": [NamedSharding(mesh, ("data",)), None]})
    assert torch.equal(tree["w"][0], torch.ones(4)) and torch.equal(tree["w"][1], torch.zeros(4))
    with pytest.raises(ValueError, match="keep"):
        Checkpointer(str(tmp_path), keep=0)


def test_async_save_writes_the_tree_as_it_was(tmp_path, monkeypatch):
    """``save_async`` snapshots every leaf before it returns: the tree
    changed in place (as the train step changes the state) while the write
    is held back still restores as it was at the call."""
    ck = Checkpointer(str(tmp_path))
    tree = {"w": torch.arange(6.0), "groups": [torch.ones(3), torch.zeros(3)],
            "step": torch.tensor(4, dtype=torch.int32)}
    want = {"w": tree["w"].clone(), "groups": [g.clone() for g in tree["groups"]],
            "step": tree["step"].clone()}
    real_savez, go = np.savez, threading.Event()

    def held_savez(*args, **kwargs):
        assert go.wait(10)
        return real_savez(*args, **kwargs)

    monkeypatch.setattr(C.np, "savez", held_savez)
    ck.save_async(1, tree)
    tree["w"].mul_(-1)
    tree["groups"][0].add_(5)
    tree["step"].add_(1)
    go.set()
    ck.wait()
    restored, _ = ck.restore(1, tree)
    for a, b in zip(tree_leaves(restored), tree_leaves(want)):
        assert torch.equal(a, b)


def test_manifest_only_step_reads_through_plandb(tmp_path):
    """A step with a manifest and no ``arrays.npz`` (how the plan database
    stored its steps before array checkpoints) restores with an empty
    ``like``: its entries are read under the current schema and read as
    stale under another."""
    for schema, name in ((plandb.SCHEMA_VERSION, "current"), (-1, "other")):
        step = tmp_path / name / "step_00000000"
        step.mkdir(parents=True)
        (step / "manifest.json").write_text(json.dumps(
            {"step": 0, "extra": {"schema": schema, "entries": {"k": {"v": 1}}}}))
    db = plandb.PlanDB(str(tmp_path / "current"))
    assert db.get("k") == {"v": 1} and db.n_stale == 0
    db = plandb.PlanDB(str(tmp_path / "other"))
    assert db.get("k") is None and db.n_stale == 1


def test_torn_async_save_invisible_then_recoverable(tmp_path, monkeypatch):
    ck = Checkpointer(str(tmp_path))
    tree = {"w": torch.arange(6.0)}
    ck.save(1, tree, extra={"tag": "live"})
    real_savez, torn = np.savez, {"fail": True}

    def flaky_savez(*args, **kwargs):
        if torn["fail"]:
            raise OSError("No space left on device")
        return real_savez(*args, **kwargs)

    monkeypatch.setattr(C.np, "savez", flaky_savez)
    ck.save_async(2, tree)
    with pytest.raises(RuntimeError, match="async checkpoint write failed"):
        ck.wait()
    ck.wait()  # surfaced once
    assert any(f.endswith(".tmp") for f in os.listdir(tmp_path))
    assert ck.all_steps() == [1] and ck.latest_step() == 1
    restored, extra = ck.restore(1, tree)
    assert torch.equal(restored["w"], torch.arange(6.0)) and extra["tag"] == "live"
    torn["fail"] = False
    ck.save(2, tree)
    assert ck.all_steps() == [1, 2]
    assert not any(f.endswith(".tmp") for f in os.listdir(tmp_path))


def test_torn_sync_save_keeps_previous_step_restorable(tmp_path, monkeypatch):
    ck = Checkpointer(str(tmp_path))
    ck.save(3, {"w": torch.full((4,), 2.0)})

    def boom(*args, **kwargs):
        raise OSError("No space left on device")

    monkeypatch.setattr(C.np, "savez", boom)
    with pytest.raises(OSError):
        ck.save(4, {"w": torch.full((4,), 9.0)})
    monkeypatch.undo()
    assert ck.latest_step() == 3
    restored, _ = ck.restore(3, {"w": torch.zeros(4)})
    assert torch.equal(restored["w"], torch.full((4,), 2.0))


def test_train_cli_smoke_finishes_and_resumes(tmp_path, capsys):
    """An uninterrupted 5-step run with an async checkpoint at step 3, and a
    relaunch from that checkpoint alone: it resumes at step 3 (the data
    stream too) and ends on the same step-5 state, bit for bit."""
    args = ["--arch", ARCH, "--smoke", "--global-batch", "2", "--seq-len", "16",
            "--device", "cpu", "--log-every", "1", "--steps", "5"]
    whole, resumed = tmp_path / "whole", tmp_path / "resumed"
    train_cli.main(args + ["--ckpt-dir", str(whole), "--ckpt-every", "3"])
    out = capsys.readouterr().out
    assert "[train] step=4 loss=" in out and out.rstrip().endswith("[train] done")
    assert Checkpointer(str(whole)).all_steps() == [3, 5]
    assert os.path.exists(whole / "hb" / "host_00000.hb")
    resumed.mkdir()
    os.rename(whole / "step_00000003", resumed / "step_00000003")
    train_cli.main(args + ["--ckpt-dir", str(resumed)])
    out = capsys.readouterr().out
    assert "[train] resumed from step 3" in out and "[train] step=3 " in out
    assert "[train] step=2 " not in out and out.rstrip().endswith("[train] done")
    with np.load(whole / "step_00000005" / "arrays.npz") as a, \
            np.load(resumed / "step_00000005" / "arrays.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    with pytest.raises(ValueError, match="needs 512 ranks; 1 rank"):
        train_cli.main(args + ["--mesh", "multi"])


def test_heartbeats_and_restart_policy(tmp_path):
    d = str(tmp_path)
    Heartbeat(d, 0).beat(10)
    Heartbeat(d, 1).beat(10)
    mon = HeartbeatMonitor(d, deadline_s=60)
    assert mon.healthy() and mon.dead_hosts() == []
    assert mon.dead_hosts(now=time.time() + 120) == [0, 1]
    policy = RestartPolicy(max_restarts=1)
    assert policy.on_fault([1], 40) == {"action": "restart", "from_step": 40,
                                        "replace_hosts": [1]}
    assert policy.on_fault([], None)["action"] == "abort"
