"""Port parity: the launch grid (``launch/shapes.py``), the dry run
(``launch/dryrun.py``) and ``quantize_params_for_serving``, against the
reference on the CPU.

The reference's ``repro.launch.dryrun`` sets ``XLA_FLAGS`` to 512 host
devices at import, so its numbers (``packed_tp_projection``,
``_packing_plan_verdicts``) are taken in one subprocess, whose JSON xdist
workers share through a file lock; no test process imports it.  The port's
dry run runs one rank's step on meta tensors (its module docstring), so its
cells are held to the reference part by part:

* ``supported``, ``input_specs`` and ``cache_specs`` equal the reference's
  for every registry arch and shape at the full config, shape for shape and
  dtype for dtype (the cache after restacking the port's lists);
* ``packed_tp_projection`` equals the reference's dict number for number
  (qwen1.5-110b, dbrx-132b, jamba-v0.1-52b at tp 2 and 8);
* an ``int4_serve`` cell's ``packing_plans`` equal the reference's verdicts;
* a dense prefill cell's FLOPs equal an analytic count from the config's
  widths, and a train cell's full depth ``f1 + (G-1)(f2-f1)``;
* every supported smoke cell's step runs on pod16x16 at baseline, and
  ``run_cell`` writes the reference's record (MoE cells under
  ``moe_rows: "capacity"``);
* the dry run's stand-ins for the model's loops count the loops' FLOPs,
  and take meta tensors only;
* ``quantize_params_for_serving`` is bit-equal to the reference's.
"""

from __future__ import annotations

import contextlib
import dataclasses
import fcntl
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.packed_params import quantize_params_for_serving
from repro_torch.launch import dryrun as D
from repro_torch.launch import shapes as PS
from repro_torch.models.registry import get_config, list_archs
from repro_torch.tree import keyed_leaves, to_numpy

ROOT = Path(__file__).resolve().parents[1]
TPS = (2, 8)
PLANS_ARCH = "qwen1.5-110b"

_REFERENCE = f"""
import json, sys
import repro.launch.dryrun as D
from repro.models.registry import get_config
out = {{"packed_tp": {{f"{{a}} {{tp}}": D.packed_tp_projection(a, tp)
                     for a in D.PACKED_TP_ARCHS for tp in {TPS!r}}},
       "plans": D._packing_plan_verdicts(get_config({PLANS_ARCH!r}, smoke=True))}}
json.dump(out, open(sys.argv[1], "w"))
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory) -> dict:
    """The reference dry run's numbers, from one subprocess a test session
    (xdist workers share its JSON under a file lock)."""
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent
    path = base / "dryrun_reference.json"
    with open(base / "dryrun_reference.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not path.exists():
            env = dict(os.environ, JAX_PLATFORMS="cpu",
                       PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                                   os.environ.get("PYTHONPATH", "")]))
            subprocess.run([sys.executable, "-c", _REFERENCE, str(path)], env=env,
                           check=True, timeout=300)
    return json.loads(path.read_text())


def _dtype(dt) -> str:
    return str(dt).removeprefix("torch.")


# ---- launch/shapes.py --------------------------------------------------------


def test_shapes_table_equals_the_reference():
    from repro.launch import shapes as JS

    assert list(PS.SHAPES) == list(JS.SHAPES)
    for name, shape in PS.SHAPES.items():
        assert dataclasses.astuple(shape) == dataclasses.astuple(JS.SHAPES[name])


@pytest.mark.parametrize("arch", list_archs())
def test_supported_inputs_and_cache_equal_the_reference(arch):
    import jax

    from repro.launch import shapes as JS
    from repro.models.registry import get_config as j_get_config

    cfg, jcfg = get_config(arch), j_get_config(arch)
    for name, shape in PS.SHAPES.items():
        ok = PS.supported(cfg, shape)
        assert ok == JS.supported(jcfg, JS.SHAPES[name]), name
        if not ok[0]:
            continue
        got = {k: (tuple(v.shape), _dtype(v.dtype), v.device.type)
               for k, v in PS.input_specs(cfg, shape).items()}
        want = {k: (tuple(v.shape), np.dtype(v.dtype).name, "meta")
                for k, v in JS.input_specs(jcfg, JS.SHAPES[name]).items()}
        assert got == want, name
        if shape.kind != "decode":
            continue
        # the port's cache restacked into the reference's layout
        got = {}
        for _, key, stacked, _, leaf in keyed_leaves(PS.cache_specs(cfg, shape)):
            assert leaf.is_meta
            got[key] = (stacked, _dtype(leaf.dtype))
        flat = jax.tree_util.tree_flatten_with_path(JS.cache_specs(jcfg, JS.SHAPES[name]))[0]
        want = {"/".join(str(p.key) for p in path): (tuple(v.shape), np.dtype(v.dtype).name)
                for path, v in flat}
        assert got == want, name


# ---- packed_tp_projection and the int4_serve plans ---------------------------


@pytest.mark.parametrize("tp", TPS)
@pytest.mark.parametrize("arch", D.PACKED_TP_ARCHS)
def test_packed_tp_projection_equals_the_reference(reference, arch, tp):
    got = json.loads(json.dumps(D.packed_tp_projection(arch, tp)))
    assert got == reference["packed_tp"][f"{arch} {tp}"]


def test_int4_serve_packing_plans_equal_the_reference(reference, tmp_path):
    rec = D.run_cell(PLANS_ARCH, "decode_32k", False, str(tmp_path), smoke=True,
                     variant="int4_serve")
    assert rec["ok"], rec.get("error")
    assert rec["packing_plans"] == reference["plans"]
    assert rec["variant"] == "int4_serve" and rec["memory"]["argument_size_in_bytes"] > 0


# ---- FLOPs -------------------------------------------------------------------


def test_dense_prefill_flops_equal_the_analytic_count(tmp_path):
    rec = D.run_cell("qwen1.5-110b", "prefill_32k", False, str(tmp_path), smoke=True)
    assert rec["ok"], rec.get("error")
    c = get_config("qwen1.5-110b", smoke=True)
    shape = PS.SHAPES["prefill_32k"]
    rows = shape.global_batch // 16  # the batch over "data" of pod16x16
    s, d, h, kv, hd, f = shape.seq_len, c.d_model, c.n_heads, c.n_kv_heads, c.hd, c.d_ff
    t = rows * s
    per_layer = (2 * t * d * h * hd          # q
                 + 2 * 2 * t * d * kv * hd   # k, v
                 + 2 * t * h * hd * d        # o
                 + 3 * 2 * t * d * f         # up, gate, down
                 + 2 * 2 * rows * h * s * s * hd)  # scores and probs @ v, whole
    norms = (2 * c.n_layers + 1) * 2 * t * d  # rmsnorm's variance is an einsum
    want = c.n_layers * per_layer + norms + 2 * t * d * c.vocab_size  # lm_head
    assert rec["flops"] == want
    assert rec["flops_basis"] == "matmul" and rec["n_devices"] == 256


def test_train_flops_over_depth_are_the_group_increments():
    """At 5 groups (the smoke configs have one or two)."""
    cfg = dataclasses.replace(get_config("qwen1.5-110b", smoke=True), n_layers=5)
    shape = PS.ShapeSpec("train_64", 64, 32, "train")

    def flops(depth):
        lowered, _, mesh = D.lower_cell("qwen1.5-110b", "train_4k", False, depth_groups=depth,
                                        shape=shape, cfg=cfg)
        return D.measure(lowered, mesh, memory=False)["flops"]

    f1, f2, full = flops(1), flops(2), flops(None)
    assert f2 > f1 > 0
    assert full == f1 + (cfg.n_groups - 1) * (f2 - f1)


# ---- every smoke cell --------------------------------------------------------


@pytest.mark.parametrize("arch", list_archs())
def test_every_supported_smoke_cell_is_ok(arch):
    """Every supported cell's full-depth step on pod16x16; ``run_cell``'s
    record (and its one- and two-group models) is held below, on the cells
    that cost least, and the group increments above."""
    for name, shape in PS.SHAPES.items():
        if not PS.supported(get_config(arch), shape)[0]:
            continue
        lowered, _, mesh = D.lower_cell(arch, name, False, smoke=True)
        rec = D.measure(lowered, mesh)
        assert rec["memory"]["argument_size_in_bytes"] > 0 and rec["flops"] > 0, name
        assert rec["memory"]["temp_size_in_bytes"] > 0, name
        assert rec["collectives"]["total"] == sum(rec["collectives"][k] for k in D.COLLECTIVES)
        assert rec["collectives"]["all-gather"] > 0, name  # every rank gathers its weights
        assert mesh.size == 256


# the reference's record keys (``repro.launch.dryrun.run_cell``), less the
# memory key XLA alone has (``generated_code_size_in_bytes``)
RECORD_KEYS = {"arch", "shape", "mesh", "ok", "variant", "flops", "bytes_accessed",
               "collectives", "scan_body", "memory", "n_devices", "n_params", "lower_s",
               "compile_s"}
MEMORY_KEYS = {"argument_size_in_bytes", "output_size_in_bytes", "temp_size_in_bytes",
               "alias_size_in_bytes"}


@pytest.mark.parametrize("arch", ["qwen1.5-110b", "moonshot-v1-16b-a3b"])
def test_run_cell_writes_the_reference_record(arch, tmp_path):
    rec = D.run_cell(arch, "decode_32k", False, str(tmp_path), smoke=True)
    assert rec["ok"], (rec.get("error"), rec.get("traceback"))
    assert rec == json.loads((tmp_path / f"{arch}__decode_32k__pod16x16.json").read_text())
    moe = get_config(arch, smoke=True).n_experts > 0
    assert set(rec) == RECORD_KEYS | {"flops_basis"} | ({"moe_rows"} if moe else set())
    assert set(rec["memory"]) == MEMORY_KEYS
    assert set(rec["collectives"]) == set(D.COLLECTIVES) | {"total"}
    assert rec["flops_basis"] == "matmul" and rec.get("moe_rows") == ("capacity" if moe else None)
    assert rec["n_params"] > 0 and rec["n_devices"] == 256
    f1, f2 = rec["scan_body"]["flops_1g"], rec["scan_body"]["flops_2g"]
    groups = get_config(arch, smoke=True).n_groups
    assert 0 < f1 < f2 and rec["flops"] == f1 + (groups - 1) * (f2 - f1)


def test_dryrun_main_exits_nonzero_on_a_failing_cell(tmp_path, capsys, monkeypatch):
    def broken(*a, **k):
        raise RuntimeError("broken cell")

    monkeypatch.setattr(D, "lower_cell", broken)
    code = D.main(["--arch", "qwen1.5-110b", "--shape", "decode_32k", "--smoke",
                   "--out", str(tmp_path)])
    assert code == 1
    rec = json.loads((tmp_path / "qwen1.5-110b__decode_32k__pod16x16.json").read_text())
    assert not rec["ok"] and "broken cell" in rec["error"] and rec["traceback"]
    assert "FAIL" in capsys.readouterr().out


# ---- quantize_params_for_serving -----------------------------------------------


def _reference_pack(tree, **kw):
    import jax

    from repro.core.packed_params import quantize_params_for_serving as j_quantize

    return jax.tree.map(np.asarray, j_quantize(tree, **kw))


def _assert_trees_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        if isinstance(want[k], dict):
            _assert_trees_equal(got[k], want[k])
        else:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("prepack", [False, True])
def test_quantize_params_for_serving_bit_equals_the_reference(prepack):
    import jax
    import jax.numpy as jnp

    from repro.models import transformer as JT
    from repro.models.registry import get_config as j_get_config

    from repro_torch.convert import params_from_numpy

    key = jax.random.PRNGKey(0)
    w = np.asarray(jax.random.normal(key, (64, 48), jnp.float32))
    got = quantize_params_for_serving({"w": torch.from_numpy(w)}, min_dim=16, prepack=prepack)
    _assert_trees_equal(to_numpy(got), _reference_pack({"w": jnp.asarray(w)}, min_dim=16,
                                                       prepack=prepack))
    zeros = quantize_params_for_serving({"up": torch.zeros((128, 128), dtype=torch.bfloat16)},
                                        min_dim=16, prepack=prepack)
    _assert_trees_equal(to_numpy(zeros), _reference_pack(
        {"up": jnp.zeros((128, 128), jnp.bfloat16)}, min_dim=16, prepack=prepack))
    assert "w_f32" not in zeros["up"] or prepack
    for arch in ("qwen1.5-110b", "dbrx-132b"):
        jcfg = dataclasses.replace(j_get_config(arch, smoke=True), dtype="float32")
        jparams = JT.init_params(key, jcfg)
        params = params_from_numpy(jax.tree.map(np.array, jparams),
                                   dataclasses.replace(get_config(arch, smoke=True),
                                                       dtype="float32"))
        got = to_numpy(quantize_params_for_serving(params, min_dim=16, prepack=prepack))
        _assert_trees_equal(got, _reference_pack(jparams, min_dim=16, prepack=prepack))


def test_quantize_params_for_serving_runs_on_meta():
    params = {"w": torch.empty((4096, 1024), device="meta")}
    leaf = quantize_params_for_serving(params)["w"]
    assert leaf["packed"].is_meta and tuple(leaf["packed"].shape) == (2048, 1024)
    assert leaf["packed"].dtype == torch.uint8 and tuple(leaf["scale"].shape) == (1, 1024)


@pytest.mark.parametrize("mixer", ["mamba", "mlstm", "slstm"])
def test_meta_recurrences_count_the_loops_flops(mixer):
    """The dry run's stand-ins for ``models.ssm``'s loops (one op, or at
    most three chunk calls) count the loops' matmul FLOPs exactly, forward
    and backward: mLSTM at 3 chunks (first, middle and last), the per-token
    recurrences over 64 tokens, one thread (the loops' tiny ops crawl when
    their threads contend with the other test workers)."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.models import ssm
    from repro_torch.tree import tree_leaves

    arch = "jamba-v0.1-52b" if mixer == "mamba" else "xlstm-1.3b"
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    seq = 3 * ssm.CHUNK if mixer == "mlstm" else 64
    counts, threads = [], torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for dev in ("cpu", "meta"):
            gen = None if dev == "meta" else torch.Generator().manual_seed(0)
            params = getattr(ssm, f"init_{mixer}")(gen, cfg, torch.float32, torch.device(dev))
            for t in tree_leaves(params):
                t.requires_grad_(True)
            x = torch.zeros((2, seq, cfg.d_model), device=dev, requires_grad=True)
            stand_ins = D.meta_stand_ins() if dev == "meta" else contextlib.nullcontext()
            with stand_ins, FlopCounterMode(display=False) as fc:
                with torch.no_grad():
                    getattr(ssm, mixer)(params, x, cfg)
                forward = fc.get_total_flops()
                y, _ = getattr(ssm, mixer)(params, x, cfg)
                y.sum().backward()
            counts.append((forward, fc.get_total_flops() - forward))
    finally:
        torch.set_num_threads(threads)
    assert counts[0] == counts[1] and counts[0][0] > 0


def test_stand_ins_take_meta_tensors_only():
    """Inside the dry run's stand-ins a tensor off the meta device raises (a
    step on the card never runs them); outside, the model's own code is
    back."""
    from repro_torch.models import moe, ssm

    cfg = dataclasses.replace(get_config("jamba-v0.1-52b", smoke=True), dtype="float32")
    params = ssm.init_mamba(torch.Generator().manual_seed(0), cfg, torch.float32,
                            torch.device("cpu"))
    x = torch.zeros((1, 4, cfg.d_model))
    own = (moe._dispatch, ssm._mamba_chunk, ssm._mlstm_scan, ssm._slstm_scan)
    with D.meta_stand_ins():
        assert (moe._dispatch, ssm._mamba_chunk) != own[:2]
        with pytest.raises(ValueError, match="meta tensors"):
            ssm.mamba(params, x, cfg)
        with pytest.raises(ValueError, match="meta tensors"):
            moe._dispatch(torch.zeros(8, dtype=torch.int64), 4, 2, None)
    assert (moe._dispatch, ssm._mamba_chunk, ssm._mlstm_scan, ssm._slstm_scan) == own
    assert ssm.mamba(params, x, cfg)[0].shape == x.shape
