"""Port parity: the serving surface beside decoding, against the JAX
reference at the ``qwen1.5-110b`` smoke config in float32.

* ``Engine.outputs`` and ``Engine.cancel`` (a queued and a running rid):
  the same outputs, finish reasons and cancel counts as the reference
  engine driven through the same calls.
* ``fuse_projection_weights``: the fused tree equals the reference's,
  leaf for leaf, bit-exact (a concatenation).
* ``ServeConfig.fuse_projections``: the reference's accepted values and
  ``ValueError``; greedy tokens identical fused ("mlp", "all") and unfused
  in every packed mode, and identical to the reference engine with the
  same setting.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.packed_params import fuse_projection_weights as j_fuse
from repro.models import transformer as JT
from repro.models.registry import get_config as j_get_config
from repro.serving import Engine as JEngine
from repro.serving import ServeConfig as JServeConfig
from repro_torch.convert import params_from_numpy, spec_from_dict
from repro_torch.core.packed_params import fuse_projection_weights, iter_packable_weights
from repro_torch.kernels.ref import spec_from_name
from repro_torch.models.registry import get_config as t_get_config
from repro_torch.serving import Engine, ServeConfig

ARCH = "qwen1.5-110b"
PROMPTS = [[5, 17, 33, 2, 9], [40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50],
           [7, 8, 9], [12, 13, 14, 15]]
KW = dict(n_slots=2, max_len=32, prefill_chunk=4, max_new=6)


def numpy_params(jcfg, seed: int = 0) -> dict:
    """Seeded numpy weights in the reference's layout, biases nonzero so
    that fusing them is exercised."""
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
    return jcfg, tcfg, np_tree, jax.tree.map(jnp.asarray, np_tree), params_from_numpy(np_tree, tcfg)


def _drive_with_cancels(eng) -> None:
    """Four requests on two slots: after two steps cancel one queued and one
    running request, then run to the end."""
    rids = [eng.submit(p, admit=False) for p in PROMPTS]
    eng.step()
    eng.step()
    eng.cancel(rids[3])  # still queued: both slots are busy
    eng.cancel(rids[0], reason="deadline")  # running
    while eng.active.any() or eng.scheduler.n_queued:
        eng.step()


def test_outputs_and_cancel_match_reference_engine(weights):
    jcfg, tcfg, _, jparams, tparams = weights
    jeng = JEngine(jcfg, jparams, JServeConfig(**KW))
    teng = Engine(tcfg, tparams, ServeConfig(device="cpu", **KW))
    _drive_with_cancels(jeng)
    _drive_with_cancels(teng)
    want = {r: list(t) for r, t in jeng.outputs.items()}
    got = {r: list(t) for r, t in teng.outputs.items()}
    assert got == want
    # the queued rid never ran; the running one kept its first token and
    # the two steps' tokens
    assert 3 not in got and len(got[0]) == 3
    for rid, req in jeng.scheduler.requests.items():
        assert teng.scheduler.requests[rid].finish_reason == req.finish_reason
    for key in ("cancelled", "shed", "finished"):
        assert teng.stats()[key] == jeng.stats()[key], key
    with pytest.raises(RuntimeError, match="cannot cancel"):
        teng.cancel(1)
    with pytest.raises(ValueError, match="cancel reason"):
        teng.cancel(teng.submit([3, 4]), reason="bored")


def _flatten(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{path}[{i}]")
    else:
        yield path, tree


@pytest.mark.parametrize("fuse_attn", [True, False])
def test_fuse_projection_weights_matches_reference(weights, fuse_attn):
    jcfg, tcfg, np_tree, _, tparams = weights
    want = params_from_numpy(jax.tree.map(np.asarray, j_fuse(np_tree, fuse_attn=fuse_attn)),
                             tcfg)
    got = fuse_projection_weights(tparams, fuse_attn=fuse_attn)
    want_leaves, got_leaves = dict(_flatten(want)), dict(_flatten(got))
    assert got_leaves.keys() == want_leaves.keys()
    for path, leaf in want_leaves.items():
        assert torch.equal(got_leaves[path], leaf), path
    assert ("/groups[0]/attn/wqkv/b" in got_leaves) == fuse_attn
    assert "/groups[0]/mlp/upgate/w" in got_leaves
    assert {p for p, _ in iter_packable_weights(got)} == {
        p for p, _ in iter_packable_weights(want)}


def test_fuse_projections_values():
    for value in (True, False, "none", "mlp", "all"):
        ServeConfig(device="cpu", fuse_projections=value)
    with pytest.raises(ValueError, match="fuse_projections"):
        ServeConfig(device="cpu", fuse_projections="qkv")


def _plans(tparams, name: str) -> dict:
    spec = spec_from_name(name)
    return {p: spec for p, _ in iter_packable_weights(tparams)}


@pytest.mark.parametrize("mode", ["int4_packed", "dsp_tuned", "dsp_packed"])
def test_fused_greedy_tokens_identical_to_unfused(weights, mode):
    """Per-column quantization keeps every fused column bit-identical, so
    the tokens are too; a dsp_tuned table is keyed by the served tree's
    paths, fused ones included."""
    _, tcfg, _, _, tparams = weights
    runs = {}
    for fuse in ("none", "mlp", "all"):
        table = None
        if mode == "dsp_tuned":
            served = (tparams if fuse == "none"
                      else fuse_projection_weights(tparams, fuse_attn=fuse == "all"))
            table = _plans(served, "a4w4-p10-n32-mr+full-c2")
        eng = Engine(tcfg, tparams, ServeConfig(device="cpu", quant_mode=mode,
                                                fuse_projections=fuse, **KW),
                     plan_table=table)
        runs[fuse] = eng.generate(PROMPTS[:3])
        if mode == "dsp_tuned":
            assert {r.name for r in eng.plan_table.values()} == {"a4w4-p10-n32-mr+full-c2"}
    assert runs["mlp"] == runs["none"]
    assert runs["all"] == runs["none"]


@pytest.mark.parametrize("mode, fuse", [("int4_packed", "mlp"), ("int4_packed", "all"),
                                        ("dsp_tuned", "all")])
def test_fused_greedy_tokens_identical_to_reference_engine(weights, mode, fuse):
    jcfg, tcfg, _, jparams, tparams = weights
    kw = dict(KW, quant_mode=mode, fuse_projections=fuse)
    jeng = JEngine(jcfg, jparams, JServeConfig(**kw))
    want = jeng.generate(PROMPTS[:3])
    table = None
    if mode == "dsp_tuned":
        table = {p: spec_from_dict(dataclasses.asdict(r.spec))
                 for p, r in jeng.plan_table.items()}
        assert any("wqkv" in p for p in table)
    teng = Engine(tcfg, tparams, ServeConfig(device="cpu", **kw), plan_table=table)
    assert teng.generate(PROMPTS[:3]) == want
