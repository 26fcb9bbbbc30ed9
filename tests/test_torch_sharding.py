"""Port parity: the training half of the sharding policy, on the CPU, in
one process.

* ``fsdp_axes``, ``param_pspec``, ``batch_pspec``, ``logits_pspec``,
  ``cache_pspec`` and the activation policy's ``spec_for`` equal the
  reference's entry for entry on the reference tests' ``FakeMesh`` cases
  (``tests/test_sharding.py``, ``tests/test_act_sharding.py``).
* ``param_shardings`` over the port's tree (lists of groups), with and
  without ``serving=True``, equals the reference's ``param_shardings`` over
  the reference's stacked tree, less the stacked axes' entries, for every
  registry arch's smoke config at meshes (16, 16), (2, 16, 16), (2, 2)
  and (1, 2).
* ``constrain`` returns its input, with and without a policy;
  ``constrain_group_params`` is the identity without one.
* ``NamedSharding``'s slices: a tuple entry splits its dim major to minor.
* ``compressed_grads`` over the port's lists of groups is bit-equal to the
  reference's over the stacked leaves (one scale a stacked leaf).
* One process is a mesh of one rank, whose train step is the mesh-free
  step bit for bit; the production meshes raise, naming the ranks needed.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.runtime import sharding as JS
from repro.runtime.act_sharding import activation_sharding as j_activation_sharding
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
from repro_torch.launch.steps import make_train_step
from repro_torch.launch.train import build_state, param_placement
from repro_torch.models import transformer as T
from repro_torch.models.registry import get_config as t_get_config
from repro_torch.models.registry import list_archs
from repro_torch.optim import AdamWConfig
from repro_torch.runtime import act_sharding as TA
from repro_torch.runtime import sharding as TS
from repro_torch.runtime.compression import compressed_grads
from repro_torch.tree import keyed_leaves, to_numpy, tree_leaves


class FakeMesh:
    """Duck-typed mesh for rule tests (shape dict + axis names)."""

    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


MESH1 = FakeMesh({"data": 16, "model": 16})
MESH2 = FakeMesh({"pod": 2, "data": 16, "model": 16})
MESHES = {"16x16": MESH1, "2x16x16": MESH2, "2x2": FakeMesh({"data": 2, "model": 2}),
          "1x2": FakeMesh({"data": 1, "model": 2})}

# the reference tests' param_pspec cases, and a few more of each rule
PARAM_CASES = [
    ("groups/attn/wq/w", (80, 8192, 8192)),
    ("groups/attn/wo/w", (80, 8192, 8192)),
    ("embed/w", (152064, 8192)),
    ("groups/ln1/scale", (80, 8192)),
    ("groups/moe/up", (40, 16, 6144, 10752)),
    ("groups/moe/down", (40, 16, 10752, 6144)),
    ("groups/moe/router/w", (40, 6144, 16)),
    ("lm_head/w", (1280, 51866)),
    ("groups/attn/wq/b", (80, 8192)),
    ("groups/mlp/down/w", (4, 8, 16)),
    ("groups/mamba/conv_w", (4, 3, 4, 512)),
    ("patch_proj/w", (1024, 4096)),
]
CACHE_CASES = [
    ((4, 1, 524288, 8, 128), 1, "attn"),
    ((40, 128, 32768, 8, 128), 128, "attn"),
    ((40, 64, 32768, 8, 128), 64, "attn"),
    ((40, 3, 36, 8, 128), 3, "attn"),
    ((4, 128, 4096), 128, "mamba"),
    ((4, 3, 128, 64, 16), 128, "mamba"),
    ((4, 7, 33), 7, "slstm"),
]
ACT_CASES = [
    ("residual", (256, 4096, 3840)), ("residual", (7, 64, 128)),
    ("hidden", (256, 4096, 10240)), ("heads", (256, 4096, 32, 120)),
    ("heads", (32, 4096, 36, 128)), ("heads", (128, 1, 64, 128)),
    ("scores_decode", (128, 64, 1, 32768)), ("expert", (16, 1024, 6144)),
    ("expert", (6, 64, 64)), ("other", (4, 4)),
]


@pytest.mark.parametrize("mesh", [MESH1, MESH2], ids=["16x16", "2x16x16"])
def test_placement_rules_match_reference(mesh):
    assert TS.fsdp_axes(mesh) == JS.fsdp_axes(mesh)
    for path, shape in PARAM_CASES:
        assert TS.param_pspec(path, shape, mesh) == tuple(JS.param_pspec(path, shape, mesh)), path
    for shape, batch, path in CACHE_CASES:
        assert TS.cache_pspec(mesh, shape, batch, path) == \
            tuple(JS.cache_pspec(mesh, shape, batch, path)), (shape, path)
    for batch in (1, 7, 16, 64, 128):
        assert TS.batch_pspec(mesh, batch) == tuple(JS.batch_pspec(mesh, batch))
        assert TS.logits_pspec(mesh, batch) == tuple(JS.logits_pspec(mesh, batch))


def test_reference_test_cases_hold():
    # the reference tests' own assertions, on the port's functions
    assert TS.param_pspec("groups/attn/wq/w", (80, 8192, 8192), MESH1) == (None, "data", "model")
    assert TS.param_pspec("groups/attn/wo/w", (80, 8192, 8192), MESH2) == \
        (None, "model", ("pod", "data"))
    assert TS.param_pspec("embed/w", (152064, 8192), MESH1) == ("model", "data")
    assert TS.param_pspec("groups/moe/up", (40, 16, 6144, 10752), MESH1)[1] == "model"
    assert "model" not in TS.param_pspec("lm_head/w", (1280, 51866), MESH1)
    assert TS.batch_pspec(MESH2, 16) == (None, None)
    spec = TS.cache_pspec(MESH2, (4, 1, 524288, 8, 128), batch=1)
    assert spec[1] is None and spec[2] == ("pod", "data")


def _port_spec_for(mesh, kind, shape):
    with TA.activation_sharding(mesh):
        return TA._policy().spec_for(kind, shape)


def _ref_spec_for(mesh, kind, shape):
    from repro.runtime import act_sharding

    with j_activation_sharding(mesh):
        _, spec_for, _ = act_sharding._policy()
        spec = spec_for(kind, shape)
        return None if spec is None else tuple(spec)


@pytest.mark.parametrize("mesh", [MESH1, MESH2], ids=["16x16", "2x16x16"])
def test_activation_specs_match_reference(mesh):
    for kind, shape in ACT_CASES:
        assert _port_spec_for(mesh, kind, shape) == _ref_spec_for(mesh, kind, shape), kind


def test_constrain_is_noop_with_and_without_policy():
    x = torch.ones((4, 4))
    gp = {"w": torch.ones(2)}
    assert TA.constrain(x, "residual") is x
    assert TA.constrain_group_params(gp) is gp
    with TA.activation_sharding(MESH1):
        assert TA.constrain(x, "residual") is x
        assert TA.constrain_group_params(gp) is gp  # no group_shardings
    assert TA._policy() is None


@functools.lru_cache(maxsize=None)
def _ref_shapes(arch: str):
    from repro.models import transformer as JT
    from repro.models.registry import get_config as j_get_config

    return jax.eval_shape(lambda: JT.init_params(jax.random.PRNGKey(0),
                                                 j_get_config(arch, smoke=True)))


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", list_archs())
def test_param_shardings_match_reference_tree(arch, mesh_name):
    mesh = MESHES[mesh_name]
    abstract = AbstractMesh(tuple(mesh.shape.values()), mesh.axis_names)
    ref_tree = _ref_shapes(arch)
    port_tree = T.init_params(t_get_config(arch, smoke=True), device="meta")
    for serving in (False, True):
        want = {"/".join(str(p.key) for p in path): (leaf.shape, tuple(sh.spec))
                for (path, leaf), sh in zip(
                    jax.tree_util.tree_flatten_with_path(ref_tree)[0],
                    jax.tree.leaves(JS.param_shardings(ref_tree, abstract, serving=serving)))}
        got = TS.param_shardings(port_tree, mesh, serving=serving)
        seen = set()
        for (path, key, shape, depth, _), sh in zip(keyed_leaves(port_tree),
                                                   tree_leaves(got)):
            ref_shape, ref_spec = want[key]
            spec = sh.spec
            assert shape == ref_shape, key
            assert ref_spec[:depth] == (None,) * depth and spec == ref_spec[depth:], \
                (key, serving, spec, ref_spec)
            seen.add(key)
        assert seen == set(want)


class _Coords:
    """A mesh seen from the rank at ``coord`` (no process group)."""

    def __init__(self, shape, coord):
        self.shape, self.axis_names, self.coord = shape, tuple(shape), coord
        self.size = int(np.prod(list(shape.values())))


def test_named_sharding_splits_major_to_minor():
    shape = {"pod": 2, "data": 2, "model": 2}
    full = torch.arange(8 * 6).reshape(8, 6)
    for pod in range(2):
        for data in range(2):
            for model in range(2):
                mesh = _Coords(shape, {"pod": pod, "data": data, "model": model})
                sh = TS.NamedSharding(mesh, (("pod", "data"), "model"))
                part = pod * 2 + data
                assert torch.equal(sh.place(full), full[2 * part:2 * part + 2,
                                                        3 * model:3 * model + 3])
                assert sh.shard_shape((8, 6)) == (2, 3)
                assert sh.owns()
                rep = TS.NamedSharding(mesh, (None, "model"))
                assert rep.owns() == (pod == data == 0)


def test_compressed_grads_share_the_stacked_leaf_scale():
    from repro.runtime.compression import compressed_grads as j_compress

    rng = np.random.default_rng(5)
    # three groups whose absmax differ by orders of magnitude, and an inner list
    groups = [{"w": (rng.standard_normal((6, 4)) * 10.0 ** -i).astype(np.float32),
               "inner": [(rng.standard_normal(3) * 10.0 ** i).astype(np.float32)
                         for _ in range(2)]} for i in range(3)]
    port = {"groups": [{"w": torch.from_numpy(g["w"].copy()),
                        "inner": [torch.from_numpy(x.copy()) for x in g["inner"]]}
                       for g in groups], "b": torch.from_numpy(rng.standard_normal(5)
                                                               .astype(np.float32))}
    err = {"groups": [{"w": torch.zeros(6, 4), "inner": [torch.zeros(3)] * 2}] * 3,
           "b": torch.zeros(5)}
    ref = jax.tree.map(jnp.asarray, to_numpy(port))
    for _ in range(2):
        ref_g, ref_e = j_compress(ref, jax.tree.map(jnp.asarray, to_numpy(err)))
        got_g, err = compressed_grads(port, err)
        for a, b in zip(jax.tree.leaves(to_numpy(got_g)), jax.tree.leaves(ref_g)):
            np.testing.assert_array_equal(a, np.asarray(b))
        for a, b in zip(jax.tree.leaves(to_numpy(err)), jax.tree.leaves(ref_e)):
            np.testing.assert_array_equal(a, np.asarray(b))


def test_one_process_is_a_mesh_of_one_rank():
    mesh = make_local_mesh()
    assert mesh.shape == {"data": 1, "model": 1} and mesh.size == 1 and mesh.rank == 0
    cfg = dataclasses.replace(t_get_config("qwen1.5-110b", smoke=True), dtype="float32")
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 8), generator=torch.Generator()
                                     .manual_seed(0)),
             "labels": torch.randint(0, cfg.vocab_size, (2, 8), generator=torch.Generator()
                                     .manual_seed(1))}
    states = []
    for m, placement in ((None, None), (mesh, param_placement(cfg, mesh))):
        state = build_state(cfg, device="cpu", compress_grads=True)
        step = make_train_step(cfg, AdamWConfig(), m, compress_grads=True,
                               grad_shardings=placement)
        state, metrics = step(state, batch)
        states.append([state, metrics])
    for a, b in zip(tree_leaves(states[0]), tree_leaves(states[1])):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="needs 256 ranks; 1 rank"):
        make_production_mesh()
    with pytest.raises(ValueError, match="needs 512 ranks"):
        make_production_mesh(multi_pod=True)
