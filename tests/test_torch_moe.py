"""Port parity: the MoE family (``repro_torch.models.moe``, the ``moe``
family of ``models.transformer``, per-expert packed leaves) against the
reference.

* ``moe_ffn`` against the reference's in both branches, the capacity path
  (``valid=None``: the same tokens dropped by the rank rule of the stable
  sort) and dropless serving (``valid`` given), output within ``atol 1e-5``
  and the aux loss within ``1e-6``, on the moonshot and dbrx smoke
  configs; padding lanes leave the real tokens' outputs unchanged.
* ``split_expert_stacks`` and ``iter_packable_weights`` give the
  reference's paths (per expert) and shapes; the split is idempotent.
* ``params_from_numpy`` carries the reference's MoE tree across.
* Greedy tokens of the port's ``Engine`` equal the reference ``Engine``'s
  on moonshot smoke in ``native``, ``int8``, ``int4_packed``,
  ``dsp_tuned`` and ``dsp_packed`` (one reference engine per mode); dbrx
  smoke's forward logits within ``atol 1e-4``, capacity path and masked.

Weights are seeded numpy in the reference's layout, at float32.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import packed_params as JP
from repro.models import moe as JM
from repro.models import transformer as JT
from repro.models.registry import get_config as j_get_config
from repro.serving import Engine as JEngine
from repro.serving import ServeConfig as JServeConfig
from repro_torch.convert import params_from_numpy
from repro_torch.core import packed_params as TP
from repro_torch.models import moe as TM
from repro_torch.models import transformer as TT
from repro_torch.models.registry import get_config as t_get_config
from repro_torch.serving import Engine, ServeConfig

MOONSHOT, DBRX = "moonshot-v1-16b-a3b", "dbrx-132b"
PROMPTS = [[5, 17, 33, 2, 9], [40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50], [7, 8, 9]]
KW = dict(n_slots=2, max_len=32, prefill_chunk=4, max_new=6)
MOE_ATOL, AUX_ATOL, LOGIT_ATOL = 1e-5, 1e-6, 1e-4


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


def _configs(arch: str):
    return (dataclasses.replace(j_get_config(arch, smoke=True), dtype="float32"),
            dataclasses.replace(t_get_config(arch, smoke=True), dtype="float32"))


_WEIGHTS: dict = {}


def weights(arch: str):
    """(jcfg, tcfg, numpy tree, reference params, port params), built once."""
    if arch not in _WEIGHTS:
        jcfg, tcfg = _configs(arch)
        tree = numpy_params(jcfg)
        _WEIGHTS[arch] = (jcfg, tcfg, tree, jax.tree.map(jnp.asarray, tree),
                          params_from_numpy(tree, tcfg))
    return _WEIGHTS[arch]


def _moe_layer(arch: str, seed: int):
    jcfg, tcfg = _configs(arch)
    rng = np.random.default_rng(seed)
    e, d, f = jcfg.n_experts, jcfg.d_model, jcfg.d_ff
    tree = {"router": {"w": (rng.standard_normal((d, e)) * d**-0.5).astype(np.float32)},
            "up": (rng.standard_normal((e, d, f)) * d**-0.5).astype(np.float32),
            "gate": (rng.standard_normal((e, d, f)) * d**-0.5).astype(np.float32),
            "down": (rng.standard_normal((e, f, d)) * f**-0.5).astype(np.float32)}
    tparams = {"router": {"w": torch.from_numpy(tree["router"]["w"])},
               **{k: torch.from_numpy(tree[k]) for k in ("up", "gate", "down")}}
    return jcfg, tcfg, jax.tree.map(jnp.asarray, tree), tparams


@pytest.mark.parametrize("branch", ["capacity", "dropless"])
@pytest.mark.parametrize("arch", [MOONSHOT, DBRX])
def test_moe_ffn_matches_reference(arch, branch):
    jcfg, tcfg, jparams, tparams = _moe_layer(arch, 1)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 7, jcfg.d_model)).astype(np.float32)
    valid = None
    if branch == "dropless":
        valid = np.ones((3, 7), bool)
        valid[1, 4:] = False
        valid[2] = False
    if branch == "capacity":  # the rank rule must drop something here
        t, k, e = 21, jcfg.experts_per_token, jcfg.n_experts
        assert int(t * k / e * jcfg.capacity_factor) < t * k
    jout, jaux = JM.moe_ffn(jparams, jnp.asarray(x), jcfg, None,
                            None if valid is None else jnp.asarray(valid))
    reads = TM.HOST_READS["count"]
    tout, taux = TM.moe_ffn(tparams, torch.from_numpy(x), tcfg, None,
                            None if valid is None else torch.from_numpy(valid))
    assert TM.HOST_READS["count"] == reads + 1  # one row-count read per layer
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=0, atol=MOE_ATOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=0, atol=AUX_ATOL)
    if valid is not None:
        assert not tout.numpy()[~valid].any()  # padding rows produce zeros


def test_padding_lanes_leave_real_tokens_unchanged():
    _, tcfg, _, tparams = _moe_layer(MOONSHOT, 3)
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((4, 5, tcfg.d_model)).astype(np.float32))
    valid = torch.ones((4, 5), dtype=torch.bool)
    valid[0, 3:] = False
    valid[3] = False
    base, _ = TM.moe_ffn(tparams, x, tcfg, None, valid)
    noisy = torch.where(valid[..., None], x, 100 * torch.randn_like(x))
    again, _ = TM.moe_ffn(tparams, noisy, tcfg, None, valid)
    torch.testing.assert_close(again[valid], base[valid], rtol=0, atol=0)
    alone, _ = TM.moe_ffn(tparams, x[1:2], tcfg, None, valid[1:2])
    torch.testing.assert_close(alone[0], base[1], rtol=0, atol=1e-6)


@pytest.mark.parametrize("arch", [MOONSHOT, DBRX])
def test_split_expert_stacks_and_paths_match_reference(arch):
    jcfg, _, _, jparams, tparams = weights(arch)
    jsplit = JP.split_expert_stacks(jparams)
    tsplit = TP.split_expert_stacks(tparams)
    want = {(p, tuple(leaf.shape[1:]) if p.startswith("/groups") else tuple(leaf.shape))
            for p, leaf in JP.iter_packable_weights(jsplit)}
    got = {(p, tuple(leaf.shape)) for p, leaf in TP.iter_packable_weights(tsplit)}
    assert got == want
    assert any("/moe/up/e" in p for p, _ in got)
    # idempotent, and the split shares the stack's storage
    again = TP.split_expert_stacks(tsplit)
    assert again["groups"][0]["moe"]["up"].keys() == tsplit["groups"][0]["moe"]["up"].keys()
    e0 = tsplit["groups"][0]["moe"]["up"]["e0"]
    assert e0.data_ptr() == tparams["groups"][0]["moe"]["up"].data_ptr()
    # quantizing modes split; native and none do not
    for mode in ("int8", "dsp_packed"):
        assert isinstance(TP.quantize_for_serving(tparams, mode)["groups"][0]["moe"]["up"],
                          dict)
    for mode in ("native", "none"):
        assert TP.quantize_for_serving(tparams, mode) is tparams


@pytest.mark.parametrize("arch", [MOONSHOT, DBRX])
def test_params_from_numpy_carries_the_moe_tree(arch):
    jcfg, tcfg, tree, _, tparams = weights(arch)
    assert len(tparams["groups"]) == jcfg.n_layers
    for i, layer in enumerate(tparams["groups"]):
        moe = layer["moe"]
        assert moe["router"]["w"].shape == (tcfg.d_model, tcfg.n_experts)
        np.testing.assert_array_equal(moe["router"]["w"].numpy(),
                                      tree["groups"]["moe"]["router"]["w"][i])
        for name in ("up", "gate", "down"):
            np.testing.assert_array_equal(moe[name].numpy(),
                                          tree["groups"]["moe"][name][i])
    assert tparams["groups"][0]["moe"]["down"].shape == (
        tcfg.n_experts, tcfg.d_ff, tcfg.d_model)


def test_dbrx_forward_logits_match_reference():
    jcfg, tcfg, _, jparams, tparams = weights(DBRX)
    rng = np.random.default_rng(5)
    tokens = rng.integers(2, jcfg.vocab_size, size=(2, 9))
    valid = np.ones((2, 9), bool)
    valid[1, 6:] = False
    for v in (None, valid):
        jl, _, jaux = JT.forward(jparams, jcfg, jnp.asarray(tokens),
                                 valid=None if v is None else jnp.asarray(v))
        tl, _, taux = TT.forward(tparams, tcfg, torch.from_numpy(tokens),
                                 valid=None if v is None else torch.from_numpy(v))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=LOGIT_ATOL)
        np.testing.assert_allclose(float(taux), float(jaux), rtol=0, atol=AUX_ATOL)


@pytest.mark.parametrize("mode", ["native", "int8", "int4_packed", "dsp_tuned",
                                  "dsp_packed"])
def test_moonshot_greedy_tokens_identical_to_reference_engine(mode):
    jcfg, tcfg, _, jparams, tparams = weights(MOONSHOT)
    want = JEngine(jcfg, jparams, JServeConfig(quant_mode=mode, **KW)).generate(PROMPTS)
    eng = Engine(tcfg, tparams, ServeConfig(device="cpu", quant_mode=mode, **KW))
    assert eng.generate(PROMPTS) == want
    if mode not in ("native",):
        experts = eng.params["groups"][0]["moe"]["up"]
        assert isinstance(experts, dict) and len(experts) == tcfg.n_experts
