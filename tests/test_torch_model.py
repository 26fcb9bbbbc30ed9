"""Port parity: parameters, packed serving weights and the dense forward
pass of ``repro_torch`` against the JAX reference, at the ``qwen1.5-110b``
smoke config in float32.

Weights are made once as seeded numpy arrays in the reference's layout,
handed to both packages (the port through ``params_from_numpy``), and
quantized by both: the packed payloads must be bit-exact.  Logits are compared with
a stated tolerance:

* ``native``: atol 1e-5 — XLA's and torch's float32 sums (matmuls, the
  norm's reduction, softmax) round in different orders at the ulp.
* quantized modes: the integer arithmetic is bit-exact, but those ulp
  differences reach the activations a layer quantizes, and one of them can
  land on a rounding boundary and flip a quantized activation by one step.
  On these inputs the largest difference measured was 2.9e-6 (native) and
  1.5e-6 (quantized modes); the bound is atol 1e-4.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.packed_params import iter_packable_weights as j_iter
from repro.core.packed_params import quantize_for_serving as j_quantize
from repro.kernels.ref import PackedDotSpec as JSpec
from repro.models import transformer as JT
from repro.models.registry import get_config as j_get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.packed_params import (
    iter_packable_weights,
    quantize_for_serving as t_quantize,
)
from repro_torch.kernels.ref import spec_from_name
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.models.registry import get_config as t_get_config

ARCH = "qwen1.5-110b"
PLANS = ("a4w4-p10-n32-mr+full-c2", "a4w4-p11-n16-full-c2")
ATOL = {"native": 1e-5, "int4_packed": 1e-4, "dsp_tuned": 1e-4,
        "dsp_packed": 1e-4}


def numpy_params(jcfg, seed: int = 0) -> dict:
    """Seeded numpy weights in the reference's parameter layout (read off
    ``jax.eval_shape`` of its ``init_params``): N(0, 1/d_in) matrices,
    N(0, 0.02**2) embeddings, norm scales and biases drawn around 1 and 0."""
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
def setup():
    jcfg = dataclasses.replace(j_get_config(ARCH, smoke=True), dtype="float32")
    tcfg = dataclasses.replace(t_get_config(ARCH, smoke=True), dtype="float32")
    np_tree = numpy_params(jcfg)
    jparams = jax.tree.map(jnp.asarray, np_tree)
    tparams = params_from_numpy(np_tree, tcfg)
    return jcfg, tcfg, jparams, np_tree, tparams


def _walk(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, f"{path}/{k}")
    else:
        yield path, tree


def _get(tree, path):
    for k in path.strip("/").split("/"):
        tree = tree[k]
    return tree


def test_params_from_numpy_round_trips(setup):
    jcfg, tcfg, _, np_tree, tparams = setup
    assert len(tparams["groups"]) == tcfg.n_layers
    for path, leaf in _walk(np_tree):
        if path.startswith("/groups/"):
            sub = path[len("/groups"):]
            back = np.stack([_get(g, sub).numpy() for g in tparams["groups"]])
        else:
            back = _get(tparams, path).numpy()
        np.testing.assert_array_equal(back, leaf)
    with pytest.raises(ValueError, match="stack"):
        params_from_numpy(np_tree, dataclasses.replace(tcfg, n_layers=3))


def test_packable_paths_match_reference(setup):
    _, _, jparams, _, tparams = setup
    j_paths = [p for p, _ in j_iter(jparams)]
    t_paths = list(dict.fromkeys(p for p, _ in iter_packable_weights(tparams)))
    assert sorted(t_paths) == sorted(j_paths)


def _per_layer(jleaf, i, path):
    return np.asarray(jleaf[i]) if path.startswith("/groups/") else np.asarray(jleaf)


def test_int4_packed_payloads_bit_exact(setup):
    _, _, jparams, _, tparams = setup
    _, _, _, jq, tq = _quantized(setup, "int4_packed")
    for path, _ in iter_packable_weights(tparams):
        jleaf = _get(jq, path)
        layers = tq["groups"] if path.startswith("/groups/") else [tq]
        sub = path[len("/groups"):] if path.startswith("/groups/") else path
        for i, tree in enumerate(layers):
            tleaf = _get(tree, sub)
            for name in ("packed", "scale", "w_f32"):
                np.testing.assert_array_equal(
                    tleaf[name].numpy(), _per_layer(jleaf[name], i, path))


@pytest.mark.parametrize("plan", PLANS)
def test_dsp_tuned_payloads_bit_exact(setup, plan):
    _, _, _, jq, tq = _quantized(setup, "dsp_tuned", plan)
    tspec = spec_from_name(plan)
    for path, _ in iter_packable_weights(tq):
        jleaf = _get(jq, path)
        layers = tq["groups"] if path.startswith("/groups/") else [tq]
        sub = path[len("/groups"):] if path.startswith("/groups/") else path
        for i, tree in enumerate(layers):
            tleaf = _get(tree, sub)
            assert tleaf.spec == tspec
            for name in ("payload", "scale", "words", "wsc", "zp_row"):
                jv, tv = getattr(jleaf, name), getattr(tleaf, name)
                if jv is None:
                    assert tv is None, name
                    continue
                np.testing.assert_array_equal(tv.numpy(), _per_layer(jv, i, path))


_QUANTIZED: dict = {}


def _quantized(setup, mode, plan=PLANS[0]):
    """(jax cfg, port cfg, jax params, port params) served in ``mode`` with
    use_kernel=False; the reference runs eagerly (see the module docstring
    of test_torch_kernels) and each tree is built once per module."""
    jcfg, tcfg, jparams, _, tparams = setup
    jcfg = dataclasses.replace(jcfg, quant=dataclasses.replace(
        jcfg.quant, mode=mode, use_kernel=False))
    tcfg = dataclasses.replace(tcfg, quant=dataclasses.replace(
        tcfg.quant, mode=mode, use_kernel=False))
    if mode in ("native", "dsp_packed"):
        return jcfg, tcfg, jparams, jparams, tparams
    key = (id(tparams), mode, plan)
    if key not in _QUANTIZED:
        tplans = jplans = None
        if mode == "dsp_tuned":
            tspec = spec_from_name(plan)
            jspec = JSpec(**dataclasses.asdict(tspec))
            paths = [p for p, _ in iter_packable_weights(tparams)]
            tplans = dict.fromkeys(paths, tspec)
            jplans = dict.fromkeys(paths, jspec)
        _QUANTIZED[key] = (j_quantize(jparams, mode, plans=jplans),
                           t_quantize(tparams, mode, plans=tplans, use_kernel=False))
    return (jcfg, tcfg, jparams) + _QUANTIZED[key]


@pytest.mark.parametrize("mode", ["native", "int4_packed", "dsp_tuned", "dsp_packed"])
def test_chunked_prefill_and_cached_decode_logits(setup, mode):
    """The port's cached chunked prefill of a prompt, then one cached decode
    step, against the reference's full-context ``T.forward`` over the
    prompt plus the decoded token (and the port's own full-context pass)."""
    jcfg, tcfg, _, jp, tp = _quantized(setup, mode)
    rng = np.random.default_rng(7)
    b, s, window = 2, 6, 16
    tokens = rng.integers(2, jcfg.vocab_size, size=(b, s + 1)).astype(np.int32)
    want, _, _ = jax.jit(JT.forward, static_argnums=1)(jp, jcfg, tokens)
    want = np.asarray(want)
    tt = torch.from_numpy(tokens).long()
    pos = torch.arange(s + 1)[None].expand(b, s + 1)
    cache = TT.init_cache(tcfg, b, window, device="cpu")
    prefill, cache, _ = TT.forward(tp, tcfg, tt[:, :s], positions=pos[:, :s],
                                   cache=cache)
    decode, _, _ = TT.forward(tp, tcfg, tt[:, s:], positions=pos[:, s:],
                              cache=cache)
    full, _, _ = TT.forward(tp, tcfg, tt)
    for got, ref in ((prefill, want[:, :s]), (decode, want[:, s:]), (full, want)):
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=ATOL[mode])


def test_other_families_raise():
    """Every family builds now; what still raises is the paged attention
    branch of the continuous engine's cache (ROADMAP queue 9)."""
    cfg = t_get_config("xlstm-1.3b", smoke=True)
    params = TT.init_params(cfg, device="cpu")
    assert len(params["groups"]) == cfg.n_groups
    dense = t_get_config("qwen1.5-110b", smoke=True)
    x = torch.zeros((1, 1, dense.d_model))
    attn = TT.init_params(dense, device="cpu")["groups"][0]["attn"]
    pages = {"pages_k": torch.zeros(1), "pages_v": torch.zeros(1)}
    with pytest.raises(NotImplementedError, match="queue 9"):
        TL.attention(attn, x, dense, torch.zeros((1, 1), dtype=torch.long), cache=pages)
