"""Port parity: the five families the port serves since the last slice
(ssm ``xlstm-1.3b``, hybrid ``jamba-v0.1-52b``, encdec ``whisper-large-v3``,
vlm ``llava-next-mistral-7b``, dense with a sliding window
``h2o-danube-3-4b``) against the reference, at their smoke configs in f32
with the reference's ``jax.random`` parameters carried across by
``params_from_numpy``.

* Attention: the sliding window's causal mask (plain and chunked online
  softmax) and its ring cache over a wrap, with rows at different
  positions; cross-attention from ``kv_x`` and the engine's chunk-local
  form (``kv_x=None``, not causal); ``atol 1e-5``.
* ``params_from_numpy`` splits the groups and the inner stacks (restacked,
  the reference's arrays come back exactly); the packable paths and their
  shapes equal the reference's ``iter_packable_weights`` (experts split);
  ``forward`` logits within ``atol 1e-4`` (whisper with and without an
  encoder output, ``encode`` within ``atol 1e-5``; llava with patch
  embeddings; the recurrent families with and without ``valid``).
* Greedy tokens of the port's ``Engine`` equal the reference ``Engine``'s
  at the same ``ServeConfig`` in ``native``, ``int4_packed`` and
  ``dsp_tuned``, and ``dsp_mixed`` for xlstm (the port's sensitivity pass
  and allocation, carried to the reference engine as the plan database's
  JSON); h2o-danube's fourth prompt wraps its 32-token window.  The
  reference's jitted quantizers multiply by the reciprocal of ``qmax``
  where the port divides (ROADMAP §3, settled), so an activation at a
  rounding boundary can quantize one step apart: where the jitted
  reference's tokens differ, the port's must equal the reference engine's
  run eagerly (``jax.disable_jit``) on those prompts (requests are
  independent rows).  On this tree that happens for h2o-danube under
  ``int4_packed`` (the 11-token prompt, second token).
* The ``dsp_tuned`` plan tables of xlstm and jamba equal the reference
  engine's, path by path, and jamba's experts serve ``INT4_EXACT`` in both.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import packed_params as JP
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.models.registry import get_config as j_get_config
from repro.serving import Engine as JEngine
from repro.serving import ServeConfig as JServeConfig
from repro.tuning import plandb as jdb
from repro_torch.convert import params_from_numpy
from repro_torch.core import packed_params as TP
from repro_torch.kernels.ref import INT4_EXACT
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.models.registry import get_config as t_get_config
from repro_torch.serving import Engine, ServeConfig
from repro_torch.tuning import plandb as tdb

XLSTM, JAMBA, WHISPER = "xlstm-1.3b", "jamba-v0.1-52b", "whisper-large-v3"
LLAVA, H2O = "llava-next-mistral-7b", "h2o-danube-3-4b"
ARCHS = (XLSTM, JAMBA, WHISPER, LLAVA, H2O)
ATTN_ATOL, LOGIT_ATOL, ENCODE_ATOL = 1e-5, 1e-4, 1e-5
KW = dict(n_slots=2, max_len=48, prefill_chunk=4, max_new=6)
PROMPTS = [[5, 17, 33, 2, 9], list(range(40, 51)), [7, 8, 9]]
# h2o-danube: 30 prompt tokens and 6 new ones cross its 32-token window
WRAP_PROMPT = [int(t) for t in np.random.default_rng(7).integers(2, 256, 30)]
MIXED_KW = dict(width_candidates=((4, 4), (8, 8)), calib_tokens=8)
TOKEN_CASES = [(a, m) for a in ARCHS for m in ("native", "int4_packed", "dsp_tuned")]
TOKEN_CASES.append((XLSTM, "dsp_mixed"))


def _configs(arch: str):
    return (dataclasses.replace(j_get_config(arch, smoke=True), dtype="float32"),
            dataclasses.replace(t_get_config(arch, smoke=True), dtype="float32"))


@functools.lru_cache(maxsize=None)
def weights(arch: str):
    """(jcfg, tcfg, numpy tree, reference params, port params), built once."""
    jcfg, tcfg = _configs(arch)
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.array, jparams)  # writable copies
    return jcfg, tcfg, tree, jparams, params_from_numpy(tree, tcfg)


def _prompts(arch: str) -> list[list[int]]:
    return PROMPTS + [WRAP_PROMPT] if arch == H2O else PROMPTS


def _reference_tokens(arch: str, mode: str, prompts, allocation=None,
                      eager: bool = False) -> list[list[int]]:
    """Greedy tokens of a reference engine at the tests' ``ServeConfig``,
    per prompt; ``eager`` runs it under ``jax.disable_jit``."""
    jcfg, _, _, jparams, _ = weights(arch)
    extra = MIXED_KW if mode == "dsp_mixed" else {}
    with jax.disable_jit() if eager else contextlib.nullcontext():
        eng = JEngine(jcfg, jparams, JServeConfig(quant_mode=mode, **KW, **extra),
                      mixed_allocation=allocation)
        return list(eng.generate([list(p) for p in prompts]).values())


def _torch(tree):
    return {k: _torch(v) if isinstance(v, dict) else torch.from_numpy(np.array(v))
            for k, v in tree.items()}


# ---- attention ---------------------------------------------------------------


def _attention_inputs(arch: str, seed: int, **replace):
    jcfg, tcfg = _configs(arch)
    jcfg, tcfg = (dataclasses.replace(c, **replace) for c in (jcfg, tcfg))
    jparams = JL.init_attention(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tcfg, jparams, _torch(jparams)


@pytest.mark.parametrize("chunk", [0, 8], ids=["plain", "chunked"])
def test_sliding_window_causal_mask_matches_reference(chunk):
    jcfg, tcfg, jp, tp = _attention_inputs(H2O, 1, attention_chunk=chunk)
    assert jcfg.sliding_window == 32
    x = np.random.default_rng(2).standard_normal((2, 48, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(48)[None], (2, 48))
    want, _ = JL.attention(jp, jnp.asarray(x), jcfg, jnp.asarray(pos))
    got, _ = TL.attention(tp, torch.from_numpy(x), tcfg, torch.from_numpy(pos.copy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATTN_ATOL)
    # the window matters here: a full causal mask gives another answer
    full, _ = TL.attention(tp, torch.from_numpy(x), dataclasses.replace(
        tcfg, sliding_window=None), torch.from_numpy(pos.copy()))
    assert (full - got).abs().max() > 1e-3


def test_sliding_window_ring_cache_over_a_wrap():
    jcfg, tcfg, jp, tp = _attention_inputs(H2O, 3)
    rng = np.random.default_rng(4)
    b, steps, window = 2, 44, 32
    jcache = JL.init_kv_cache(jcfg, b, 48, jnp.float32)
    tcache = TL.init_kv_cache(tcfg, b, 48, torch.float32, torch.device("cpu"))
    assert tcache["k"].shape[1] == jcache["k"].shape[1] == window
    for t in range(steps):
        x = rng.standard_normal((b, 1, jcfg.d_model)).astype(np.float32)
        pos = np.array([[t], [t + 5]])  # rows at different depths, both wrap
        want, jcache = JL.attention(jp, jnp.asarray(x), jcfg, jnp.asarray(pos), cache=jcache)
        got, tcache = TL.attention(tp, torch.from_numpy(x), tcfg, torch.from_numpy(pos),
                                   cache=tcache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATTN_ATOL)
    np.testing.assert_allclose(tcache["k"].numpy(), np.asarray(jcache["k"]), rtol=0,
                               atol=ATTN_ATOL)


@pytest.mark.parametrize("form", ["kv_x", "chunk_local"])
def test_cross_attention_matches_reference(form):
    jcfg, tcfg, jp, tp = _attention_inputs(WHISPER, 5)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 5, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(3, 8)[None], (2, 5)).copy()
    kv = rng.standard_normal((2, 9, jcfg.d_model)).astype(np.float32) if form == "kv_x" else None
    want, _ = JL.attention(jp, jnp.asarray(x), jcfg, jnp.asarray(pos), causal=False,
                           kv_x=None if kv is None else jnp.asarray(kv))
    got, _ = TL.attention(tp, torch.from_numpy(x), tcfg, torch.from_numpy(pos), causal=False,
                          kv_x=None if kv is None else torch.from_numpy(kv))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATTN_ATOL)
    if kv is not None:  # fused qkv is self-attention only
        fused = TP.fuse_projection_weights({"attn": tp})["attn"]
        with pytest.raises(ValueError, match="self-attention"):
            TL.attention(fused, torch.from_numpy(x), tcfg, torch.from_numpy(pos),
                         causal=False, kv_x=torch.from_numpy(kv))


# ---- trees and forwards ------------------------------------------------------


def _restack(tree):
    """The port's tree back in the reference's stacked layout (numpy)."""
    if isinstance(tree, list):
        items = [_restack(v) for v in tree]
        if isinstance(items[0], dict):
            return {k: _restack_items([it[k] for it in items]) for k in items[0]}
        return np.stack(items)
    if isinstance(tree, dict):
        return {k: _restack(v) for k, v in tree.items()}
    return tree.numpy()


def _restack_items(items):
    if isinstance(items[0], dict):
        return {k: _restack_items([it[k] for it in items]) for k in items[0]}
    return np.stack(items)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_numpy_and_packable_paths(arch):
    jcfg, tcfg, tree, jparams, tparams = weights(arch)
    assert len(tparams["groups"]) == tcfg.n_groups
    back = _restack(tparams)
    flat_want = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_got) == len(flat_want)
    for path, leaf in flat_want:
        np.testing.assert_array_equal(flat_got[path], leaf)
    want = {(p, tuple(v.shape[-2:])) for p, v in
            JP.iter_packable_weights(JP.split_expert_stacks(jparams))}
    got = {(p, tuple(v.shape)) for p, v in
           TP.iter_packable_weights(TP.split_expert_stacks(tparams))}
    assert got == want
    # and a fresh port tree has the reference's structure
    fresh = _restack(TT.init_params(tcfg, device="cpu"))
    assert (jax.tree_util.tree_structure(fresh) == jax.tree_util.tree_structure(tree))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_reference(arch):
    jcfg, tcfg, _, jparams, tparams = weights(arch)
    rng = np.random.default_rng(8)
    tokens = rng.integers(2, jcfg.vocab_size, size=(2, 9))
    valid = np.ones((2, 9), bool)
    valid[1, 6:] = False
    cases = [{}]
    if tcfg.family in ("ssm", "hybrid"):
        cases.append({"valid": valid})
    if tcfg.family == "encdec":
        frames = rng.standard_normal((2, jcfg.encoder_len, jcfg.d_model)).astype(np.float32)
        jenc = JT.encode(jparams, jcfg, jnp.asarray(frames))
        tenc = TT.encode(tparams, tcfg, torch.from_numpy(frames))
        np.testing.assert_allclose(tenc.numpy(), np.asarray(jenc), rtol=0, atol=ENCODE_ATOL)
        cases.append({"encoder_out": (jenc, tenc)})
    if tcfg.family == "vlm":
        pe = rng.standard_normal((2, jcfg.n_patches, jcfg.d_model)).astype(np.float32)
        cases.append({"patch_embeds": pe})
    for case in cases:
        jkw, tkw = {}, {}
        for k, v in case.items():
            j, t = v if isinstance(v, tuple) else (jnp.asarray(v), torch.from_numpy(v))
            jkw[k], tkw[k] = j, t
        jl, _, jaux = JT.forward(jparams, jcfg, jnp.asarray(tokens), **jkw)
        tl, _, taux = TT.forward(tparams, tcfg, torch.from_numpy(tokens), **tkw)
        assert tl.shape == jl.shape
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=LOGIT_ATOL)
        np.testing.assert_allclose(float(taux), float(jaux), rtol=0, atol=1e-6)


def test_model_veneer():
    _, tcfg, _, _, tparams = weights(LLAVA)
    model = TT.Model(tcfg)
    tokens = torch.tensor([[3, 4, 5]])
    got, _, _ = model(tparams, tokens)
    want, _, _ = TT.forward(tparams, tcfg, tokens)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert len(model.init_cache(2, 8, device="cpu")) == tcfg.n_groups
    assert len(model.init(device="cpu")["groups"]) == tcfg.n_groups


# ---- serving -----------------------------------------------------------------


@pytest.mark.parametrize("arch,mode", TOKEN_CASES, ids=[f"{a}-{m}" for a, m in TOKEN_CASES])
def test_greedy_tokens_identical_to_reference_engine(arch, mode):
    _, tcfg, _, _, tparams = weights(arch)
    extra = MIXED_KW if mode == "dsp_mixed" else {}
    eng = Engine(tcfg, tparams, ServeConfig(device="cpu", quant_mode=mode, **KW, **extra))
    prompts = _prompts(arch)
    got = list(eng.generate(prompts).values())
    assert all(len(t) == KW["max_new"] for t in got)
    allocation = None
    if mode == "dsp_mixed":  # the port's allocation, carried across as JSON
        blob = json.loads(json.dumps(tdb.allocation_to_json(eng.mixed_allocation)))
        allocation = jdb.allocation_from_json(blob)
    want = _reference_tokens(arch, mode, prompts, allocation)
    differ = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
    if differ:  # an activation one rounding step apart under jit
        assert mode != "native", (got, want)
        eager = _reference_tokens(arch, mode, [prompts[i] for i in differ], allocation,
                                  eager=True)
        assert [got[i] for i in differ] == eager


@pytest.mark.parametrize("arch", [XLSTM, JAMBA])
def test_dsp_tuned_plan_table_matches_reference(arch):
    _, tcfg, _, _, tparams = weights(arch)
    eng = Engine(tcfg, tparams, ServeConfig(device="cpu", quant_mode="dsp_tuned", **KW))
    jcfg, _, _, jparams, _ = weights(arch)
    jeng = JEngine(jcfg, jparams, JServeConfig(quant_mode="dsp_tuned", **KW))
    got = {p: r.name for p, r in eng.plan_table.items()}
    assert got == {p: r.name for p, r in jeng.plan_table.items()}
    if arch == JAMBA:  # the tuner plans the stacked expert path; experts serve INT4_EXACT
        assert "/groups/moe/up" in got
        leaf = eng.params["groups"][0]["moe"][1]["up"]["e3"]
        jleaf = jeng.params["groups"]["moe"]["up"]["e3"]
        assert leaf.spec == INT4_EXACT and jleaf.spec.name() == INT4_EXACT.name()


def test_fused_projections_serve_the_hybrid():
    """``fuse_projections="all"`` joins jamba's attention q|k|v (the inner
    stacks, lists, are left as they are); each output column stays
    bit-identical, so do the tokens."""
    _, tcfg, _, _, tparams = weights(JAMBA)
    toks = []
    for fuse in ("none", "all"):
        eng = Engine(tcfg, tparams, ServeConfig(device="cpu", quant_mode="int4_packed",
                                                fuse_projections=fuse, **KW))
        toks.append(eng.generate(PROMPTS))
    assert "wqkv" in eng.params["groups"][0]["attn"]
    assert toks[0] == toks[1]
