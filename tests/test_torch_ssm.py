"""Port parity: the recurrent mixers (``repro_torch.models.ssm``) against the
reference's ``repro.models.ssm``, and the port's chunking invariant.

* Mamba (jamba smoke), mLSTM and sLSTM (xlstm smoke), f32, with the
  reference's own ``init_*`` weights carried across: the eager branch
  (``valid=None``, the chunked scan; also over two chunks of ``CHUNK``
  tokens) and the per-token branch (``valid`` a per-row prefix mask, one
  row all padding), each with and without a cache, outputs and new cache
  within ``rtol 1e-4, atol 1e-5`` (over two chunks ``atol 1e-4``: mLSTM's
  256-term sums, weighted by exponentials, round apart by up to 3.2e-5 on
  these inputs, in 18 of 32768 outputs).  Mamba's in-chunk scan is a sequential
  recurrence in the port and ``lax.associative_scan`` in the reference, so
  the eager branch cannot agree bitwise.
* The chunking invariant, in the port: an engine's recurrent state after a
  prefill in chunks of C tokens equals the state after C chunk-1 steps,
  bitwise under ``int4_packed`` and within ``rtol 1e-5, atol 1e-5`` under
  ``native`` (xlstm and jamba smoke).  In jamba the bitwise claim holds up
  to its attention slot: attention is plain float, and its sums over a
  chunk of C queries round apart from C single queries at the ulp, so the
  Mamba layers after it agree within the native tolerance (measured:
  7.2e-7 at most).  The reference's own test of this fails on JAX 0.9.0,
  so the port is held to itself here.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as JS
from repro.models.registry import get_config as j_get_config
from repro_torch.models import ssm as TS
from repro_torch.models import transformer as TT
from repro_torch.models.registry import get_config as t_get_config
from repro_torch.serving import Engine, ServeConfig

RTOL, ATOL = 1e-4, 1e-5
LONG_ATOL = 1e-4  # two chunks of CHUNK tokens
NATIVE_RTOL, NATIVE_ATOL = 1e-5, 1e-5
MIXERS = {"mamba": "jamba-v0.1-52b", "mlstm": "xlstm-1.3b", "slstm": "xlstm-1.3b"}


def _configs(arch: str):
    return (dataclasses.replace(j_get_config(arch, smoke=True), dtype="float32"),
            dataclasses.replace(t_get_config(arch, smoke=True), dtype="float32"))


def _torch(tree):
    return {k: _torch(v) if isinstance(v, dict) else torch.from_numpy(np.array(v))
            for k, v in tree.items()}


def _mixer(kind: str, seed: int):
    jcfg, tcfg = _configs(MIXERS[kind])
    jparams = getattr(JS, f"init_{kind}")(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tcfg, jparams, _torch(jparams)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("cached", [False, True], ids=["nocache", "cache"])
@pytest.mark.parametrize("branch", ["eager", "valid"])
@pytest.mark.parametrize("kind", list(MIXERS))
def test_mixer_matches_reference(kind, branch, cached):
    jcfg, tcfg, jparams, tparams = _mixer(kind, 1)
    jfn, tfn = getattr(JS, kind), getattr(TS, kind)
    rng = np.random.default_rng(2)
    x = (0.5 * rng.standard_normal((3, 7, jcfg.d_model))).astype(np.float32)
    jcache = tcache = None
    if cached:  # a state reached on a prefix, carried into both
        warm = (0.5 * rng.standard_normal((3, 5, jcfg.d_model))).astype(np.float32)
        init = getattr(JS, f"init_{kind}_cache")(jcfg, 3)
        _, jcache = jfn(jparams, jnp.asarray(warm), jcfg, cache=init)
        tcache = _torch(jcache)
    valid = None
    if branch == "valid":
        valid = np.zeros((3, 7), bool)
        valid[0], valid[1, :4] = True, True  # row 2 is all padding
    jout, jnew = jfn(jparams, jnp.asarray(x), jcfg, cache=jcache,
                     valid=None if valid is None else jnp.asarray(valid))
    tout, tnew = tfn(tparams, torch.from_numpy(x), tcfg, cache=tcache,
                     valid=None if valid is None else torch.from_numpy(valid))
    _close(tout, jout)
    if cached:
        assert tnew.keys() == jnew.keys()
        for name in jnew:
            assert tnew[name].dtype == torch.float32
            _close(tnew[name], jnew[name])
        if valid is not None:  # the all-padding row keeps its state exactly
            for name in jnew:
                torch.testing.assert_close(tnew[name][2], tcache[name][2], rtol=0, atol=0)
    else:
        assert tnew is None and jnew is None


@pytest.mark.parametrize("kind", ["mamba", "mlstm"])
def test_eager_scan_over_two_chunks(kind):
    jcfg, tcfg, jparams, tparams = _mixer(kind, 3)
    x = (0.5 * np.random.default_rng(4).standard_normal((1, 2 * TS.CHUNK, jcfg.d_model))
         ).astype(np.float32)
    init = getattr(JS, f"init_{kind}_cache")(jcfg, 1)
    jout, jnew = getattr(JS, kind)(jparams, jnp.asarray(x), jcfg, cache=init)
    tout, tnew = getattr(TS, kind)(tparams, torch.from_numpy(x), tcfg, cache=_torch(init))
    _close(tout, jout, atol=LONG_ATOL)
    for name in jnew:
        _close(tnew[name], jnew[name], atol=LONG_ATOL)


def test_cache_layouts_and_softplus():
    """f32 recurrent state whatever the compute dtype (sLSTM's m starts at
    -30), mLSTM's head width d_model // n_heads, f32 a_log and d_skip; and
    softplus is logaddexp(x, 0) past F.softplus's threshold."""
    cfg = t_get_config("xlstm-1.3b", smoke=True)
    assert cfg.dtype == "bfloat16"
    cache = TT.init_cache(cfg, 2, 16, device="cpu")
    assert all(t.dtype == torch.float32 for g in cache for t in
               [*g["slstm"].values(), *(v for m in g["mlstm"] for v in m.values())])
    assert bool((cache[0]["slstm"]["m"] == -30).all())
    assert cache[0]["mlstm"][0]["c"].shape == (2, cfg.n_heads, 32, 32)
    jamba = t_get_config("jamba-v0.1-52b", smoke=True)
    p = TT.init_params(jamba, dtype=torch.bfloat16, device="cpu")
    mam = p["groups"][0]["mamba"][0]
    assert mam["a_log"].dtype == mam["d_skip"].dtype == torch.float32
    assert mam["in_proj"]["w"].dtype == torch.bfloat16
    x = torch.tensor([-40.0, -1.0, 0.0, 21.0, 60.0])
    np.testing.assert_array_equal(TS._softplus(x).numpy(),
                                  np.asarray(jax.nn.softplus(jnp.asarray(x.numpy()))))


def _recurrent_state(eng: Engine, slot: int) -> list[torch.Tensor]:
    leaves = []

    def walk(tree):
        if isinstance(tree, dict):
            for k, v in tree.items():
                if k != "attn":
                    walk(v)
        elif isinstance(tree, list):
            for v in tree:
                walk(v)
        else:
            leaves.append(tree[slot])

    walk(eng.cache)
    return leaves


@pytest.mark.parametrize("mode", ["int4_packed", "native"])
@pytest.mark.parametrize("arch", ["xlstm-1.3b", "jamba-v0.1-52b"])
def test_chunked_prefill_state_equals_chunk1_steps(arch, mode):
    _, tcfg = _configs(arch)
    params = TT.init_params(tcfg, seed=0, device="cpu")
    prompt = list(range(5, 16))  # 11 tokens: chunks of 4 leave a ragged tail
    states, first = [], []
    for chunk in (4, 1):
        eng = Engine(tcfg, params, ServeConfig(device="cpu", quant_mode=mode, n_slots=2,
                                               max_len=32, prefill_chunk=chunk, max_new=4))
        eng.submit([7, 8, 9])   # slot 0, prefilled alone
        eng.submit(prompt)      # slot 1
        states.append(_recurrent_state(eng, 1))
        first.append(int(eng.last_token[1]))
    assert first[0] == first[1]
    # jamba: the Mamba slots before its attention slot (conv and h each)
    bitwise = len(states[0]) if tcfg.family == "ssm" else 2 * (tcfg.group_size // 2)
    for i, (got, want) in enumerate(zip(*states)):
        if mode == "int4_packed" and i < bitwise:
            torch.testing.assert_close(got, want, rtol=0, atol=0)
        else:
            torch.testing.assert_close(got, want, rtol=NATIVE_RTOL, atol=NATIVE_ATOL)
