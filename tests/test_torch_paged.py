"""Port parity: the paged KV cache of the continuous engine.

* ``PageAllocator`` (host code, copied): the reference's own cases
  (``tests/test_paged_cache.py``) run against the port's class and
  ``OutOfPages``, one parametrised case each.
* The paged branch of ``layers.attention``: rows at different depths,
  lanes masked by the sentinel, pages allocated out of order, decode and
  chunked prefill; within ``atol 1e-5`` (f32) of the dense-cache branch
  on the same K/V history and of the reference's paged branch, its pools
  equal to the reference's.  Sentinel writes and gathers neither raise
  nor touch a live page.  The sliding window's ring pages (h2o-danube)
  over a wrap, against the reference.
* ``transformer.init_paged_cache`` per family (dense, sliding window,
  ssm, hybrid): the reference's leaves, shapes and values, in the port's
  per-group layout.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import test_paged_cache as reference_cases
import torch

from repro.models import layers as JL
from repro.models import transformer as JT
from repro.models.registry import get_config as j_get_config
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.models.registry import get_config as t_get_config
from repro_torch.serving import OutOfPages, PageAllocator

ATOL = 1e-5  # f32 attention: the two branches differ by summation order only
ALLOCATOR_CASES = sorted(n for n in dir(reference_cases) if n.startswith("test_"))


@pytest.mark.parametrize("case", ALLOCATOR_CASES)
def test_page_allocator_reference_cases(case, monkeypatch):
    monkeypatch.setattr(reference_cases, "PageAllocator", PageAllocator)
    monkeypatch.setattr(reference_cases, "OutOfPages", OutOfPages)
    getattr(reference_cases, case)()


# ---- the paged attention branch ---------------------------------------------


def _configs(arch: str):
    return (dataclasses.replace(j_get_config(arch, smoke=True), dtype="float32"),
            dataclasses.replace(t_get_config(arch, smoke=True), dtype="float32"))


def _attention(arch: str, seed: int):
    jcfg, tcfg = _configs(arch)
    jp = JL.init_attention(jax.random.PRNGKey(seed), jcfg)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    return jcfg, tcfg, jp, tp


def _reference_attention(jcfg):
    """The reference's attention jitted for one config (an eager call per
    step costs seconds over the steps below)."""
    return jax.jit(lambda p, x, pos, cache, table: JL.attention(
        p, x, jcfg, pos, cache=cache, page_table=table))


def _pools(tcfg, n_pages, ps):
    return TL.init_paged_kv_cache(tcfg, n_pages, ps, torch.float32, torch.device("cpu"))


def test_paged_attention_matches_dense_and_reference():
    """Two lanes at different depths on pages given out of order (lane 0:
    pages 5, 1, 6; lane 1: 0, 3, 4), a third lane on the sentinel throughout;
    a 6-token chunk, then decode steps.  Each output within ``ATOL`` of
    the dense cache's and of the reference's paged branch; pages no table
    names stay zero."""
    jcfg, tcfg, jp, tp = _attention("qwen1.5-110b", 1)
    ps, n_pages, max_blocks = 4, 8, 3
    invalid = n_pages
    table = np.array([[5, 1, 6], [0, 3, 4], [invalid] * 3], np.int32)
    rng = np.random.default_rng(2)
    tpages = _pools(tcfg, n_pages, ps)
    jpages = JL.init_paged_kv_cache(jcfg, n_pages, ps, jnp.float32)
    dense = TL.init_kv_cache(tcfg, 3, max_blocks * ps, torch.float32, torch.device("cpu"))
    start = np.array([0, 2, 0])
    ref = _reference_attention(jcfg)
    for s in (6, 1, 1, 1):
        x = rng.standard_normal((3, s, jcfg.d_model)).astype(np.float32)
        pos = start[:, None] + np.arange(s)[None]
        got, tpages = TL.attention(tp, torch.from_numpy(x), tcfg, torch.from_numpy(pos),
                                   cache=tpages, page_table=torch.from_numpy(table))
        want, jpages = ref(jp, jnp.asarray(x), jnp.asarray(pos), jpages,
                           jnp.asarray(table))
        dense_out, dense = TL.attention(tp, torch.from_numpy(x), tcfg,
                                        torch.from_numpy(pos), cache=dense)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
        # the masked lane attends over junk only (every key masked), which
        # the engines never read; the dense cache holds its own history
        np.testing.assert_allclose(got[:2].numpy(), dense_out[:2].numpy(), rtol=0, atol=ATOL)
        assert torch.isfinite(got).all()
        start = start + s
    for name in ("pages_k", "pages_v"):
        np.testing.assert_allclose(tpages[name].numpy(), np.asarray(jpages[name]),
                                   rtol=0, atol=ATOL)
        untouched = sorted(set(range(n_pages)) - set(table[table < n_pages].tolist()))
        assert untouched == [2, 7]
        assert not tpages[name][untouched].any()


def test_sentinel_writes_and_gathers_never_reach_a_live_page():
    """A position past the table's blocks and a lane all on the sentinel:
    no raise, and the pools come back exactly as they went in (every page
    live and filled)."""
    _, tcfg, _, tp = _attention("qwen1.5-110b", 3)
    ps, n_pages = 4, 4
    gen = torch.Generator().manual_seed(0)
    pages = {k: torch.randn((n_pages, ps, tcfg.n_kv_heads, tcfg.hd), generator=gen)
             for k in ("pages_k", "pages_v")}
    table = torch.tensor([[0, 1], [n_pages, n_pages]], dtype=torch.int32)
    x = torch.randn((2, 1, tcfg.d_model), generator=gen)
    pos = torch.tensor([[8], [3]])  # lane 0 at block 2 of a 2-block table
    out, new = TL.attention(tp, x, tcfg, pos, cache=pages, page_table=table)
    assert torch.isfinite(out).all()
    for k in pages:
        assert torch.equal(new[k], pages[k])


def test_paged_ring_matches_reference_over_a_wrap():
    """h2o-danube's 32-token window paged as a ring (8 pages of 4 a lane):
    24 single-token steps from positions 20 and 25, so both lanes wrap."""
    jcfg, tcfg, jp, tp = _attention("h2o-danube-3-4b", 4)
    ps, b = 4, 2
    blocks = jcfg.sliding_window // ps
    table = np.arange(b * blocks, dtype=np.int32).reshape(b, blocks)[:, ::-1].copy()
    tpages = _pools(tcfg, b * blocks, ps)
    jpages = JL.init_paged_kv_cache(jcfg, b * blocks, ps, jnp.float32)
    rng = np.random.default_rng(5)
    ref = _reference_attention(jcfg)
    for t in range(20, 44):
        x = rng.standard_normal((b, 1, jcfg.d_model)).astype(np.float32)
        pos = np.array([[t], [t + 5]])
        got, tpages = TL.attention(tp, torch.from_numpy(x), tcfg, torch.from_numpy(pos),
                                   cache=tpages, page_table=torch.from_numpy(table))
        want, jpages = ref(jp, jnp.asarray(x), jnp.asarray(pos), jpages, jnp.asarray(table))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


def test_paged_cache_needs_a_page_table():
    _, tcfg, _, tp = _attention("qwen1.5-110b", 6)
    with pytest.raises(ValueError, match="page_table"):
        TL.attention(tp, torch.zeros((1, 1, tcfg.d_model)), tcfg,
                     torch.zeros((1, 1), dtype=torch.long), cache=_pools(tcfg, 2, 4))


# ---- init_paged_cache -------------------------------------------------------


def _restack(items):
    """Same-structured port trees stacked into one numpy tree: a cache's
    list of groups (and each inner list of a recurrent stack) becomes the
    reference's leading axis."""
    first = items[0]
    if isinstance(first, dict):
        return {k: _restack([it[k] for it in items]) for k in first}
    if isinstance(first, list):
        return _restack([_restack(it) for it in items])
    return np.stack([np.asarray(it) for it in items])


@pytest.mark.parametrize("arch", ["qwen1.5-110b", "h2o-danube-3-4b", "xlstm-1.3b",
                                  "jamba-v0.1-52b"])
def test_init_paged_cache_matches_reference(arch):
    jcfg, tcfg = _configs(arch)
    want = JT.init_paged_cache(jcfg, 6, 4, batch=3)
    got = _restack(TT.init_paged_cache(tcfg, 6, 4, batch=3, device="cpu"))
    flat_want = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_got = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert len(flat_got) == len(flat_want)
    for path, leaf in flat_want:
        np.testing.assert_array_equal(flat_got[path], np.asarray(leaf), err_msg=str(path))
    if jcfg.family in ("ssm", "hybrid"):
        with pytest.raises(ValueError, match="batch"):
            TT.init_paged_cache(tcfg, 6, 4, device="cpu")
