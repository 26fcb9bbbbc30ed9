"""Port parity: the training path's numpy and elementwise pieces against the
JAX reference on the CPU.

* ``compressed_grads``: bit-equal to the reference's (both divide by the
  per-leaf scale in IEEE f32, round half to even, clip to int8), over two
  steps of error feedback;
* the schedules: ``rtol 1e-6`` (``cos`` and ``pow`` of two libraries may
  differ by an ulp);
* ``clip_by_global_norm``: ``rtol 1e-6`` (the sum of squares in another
  order);
* ``SyntheticStream``: batches bit-equal, per host, through the prefetch
  thread and after ``load_state_dict``.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticStream as JStream
from repro.optim import schedule as JS
from repro.optim.adamw import clip_by_global_norm as j_clip
from repro.runtime.compression import compressed_grads as j_compress
from repro.runtime.compression import init_error_feedback as j_init_error
from repro_torch.data import DataConfig, SyntheticStream
from repro_torch.optim import adamw_init, clip_by_global_norm
from repro_torch.optim import schedule as TS
from repro_torch.runtime import compressed_grads, init_error_feedback


def grad_tree(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"a": {"w": (rng.standard_normal((24, 16)) * 1e-2).astype(np.float32)},
            "b": (rng.standard_normal((40,)) * 3).astype(np.float32),
            "c": {"scale": np.zeros((8,), np.float32)}}


def as_torch(tree):
    return {k: as_torch(v) if isinstance(v, dict) else torch.from_numpy(v.copy())
            for k, v in tree.items()}


def as_jax(tree):
    return {k: as_jax(v) if isinstance(v, dict) else jnp.asarray(v)
            for k, v in tree.items()}


def assert_tree_equal(got, want):
    for k, v in want.items():
        if isinstance(v, dict):
            assert_tree_equal(got[k], v)
        else:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)


def test_compressed_grads_bit_equal_with_error_feedback():
    jerr = j_init_error(as_jax(grad_tree(0)))
    terr = init_error_feedback(as_torch(grad_tree(0)))
    assert_tree_equal(terr, jerr)
    for step in range(2):
        g = grad_tree(step + 1)
        jg, jerr = j_compress(as_jax(g), jerr)
        tg, terr = compressed_grads(as_torch(g), terr)
        assert_tree_equal(tg, jg)
        assert_tree_equal(terr, jerr)
    assert terr["c"]["scale"].abs().max() == 0  # an all-zero leaf stays zero


@pytest.mark.parametrize("name,args", [
    ("cosine_with_warmup", (3e-4, 5, 30)),
    ("cosine_with_warmup", (1e-3, 0, 7, 0.0)),
    ("constant", (2e-4,)),
    ("rsqrt", (1e-3, 4)),
])
def test_schedules_match(name, args):
    js, ts = getattr(JS, name)(*args), getattr(TS, name)(*args)
    for step in range(0, 40):
        want = float(js(jnp.asarray(step, jnp.int32)))
        got = ts(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(float(got), want, rtol=1e-6, err_msg=f"step {step}")


@pytest.mark.parametrize("max_norm", [1e-3, 1.0, 1e3])
def test_clip_by_global_norm_matches(max_norm):
    g = grad_tree(7)
    jc, jn = j_clip(as_jax(g), max_norm)
    tc, tn = clip_by_global_norm(as_torch(g), max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    for k in ("b",):
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), rtol=1e-6)
    np.testing.assert_allclose(tc["a"]["w"].numpy(), np.asarray(jc["a"]["w"]), rtol=1e-6)


def test_adamw_init_mirrors_the_tree():
    params = as_torch(grad_tree(3))
    params["a"]["w"] = params["a"]["w"].to(torch.bfloat16)
    state = adamw_init(params)
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 0
    assert state["m"]["a"]["w"].dtype == torch.float32
    assert state["v"]["a"]["w"].shape == (24, 16)


@pytest.mark.parametrize("n_hosts,host_id", [(1, 0), (2, 0), (2, 1)])
def test_stream_batches_bit_equal(n_hosts, host_id):
    kw = dict(vocab_size=97, seq_len=17, global_batch=8, seed=3, n_hosts=n_hosts,
              host_id=host_id)
    ref, port = JStream(JDataConfig(**kw)), SyntheticStream(DataConfig(**kw))
    for step in (0, 1, 5):
        want, got = ref.batch_at(step), port.batch_at(step)
        assert set(got) == {"tokens", "labels"}
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def test_stream_prefetch_and_state_dict():
    cfg = DataConfig(vocab_size=97, seq_len=9, global_batch=4, seed=5)
    ref = JStream(JDataConfig(vocab_size=97, seq_len=9, global_batch=4, seed=5))
    s = SyntheticStream(cfg, prefetch=2).start()
    try:
        got = [next(s) for _ in range(3)]
    finally:
        s.stop()
    assert s._thread is not None and not s._thread.is_alive()
    for i, b in enumerate(got):
        np.testing.assert_array_equal(b["tokens"], ref.batch_at(i)["tokens"])
    assert s.state_dict() == {"step": 3, "seed": 5}
    fresh = SyntheticStream(cfg)
    fresh.load_state_dict(s.state_dict())
    np.testing.assert_array_equal(next(fresh)["labels"], ref.batch_at(3)["labels"])
    with pytest.raises(ValueError, match="seed"):
        fresh.load_state_dict({"step": 0, "seed": 6})
