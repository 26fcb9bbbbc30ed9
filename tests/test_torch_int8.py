"""Port parity: the ``int8`` linear mode and ``ops.quantized_matmul_ref``
against the reference.

* The integers are bit-exact: the row-wise signed int8 activations, the
  column-wise int8 weights and the exact accumulator before scaling (and
  ``quantized_matmul_ref``'s offset-binary payloads and zero-point term).
* After scaling, the f32 outputs agree within ``atol 1e-6, rtol 1e-6``
  (the same IEEE operations in the same order; the reference runs under
  ``jax.disable_jit()``, where XLA cannot turn its ``/ qmax`` into a
  multiply).
* Greedy tokens of the ``int8`` engine equal the reference engine's,
  unfused and with ``fuse_projections="all"``.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import packed_linear as JL
from repro.core import quantize as JQ
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import transformer as JT
from repro.models.registry import get_config as j_get_config
from repro.serving import Engine as JEngine
from repro.serving import ServeConfig as JServeConfig
from repro_torch.convert import params_from_numpy
from repro_torch.core import packed_linear as TL
from repro_torch.core import quantize as TQ
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models.registry import get_config as t_get_config
from repro_torch.serving import Engine, ServeConfig

ATOL = RTOL = 1e-6
ARCH = "qwen1.5-110b"
PROMPTS = [[5, 17, 33, 2, 9], [40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50], [7, 8, 9]]
SHAPES = [((3, 64), (64, 48)), ((2, 5, 96), (96, 40)), ((1, 256), (256, 128)),
          ((17, 33), (33, 7))]


def _x(shape, seed: int, scale: float = 1.0) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("xs, ws", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_int8_accumulator_bit_exact(xs, ws):
    x, w = _x((int(np.prod(xs[:-1])), xs[-1]), 0), _x(ws, 1, ws[0] ** -0.5)
    with jax.disable_jit():
        jxq = JQ.quantize_signed(jnp.asarray(x), bits=8, axis=-1)
        jwq = JQ.quantize_signed(jnp.asarray(w), bits=8, axis=0)
        want = np.asarray(jref.ref_quantized_matmul(jxq.values, jwq.values))
    txq = TQ.quantize_signed(torch.from_numpy(x), bits=8, axis=-1)
    twq = TQ.quantize_signed(torch.from_numpy(w), bits=8, axis=0)
    np.testing.assert_array_equal(txq.values.numpy(), np.asarray(jxq.values))
    np.testing.assert_array_equal(twq.values.numpy(), np.asarray(jwq.values))
    np.testing.assert_array_equal(txq.scale.numpy(), np.asarray(jxq.scale))
    got = tref.ref_quantized_matmul(txq.values, twq.values)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("xs, ws", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_int8_linear_matches_reference(xs, ws, bias):
    x, w = _x(xs, 2), _x(ws, 3, ws[0] ** -0.5)
    jp = {"w": jnp.asarray(w)}
    tp = {"w": torch.from_numpy(w)}
    if bias:
        b = _x((ws[1],), 4, 0.1)
        jp["b"], tp["b"] = jnp.asarray(b), torch.from_numpy(b)
    with jax.disable_jit():
        want = np.asarray(JL.apply_linear(jp, jnp.asarray(x), JL.LinearSpec(mode="int8")))
    got = TL.apply_linear(tp, torch.from_numpy(x), TL.LinearSpec(mode="int8"))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_quantized_matmul_ref_matches_reference(bits):
    x, w = _x((6, 80), 5), _x((80, 24), 6, 80 ** -0.5)
    with jax.disable_jit():
        jxq = JQ.quantize_unsigned(jnp.asarray(x), bits=bits, axis=-1)
        jwq = JQ.quantize_signed(jnp.asarray(w), bits=bits, axis=0)
        jacc = np.asarray(jref.ref_quantized_matmul(jxq.values, jwq.values)
                          - JQ.zero_point_correction(jwq.values, jxq.zero_point)[None, :])
        want = np.asarray(jops.quantized_matmul_ref(jnp.asarray(x), jnp.asarray(w), bits))
    txq = TQ.quantize_unsigned(torch.from_numpy(x), bits=bits, axis=-1)
    twq = TQ.quantize_signed(torch.from_numpy(w), bits=bits, axis=0)
    tacc = (tref.ref_quantized_matmul(txq.values, twq.values)
            - TQ.zero_point_correction(twq.values, txq.zero_point)[None, :])
    np.testing.assert_array_equal(tacc.numpy(), jacc)
    got = tops.quantized_matmul_ref(torch.from_numpy(x), torch.from_numpy(w), bits)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def _numpy_params(jcfg, seed: int = 0) -> dict:
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
    np_tree = _numpy_params(jcfg)
    return jcfg, tcfg, jax.tree.map(jnp.asarray, np_tree), params_from_numpy(np_tree, tcfg)


@pytest.mark.parametrize("fuse", ["none", "all"])
def test_int8_greedy_tokens_identical_to_reference_engine(weights, fuse):
    jcfg, tcfg, jparams, tparams = weights
    kw = dict(n_slots=2, max_len=32, prefill_chunk=4, max_new=6, quant_mode="int8",
              fuse_projections=fuse)
    want = JEngine(jcfg, jparams, JServeConfig(**kw)).generate(PROMPTS)
    eng = Engine(tcfg, tparams, ServeConfig(device="cpu", **kw))
    assert eng.plan_table == {}
    assert eng.generate(PROMPTS) == want
