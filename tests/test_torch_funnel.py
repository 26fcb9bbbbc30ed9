"""Port parity: the linear funnel's leaf conditions, the dequantize helpers,
chunked causal attention and attention at the head dims the CUDA kernels
take beyond 64 and 128, against the JAX reference.

The same seeded numpy inputs go to both packages.  Tolerances:

* ``dequantize``, ``dequantize_packed``, ``materialize_weight`` and the
  packed payloads are bit-exact (tolerance 0): the same f32 multiply.
* A leaf dequantized at use (``x @ materialize_weight(w)``) is a float
  matmul on both sides: XLA and torch sum it in different orders, so atol
  1e-5 (values of order 1; the largest difference measured is about 1e-6).
* The int4 path of a 2-D nibble leaf under ``int4_packed`` is held
  bit-exact against the reference run eagerly (``jax.disable_jit``; under
  ``jit`` XLA turns the scale's division into a reciprocal multiply).
* Forward logits with ``attention_chunk`` set: atol 1e-5, as the port's
  other float32 forward comparisons (``tests/test_torch_model.py``); the
  chunked loop itself against the reference's: atol 1e-6 in f32, one bf16
  step in bf16.
* Attention at hd 16, 40 and 120 against the reference's Pallas kernel in
  interpret mode: the tolerances of ``tests/test_torch_addpack_attention.py``
  (f32 atol 5e-6; bf16 atol 1e-6 with one bf16 step, rtol 2**-7).  The
  card holds its kernels to this plain version at those hd.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import packed_linear as JL
from repro.core import packed_params as JP
from repro.core import quantize as JQ
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as j_flash
from repro.models import layers as JLayers
from repro.models import transformer as JT
from repro.models.registry import get_config as j_get_config
from repro_torch.convert import params_from_numpy, spec_from_dict
from repro_torch.core import packed_linear as TL
from repro_torch.core import packed_params as TP
from repro_torch.core import quantize as TQ
from repro_torch.kernels import flash_attention as TF
from repro_torch.models import layers as TLayers
from repro_torch.models import transformer as TT
from repro_torch.models.registry import get_config as t_get_config

MODES = ("native", "int4_packed", "dsp_packed", "dsp_tuned", "int8", "qat4")
D_IN, D_OUT = 64, 48
FLOAT_ATOL = 1e-5
PLAN = jref.PackedDotSpec(4, 4, 10, 32, "mr+full", 2, 2)  # the card's default plan


def _np(t) -> np.ndarray:
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _weights(shape, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * shape[-2] ** -0.5).astype(np.float32)


def _nibble_leaves(shape, seed: int):
    """The same int4-packed leaf in both packages: the reference's packer
    (any leading axes), its payload and scale handed to the port."""
    jleaf = JP._pack_matrix(jnp.asarray(_weights(shape, seed)))
    tleaf = {"packed": torch.from_numpy(np.array(jleaf["packed"])),
             "scale": torch.from_numpy(np.array(jleaf["scale"]))}
    return jleaf, tleaf


def _tuned_leaves(shape, seed: int, spec=PLAN, prepack: bool = True):
    """The same DspTunedLeaf in both packages, from one plan-grid quantize."""
    w = jnp.asarray(_weights(shape, seed))
    q = jax.vmap(lambda m: JQ.quantize_signed(m, bits=spec.bits_w, axis=0))(
        w.reshape((-1,) + shape[-2:]))
    values = np.asarray(q.values).reshape(shape).astype(np.int8)
    scale = np.asarray(q.scale).reshape(shape[:-2] + (1, shape[-1]))
    jleaf = JP.DspTunedLeaf(values=jnp.asarray(values), scale=jnp.asarray(scale),
                            spec=spec, prepack=prepack)
    tleaf = TP.DspTunedLeaf(torch.from_numpy(values), torch.from_numpy(scale),
                            spec_from_dict(dataclasses.asdict(spec)), prepack=prepack)
    return jleaf, tleaf


def _x(shape, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_dequantize_bit_exact():
    x = _x((6, 40), 0)
    for quantize, axis in (("quantize_signed", 0), ("quantize_unsigned", -1)):
        jq = getattr(JQ, quantize)(jnp.asarray(x), bits=4, axis=axis)
        tq = getattr(TQ, quantize)(torch.from_numpy(x), bits=4, axis=axis)
        np.testing.assert_array_equal(_np(TQ.dequantize(tq)), np.asarray(JQ.dequantize(jq)))


@pytest.mark.parametrize("shape", [(D_IN, D_OUT), (3, D_IN, D_OUT)], ids=["2d", "stacked"])
def test_dequantize_packed_and_materialize_bit_exact(shape):
    jleaf, tleaf = _nibble_leaves(shape, 1)
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        want = np.asarray(JP.dequantize_packed(jleaf, jdt).astype(jnp.float32))
        np.testing.assert_array_equal(
            TP.dequantize_packed(tleaf, tdt).to(torch.float32).numpy(), want)
        np.testing.assert_array_equal(
            TP.materialize_weight(tleaf, tdt).to(torch.float32).numpy(), want)
    jt, tt = _tuned_leaves(shape, 2, prepack=False)
    np.testing.assert_array_equal(
        TP.materialize_weight(tt, torch.float32).numpy(),
        np.asarray(JP.materialize_weight(jt, jnp.float32)))
    w = torch.zeros(shape)
    assert TP.materialize_weight(w, torch.float32) is w  # float leaves pass


def _apply(jparams, tparams, x: np.ndarray, mode: str):
    jspec = JL.LinearSpec(mode=mode)
    with jax.disable_jit():
        want = np.asarray(JL.apply_linear(jparams, jnp.asarray(x), jspec))
    got = TL.apply_linear(tparams, torch.from_numpy(x), TL.LinearSpec(mode=mode)).numpy()
    return got, want


@pytest.mark.parametrize("mode", MODES)
def test_nibble_leaf_follows_the_reference_conditions(mode):
    """2-D nibble leaf: the int4 path only under int4_packed, else
    dequantized at use; a stacked leaf is always dequantized at use."""
    jleaf, tleaf = _nibble_leaves((D_IN, D_OUT), 3)
    b = _x((D_OUT,), 4) * 0.1
    jp = {"w": jleaf, "b": jnp.asarray(b)}
    tp = {"w": tleaf, "b": torch.from_numpy(b)}
    x = _x((2, 5, D_IN), 5)
    got, want = _apply(jp, tp, x, mode)
    if mode == "int4_packed":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=FLOAT_ATOL)
        dense = x @ TP.materialize_weight(tleaf, torch.float32).numpy() + b
        np.testing.assert_allclose(got, dense, rtol=0, atol=FLOAT_ATOL)
    jleaf3, tleaf3 = _nibble_leaves((2, D_IN, D_OUT), 6)
    x3 = _x((2, 5, D_IN), 7)
    got, want = _apply({"w": jleaf3}, {"w": tleaf3}, x3, mode)
    assert got.shape == (2, 5, D_OUT)
    np.testing.assert_allclose(got, want, rtol=0, atol=FLOAT_ATOL)


@pytest.mark.parametrize("mode", MODES)
def test_tuned_leaf_follows_the_reference_conditions(mode):
    """2-D DspTunedLeaf: its plan whatever the mode (bit-exact integers,
    so the f32 outputs match); stacked: dequantized at use."""
    jleaf, tleaf = _tuned_leaves((D_IN, D_OUT), 8)
    x = _x((3, D_IN), 9)
    got, want = _apply({"w": jleaf}, {"w": tleaf}, x, mode)
    np.testing.assert_array_equal(got, want)
    jleaf3, tleaf3 = _tuned_leaves((2, D_IN, D_OUT), 10, prepack=False)
    x3 = _x((2, 4, D_IN), 11)
    got, want = _apply({"w": jleaf3}, {"w": tleaf3}, x3, mode)
    np.testing.assert_allclose(got, want, rtol=0, atol=FLOAT_ATOL)


def test_unported_modes_still_raise_on_float_leaves():
    """The training modes, once unported here, now run on a float leaf:
    the weight fake-quantized per output column (bit-exact), then a float
    matmul (atol as above)."""
    w = _weights((D_IN, D_OUT), 12)
    for mode in ("qat4", "qat8"):
        got, want = _apply({"w": jnp.asarray(w)}, {"w": torch.from_numpy(w)},
                           _x((3, D_IN), 13), mode)
        np.testing.assert_allclose(got, want, rtol=0, atol=FLOAT_ATOL)


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


@pytest.mark.parametrize("seq, chunk", [(32, 8), (24, 8), (20, 8), (8, 8)])
def test_forward_with_attention_chunk_matches_reference(seq, chunk, monkeypatch):
    """The chunked path runs exactly under the reference's condition (the
    chunk divides S and S > chunk: S = 32, 24, not 20 or 8), and the logits
    match the reference's forward and the port's unchunked one."""
    arch = "qwen1.5-110b"
    jcfg = dataclasses.replace(j_get_config(arch, smoke=True), dtype="float32",
                               attention_chunk=chunk)
    tcfg = dataclasses.replace(t_get_config(arch, smoke=True), dtype="float32",
                               attention_chunk=chunk)
    np_tree = _numpy_params(jcfg)
    tokens = np.random.default_rng(seq).integers(2, jcfg.vocab_size, (2, seq))
    want, _, _ = JT.forward(jax.tree.map(jnp.asarray, np_tree), jcfg, jnp.asarray(tokens))
    tparams = params_from_numpy(np_tree, tcfg)
    calls = []
    chunked = TLayers._chunked_causal_attention
    monkeypatch.setattr(TLayers, "_chunked_causal_attention",
                        lambda *a: calls.append(a[-1]) or chunked(*a))
    got, _, _ = TT.forward(tparams, tcfg, torch.from_numpy(tokens))
    taken = seq > chunk and seq % chunk == 0
    assert calls == ([chunk] * tcfg.n_layers if taken else [])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=FLOAT_ATOL)
    unchunked, _, _ = TT.forward(tparams, dataclasses.replace(tcfg, attention_chunk=0),
                                 torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), unchunked.numpy(), rtol=0, atol=FLOAT_ATOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_causal_attention_matches_reference_function(dtype):
    """The online-softmax loop itself against the reference's
    ``_chunked_causal_attention`` on the same (B, S, H, hd) inputs: the
    same f32 recurrence, so f32 agrees to atol 1e-6 (summation order
    only); bf16 inputs round the output once, one bf16 step (rtol 2**-7)."""
    rng = np.random.default_rng(13)
    q, k, v = (rng.standard_normal((2, 48, 4, 16)).astype(np.float32) for _ in range(3))
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    pos = jnp.broadcast_to(jnp.arange(48)[None], (2, 48))
    want = JLayers._chunked_causal_attention(
        *(jnp.asarray(t).astype(jdt) for t in (q, k, v)), pos, 16, None)
    got = TLayers._chunked_causal_attention(
        *(torch.from_numpy(t).to(tdt) for t in (q, k, v)), 16)
    atol, rtol = (1e-6, 0.0) if dtype == "float32" else (1e-6, 2**-7)
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want.astype(jnp.float32)), rtol=rtol, atol=atol)


def test_chunked_attention_layer_matches_reference():
    """The layer alone, the reference test's shape (B 2, S 64, chunk 16)."""
    arch = "qwen1.5-110b"
    jcfg = dataclasses.replace(j_get_config(arch, smoke=True), dtype="float32",
                               attention_chunk=16)
    tcfg = dataclasses.replace(t_get_config(arch, smoke=True), dtype="float32",
                               attention_chunk=16)
    np_tree = _numpy_params(jcfg)
    attn = jax.tree.map(lambda a: a[0], np_tree["groups"]["attn"])
    x = _x((2, 64, jcfg.d_model), 12)
    pos = np.broadcast_to(np.arange(64)[None], (2, 64))
    want, _ = JLayers.attention(jax.tree.map(jnp.asarray, attn), jnp.asarray(x), jcfg,
                                jnp.asarray(pos))
    tattn = jax.tree.map(lambda a: torch.from_numpy(np.ascontiguousarray(a)), attn)
    got, _ = TLayers.attention(tattn, torch.from_numpy(x), tcfg, torch.from_numpy(pos.copy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=FLOAT_ATOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [16, 120, 40])
def test_attention_head_dims_match_pallas(hd, dtype):
    """The head dims the CUDA kernels take besides 64 and 128 (every smoke
    config's 16, h2o-danube-3-4b's 120): what the wrapper computes on the
    CPU, the plain version the card's checks hold the kernels to, against
    the reference's Pallas kernel on the same inputs."""
    rng = np.random.default_rng(hd)
    qkv = [rng.standard_normal((1, 2, 128, hd)).astype(np.float32) for _ in range(3)]
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "float32"
                else (jnp.bfloat16, torch.bfloat16))
    want = j_flash(*(jnp.asarray(t).astype(jdt) for t in qkv), bq=64, bk=32, interpret=True)
    got = TF.flash_attention(*(torch.from_numpy(t).to(tdt) for t in qkv), bq=64, bk=32)
    assert got.dtype == tdt and got.shape == (1, 2, 128, hd)
    atol, rtol = (5e-6, 0.0) if dtype == "float32" else (1e-6, 2**-7)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=atol, rtol=rtol)
