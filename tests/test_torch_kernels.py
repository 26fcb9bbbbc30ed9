"""Port parity: the kernel wrappers' plain versions against the reference's
Pallas kernels (interpret mode), and the ``ops`` float entries against the
reference's.

On the CPU a wrapper of ``repro_torch.kernels`` runs its kernel's plain
version (the CUDA kernel itself is held against that plain version on the
card by ``chip_smoke.py``).  Integer outputs are bit-exact (tolerance 0).
The ``ops.*_f32`` entries do the reference's float operations in the same
order, so their f32 outputs are bit-exact too against the reference run
eagerly (``jax.disable_jit``): under ``jit`` XLA rewrites the scale's
division by the constant ``qmax`` into a multiply by its reciprocal, which
moves a scale by one ulp; the port divides, as the eager reference and the
reference's fused kernel prologue do.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantize as jq
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.int4_matmul import int4_matmul as j_int4_matmul
from repro.kernels.packed_matmul import (
    packed_matmul as j_packed_matmul,
    packed_matmul_prepacked as j_packed_matmul_prepacked,
)
from repro_torch.convert import spec_from_dict
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.int4_matmul import int4_matmul
from repro_torch.kernels.packed_matmul import packed_matmul, packed_matmul_prepacked

# naive, full, mr, mr+full and multi-column plans, the card's default plan
# (a4w4-p10-n32-mr+full-c2) among them
PLANS = [
    jref.INT4_NAIVE,
    jref.PackedDotSpec(4, 4, 11, 16, "full", 0, 2),
    jref.PackedDotSpec(4, 4, 9, 8, "mr", 3, 1),
    jref.PackedDotSpec(4, 4, 10, 32, "mr+full", 2, 2),
    jref.PackedDotSpec(8, 8, 11, 1, "full", 0, 4),
]
M, K, N = 5, 100, 40  # one block, ragged in every axis


def _eq(t: torch.Tensor, j) -> None:
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def _ints(spec, seed: int):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 1 << spec.bits_a, size=(M, K)).astype(np.int32)
    lo = -(1 << (spec.bits_w - 1))
    w = rng.integers(lo, -lo, size=(K, N)).astype(np.int32)
    return x, w


@pytest.mark.parametrize("spec", PLANS[:4], ids=lambda s: s.name())
def test_packed_matmul_prepacked_both_forms(spec):
    port = spec_from_dict(dataclasses.asdict(spec))
    x, w = _ints(spec, seed=spec.p)
    jp = jref.pack_weight_words(jnp.asarray(w), spec)
    tp = tref.pack_weight_words(torch.from_numpy(w), port)
    # unsigned-int form
    want = j_packed_matmul_prepacked(jnp.asarray(x), jp.words, jp.wsc,
                                     spec=spec, interpret=True)
    _eq(packed_matmul_prepacked(torch.from_numpy(x), tp.words, tp.wsc, port), want)
    # fused-quantize form: raw f32 + the per-row scale over the full K
    xf = np.random.default_rng(spec.p + 1).standard_normal((M, K)).astype(np.float32)
    zp = 1 << (spec.bits_a - 1)
    scale = (np.maximum(np.abs(xf).max(-1, keepdims=True), 1e-8)
             / np.float32(zp - 1)).astype(np.float32)
    want = j_packed_matmul_prepacked(jnp.asarray(xf), jp.words, jp.wsc,
                                     spec=spec, interpret=True,
                                     x_scale=jnp.asarray(scale), x_zp=zp)
    got = packed_matmul_prepacked(torch.from_numpy(xf), tp.words, tp.wsc, port,
                                  x_scale=torch.from_numpy(scale), x_zp=zp)
    _eq(got, want)


@pytest.mark.parametrize("spec", PLANS[:4], ids=lambda s: s.name())
def test_packed_matmul(spec):
    port = spec_from_dict(dataclasses.asdict(spec))
    x, w = _ints(spec, seed=spec.p + 7)
    want = j_packed_matmul(jnp.asarray(x), jnp.asarray(w), spec=spec,
                           block=(8, 128, 128), interpret=True)
    _eq(packed_matmul(torch.from_numpy(x), torch.from_numpy(w), port), want)


def test_int4_matmul():
    rng = np.random.default_rng(5)
    x = rng.integers(-128, 128, size=(8, 128)).astype(np.int8)
    w = rng.integers(0, 256, size=(64, 128)).astype(np.uint8)
    want = j_int4_matmul(jnp.asarray(x), jnp.asarray(w), block=(8, 128, 128),
                         interpret=True)
    _eq(int4_matmul(torch.from_numpy(x), torch.from_numpy(w)), want)


def _float_operands(seed: int):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, 96)).astype(np.float32)
    w = (rng.standard_normal((96, N)) * 0.1).astype(np.float32)
    return x, w


@jax.disable_jit()
def test_ops_float_entries_bit_exact():
    spec = PLANS[1]  # multi-column and provably exact: the f32 shortcut too
    port = spec_from_dict(dataclasses.asdict(spec))
    x, w = _float_operands(seed=spec.p)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    _eq(tops.packed_matmul_f32(xt, wt, port, use_kernel=False),
        jops.packed_matmul_f32(jnp.asarray(x), jnp.asarray(w), spec=spec,
                               use_kernel=False))
    wq = jq.quantize_signed(jnp.asarray(w), bits=spec.bits_w, axis=0)
    wv, ws = np.array(wq.values), np.array(wq.scale)
    _eq(tops.dsp_tuned_matmul_f32(xt, torch.from_numpy(wv), torch.from_numpy(ws),
                                  port, use_kernel=False),
        jops.dsp_tuned_matmul_f32(jnp.asarray(x), wq.values, wq.scale, spec=spec,
                                  use_kernel=False))
    jp = jref.pack_weight_words(wq.values.astype(jnp.int32), spec)
    tp = tref.pack_weight_words(torch.from_numpy(wv), port)
    zp_row = jq.zero_point_correction(wq.values, 1 << (spec.bits_a - 1))
    _eq(tops.dsp_tuned_matmul_prepacked_f32(
            xt, tp.words, tp.wsc, torch.from_numpy(np.array(zp_row)),
            torch.from_numpy(ws), None, port, use_kernel=False),
        jops.dsp_tuned_matmul_prepacked_f32(
            jnp.asarray(x), jp.words, jp.wsc, zp_row, wq.scale, None, spec=spec,
            use_kernel=False))
    w_f32 = wv.astype(np.float32)  # the CPU f32-GEMM shortcut
    _eq(tops.dsp_tuned_matmul_prepacked_f32(
            xt, tp.words, tp.wsc, torch.from_numpy(np.array(zp_row)),
            torch.from_numpy(ws), torch.from_numpy(w_f32), port,
            use_kernel=False, exact_f32=True),
        jops.dsp_tuned_matmul_prepacked_f32(
            jnp.asarray(x), jp.words, jp.wsc, zp_row, wq.scale,
            jnp.asarray(w_f32), spec=spec, use_kernel=False, exact_f32=True))


@jax.disable_jit()
def test_ops_int4_entries_bit_exact():
    x, w = _float_operands(seed=9)
    wq = jq.quantize_signed(jnp.asarray(w), bits=4, axis=0)
    packed = np.array(jref.pack_int4_weights(wq.values))
    scale = np.array(wq.scale)
    _eq(tops.int4_matmul_f32(torch.from_numpy(x), torch.from_numpy(packed),
                             torch.from_numpy(scale), use_kernel=False),
        jops.int4_matmul_f32(jnp.asarray(x), jnp.asarray(packed), wq.scale,
                             use_kernel=False))
    w_f32 = np.array(wq.values).astype(np.float32)
    _eq(tops.int4_prepacked_matmul_f32(torch.from_numpy(x), torch.from_numpy(w_f32),
                                       torch.from_numpy(scale)),
        jops.int4_prepacked_matmul_f32(jnp.asarray(x), jnp.asarray(w_f32),
                                       wq.scale))


def test_use_kernel_on_cpu_tensor_raises():
    x = torch.zeros((2, 64))
    w = torch.zeros((64, 32))
    with pytest.raises(ValueError, match="use_kernel=True"):
        tops.packed_matmul_f32(x, w, tref.INT4_EXACT, use_kernel=True)
    with pytest.raises(ValueError, match="use_kernel=True"):
        tops.int4_matmul_f32(x, torch.zeros((32, 32), dtype=torch.uint8),
                             torch.ones((1, 32)), use_kernel=True)
    tp = tref.pack_weight_words(torch.zeros((64, 32), dtype=torch.int32),
                                tref.INT4_EXACT)
    with pytest.raises(ValueError, match="use_kernel=True"):
        tops.dsp_tuned_matmul_prepacked_f32(
            x, tp.words, None, torch.zeros(32, dtype=torch.int32),
            torch.ones((1, 32)), None, tref.INT4_EXACT, use_kernel=True)


def test_wrappers_reject_bad_operands():
    spec = tref.INT4_MR_OVERPACKED
    tp = tref.pack_weight_words(torch.zeros((64, 8), dtype=torch.int32), spec)
    with pytest.raises(ValueError, match="mr plan"):
        packed_matmul_prepacked(torch.zeros((2, 64), dtype=torch.int32),
                                tp.words, None, spec)
    with pytest.raises(ValueError, match="exceeds"):
        packed_matmul_prepacked(torch.zeros((2, 96), dtype=torch.int32),
                                tp.words, tp.wsc, spec)
    with pytest.raises(ValueError, match="both x_scale and x_zp"):
        packed_matmul_prepacked(torch.zeros((2, 64)), tp.words, tp.wsc, spec,
                                x_scale=torch.ones((2, 1)))
    with pytest.raises(ValueError, match="K//2"):
        int4_matmul(torch.zeros((2, 64), dtype=torch.int8),
                    torch.zeros((30, 8), dtype=torch.uint8))
