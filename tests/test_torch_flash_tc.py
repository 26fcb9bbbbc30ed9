"""The bf16 tensor-core route of ``flash_attention`` on the CPU: its rounding,
emulated by ``emulate_tensor_core_flash`` (scores from exact bf16 products
scaled after the sum, online softmax over the kernel's 64-key tiles, P V as
``P_hi V + P_lo V``), against the reference's Pallas kernel in interpret
mode and the port's plain version, and the route bookkeeping.

Tolerance: ``atol 1e-5, rtol 2**-7``, the bf16 tolerance the card's checks
hold the kernel to: both sides are rounded to bf16 once, so they may sit one
bf16 step apart.  Rounding P to bf16 once instead of splitting it falls
outside that tolerance, which is why the kernel splits it.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as j_flash
from repro_torch.kernels import flash_attention as tfa

ATOL, RTOL = 1e-5, 2**-7


def _bf16_qkv(shape, seed):
    """q, k, v drawn from a seeded numpy generator, rounded to bf16."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).bfloat16()
            for _ in range(3)]


def _pallas(q, k, v, bq, bk):
    jq, jk, jv = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in (q, k, v))
    return np.asarray(j_flash(jq, jk, jv, bq=bq, bk=bk, interpret=True).astype(jnp.float32))


def _outside(got: torch.Tensor, want) -> int:
    g, w = got.float().numpy(), np.asarray(want, dtype=np.float32)
    return int((np.abs(g - w) > ATOL + RTOL * np.abs(w)).sum())


@pytest.mark.parametrize("shape,bq,bk", [((1, 2, 512, 128), 256, 128),
                                         ((1, 2, 256, 64), 128, 64)])
def test_emulation_matches_pallas_and_plain(shape, bq, bk):
    q, k, v = _bf16_qkv(shape, seed=21)
    got = tfa.emulate_tensor_core_flash(q, k, v)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    np.testing.assert_allclose(got.float().numpy(), _pallas(q, k, v, bq, bk),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got.float().numpy(),
                               tfa.plain_flash_attention(q, k, v).float().numpy(),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("s,bq,bk", [(96, 32, 8), (200, 8, 8)])
@pytest.mark.parametrize("hd", [64, 128])
def test_emulation_ragged_s_matches_plain(s, bq, bk, hd):
    q, k, v = _bf16_qkv((1, 3, s, hd), seed=s + hd)
    got = tfa.emulate_tensor_core_flash(q, k, v)
    want = tfa.flash_attention(q, k, v, bq=bq, bk=bk)  # a CPU tensor: the plain version
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("shape", [(1, 2, 512, 128), (1, 2, 256, 64)])
def test_rounding_p_once_falls_outside_the_tolerance(shape):
    q, k, v = _bf16_qkv(shape, seed=21)
    want = tfa.plain_flash_attention(q, k, v)
    assert _outside(tfa.emulate_tensor_core_flash(q, k, v), want.float().numpy()) == 0
    once = tfa.emulate_tensor_core_flash(q, k, v, split=False)
    assert _outside(once, want.float().numpy()) > q.numel() // 100


def test_emulation_tiles_past_the_diagonal_add_nothing():
    q, k, v = _bf16_qkv((1, 1, 128, 64), seed=3)
    full = tfa.emulate_tensor_core_flash(q, k, v)
    # the first 64 rows never see the second key tile: truncating S keeps them
    head = tfa.emulate_tensor_core_flash(*(t[:, :, :64].contiguous() for t in (q, k, v)))
    assert torch.equal(full[:, :, :64], head)


def test_emulation_takes_bf16_only():
    q = torch.zeros((1, 1, 64, 64))
    with pytest.raises(TypeError):
        tfa.emulate_tensor_core_flash(q, q, q)


def test_routes_name_one_kernel_per_dtype():
    assert tfa.ROUTES == {torch.bfloat16: "flash_attention_sm90",
                          torch.float16: "flash_attention_sm90_f16",
                          torch.float32: "flash_attention_sm90_f32"}
    # every route is a kernel of its own, counted on its own; the CUDA-core
    # f32 kernel stays callable beside them
    assert set(tfa.ROUTES.values()) < set(tfa.KERNELS) == set(tfa.SOURCES)
    assert set(tfa.flash_attention.route_launches) == set(tfa.KERNELS)
    sources = {p.stem for p in tfa.build.CSRC.glob("*.cu")}
    assert set(tfa.SOURCES.values()) <= sources
    for name, stem in tfa.SOURCES.items():  # each C entry is in its source
        assert f'"C" int {name}_launch(' in (tfa.build.CSRC / f"{stem}.cu").read_text()


def test_cpu_tensors_count_no_route_launch():
    before = (tfa.flash_attention.launches, dict(tfa.flash_attention.route_launches))
    for dtype in tfa.ROUTES:
        x = torch.zeros((1, 1, 64, 64), dtype=dtype)
        tfa.flash_attention(x, x, x, bq=64, bk=64)
    assert (tfa.flash_attention.launches, tfa.flash_attention.route_launches) == before
