"""Port parity: the training path of ``repro_torch`` against the JAX
reference on the CPU.

Reference parameters come from ``T.init_params`` (seed 0) and cross to the
port through ``convert.params_from_numpy``; batches are the reference's
``SyntheticStream`` batches.  The reference is held through its mesh-free
step (``loss_fn`` and ``make_train_step`` with ``mesh=None``): its own
training CLI fails on this JAX (a sharding error in its embedding gather
under the local mesh).  Tolerances, each stated where it is used:

* fake-quant: forward bit-equal, the straight-through mask equal;
* one step in f32 (``qwen1.5-110b`` smoke; native, qat4, qat4 with 8-bit
  activations): loss ``rtol 1e-5``, every gradient leaf ``rtol 1e-4, atol
  1e-6`` (XLA's and torch's f32 sums round in different orders);
* the same step in the default bf16 compute: loss ``rtol 5e-3``; per leaf
  the relative Frobenius error against the reference's bf16 gradient under
  ``2e-2``, raised to ``3e-2`` on the leaves where the reference's own bf16
  gradient lies more than 2e-2 from its f32 one (there 2e-2 sits below the
  reference's own rounding spread), and every leaf no farther from the
  reference's f32 gradient than 1.1 times the reference's own bf16
  gradient is.  On this batch the reference's bf16 gradients lie up to
  2.8e-2 from its f32 ones (``attn/wq/b``), bf16 rounding alone; the
  port's lie up to 2.32e-2 from the reference's bf16 ones (``attn/wq/b``,
  the one leaf over 2e-2) and closer to the f32 ones than the reference's
  own, on every leaf;
* AdamW given the reference's gradients and state: ``rtol 1e-6, atol
  1e-7``;
* ten train steps: losses within ``1e-3`` relative of the reference's;
* per family (f32 smoke configs): loss and gradient norm ``rtol 1e-4``.
"""

from __future__ import annotations

import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantize as JQ
from repro.core.packed_linear import LinearSpec as JSpec
from repro.launch.steps import loss_fn as j_loss_fn
from repro.launch.steps import make_prefill_step as j_make_prefill_step
from repro.launch.steps import make_serve_step as j_make_serve_step
from repro.launch.steps import make_train_step as j_make_train_step
from repro.models import transformer as JT
from repro.models.registry import get_config as j_get_config
from repro.optim.adamw import AdamWConfig as JAdamW
from repro.optim.adamw import adamw_init as j_adamw_init
from repro.optim.adamw import adamw_update as j_adamw_update
from repro.optim.schedule import cosine_with_warmup as j_cosine
from repro_torch.convert import (
    params_from_numpy,
    params_to_numpy,
    state_from_numpy,
    state_to_numpy,
)
from repro_torch.core import quantize as TQ
from repro_torch.core.packed_linear import INTEGER_MODES, LinearSpec, apply_linear
from repro_torch.core.packed_params import quantize_for_serving
from repro_torch.data import DataConfig, SyntheticStream
from repro_torch.launch.steps import (
    loss_and_grads,
    make_prefill_step,
    make_serve_step,
    make_train_step,
)
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.launch.train import build_state, param_placement
from repro_torch.models import transformer as TT
from repro_torch.models.registry import get_config as t_get_config
from repro_torch.optim import AdamWConfig
from repro_torch.optim import adamw_update as t_adamw_update
from repro_torch.optim import cosine_with_warmup as t_cosine
from repro_torch.tree import to_numpy, tree_leaves

ARCH = "qwen1.5-110b"
KEY = jax.random.PRNGKey(0)


def configs(arch: str, dtype: str = "float32", mode: str = "native",
            act_bits: int | None = None):
    # the reference unrolled and without remat: it compiles about a third
    # faster, and neither changes a value (the port keeps its remat)
    jcfg = dataclasses.replace(j_get_config(arch, smoke=True), dtype=dtype,
                               quant=JSpec(mode=mode, act_bits=act_bits),
                               remat="none", scan_layers=False)
    tcfg = dataclasses.replace(t_get_config(arch, smoke=True), dtype=dtype,
                               quant=LinearSpec(mode=mode, act_bits=act_bits))
    return jcfg, tcfg


def batch_np(cfg, batch: int, seq: int) -> dict:
    b = SyntheticStream(DataConfig(cfg.vocab_size, seq + 1, batch, seed=1)).batch_at(0)
    rng = np.random.default_rng(0)
    if cfg.family == "encdec":
        b["frames"] = rng.standard_normal((batch, cfg.encoder_len, cfg.d_model),
                                          dtype=np.float32)
    if cfg.family == "vlm":
        b["patches"] = rng.standard_normal((batch, cfg.n_patches, cfg.d_model),
                                           dtype=np.float32)
    return b


@functools.cache
def ref_value_and_grad(jcfg):
    """The reference train step's gradient, jitted once per config:
    ``loss_fn`` on the params cast for compute (its ``cast_for_compute``)."""
    dt = {"bfloat16": jnp.bfloat16, "float32": jnp.float32}[jcfg.dtype]

    def cast(p):
        return p.astype(dt) if p.dtype == jnp.float32 and p.ndim > 1 else p

    return jax.jit(jax.value_and_grad(
        lambda p, b: j_loss_fn(jax.tree.map(cast, p), jcfg, b), has_aux=True))


def ref_loss_and_grads(jparams, jcfg, batch: dict):
    (loss, _), grads = ref_value_and_grad(jcfg)(jparams, batch)
    return float(loss), jax.tree.map(np.asarray, grads)


def port_loss_and_grads(np_params, tcfg, batch: dict):
    loss, _, grads = loss_and_grads(params_from_numpy(np_params, tcfg), tcfg,
                                    {k: torch.from_numpy(v) for k, v in batch.items()})
    return float(loss), params_to_numpy(grads)


def leaves_with_paths(tree):
    return [("/".join(str(p.key) for p in path), leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]


@pytest.fixture(scope="module")
def ref_params():
    jcfg, _ = configs(ARCH)
    jparams = JT.init_params(KEY, jcfg)
    return jparams, jax.tree.map(np.asarray, jparams)


# ---- (a) fake-quant ---------------------------------------------------------


@pytest.mark.parametrize("signed", [True, False])
@pytest.mark.parametrize("bits", [4, 8])
def test_fake_quant_forward_and_ste_mask_equal(signed, bits):
    rng = np.random.default_rng(bits)
    x = (rng.standard_normal((6, 40)) * 3).astype(np.float32)
    g = rng.standard_normal((6, 40)).astype(np.float32)
    jfq = JQ.fake_quant_signed if signed else JQ.fake_quant_unsigned
    tfq = TQ.fake_quant_signed if signed else TQ.fake_quant_unsigned
    for axis in (0, -1):
        jy, vjp = jax.vjp(lambda a: jfq(a, bits, axis), jnp.asarray(x))
        (jgx,) = vjp(jnp.asarray(g))
        xt = torch.from_numpy(x).requires_grad_(True)
        ty = tfq(xt, bits, axis)
        (tgx,) = torch.autograd.grad(ty, xt, torch.from_numpy(g))
        # bit-equal forward, equal masked gradient (0 or g exactly)
        np.testing.assert_array_equal(ty.detach().numpy(), np.asarray(jy))
        np.testing.assert_array_equal(tgx.numpy(), np.asarray(jgx))


# ---- (b) one step in f32 ----------------------------------------------------


@pytest.fixture(scope="module")
def native_f32(ref_params):
    """The reference's native f32 loss and gradients on a 2 x 16 batch."""
    jcfg, _ = configs(ARCH)
    batch = batch_np(jcfg, 2, 16)
    return (batch, *ref_loss_and_grads(ref_params[0], jcfg,
                                       {k: jnp.asarray(v) for k, v in batch.items()}))


@pytest.mark.parametrize("mode,act_bits", [("native", None), ("qat4", None), ("qat4", 8)])
def test_train_step_gradients_f32(ref_params, native_f32, mode, act_bits):
    jparams, np_params = ref_params
    jcfg, tcfg = configs(ARCH, "float32", mode, act_bits)
    batch = native_f32[0]
    if mode == "native":
        _, jloss, jgrads = native_f32
    else:
        jloss, jgrads = ref_loss_and_grads(jparams, jcfg,
                                           {k: jnp.asarray(v) for k, v in batch.items()})
    tloss, tgrads = port_loss_and_grads(np_params, tcfg, batch)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    tflat = dict(leaves_with_paths(tgrads))
    for path, g in leaves_with_paths(jgrads):
        np.testing.assert_allclose(tflat[path], g, rtol=1e-4, atol=1e-6, err_msg=path)


# ---- (c) one step in bf16 ---------------------------------------------------


def test_train_step_gradients_bf16(ref_params):
    jparams, np_params = ref_params
    batch = batch_np(configs(ARCH)[0], 8, 32)  # the reference tests' batch
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jcfg32, _ = configs(ARCH, "float32")
    jcfg, tcfg = configs(ARCH, "bfloat16")
    _, j32 = ref_loss_and_grads(jparams, jcfg32, jb)
    jloss, jgrads = ref_loss_and_grads(jparams, jcfg, jb)
    tloss, tgrads = port_loss_and_grads(np_params, tcfg, batch)
    np.testing.assert_allclose(tloss, jloss, rtol=5e-3)
    tflat, f32 = dict(leaves_with_paths(tgrads)), dict(leaves_with_paths(j32))
    for path, g in leaves_with_paths(jgrads):
        ref_spread = np.linalg.norm(g - f32[path])
        # 2e-2, or 3e-2 where the reference's own bf16 leaf lies farther
        # than 2e-2 from its f32 one
        bound = 2e-2 if ref_spread < 2e-2 * np.linalg.norm(g) else 3e-2
        err = np.linalg.norm(tflat[path] - g) / np.linalg.norm(g)
        assert err < bound, (path, err, bound)
        assert np.linalg.norm(tflat[path] - f32[path]) <= 1.1 * ref_spread, path


# ---- (d) AdamW from the reference's gradients -------------------------------


def test_adamw_update_from_reference_gradients(ref_params, native_f32):
    """Three updates, each from the reference's state before it and the
    reference's gradients (scaled per step): params, moments, step, norm and
    lr ``rtol 1e-6, atol 1e-7``.  Compared update by update, not after a
    run: early AdamW steps move by about sign(g) * lr, so a component near
    0 that rounds differently would flip a whole 2 * lr."""
    jparams, _ = ref_params
    jgrads = native_f32[2]
    _, tcfg = configs(ARCH)
    sched_j = j_cosine(1e-3, warmup=1, total=10)
    sched_t = t_cosine(1e-3, warmup=1, total=10)
    jcfg_opt = JAdamW(lr=1e-3, weight_decay=0.1, grad_clip=1.0)
    tcfg_opt = AdamWConfig(lr=1e-3, weight_decay=0.1, grad_clip=1.0)
    jstate = {"params": jparams, "opt": j_adamw_init(jparams)}
    j_update = jax.jit(lambda p, g, o: j_adamw_update(p, g, o, jcfg_opt, sched_j))
    for k, factor in enumerate((1.0, -0.4, 2.5)):
        g = jax.tree.map(lambda a: jnp.asarray(a * factor), jgrads)
        t = state_from_numpy(jax.tree.map(np.asarray, jstate), tcfg)
        tg = params_from_numpy(jax.tree.map(np.asarray, g), tcfg)
        jp, jopt, jm = j_update(jstate["params"], g, jstate["opt"])
        tp, topt, tm = t_adamw_update(t["params"], tg, t["opt"], tcfg_opt, sched_t)
        got = state_to_numpy({"params": tp, "opt": topt})
        want = {"params": jp, "opt": jopt}
        gflat = dict(leaves_with_paths(got))
        for path, a in leaves_with_paths(want):
            np.testing.assert_allclose(gflat[path], np.asarray(a), rtol=1e-6, atol=1e-7,
                                       err_msg=f"update {k}: {path}")
        for name in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[name]), float(jm[name]), rtol=1e-6)
        jstate = {"params": jp, "opt": jopt}


# ---- (e) ten steps ----------------------------------------------------------


def test_ten_steps_follow_the_reference(ref_params):
    jparams, np_params = ref_params
    jcfg, tcfg = configs(ARCH)
    data = SyntheticStream(DataConfig(jcfg.vocab_size, 33, 8, seed=1))
    jstep = jax.jit(j_make_train_step(jcfg, JAdamW(lr=1e-3)))
    jstate = {"params": jparams, "opt": j_adamw_init(jparams)}
    tstate = build_state(tcfg, device="cpu")
    tstate["params"] = params_from_numpy(np_params, tcfg)
    tstep = make_train_step(tcfg, AdamWConfig(lr=1e-3))
    jl, tl = [], []
    for i in range(10):
        b = data.batch_at(i)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        tstate, tm = tstep(tstate, {k: torch.from_numpy(v) for k, v in b.items()})
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    # the reference's test_loss_decreases asks 0.3 over 30 steps; 10 steps
    # of lr 1e-3 already clear it
    assert np.mean(tl[-5:]) < np.mean(tl[:5]) - 0.3, tl


# ---- gradient accumulation ------------------------------------------------


def test_microbatched_step_follows_the_reference(ref_params):
    """``microbatches=2`` against the reference's step, f32, one step on a
    4 x 16 batch: loss ``rtol 1e-5``; ``ce`` and ``aux`` (the last
    microbatch's, as the reference reports them) ``rtol 1e-5``; grad norm
    ``rtol 1e-4``; the first moment (0.1 times the clipped accumulated
    gradient) ``rtol 1e-4, atol 1e-7``."""
    jparams, np_params = ref_params
    jcfg, tcfg = configs(ARCH)
    b = batch_np(jcfg, 4, 16)
    jstep = jax.jit(j_make_train_step(jcfg, JAdamW(lr=1e-3), microbatches=2))
    jstate, jm = jstep({"params": jparams, "opt": j_adamw_init(jparams)},
                       {k: jnp.asarray(v) for k, v in b.items()})
    tstate = build_state(tcfg, device="cpu")
    tstate["params"] = params_from_numpy(np_params, tcfg)
    tstate, tm = make_train_step(tcfg, AdamWConfig(lr=1e-3), microbatches=2)(
        tstate, {k: torch.from_numpy(v) for k, v in b.items()})
    for name in ("loss", "ce", "aux"):
        np.testing.assert_allclose(float(tm[name]), float(jm[name]), rtol=1e-5, err_msg=name)
    # ce is the last microbatch's, not the whole batch's
    _, last, _ = loss_and_grads(params_from_numpy(np_params, tcfg), tcfg,
                                {k: torch.from_numpy(v[2:]) for k, v in b.items()})
    np.testing.assert_allclose(float(tm["ce"]), float(last["ce"]), rtol=1e-6)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    tflat = dict(leaves_with_paths(to_numpy(tstate["opt"]["m"])))
    for path, m in leaves_with_paths(jstate["opt"]["m"]):
        np.testing.assert_allclose(tflat[path], np.asarray(m), rtol=1e-4, atol=1e-7,
                                   err_msg=path)


# ---- prefill and serve steps -------------------------------------------------


@pytest.mark.parametrize("arch", [ARCH, "whisper-large-v3"])
def test_prefill_and_serve_steps_follow_the_reference(arch):
    """f32 smoke configs, the reference jitted: the prefill step's last
    logits ``atol 1e-4``; three greedy serve steps from an empty cache (the
    encdec family with the encoder's output) give equal tokens, and the
    cache after them ``atol 1e-5``."""
    jcfg, tcfg = configs(arch)
    jparams = JT.init_params(KEY, jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg)
    b = batch_np(jcfg, 2, 8)
    want = jax.jit(j_make_prefill_step(jcfg))(jparams,
                                              {k: jnp.asarray(v) for k, v in b.items()})
    with torch.no_grad():
        got = make_prefill_step(tcfg)(tparams, {k: torch.from_numpy(v) for k, v in b.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)

    jserve, tserve = jax.jit(j_make_serve_step(jcfg)), make_serve_step(tcfg)
    jcache = JT.init_cache(jcfg, batch=2, max_len=16)
    tcache = TT.init_cache(tcfg, batch=2, max_len=16, device="cpu")
    extra = {}
    if jcfg.family == "encdec":
        extra["encoder_out"] = JT.encode(jparams, jcfg, jnp.asarray(b["frames"]))
    tok = np.asarray(b["tokens"][:, :1])
    for pos in range(3):
        positions = np.full((2, 1), pos, np.int32)
        jtok, jcache = jserve(jparams, jcache, {
            "tokens": jnp.asarray(tok), "positions": jnp.asarray(positions), **extra})
        with torch.no_grad():
            ttok, tcache = tserve(tparams, tcache, {
                "tokens": torch.from_numpy(tok), "positions": torch.from_numpy(positions),
                **{k: torch.from_numpy(np.array(v)) for k, v in extra.items()}})
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        tok = np.array(jtok)[:, None]
    tflat = dict(leaves_with_paths(to_numpy(tcache)))
    for path, leaf in leaves_with_paths(jcache):
        np.testing.assert_allclose(tflat[path], np.asarray(leaf), atol=1e-5, err_msg=path)


# ---- (h) every family -------------------------------------------------------


FAMILIES = ["h2o-danube-3-4b", "moonshot-v1-16b-a3b", "xlstm-1.3b", "jamba-v0.1-52b",
            "whisper-large-v3", "llava-next-mistral-7b"]  # dense: qwen above


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_loss_and_grad_norm(arch):
    jcfg, tcfg = configs(arch)
    jparams = JT.init_params(KEY, jcfg)
    batch = batch_np(jcfg, 2, 16)
    jloss, jgrads = ref_loss_and_grads(jparams, jcfg,
                                       {k: jnp.asarray(v) for k, v in batch.items()})
    tloss, tgrads = port_loss_and_grads(jax.tree.map(np.asarray, jparams), tcfg, batch)

    def norm(tree):
        return np.sqrt(sum(np.sum(np.square(g.astype(np.float64)))
                           for _, g in leaves_with_paths(tree)))

    np.testing.assert_allclose(tloss, jloss, rtol=1e-4)
    np.testing.assert_allclose(norm(tgrads), norm(jgrads), rtol=1e-4)


# ---- (j) the integer modes have no gradient --------------------------------


@pytest.mark.parametrize("mode", INTEGER_MODES)
def test_integer_modes_raise_under_autograd(mode):
    gen = torch.Generator().manual_seed(0)
    params = {"w": torch.randn((64, 32), generator=gen)}
    x = torch.randn((3, 64), generator=gen)
    spec = LinearSpec(mode=mode)
    with torch.no_grad():
        apply_linear(params, x, spec)  # serving: no gradient asked
    with pytest.raises(RuntimeError, match="no gradient"):
        apply_linear(params, x.requires_grad_(True), spec)
    with pytest.raises(RuntimeError, match="no gradient"):
        apply_linear({"w": params["w"].requires_grad_(True)}, x.detach(), spec)


def test_packed_leaves_raise_under_autograd():
    cfg = dataclasses.replace(t_get_config(ARCH, smoke=True), dtype="float32")
    params = TT.init_params(cfg, device="cpu")
    packed = quantize_for_serving(params, "int4_packed")
    x = torch.randn((2, 3, cfg.d_model), requires_grad=True)
    with pytest.raises(RuntimeError, match="no gradient"):
        apply_linear(packed["groups"][0]["attn"]["wq"], x, LinearSpec(mode="int4_packed"))


def test_qat_trains_and_mesh_raises():
    _, tcfg = configs(ARCH, "float32", "qat8", 8)
    state = build_state(tcfg, device="cpu")
    before = [p.clone() for p in tree_leaves(state["params"])]
    step = make_train_step(tcfg, AdamWConfig())
    b = batch_np(tcfg, 2, 16)
    state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
    assert np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0
    assert all(not torch.equal(a, p) for a, p in zip(before, tree_leaves(state["params"])))
    # the mesh path: one process is a mesh of one rank, whose placed state
    # takes the mesh-free step bit for bit (the 4-rank world of
    # tests/test_torch_mesh_train.py holds the sharded step)
    mesh = make_local_mesh()
    placement = param_placement(tcfg, mesh)
    meshed = build_state(tcfg, device="cpu", shardings=placement)
    meshed, mm = make_train_step(tcfg, AdamWConfig(), mesh, grad_shardings=placement)(
        meshed, {k: torch.from_numpy(v) for k, v in b.items()})
    assert float(mm["loss"]) == float(m["loss"])
    assert all(torch.equal(a, p) for a, p in zip(tree_leaves(meshed["params"]),
                                                  tree_leaves(state["params"])))
    # a mesh of more than one rank needs the state's placement
    with pytest.raises(ValueError, match="needs grad_shardings"):
        make_train_step(tcfg, AdamWConfig(), mesh=types.SimpleNamespace(size=4))


def test_mlstm_gradient_finite_where_gates_overflow():
    """With forget gates near 0 (bias -10), the gates above the chunk's
    diagonal overflow f32's exp; masking before the exp keeps the gradient
    finite (``where(mask, exp(g), 0)``, the reference's form, gives 0 * inf
    = nan).  The values are the reference's: ``tests/test_torch_ssm.py``
    holds the mixer to it."""
    _, tcfg = configs("xlstm-1.3b")
    params = TT.init_params(tcfg, device="cpu")
    for group in params["groups"]:
        for sub in group["mlstm"]:
            sub["wf"]["b"].fill_(-10.0)
    batch = batch_np(tcfg, 2, 16)
    loss, _, grads = loss_and_grads(params, tcfg,
                                    {k: torch.from_numpy(v) for k, v in batch.items()})
    assert torch.isfinite(loss)
    for g in tree_leaves(grads):
        assert torch.isfinite(g).all()


def test_converted_state_owns_its_memory(ref_params):
    """The train step updates the port's state in place; a state converted
    from the reference's arrays must not write back into them (a view of a
    JAX array's buffer would, and would race with its async dispatch)."""
    _, np_params = ref_params
    _, tcfg = configs(ARCH)
    before = jax.tree.map(np.copy, np_params)
    state = build_state(tcfg, device="cpu")
    state["params"] = params_from_numpy(np_params, tcfg)
    step = make_train_step(tcfg, AdamWConfig(lr=1e-2))
    b = batch_np(tcfg, 2, 16)
    step(state, {k: torch.from_numpy(v) for k, v in b.items()})
    for (path, got), (_, want) in zip(leaves_with_paths(np_params),
                                      leaves_with_paths(before)):
        np.testing.assert_array_equal(got, want, err_msg=path)
