"""Port parity: the fixed-slot serving ``Engine`` of ``repro_torch`` against
the reference ``Engine``, plus the port's sampling and device contracts.

Greedy decoding must emit identical tokens on the same weights, with two
slots and three requests of different prompt lengths, so that one request
is prefilled while another is mid-decode.  Sampled decoding cannot match
token for token (``jax.random`` and torch draw different numbers); it is
held to determinism for a fixed (seed, rid, position) and to the
top-k/top-p set of the reference's formula.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as JT
from repro.models.registry import get_config as j_get_config
from repro.serving import Engine as JEngine
from repro.serving import ServeConfig as JServeConfig
from repro_torch.convert import params_from_numpy, spec_from_dict
from repro_torch.models import transformer as TT
from repro_torch.models.registry import get_config as t_get_config
from repro_torch.serving import Engine, SamplingParams, ServeConfig
from repro_torch.serving.sampling import keep_mask, row_seed, sample_tokens

ARCH = "qwen1.5-110b"
PROMPTS = [[5, 17, 33, 2, 9], [40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50],
           [7, 8, 9]]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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
def weights():
    jcfg = dataclasses.replace(j_get_config(ARCH, smoke=True), dtype="float32")
    tcfg = dataclasses.replace(t_get_config(ARCH, smoke=True), dtype="float32")
    np_tree = numpy_params(jcfg)
    jparams = jax.tree.map(jnp.asarray, np_tree)
    tparams = params_from_numpy(np_tree, tcfg)
    return jcfg, tcfg, jparams, tparams


@pytest.mark.parametrize("mode", ["native", "int4_packed", "dsp_tuned"])
def test_greedy_tokens_identical_to_reference_engine(weights, mode):
    jcfg, tcfg, jparams, tparams = weights
    kw = dict(n_slots=2, max_len=32, prefill_chunk=4, max_new=6, quant_mode=mode)
    jeng = JEngine(jcfg, jparams, JServeConfig(**kw))
    want = jeng.generate(PROMPTS)
    plan_table = None
    if mode == "dsp_tuned":
        plan_table = {p: spec_from_dict(dataclasses.asdict(r.spec))
                      for p, r in jeng.plan_table.items()}
    teng = Engine(tcfg, tparams, ServeConfig(device="cpu", use_kernel=False, **kw),
                  plan_table=plan_table)
    got = teng.generate(PROMPTS)
    assert got == want
    for rid in want:
        assert (teng.scheduler.requests[rid].finish_reason
                == jeng.scheduler.requests[rid].finish_reason)
    if mode == "dsp_tuned":
        assert {p: r.name for p, r in teng.plan_table.items()} == {
            p: r.name for p, r in jeng.plan_table.items()}


def test_sampled_decoding_is_deterministic(weights):
    _, tcfg, _, tparams = weights
    scfg = ServeConfig(device="cpu", n_slots=2, max_len=32, prefill_chunk=4,
                       max_new=6, seed=3)
    sampling = SamplingParams(temperature=0.9, top_k=20, top_p=0.9)
    runs = [Engine(tcfg, tparams, scfg).generate(PROMPTS, sampling=sampling)
            for _ in range(2)]
    assert runs[0] == runs[1]
    logits = torch.randn(3, 50, generator=torch.Generator().manual_seed(0))
    temp = torch.full((3,), 0.7)
    seeds = [row_seed(3, rid, 9) for rid in range(3)]
    a = sample_tokens(logits, seeds, temp, torch.full((3,), 5), torch.ones(3))
    b = sample_tokens(logits, seeds, temp, torch.full((3,), 5), torch.ones(3))
    assert torch.equal(a, b)


def _reference_keep(logits, temperature, top_k, top_p):
    """The keep set of ``repro.serving.sampling.sample_tokens``, in jnp."""
    v = logits.shape[-1]
    scaled = logits / jnp.maximum(temperature, 1e-6)[:, None]
    desc = -jnp.sort(-scaled, axis=-1)
    kth = jnp.take_along_axis(desc, jnp.clip(top_k - 1, 0, v - 1)[:, None], axis=-1)
    keep = jnp.where((top_k > 0)[:, None], scaled >= kth, True)
    probs = jax.nn.softmax(scaled, axis=-1)
    sp = -jnp.sort(-probs, axis=-1)
    csum = jnp.cumsum(sp, axis=-1)
    n_keep = jnp.maximum(jnp.sum(csum - sp < top_p[:, None], axis=-1), 1)
    thr = jnp.take_along_axis(sp, (n_keep - 1)[:, None], axis=-1)
    return keep & (probs >= thr)


def test_sampled_tokens_lie_in_reference_top_k_top_p_set():
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((4, 64)) * 3).astype(np.float32)
    temp = np.array([0.5, 1.0, 1.3, 0.8], np.float32)
    top_k = np.array([0, 5, 12, 3], np.int32)
    top_p = np.array([0.8, 1.0, 0.6, 0.95], np.float32)
    want = np.asarray(_reference_keep(jnp.asarray(logits), jnp.asarray(temp),
                                      jnp.asarray(top_k), jnp.asarray(top_p)))
    lt, tt = torch.from_numpy(logits), torch.from_numpy(temp)
    kt, pt = torch.from_numpy(top_k).long(), torch.from_numpy(top_p)
    np.testing.assert_array_equal(keep_mask(lt, tt, kt, pt).numpy(), want)
    for pos in range(50):
        seeds = [row_seed(0, rid, pos) for rid in range(4)]
        tok = sample_tokens(lt, seeds, tt, kt, pt).numpy()
        assert want[np.arange(4), tok].all()
    greedy = sample_tokens(lt, [0] * 4, torch.zeros(4), kt, pt).numpy()
    np.testing.assert_array_equal(greedy, logits.argmax(-1))


def test_entry_points_default_to_cuda_and_raise_without_it(weights):
    _, tcfg, _, tparams = weights
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Engine(tcfg, tparams, ServeConfig())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TT.init_params(tcfg)
    with pytest.raises(ValueError, match="use_kernel=True"):
        Engine(tcfg, tparams, ServeConfig(device="cpu", use_kernel=True))


def test_unported_knobs_are_rejected_by_name():
    """No knob is rejected as unported any more: tensor parallelism, the
    continuous engine's paged-cache knobs, deadlines and the governor are
    validated as the reference validates them."""
    assert ServeConfig(device="cpu", tp=2).tp == 2
    with pytest.raises(ValueError, match="tp must be >= 1"):
        ServeConfig(device="cpu", tp=0)
    with pytest.raises(ValueError, match="use_kernel=True is not supported"):
        ServeConfig(device="cpu", tp=2, use_kernel=True)
    scfg = ServeConfig(device="cpu", page_size=8, n_pages=4, watermark_pages=1,
                       deadline_ms=5.0, governor=True, quant_mode="dsp_tuned")
    assert (scfg.page_size, scfg.n_pages, scfg.watermark_pages) == (8, 4, 1)
    assert ServeConfig(device="cpu").page_size == 16
    for name, value in (("page_size", 0), ("n_pages", 0), ("watermark_pages", -1),
                        ("deadline_ms", 0.0), ("governor", True)):
        with pytest.raises(ValueError, match=name):
            ServeConfig(device="cpu", **{name: value})


def test_port_imports_neither_jax_nor_the_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "spec = importlib.util.spec_from_file_location('chip_smoke', "
        f"{os.path.join(REPO, 'chip_smoke.py')!r})\n"
        "importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith('jax.')"
        " or n == 'repro' or n.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print('ok', len([n for n in sys.modules if n.startswith('repro_torch')]))\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
