"""Port parity: ``ContinuousEngine`` (continuous batching over the paged KV
cache), deadlines, and the serving CLI's continuous-serving flags.

At qwen1.5-110b's smoke config in f32, with the reference's
``jax.random`` parameters carried across by ``params_from_numpy``:

* greedy tokens of the port's ``ContinuousEngine`` equal the port's
  ``Engine``'s and the reference ``ContinuousEngine``'s in ``native``,
  ``int4_packed`` and ``dsp_tuned`` (two lanes, three prompts, so one
  request prefills while another decodes); the same for xlstm-1.3b (ssm:
  per-lane recurrent state, no pages) and h2o-danube-3-4b (a paged ring,
  with a prompt that crosses its 32-token window);
* a preempted request resumes bit-identically, greedy and sampled;
* a shared prefix with copy-on-write emits what the unshared run emits;
* one load (a shared prefix, a pool tight enough to preempt, deadlines
  on an injected clock) gives the reference's tokens, finish reasons and
  counts: admissions, preemptions, copy-on-write copies, the most pages in
  use after any grow or copy, sheds (the reference's counted by wrapping
  its allocator and scheduler);
* the fixed-slot ``Engine`` sheds queued and running requests at their
  deadlines.

Each reference engine is built once per module.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import io

import jax
import numpy as np
import pytest

from repro.models import transformer as JT
from repro.models.registry import get_config as j_get_config
from repro.serving import ContinuousEngine as JContinuous
from repro.serving import ServeConfig as JServeConfig
from repro_torch.convert import params_from_numpy
from repro_torch.launch import serve
from repro_torch.models.registry import get_config as t_get_config
from repro_torch.serving import ContinuousEngine, Engine, SamplingParams, ServeConfig

QWEN, XLSTM, H2O = "qwen1.5-110b", "xlstm-1.3b", "h2o-danube-3-4b"
KW = dict(n_slots=2, max_len=48, prefill_chunk=4, max_new=6, page_size=8)
PROMPTS = [[5, 17, 33, 2, 9], list(range(40, 51)), [7, 8, 9]]
# h2o-danube: 30 prompt tokens and 6 new ones cross its 32-token window
WRAP_PROMPT = [int(t) for t in np.random.default_rng(7).integers(2, 256, 30)]
FAMILY_MODES = {XLSTM: "native", H2O: "native"}


@functools.lru_cache(maxsize=None)
def weights(arch: str):
    """(jcfg, tcfg, reference params, port params), built once."""
    jcfg = dataclasses.replace(j_get_config(arch, smoke=True), dtype="float32")
    tcfg = dataclasses.replace(t_get_config(arch, smoke=True), dtype="float32")
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jparams, params_from_numpy(jax.tree.map(np.array, jparams), tcfg)


def _prompts(arch: str) -> list[list[int]]:
    return PROMPTS + [WRAP_PROMPT] if arch == H2O else PROMPTS


def _port(arch: str, engine_cls=ContinuousEngine, **kw):
    _, tcfg, _, tparams = weights(arch)
    return engine_cls(tcfg, tparams, ServeConfig(device="cpu", **{**KW, **kw}))


@functools.lru_cache(maxsize=None)
def _reference_tokens(arch: str, mode: str) -> list[list[int]]:
    jcfg, _, jparams, _ = weights(arch)
    eng = JContinuous(jcfg, jparams, JServeConfig(quant_mode=mode, **KW))
    return list(eng.generate([list(p) for p in _prompts(arch)]).values())


def _tokens(engine, prompts, **kw) -> list[list[int]]:
    return list(engine.generate([list(p) for p in prompts], **kw).values())


@pytest.mark.parametrize("arch,mode", [(QWEN, "native"), (QWEN, "int4_packed"),
                                       (QWEN, "dsp_tuned"), (XLSTM, FAMILY_MODES[XLSTM]),
                                       (H2O, FAMILY_MODES[H2O])])
def test_greedy_tokens_identical_to_engine_and_reference(arch, mode):
    cont = _port(arch, quant_mode=mode)
    got = _tokens(cont, _prompts(arch))
    assert got == _tokens(_port(arch, Engine, quant_mode=mode), _prompts(arch))
    assert got == _reference_tokens(arch, mode)
    cont.alloc.check()
    assert cont.alloc.n_free == cont.alloc.n_pages
    if arch == XLSTM:
        assert cont.alloc.n_pages == 1 and cont._max_blocks == 0  # no KV to page


@pytest.mark.parametrize("sampling", [None, SamplingParams(0.9, 8, 0.95)],
                         ids=["greedy", "sampled"])
def test_preemption_resumes_bit_identically(sampling):
    """Under page pressure the youngest lane is preempted, requeued at the
    front and re-prefilled with its own tokens; every stream equals the
    run with room to spare (greedy: and the fixed-slot engine's)."""
    prompts = [[2, 3, 4, 5, 6, 7, 8, 9, 10], [11, 12, 13, 14, 15, 16, 17]]
    kw = dict(quant_mode="int4_packed", max_len=32, seed=3)
    calm = _port(QWEN, n_pages=16, **kw)
    want = _tokens(calm, prompts, max_new=10, sampling=sampling)
    tight = _port(QWEN, n_pages=4, watermark_pages=0, **kw)
    got = _tokens(tight, prompts, max_new=10, sampling=sampling)
    assert tight.stats()["preempted"] >= 1, "the pool was not tight enough"
    assert calm.stats()["preempted"] == 0
    assert got == want
    if sampling is None:
        assert got == _tokens(_port(QWEN, Engine, **kw), prompts, max_new=10)
    tight.alloc.check()
    assert tight.alloc.n_free == tight.alloc.n_pages


def test_shared_prefix_with_copy_on_write_matches_unshared():
    """Three requests start with a 12-token system prompt (a full page of 8
    and a partial one), served one at a time: the first prefills the
    prefix, whose pages are pinned when its prefill lands; the others
    adopt them and prefill only their suffix (the prompt's last token at
    least).  The partial page is copied before each request writes into
    it: the first at its first decode, each adopter at admission.  The
    tokens are the unshared run's; the prefix's two pages stay pinned."""
    prefix = list(range(2, 14))
    prompts = [prefix + s for s in ([20, 21], [22, 23, 24], [25])]
    unshared = _port(QWEN, n_slots=1, max_len=32)
    want = _tokens(unshared, prompts, max_new=5)
    eng = _port(QWEN, n_slots=1, max_len=32, n_pages=16)
    eng.register_shared_prefix(prefix)
    assert _tokens(eng, prompts, max_new=5) == want
    st = eng.stats()
    assert st["cow_copies"] == 3 and st["admissions"] == 3
    assert unshared.stats()["prefill_tokens"] == 14 + 15 + 13
    assert st["prefill_tokens"] == 14 + 3 + 1
    assert st["free_pages"] == st["n_pages"] - 2
    eng.alloc.check()
    with pytest.raises(ValueError, match="already registered"):
        eng.register_shared_prefix(prefix)


# ---- one load, counted against the reference ------------------------------

PREFIX = list(range(2, 12))  # 10 tokens: a full page of 8 and a partial one
LOAD = [(PREFIX + [20, 21], None), ([30, 31, 32, 33, 34, 35, 36], 6500.0),
        (PREFIX + [22, 23, 24], None), (PREFIX + [25], 3500.0), ([40, 41, 42], 1500.0)]
LOAD_KW = dict(n_slots=3, max_len=32, prefill_chunk=4, page_size=8, n_pages=6,
               watermark_pages=0)


def _serve_load(eng) -> tuple:
    """Serve ``LOAD`` with the scheduler's clock advanced one second a
    step; count admissions, copy-on-write copies and the most pages in use
    after any grow or copy by wrapping the engine's allocator and
    scheduler (the reference reports none of the three)."""
    now = {"t": 0.0}
    eng.scheduler._clock = lambda: now["t"]
    counts = dict(admissions=0, cow_copies=0, peak_pages_in_use=0)
    alloc, sched = eng.alloc, eng.scheduler
    grow, make_writable, admit_front = alloc.grow, alloc.make_writable, sched.admit_front

    def note(out):
        counts["peak_pages_in_use"] = max(counts["peak_pages_in_use"],
                                          alloc.n_pages - alloc.n_free)
        return out

    def counted_make_writable(*a):
        out = note(make_writable(*a))
        counts["cow_copies"] += out[1] is not None
        return out

    def counted_admit_front():
        counts["admissions"] += 1
        return admit_front()

    alloc.grow = lambda *a: note(grow(*a))
    alloc.make_writable = counted_make_writable
    sched.admit_front = counted_admit_front
    eng.register_shared_prefix(PREFIX)
    rids = [eng.submit(list(p), max_new=8, admit=False, deadline_ms=d) for p, d in LOAD]
    for _ in range(200):
        if not (eng.active.any() or sched.n_queued):
            break
        eng.step()
        now["t"] += 1.0
    st = eng.stats()
    counts.update(preempted=st["preempted"], shed=st["shed"])
    reqs = sched.requests
    return ([list(reqs[r].tokens) for r in rids], [reqs[r].finish_reason for r in rids],
            counts, st)


def test_load_counts_equal_reference():
    jcfg, tcfg, jparams, tparams = weights(QWEN)
    want_tokens, want_reasons, want_counts, _ = _serve_load(
        JContinuous(jcfg, jparams, JServeConfig(**LOAD_KW)))
    got_tokens, got_reasons, got_counts, st = _serve_load(
        ContinuousEngine(tcfg, tparams, ServeConfig(device="cpu", **LOAD_KW)))
    assert got_tokens == want_tokens
    assert got_reasons == want_reasons
    assert got_counts == want_counts
    # the engine's own counters agree with the wrapped ones
    assert {k: st[k] for k in got_counts} == got_counts
    assert got_counts["preempted"] >= 1 and got_counts["cow_copies"] >= 1
    assert got_reasons.count("deadline") == got_counts["shed"] == 3
    assert got_tokens[1] and not got_tokens[4]  # shed running, and queued


# ---- deadlines and cancellation --------------------------------------------


@pytest.mark.parametrize("engine_cls", [Engine, ContinuousEngine], ids=["slot", "cont"])
def test_deadlines_shed_queued_and_running_requests(engine_cls):
    """One slot: the first request runs, the second waits in the queue.
    On a clock advanced one second a step, a 2.5 s deadline sheds the
    queued one before it is ever admitted and a 4.5 s one the running one
    mid-stream; both are counted as shed, not finished, and keep no latency
    sample."""
    eng = _port(QWEN, engine_cls, n_slots=1)
    now = {"t": 0.0}
    eng.scheduler._clock = lambda: now["t"]
    running = eng.submit([5, 6, 7], max_new=20, admit=False, deadline_ms=4500.0)
    queued = eng.submit([8, 9], max_new=2, admit=False, deadline_ms=2500.0)
    for _ in range(8):
        eng.step()
        now["t"] += 1.0
    reqs = eng.scheduler.requests
    assert reqs[queued].finish_reason == "deadline" and not reqs[queued].tokens
    assert reqs[running].finish_reason == "deadline" and 0 < len(reqs[running].tokens) < 20
    st = eng.stats()
    assert st["shed"] == st["cancelled"] == 2 and st["finished"] == 0
    assert st["p99_latency_s"] == 0.0 and not eng.active.any()
    with pytest.raises(ValueError, match="deadline_ms"):
        ServeConfig(device="cpu", deadline_ms=0.0)


def test_cancel_frees_the_lane_and_its_pages():
    eng = _port(QWEN)
    rid = eng.submit([5, 6, 7, 8, 9], max_new=10)
    eng.step()
    eng.step()
    assert eng.alloc.n_free < eng.alloc.n_pages
    eng.cancel(rid)
    eng.step()
    assert not eng.active.any() and eng.alloc.n_free == eng.alloc.n_pages
    assert eng.scheduler.requests[rid].finish_reason == "cancelled"
    eng.alloc.check()


@pytest.mark.parametrize("arch,feature", [(XLSTM, "recurrent state"),
                                          ("jamba-v0.1-52b", "mamba recurrent state"),
                                          (H2O, "sliding_window=32")])
def test_shared_prefix_rejected_naming_the_blocking_feature(arch, feature):
    cfg = dataclasses.replace(t_get_config(arch, smoke=True), dtype="float32")
    from repro_torch.models import transformer as TT

    eng = ContinuousEngine(cfg, TT.init_params(cfg, device="cpu"),
                           ServeConfig(device="cpu", **KW))
    with pytest.raises(ValueError, match=f"blocking feature: {feature}"):
        eng.register_shared_prefix([2, 3, 4])


def test_pool_too_small_for_one_request_raises():
    with pytest.raises(ValueError, match="cannot hold one max-length request"):
        _port(QWEN, n_pages=3)  # 48 tokens need 6 pages of 8


# ---- the CLI ----------------------------------------------------------------

CLI = ["--arch", QWEN, "--smoke", "--device", "cpu", "--requests", "3", "--max-new", "3"]


@pytest.mark.parametrize("flags,expect", [
    (["--engine", "continuous", "--page-size", "8", "--n-pages", "12",
      "--quant", "int4_packed"], "pages: 0/12 in use at exit"),
    (["--engine", "continuous", "--governor", "--quant", "dsp_tuned",
      "--deadline-ms", "60000"], "governor: tier 0 (primary)"),
    (["--replicas", "2", "--quant", "int4_packed"], "across 2 replicas"),
], ids=["continuous", "governor", "replicas"])
def test_serve_cli(flags, expect):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        serve.main(CLI + flags)
    assert expect in out.getvalue(), out.getvalue()


def test_serve_cli_refusals():
    with pytest.raises(ValueError, match="tp must be >= 1"):
        serve.main(CLI + ["--tp", "0"])
    with pytest.raises(SystemExit, match="--stream"):
        serve.main(CLI + ["--replicas", "2", "--stream"])
