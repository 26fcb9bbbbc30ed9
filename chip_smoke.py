"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card, ``nvcc``
and PyTorch built for CUDA.  It imports nothing of JAX or of the JAX
package ``repro``.  Phases, each of which fails the run (non-zero exit) if
anything in it fails:

1. the card: ``nvidia-smi`` name and power limit;
2. build every ``src/repro_torch/kernels/csrc/*.cu`` with nvcc for sm_90a;
3. each CUDA kernel against its plain PyTorch version on the card, on
   seeded inputs (several plans, an mr plan whose even lane is read from
   wsc (bits_w > p) among them, both activation forms, ragged M/N/K, the
   M > 16 kernels at M 17, 33, 63 and with K split over blocks, the
   M <= 16 kernels forced at M = 64, and the main path's shapes),
   bit-exact (max abs diff 0), and the M <= 16 kernels at every geometry
   (M 1, 2, 4, 8, 16; N a multiple of 16, of 8 only, of 4 only and odd;
   K 8192, split over blocks, and 202); the four matmul wrappers at the
   MoE path's shapes, (K, N) (2048, 1408), (1408, 2048) and the lm_head's
   (2048, 163840), at M 1, 3, 7, 17, 33, and at the families' shapes
   (``FAMILY_SHAPES``: jamba's Mamba projections and experts, xlstm's
   N = 4 gates, h2o-danube's and whisper's lm_heads, N = 51866 among them)
   at M 1, 4, 17, 64; then each kernel timed with CUDA
   events at the main path's decode (M=4) and prefill (M=64) shapes, beside
   its plain version, its bound and a library call, and at M=64 beside the
   M <= 16 kernel; at M=4 also by the replay of a CUDA graph of the same
   launches (``graph_ms``: the device's time, where the event-timed loop
   runs at the host's enqueue rate);
4. the main path: qwen1.5-110b at full width (depth cut to 4 layers,
   random seeded weights on the card) served greedily by the fixed-slot
   ``Engine`` in native, int8, int4_packed, dsp_tuned and dsp_packed, then
   each quantized mode again with ``fuse_projections="all"``, whose greedy
   tokens must equal the unfused run's; dsp_tuned's plans come from the
   tuner (plan_bits (4, 4), budget 0.5, the cost proxy), which must pick
   a4w4-p10-n32-mr+full-c2 on every packable weight, and a second
   dsp_tuned engine given that plan by hand must emit the same tokens;
   dsp_tuned is built once more with ``autotune_plans`` (the tuner times
   the kernel variants at each layer shape on the card) and its greedy
   tokens must equal a plain-version engine's on the same plans; the
   kernels' launch counters are zeroed just before and read just after,
   and every kernel must have launched (the M <= 16 kernels in decode, the
   M > 16 ones, ``packed_matmul_prepacked_tiled`` among them, in 64-row
   prefill chunks); logits must be finite; dsp_mixed runs its sensitivity
   pass on the card (4 widths, 32 calibration tokens, budget 0.05: 8 paths
   x 4 widths = 32 probes of 64 rows) and serves the allocation;
   then the MoE path, its counts zeroed just before and read just after:
   moonshot-v1-16b-a3b at full width (d_model 2048, 64 experts, top-6,
   d_ff 1408, vocab 163840; 48 layers cut to 4; bf16 seeded weights)
   served with the same requests in native, int8, int4_packed, dsp_tuned
   (the tuner's plans) and dsp_packed, each packed kernel launched;
   then the families, each config's counts zeroed just before it and read
   just after, all at full width with bf16 seeded weights and the same
   slots and requests: jamba-v0.1-52b (8 of 32 layers, one attention
   group) and xlstm-1.3b (all 48 layers) in native, int8, int4_packed,
   dsp_tuned and dsp_packed; h2o-danube-3-4b (2 layers, the window does
   not wrap at max_len 64), whisper-large-v3 (2 decoder and 2 encoder
   layers; also ``encode`` on 1500 frames and a decoder forward over its
   output) and llava-next-mistral-7b (2 layers; also a forward with its
   2880 patch embeddings) in native, int4_packed and dsp_tuned; each
   packed mode must launch its kernels (a sliding window prefills one
   token a chunk: its M <= 16 kernels only), logits must be finite;
5. whole-path agreement at the smoke configs (qwen1.5-110b,
   moonshot-v1-16b-a3b and the five families): the kernel engine and the
   plain-version engine emit identical greedy tokens in int4_packed,
   dsp_tuned (mr plan, each expert's too), dsp_packed and, for qwen,
   moonshot and xlstm, dsp_mixed (one allocation, from the first kernel
   engine's sensitivity pass, handed to the other three), with prefill
   chunks of 8 rows and of 32 (the M > 16 kernels); h2o-danube with a
   30-token prompt that crosses its 32-token window;
6. the paper's arithmetic on the card: ``scheme_stats`` of the five
   schemes on INT4 (delta 3), INT4 overpacked (delta -2) and the six
   4x5-bit products (Tables I/II), equal to the same calls on the CPU, and
   the quickstart's packed matmul equal to the exact integer matmul;
7. the addition-packing SNN path: one spiking layer of 512 inputs and
   2 x 524,288 neurons over 64 steps, its drive accumulated by
   ``addpack_accumulate`` (launch count zeroed just before, read just
   after), bit-exact against the kernel's plain version, the per-lane sum
   oracle and ``torch.sum``; then the reference tests' shapes (odd T,
   several N, an out-of-range case against the plain version only) and
   the kernel timed beside ``torch.sum``;
8. ``flash_attention`` on its three routes, all on the tensor cores, each
   path with the launch counts zeroed just before and read just after:
   bf16 and f16 at qwen1.5-110b's attention width (B 1, H 64 from 8 KV
   heads, hd 128, S 4096), and f32 (B 1, H 8, S 4096, hd 128), whose
   operands the route splits into three bf16 terms; each against its plain
   version and its route's emulation there, at the reference tests'
   shapes, at hd 64 and at ragged S; then each timed beside
   ``scaled_dot_product_attention`` in its dtype and its bounds (the f32
   route's counting its own six products, ``bound_basis`` "design"; the
   others' the function's), the f32 route beside the CUDA-core kernel it
   replaced, which is held to the plain version too (at the f32 shape and
   at ragged S with hd 120), and the bf16 kernel at 8 heads with hd 64 and
   128; every route also checked at hd 16 and 120, which the kernels run
   at their hd 64 and 128 instantiations; float64 inputs (hd 16 and 128)
   through the f32 route, held to the plain version on f32 copies;
9. the plan search on the card: ``rank_plans(4, 4)`` at budget 0.5 by the
   cost proxy from a cold score cache, then with ``autotune=True`` at
   (64, 8192, 8192) and decode (4, 8192, 8192), which times each plan's
   kernel variants of ``packed_matmul_prepacked`` (every candidate held
   bit-exact to the first); every in-budget plan's variants timed at both
   shapes, and the winners that differ from the wrapper's own choice by M
   counted; the top plan's winning variants held against the plain version
   at those shapes; then dsp_tuned engines at the smoke config on one
   temporary plan database: a cold build (a miss, plans scored), a warm one
   (a hit, no plan scored, the same plans and tokens) and one with
   ``autotune_plans``, whose plans (each forcing its tuned variants) must
   emit identical greedy tokens in a kernel and a plain-version engine,
   with prefill chunks of 8 rows and of 32; then dsp_mixed cold (a miss,
   the sensitivity pass run) and warm (a hit, no probe, the same widths
   and tokens) on the same database.

Output: progress lines, the card's name and power limit, one JSON line
``{"kernels": [...]}`` and, last, ``{"ok": true, "device": {...}}``.
``--json PATH`` also writes the full timing and serving tables there.
Without CUDA, or outside a checkout of the repository, it exits non-zero
and prints no result.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
MAIN_PLAN = "a4w4-p10-n32-mr+full-c2"
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
INT8_TENSOR_OPS_PER_S = 1979e12  # H100 SXM dense int8 tensor cores
CUDA_CORE_OPS_PER_S = 67e12    # H100 SXM fp32 outside the tensor cores
# 32-bit integer instructions: 64 results per clock per SM for IMAD and
# for add/shift/logic each (CUDA C++ Programming Guide, arithmetic
# instruction throughput, compute capability 9.0), on separate pipes;
# 132 SMs at the 1,980 MHz boost clock
IMAD_PER_S = 64 * 132 * 1.98e9
INT_ALU_PER_S = 64 * 132 * 1.98e9
BF16_TENSOR_OPS_PER_S = 989e12  # H100 SXM dense bf16 tensor cores
# main-path linear shapes (K, N) at full width: wq/wo, wk/wv, up/gate,
# down, lm_head; decode runs M = n_slots = 4 rows, prefill 4 x 16 = 64
SHAPES = [(8192, 8192), (8192, 1024), (8192, 49152), (49152, 8192), (8192, 152064)]
HEADLINE = (4, 8192, 49152)  # the JSON line's shape: the up/gate decode GEMV
HEADLINE_PREFILL = (64, 8192, 49152)  # ... and for the M > 16 kernels, prefill
# phase 7: one SNN layer (examples/snn_addpack.py at a real layer size)
SNN_IN, SNN_HALF, SNN_STEPS, SNN_THRESHOLD = 512, 524288, 64, 64
# phase 8: attention at qwen1.5-110b's width, one 4096-token sequence
ATTN_SEQ = 4096
# tolerances (atol, rtol) of the attention kernel against its plain
# version: both compute in f32 and differ by summation order (atol 1e-5);
# bf16 and f16 outputs, compared in f32, are rounded once each, so they may
# also sit one step of their type apart (rtol 2**-7, bf16's 8-bit
# significand; 2**-10, f16's 11-bit one)
ATTN_TOL = {"float32": (1e-5, 0.0), "bfloat16": (1e-5, 2**-7), "float16": (1e-5, 2**-10)}
# phase 8's kernels line: one entry per route
ROUTE_NAMES = {"bfloat16": "flash_attention", "float16": "flash_attention_f16",
               "float32": "flash_attention_f32"}
# the CUDA-core f32 kernel that the f32 route replaced: checked and timed
CUDA_CORE_NAME = "flash_attention_f32_cuda_core"
# phase 3: an mr plan whose even lane the kernels read from wsc (bits_w > p)
WSC_PLAN = "a4w8-p7-n2-mr+full-c4"
PACKED_MODES = ("int4_packed", "dsp_tuned", "dsp_packed")
MOE_MODES = ("native", "int8") + PACKED_MODES  # the MoE phase at moonshot's width
QUANT_MODES = ("int8",) + PACKED_MODES  # served again fused
# phase 9: the block sweep's probes (an 8192 x 8192 linear, prefill and decode)
SWEEP_SHAPE, SWEEP_DECODE = (64, 8192, 8192), (4, 8192, 8192)
L2_BYTES = 50 * 2**20
SLICE_N = 16384  # plain versions run in column slices to bound their memory
# phase 3: moonshot-v1-16b-a3b's expert shapes (K, N) (up/gate, down) and its
# lm_head, where N = 1408 is not a multiple of the wide kernels' 512 columns,
# at the per-expert row counts of MoE dispatch
MOE_SHAPES = [(2048, 1408), (1408, 2048), (2048, 163840)]
MOE_ROWS = (1, 3, 7, 17, 33)
# phase 3: the families' linear shapes (K, N) no earlier path reached:
# jamba's in_proj, x_proj, dt_proj, out_proj and experts (up/gate, down);
# xlstm's projections and its N = 4 gates (float leaves, quantized at every
# call); h2o-danube's wk/wv, down and lm_head; whisper's up and its lm_head
# (N % 4 = 2); each at decode and prefill row counts
FAMILY_SHAPES = [(4096, 16384), (8192, 288), (256, 8192), (8192, 4096), (4096, 14336),
                 (14336, 4096), (2048, 2048), (2048, 4), (3840, 960), (10240, 3840),
                 (3840, 32000), (1280, 5120), (1280, 51866)]
FAMILY_ROWS = (1, 4, 17, 64)
# the families phase: each config at full width, its depth cut (whisper's
# encoder, which the engine never runs, to 2 layers too), in these modes
ALL_MODES = ("native", "int8", "int4_packed", "dsp_tuned", "dsp_packed")
FEW_MODES = ("native", "int4_packed", "dsp_tuned")
FAMILIES = [("jamba-v0.1-52b", dict(n_layers=8), ALL_MODES),
            ("xlstm-1.3b", {}, ALL_MODES),
            ("h2o-danube-3-4b", dict(n_layers=2), FEW_MODES),
            ("whisper-large-v3", dict(n_layers=2, n_encoder_layers=2), FEW_MODES),
            ("llava-next-mistral-7b", dict(n_layers=2), FEW_MODES)]
# phase 5: h2o-danube's smoke window is 32 tokens; this prompt and 6 new
# tokens cross it
WRAP_PROMPT_LEN = 30


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# ---- timing and bounds -------------------------------------------------------


def cuda_ms(torch, fn, iters: int) -> float:
    """Mean time of ``fn()`` over ``iters`` launches, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(torch, fn, iters: int) -> float:
    """Mean time of ``fn()`` over ``iters`` launches captured once in a CUDA
    graph and replayed between CUDA events (the median of three replays):
    the device's time with no host enqueue in the loop (an event-timed loop
    of M <= 16 calls times the host).  ``fn`` is warmed up on a side stream
    first, as capture asks."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(3):
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    del graph
    return sorted(times)[1]


def zero_counts(K) -> None:
    """Every wrapper's launch count, flash_attention's per route and the
    matmuls' per kernel variant, to 0."""
    for f in K.WRAPPERS.values():
        f.launches = 0
    for counts in (K.flash_attention.route_launches, K.int4_matmul.variant_launches,
                   K.packed_matmul.variant_launches,
                   K.packed_matmul_prepacked.variant_launches):
        counts.update(dict.fromkeys(counts, 0))


def kernel_counts(K) -> dict:
    """Launches per kernel: the single-kernel wrappers', and the matmuls'
    per variant (the M <= 16 kernel under the wrapper's own name)."""
    counts = {name: f.launches for name, f in K.WRAPPERS.items()
              if name not in ("int4_matmul", "packed_matmul", "packed_matmul_prepacked")}
    counts.update(K.int4_matmul.variant_launches)
    counts.update(K.packed_matmul.variant_launches)
    counts.update(K.packed_matmul_prepacked.variant_launches)
    return counts


def bound(bytes_moved: float, ops: float, ops_rate: float) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def packed_bound(bytes_moved: float, m: int, k: int, n: int, spec,
                 derived: bool = False) -> tuple[float, str, dict]:
    """Bound of the pair-packed kernels: the bytes, or the 32-bit integer
    work, whichever takes longer.  The work: one IMAD per packed pair and
    output per column stream (twice with an mr correction, whose
    contamination is a second product), at the IMAD rate; and the
    extraction of every chunk's field, 3 integer operations (align and
    round, arithmetic shift, accumulate), 3 more for the mr restore and 1
    for a column's recombining shift, plus, where the even lane is
    ``derived`` from the words, 6 per pair word (mask, sign flip, subtract,
    subtract, shift, mask), at the add/shift/logic rate.  The two pipes
    issue side by side, so the slower one bounds.  Also returns each term in
    ms."""
    columns = spec.n_columns
    macs = m * (k // 2) * n * columns * (2 if spec.uses_mr else 1)
    fields = m * n * -(-k // spec.chunk) * columns
    ext = fields * (3 + (3 if spec.uses_mr else 0) + (1 if columns > 1 else 0))
    if derived:
        ext += 6 * (k // 2) * n
    terms = dict(bytes_ms=bytes_moved / HBM_BYTES_PER_S * 1e3,
                 imad_ms=macs / IMAD_PER_S * 1e3, extract_ms=ext / INT_ALU_PER_S * 1e3)
    t_ops = max(terms["imad_ms"], terms["extract_ms"])
    if terms["bytes_ms"] >= t_ops:
        return terms["bytes_ms"], "bytes", terms
    return t_ops, "operations", terms


def by_columns(torch, fn, n: int):
    """``fn(n0, n1)`` over column slices of at most SLICE_N, concatenated."""
    return torch.cat([fn(n0, min(n0 + SLICE_N, n)) for n0 in range(0, n, SLICE_N)],
                     dim=1)


def max_diff(torch, got, want) -> int:
    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max().item())


# ---- phase 3: kernels against their plain versions --------------------------


def check_kernels(torch, K, ref, checks: list) -> None:
    """Bit-exactness of every kernel against its plain version on seeded
    inputs: several plans (one mr plan with bits_w > p, whose even lane is
    read from wsc), both activation forms, ragged M/N/K; the M > 16 kernels
    also at ragged M (17, 33, 63), with K split over blocks, and the M <= 16
    kernels forced at M = 64.  Each check is named after the kernel that
    ran it."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    plans = [ref.INT4_EXACT, ref.INT4_NAIVE, ref.INT4_MR_OVERPACKED,
             ref.spec_from_name(MAIN_PLAN), ref.spec_from_name("a4w4-p11-n16-full-c2"),
             ref.spec_from_name("a8w8-p11-n1-full-c4"), ref.spec_from_name(WSC_PLAN)]
    shapes = [(5, 200, 300), (3, 130, 129), (4, 200, 300), (17, 130, 129),
              (64, 1000, 515), (4, 8192, 1024), (33, 8192, 1024), (63, 4096, 520)]
    for spec in plans:
        for m, k, n in shapes:
            x_u = torch.randint(0, 1 << spec.bits_a, (m, k), generator=gen,
                                device=dev, dtype=torch.int32)
            lo = -(1 << (spec.bits_w - 1))
            w_s = torch.randint(lo, -lo, (k, n), generator=gen, device=dev,
                                dtype=torch.int32)
            packed = ref.pack_weight_words(w_s, spec)
            name = f"{spec.name()} M={m} K={k} N={n}"
            xf = torch.randn((m, k), generator=gen, device=dev)
            zp = 1 << (spec.bits_a - 1)
            scale = xf.abs().amax(-1, keepdim=True).clamp_min(1e-8) / (zp - 1)
            want_int = K.packed_matmul_prepacked_plain(x_u, packed.words, packed.wsc, spec)
            want_fused = K.packed_matmul_prepacked_plain(xf, packed.words, packed.wsc, spec,
                                                         x_scale=scale, x_zp=zp)
            runs = [(K.prepacked_variant(m, spec), K.packed_matmul_prepacked)]
            if m == 64:  # the one-column kernel forced where the tiled one runs
                runs.append(("packed_matmul_prepacked",
                             K.prepacked_kernels["packed_matmul_prepacked"]))
            for variant, fn in runs:
                got = fn(x_u, packed.words, packed.wsc, spec)
                checks.append((variant, name + " int", max_diff(torch, got, want_int)))
                got = fn(xf, packed.words, packed.wsc, spec, scale, zp)
                checks.append((variant, name + " fused", max_diff(torch, got, want_fused)))
            w8 = w_s.to(torch.int8)
            want = K.packed_matmul_plain(x_u, w8, spec)
            checks.append((K.packed_variant(m, spec), name,
                           max_diff(torch, K.packed_matmul(x_u, w8, spec), want)))
            if m == 64:
                got = K.packed_kernels["packed_matmul"](x_u, w8, spec)
                checks.append(("packed_matmul", name, max_diff(torch, got, want)))
    for m, k, n in [(5, 202, 300), (17, 130, 130), (64, 1024, 515), (4, 8192, 1024),
                    (17, 8192, 1024), (33, 1000, 520), (63, 49152, 1024), (64, 8192, 8192)]:
        x = torch.randint(-128, 128, (m, k), generator=gen, device=dev, dtype=torch.int8)
        w = torch.randint(0, 256, (k // 2, n), generator=gen, device=dev, dtype=torch.uint8)
        want = K.int4_matmul_plain(x, w)
        checks.append((K.int4_variant(m), f"M={m} K={k} N={n}",
                       max_diff(torch, K.int4_matmul(x, w), want)))
        if m == 64:
            checks.append(("int4_matmul", f"M={m} K={k} N={n}",
                           max_diff(torch, K.int4_kernels["int4_matmul"](x, w), want)))
    # the M <= 16 kernels' geometries (8 columns a thread, or 4 for
    # int4_matmul and one for packed_matmul): every M tile; N a multiple of
    # 16, of 8 only, of 4 only, odd (and 304, also a multiple of 16); K long
    # enough to split over blocks, and short and ragged
    geometry_plans = [ref.INT4_EXACT, ref.INT4_NAIVE, ref.INT4_MR_OVERPACKED,
                      ref.spec_from_name("a8w8-p11-n1-full-c4")]
    for m in (1, 2, 4, 8, 16):
        for n in (1024, 304, 312, 300, 129):
            for k in (8192, 202):
                x = torch.randint(-128, 128, (m, k), generator=gen, device=dev,
                                  dtype=torch.int8)
                w = torch.randint(0, 256, (k // 2, n), generator=gen, device=dev,
                                  dtype=torch.uint8)
                checks.append(("int4_matmul", f"M={m} K={k} N={n}", max_diff(
                    torch, K.int4_matmul(x, w), K.int4_matmul_plain(x, w))))
                for spec in geometry_plans:
                    x_u = torch.randint(0, 1 << spec.bits_a, (m, k), generator=gen,
                                        device=dev, dtype=torch.int32)
                    lo = -(1 << (spec.bits_w - 1))
                    w8 = torch.randint(lo, -lo, (k, n), generator=gen, device=dev,
                                       dtype=torch.int32).to(torch.int8)
                    checks.append(("packed_matmul", f"{spec.name()} M={m} K={k} N={n}",
                                   max_diff(torch, K.packed_matmul(x_u, w8, spec),
                                            K.packed_matmul_plain(x_u, w8, spec))))
    torch.cuda.synchronize()


def check_geometries(torch, K, ref, checks: list, shapes, rows, tag: str,
                     seed: int) -> None:
    """The four matmul wrappers bit-exact against their plain versions at
    a path's ``shapes`` (K, N) and row counts (``rows``, each M choosing its
    kernel): int4_matmul, packed_matmul (``INT4_EXACT``) and
    packed_matmul_prepacked in the fused form with the main plan, the exact
    preset and an a8w8 plan (and the int form with the main plan).  Plain
    versions run in column slices."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    exact = ref.INT4_EXACT
    plans = [ref.spec_from_name(MAIN_PLAN), exact, ref.spec_from_name("a8w8-p11-n1-full-c4")]

    def cols(t, a, b):
        return None if t is None else t[..., a:b]

    for k, n in shapes:
        w4 = torch.randint(0, 256, (k // 2, n), generator=gen, device=dev, dtype=torch.uint8)
        w8 = torch.randint(-8, 8, (k, n), generator=gen, device=dev, dtype=torch.int8)
        for m in rows:
            where = f"{tag} M={m} K={k} N={n}"
            x = torch.randint(-128, 128, (m, k), generator=gen, device=dev, dtype=torch.int8)
            want = by_columns(torch, lambda a, b: K.int4_matmul_plain(x, w4[:, a:b]), n)
            checks.append((K.int4_variant(m), where, max_diff(torch, K.int4_matmul(x, w4), want)))
            xu = torch.randint(0, 16, (m, k), generator=gen, device=dev, dtype=torch.int32)
            want = by_columns(torch, lambda a, b: K.packed_matmul_plain(xu, w8[:, a:b], exact), n)
            checks.append((K.packed_variant(m, exact), f"{exact.name()} {where}",
                           max_diff(torch, K.packed_matmul(xu, w8, exact), want)))
        del w4, w8
        for i, spec in enumerate(plans):
            lo = -(1 << (spec.bits_w - 1))
            w_s = torch.randint(lo, -lo, (k, n), generator=gen, device=dev, dtype=torch.int32)
            pw = ref.pack_weight_words(w_s, spec)
            del w_s
            zp = 1 << (spec.bits_a - 1)
            for m in rows:
                where = f"{spec.name()} {tag} M={m} K={k} N={n}"
                xf = torch.randn((m, k), generator=gen, device=dev)
                scale = xf.abs().amax(-1, keepdim=True).clamp_min(1e-8) / (zp - 1)
                want = by_columns(torch, lambda a, b: K.packed_matmul_prepacked_plain(
                    xf, pw.words[..., a:b], cols(pw.wsc, a, b), spec, x_scale=scale,
                    x_zp=zp), n)
                got = K.packed_matmul_prepacked(xf, pw.words, pw.wsc, spec, x_scale=scale,
                                                x_zp=zp)
                variant = K.prepacked_variant(m, spec)
                checks.append((variant, where + " fused", max_diff(torch, got, want)))
                if i == 0:
                    x_u = torch.randint(0, 1 << spec.bits_a, (m, k), generator=gen,
                                        device=dev, dtype=torch.int32)
                    want = by_columns(torch, lambda a, b: K.packed_matmul_prepacked_plain(
                        x_u, pw.words[..., a:b], cols(pw.wsc, a, b), spec), n)
                    got = K.packed_matmul_prepacked(x_u, pw.words, pw.wsc, spec)
                    checks.append((variant, where + " int", max_diff(torch, got, want)))
            del pw
        gc.collect()
        torch.cuda.empty_cache()
    torch.cuda.synchronize()


def library_ms(torch, fn) -> float | None:
    """Time of the yardstick library call, or None where PyTorch refuses
    the shape (the refusal is printed)."""
    try:
        return cuda_ms(torch, fn, 20)
    except RuntimeError as e:
        log(f"library call refused: {str(e).splitlines()[0]}")
        return None


def _copies(make, nbytes: int) -> list:
    """Enough independent weight copies that cycling them exceeds the L2
    cache, so every timed launch reads its weights from HBM, as decode does."""
    return [make() for _ in range(max(1, math.ceil(2 * L2_BYTES / nbytes)))]


def time_kernels(torch, K, ref, checks: list) -> list[dict]:
    """Each kernel at the main path's shapes: exactness against the plain
    version, kernel / plain / library time, bound; at M = 64 the M <= 16
    kernel (the parent's) timed beside the M > 16 one (``parent_ms``)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    main = ref.spec_from_name(MAIN_PLAN)
    exact = ref.INT4_EXACT  # dsp_packed's default plan (LinearSpec.dsp_spec)
    rows = []
    for m in (4, 64):
        for k, n in SHAPES:
            xf = torch.randn((m, k), generator=gen, device=dev)
            # int4_matmul: (M, K) int8 x (K/2, N) nibbles
            xq = torch.randint(-127, 128, (m, k), generator=gen, device=dev,
                               dtype=torch.int8)
            ws = _copies(lambda: torch.randint(0, 256, (k // 2, n), generator=gen,
                                               device=dev, dtype=torch.uint8), k * n // 2)
            it = iter(range(10**9))
            ms = cuda_ms(torch, lambda: K.int4_matmul(xq, ws[next(it) % len(ws)]), 20)
            g_ms = parent_ms = None
            if m <= 16:
                g_ms = graph_ms(torch, lambda: K.int4_matmul(xq, ws[next(it) % len(ws)]), 20)
            else:
                parent_ms = cuda_ms(torch, lambda: K.int4_kernels["int4_matmul"](
                    xq, ws[next(it) % len(ws)]), 20)
            t0 = time.perf_counter()
            want = by_columns(torch, lambda a, b: K.int4_matmul_plain(xq, ws[0][:, a:b]), n)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            variant = K.int4_variant(m)
            checks.append((variant, f"main M={m} K={k} N={n}",
                           max_diff(torch, K.int4_matmul(xq, ws[0]), want)))
            w8 = ref.unpack_int4_weights(ws[0])
            xpad = torch.nn.functional.pad(xq, (0, 0, 0, max(0, 32 - m)))  # _int_mm: M > 16
            lib_ms = library_ms(torch, lambda: torch._int_mm(xpad, w8))
            del w8, want
            b_ms, b_by = bound(m * k + k * n / 2 + 4 * m * n, 2 * m * k * n,
                               INT8_TENSOR_OPS_PER_S)
            rows.append(dict(kernel=variant, M=m, K=k, N=n, ms=ms, graph_ms=g_ms,
                             parent_ms=parent_ms, plain_ms=plain_ms, library_ms=lib_ms,
                             library="torch._int_mm on unpacked int8"
                             + (" (M padded to 32)" if m < 32 else ""),
                             bound_ms=b_ms, bound_by=b_by))
            del ws
            # packed_matmul_prepacked: the main plan, fused-quantize form
            zp = 1 << (main.bits_a - 1)
            scale = xf.abs().amax(-1, keepdim=True).clamp_min(1e-8) / (zp - 1)

            def make_packed():
                w = torch.randint(-8, 8, (k, n), generator=gen, device=dev, dtype=torch.int32)
                return ref.pack_weight_words(w, main)
            pw = _copies(make_packed, 2 * k * n)  # the kernels read the words alone
            it = iter(range(10**9))
            ms = cuda_ms(torch, lambda: K.packed_matmul_prepacked(
                xf, *pw[next(it) % len(pw)], main, x_scale=scale, x_zp=zp), 10)
            g_ms = parent_ms = None
            if m <= 16:
                g_ms = graph_ms(torch, lambda: K.packed_matmul_prepacked(
                    xf, *pw[next(it) % len(pw)], main, x_scale=scale, x_zp=zp), 10)
            else:
                parent_ms = cuda_ms(torch, lambda: K.prepacked_kernels["packed_matmul_prepacked"](
                    xf, *pw[next(it) % len(pw)], main, scale, zp), 10)
            t0 = time.perf_counter()
            want = by_columns(torch, lambda a, b: K.packed_matmul_prepacked_plain(
                xf, pw[0].words[..., a:b], pw[0].wsc[..., a:b], main,
                x_scale=scale, x_zp=zp), n)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            variant = K.prepacked_variant(m, main)
            got = K.packed_matmul_prepacked(xf, *pw[0], main, x_scale=scale, x_zp=zp)
            checks.append((variant, f"main {MAIN_PLAN} M={m} K={k} N={n}",
                           max_diff(torch, got, want)))
            del pw, want, got
            # needed bytes: x, scale, words (2 B/weight: the plan's even
            # lane is derived from them, wsc is not read), out
            b_ms, b_by, terms = packed_bound(4 * m * k + 4 * m + 2 * k * n + 4 * m * n,
                                             m, k, n, main, derived=True)
            rows.append(dict(kernel=variant, plan=MAIN_PLAN, M=m, K=k, N=n, ms=ms,
                             graph_ms=g_ms, parent_ms=parent_ms, plain_ms=plain_ms,
                             library_ms=None,
                             library="none: the mr plan is not exact, no library "
                             "call computes its arithmetic", bound_ms=b_ms, bound_by=b_by,
                             bound_terms=terms))
            # packed_matmul: INT4_EXACT, unsigned ints x int8 weights
            xu = torch.randint(0, 16, (m, k), generator=gen, device=dev, dtype=torch.int32)
            w8s = _copies(lambda: torch.randint(-8, 8, (k, n), generator=gen, device=dev,
                                                dtype=torch.int8), k * n)
            it = iter(range(10**9))
            ms = cuda_ms(torch, lambda: K.packed_matmul(xu, w8s[next(it) % len(w8s)], exact), 10)
            g_ms = parent_ms = None
            if m <= 16:
                g_ms = graph_ms(torch, lambda: K.packed_matmul(
                    xu, w8s[next(it) % len(w8s)], exact), 10)
            else:
                parent_ms = cuda_ms(torch, lambda: K.packed_kernels["packed_matmul"](
                    xu, w8s[next(it) % len(w8s)], exact), 10)
            t0 = time.perf_counter()
            want = by_columns(torch, lambda a, b: K.packed_matmul_plain(
                xu, w8s[0][:, a:b], exact), n)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            variant = K.packed_variant(m, exact)
            checks.append((variant, f"main {exact.name()} M={m} K={k} N={n}",
                           max_diff(torch, K.packed_matmul(xu, w8s[0], exact), want)))
            xpad = torch.nn.functional.pad(xu.to(torch.int8), (0, 0, 0, max(0, 32 - m)))
            lib_ms = library_ms(torch, lambda: torch._int_mm(xpad, w8s[0]))
            del w8s, want
            b_ms, b_by, terms = packed_bound(4 * m * k + k * n + 4 * m * n, m, k, n, exact)
            rows.append(dict(kernel=variant, plan=exact.name(), M=m, K=k, N=n,
                             ms=ms, graph_ms=g_ms, parent_ms=parent_ms, plain_ms=plain_ms,
                             library_ms=lib_ms,
                             library="torch._int_mm (the plan is exact)"
                             + (" (M padded to 32)" if m < 32 else ""),
                             bound_ms=b_ms, bound_by=b_by, bound_terms=terms))
            gc.collect()
            torch.cuda.empty_cache()
            for r in rows[-3:]:
                log(f"time {r['kernel']:24s} M={m:3d} K={k:6d} N={n:6d}: "
                    f"{r['ms']:.4f} ms "
                    + (f"(graph replay {r['graph_ms']:.4f} ms) " if r["graph_ms"] is not None
                       else "")
                    + f"(bound {r['bound_ms']:.4f} ms by {r['bound_by']}, "
                    + (f"the M <= 16 kernel {r['parent_ms']:.4f} ms, "
                       if r["parent_ms"] is not None else "")
                    + f"plain {r['plain_ms']:.2f} ms, library "
                    f"{'-' if r['library_ms'] is None else format(r['library_ms'], '.4f')} ms)")
    return rows


# ---- phase 4 / 5 / MoE: serving ----------------------------------------------


def tree_leaves(tree):
    """Every leaf of a parameter tree (dicts and the per-layer lists walked)."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, list):
        for v in tree:
            yield from tree_leaves(v)
    else:
        yield tree


def leaf_plans(P, params) -> dict:
    """Served ``DspTunedLeaf`` plans of a quantized tree: plan name -> leaves
    (every layer and expert counted)."""
    counts: dict = {}
    for leaf in tree_leaves(params):
        if P.is_dsp_tuned_leaf(leaf):
            counts[leaf.spec.name()] = counts.get(leaf.spec.name(), 0) + 1
    return counts


def run_engine(torch, K, P, card: str, cfg, params, prompts, key: str, *,
               inspect=None, table=None, allocation=None, **scfg) -> tuple[dict, list]:
    """Build one engine (4 slots, max_len 64, prefill chunk 16, no EOS), serve
    a 2-token warm-up request, then ``prompts`` greedily to 8 tokens each;
    returns its numbers (build seconds, sensitivity probes run in the build,
    prefill tok/s, median decode ms/step, launches per kernel in the serving
    and in the build, MoE host reads per decode step, peak memory) and the
    tokens.  ``inspect(engine, build_s)`` adds its own entries."""
    at_build = kernel_counts(K)
    probes0, reads0 = P.PROBES.count, P.HOST_READS["count"]
    t0 = time.perf_counter()
    engine = P.Engine(cfg, params, P.ServeConfig(
        n_slots=4, max_len=64, prefill_chunk=16, max_new=8, eos_token=-1,  # full budgets
        device="cuda", **scfg), plan_table=table, mixed_allocation=allocation)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    probes = P.PROBES.count - probes0
    before = kernel_counts(K)  # the build launches kernels in sweeps and probes
    extra = inspect(engine, build_s, probes) if inspect is not None else {}
    warm = engine.generate([prompts[0][:4]], max_new=2)  # warm-up request
    sch = engine.scheduler
    tok0, time0 = sch.prefill_tokens, sch.prefill_time_s
    rids = [engine.submit(p, max_new=8, admit=False) for p in prompts]
    step_ms, step_reads, step_launches = [], [], []
    while engine.active.any() or sch.n_queued:
        r0, l0 = P.HOST_READS["count"], sum(kernel_counts(K).values())
        t0 = time.perf_counter()
        engine.step()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        step_reads.append(P.HOST_READS["count"] - r0)
        step_launches.append(sum(kernel_counts(K).values()) - l0)
    logits = torch.from_numpy(engine.peek_logits())
    if not bool(torch.isfinite(logits).all()):
        raise RuntimeError(f"{key}: non-finite logits")
    tokens = [list(engine.outputs[r]) for r in rids]
    lengths = [len(t) for t in tokens]
    if lengths != [8] * len(prompts) or len(next(iter(warm.values()))) != 2:
        raise RuntimeError(f"{key}: expected {len(prompts)} x 8 tokens, got {lengths}")
    after = kernel_counts(K)
    decode = sorted(step_ms[1:])  # the first step also admits (prefill)
    launches = {k: after[k] - before[k] for k in after}
    out = dict(
        build_s=build_s, probes=probes,
        prefill_tok_s=(sch.prefill_tokens - tok0) / (sch.prefill_time_s - time0),
        decode_ms_per_step=decode[len(decode) // 2],
        decode_ms_steps=decode,  # every decode step, sorted: the spread
        decode_steps=len(decode),
        launches=launches,
        build_launches={k: before[k] - at_build[k] for k in before},
        host_reads_per_decode_step=max(step_reads[1:], default=0),
        # kernel launches of each decode step after the first (which admits)
        decode_step_launches=step_launches[1:],
        peak_gb=torch.cuda.max_memory_allocated() / 1e9,
        **extra,
    )
    log(f"serve {key:18s} on {card}: build {build_s:.1f} s"
        + (f" ({probes} sensitivity probes)" if probes else "")
        + f", prefill {out['prefill_tok_s']:.1f} tok/s, decode "
        f"{out['decode_ms_per_step']:.2f} ms/step (median), launches "
        f"{ {k: v for k, v in launches.items() if v} } ({out['decode_step_launches']} a "
        f"decode step), peak {out['peak_gb']:.1f} GB"
        + (f", MoE host reads {out['host_reads_per_decode_step']} a decode step"
           if out["host_reads_per_decode_step"] else "")
        + (f", launched in the build {out['build_launches']}"
           if any(out["build_launches"].values()) else ""))
    del engine, logits
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return out, tokens


def mixed_report(P, allocation, build_s: float, probes: int) -> dict:
    """The sensitivity pass's seconds and probes, each candidate width's
    plan (as the card's engine selects it: ``exact_first`` off) and the
    allocation's summary."""
    widths = {f"a{a}w{w}": P.tuner.select_plan(a, w, error_budget=0.0).name
              for a, w in P.DEFAULT_WIDTH_CANDIDATES}
    return dict(pass_s=build_s, probes=probes, width_plans=widths,
                summary=allocation.summary())


def serve_full_width(torch, K, P, card: str):
    """The main path at full width, one engine per mode built and freed;
    dsp_tuned also with ``autotune_plans`` (the tuner times the kernels at
    every layer shape), whose greedy tokens must equal a plain-version
    engine's on the same plans; dsp_mixed with its sensitivity pass on the
    card (4 widths, 32 calibration tokens, budget 0.05); then each packed
    mode again with ``fuse_projections="all"``, whose greedy tokens must
    equal the unfused run's.  The fused runs get the float tree fused once
    here (the engine's own fusion then finds nothing left to join) with
    the unfused tree freed first, so that dsp_tuned's build keeps the
    unfused run's peak memory."""
    cfg = P.dataclasses.replace(P.get_config("qwen1.5-110b"), n_layers=4)
    params = P.T.init_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    gen = torch.Generator().manual_seed(0)
    prompts = [torch.randint(2, cfg.vocab_size, (n,), generator=gen).tolist()
               for n in (5, 17, 30)]
    plan = P.ref.spec_from_name(MAIN_PLAN)
    results, tokens, tables = {}, {}, {}
    torch.cuda.reset_peak_memory_stats()

    def serve(mode: str, params, fuse: str, key: str | None = None, table=None,
              autotune: bool = False, use_kernel: bool | None = None) -> None:
        key = key or (mode if fuse == "none" else f"{mode}+fuse")

        def inspect(engine, build_s: float, probes: int) -> dict:
            if mode == "dsp_mixed":
                alloc = engine.mixed_allocation
                rep = mixed_report(P, alloc, build_s, probes)
                log(f"{key}: sensitivity pass {build_s:.1f} s, {rep['probes']} probes "
                    f"(PROBES), width plans {rep['width_plans']}, summary "
                    + json.dumps(alloc.summary(), sort_keys=True))
                return dict(mixed=rep)
            if mode != "dsp_tuned":
                return {}
            tables[key] = dict(engine.plan_table)
            names = {p: r.name for p, r in engine.plan_table.items()}
            served = {p for p, _ in P.iter_packable_weights(params)}  # fused already
            if set(names) != served:
                raise RuntimeError(f"{key}: plans on {len(names)} of {len(served)} paths")
            plans = {p: f"{r.name} ({r.block} / {r.decode_block})"
                     for p, r in engine.plan_table.items()}
            if not autotune and table is None and set(names.values()) != {MAIN_PLAN}:
                raise RuntimeError(f"{key}: the tuner's plans {sorted(set(names.values()))},"
                                   f" expected {MAIN_PLAN} on every path")
            log(f"{key}: plans {sorted(set(plans.values()))} on {len(names)} packable "
                f"paths, built in {build_s:.1f} s"
                + (" (given)" if table is not None else " (the tuner's pick)"))
            return dict(plans=plans)

        results[key], tokens[key] = run_engine(
            torch, K, P, card, cfg, params, prompts, key, inspect=inspect, table=table,
            quant_mode=mode, fuse_projections=fuse, autotune_plans=autotune,
            use_kernel=use_kernel)

    # the hand table's dsp_tuned engine runs just before the tuner's, so
    # that the two decode times meet the same host state
    for mode in ("native", "int8", "int4_packed"):
        serve(mode, params, "none")
    # the main plan by hand on every path of the tree served
    serve("dsp_tuned", params, "none", key="dsp_tuned+table",
          table={p: plan for p, _ in P.iter_packable_weights(params)})
    for mode in ("dsp_tuned", "dsp_packed"):
        serve(mode, params, "none")
    if tokens["dsp_tuned+table"] != tokens["dsp_tuned"]:
        raise RuntimeError(f"dsp_tuned: the tuner's engine {tokens['dsp_tuned']} != the "
                           f"hand table's {tokens['dsp_tuned+table']}")
    log("dsp_tuned: greedy tokens of the tuner's plans identical to the hand table's")
    # per-layer widths from the sensitivity pass, run on the card
    serve("dsp_mixed", params, "none")
    # the measured ranking at every layer shape, held to the plain version
    # of the same plans (which launches no kernel)
    serve("dsp_tuned", params, "none", key="dsp_tuned+autotune", autotune=True)
    serve("dsp_tuned", params, "none", key="dsp_tuned+autotune+plain",
          table=tables["dsp_tuned+autotune"], use_kernel=False)
    if tokens["dsp_tuned+autotune"] != tokens["dsp_tuned+autotune+plain"]:
        raise RuntimeError(f"dsp_tuned autotuned: kernel engine {tokens['dsp_tuned+autotune']}"
                           f" != plain engine {tokens['dsp_tuned+autotune+plain']}")
    log("dsp_tuned autotuned: greedy tokens identical to the plain-version engine's")
    tables.clear()
    fused = P.fuse_projection_weights(params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    for mode in QUANT_MODES:
        serve(mode, fused, "all")
        if tokens[f"{mode}+fuse"] != tokens[mode]:
            raise RuntimeError(f"{mode}: fused tokens {tokens[mode + '+fuse']} != "
                               f"unfused {tokens[mode]}")
        log(f"fused {mode}: greedy tokens identical to the unfused engine's")
    del fused
    gc.collect()
    torch.cuda.empty_cache()
    return results


def serve_moe(torch, K, P, card: str) -> dict:
    """The MoE family at moonshot-v1-16b-a3b's full width (48 layers cut to
    4; 64 experts, top-6), bf16 seeded weights, served greedily with phase
    4's requests in every mode; reports each mode's numbers and the plans
    its ``DspTunedLeaf`` leaves serve."""
    cfg = P.dataclasses.replace(P.get_config("moonshot-v1-16b-a3b"), n_layers=4)
    t0 = time.perf_counter()
    params = P.T.init_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    n_weights = sum(t.numel() for t in tree_leaves(params))
    log(f"moe: {cfg.name} at full width, {cfg.n_layers} layers, {n_weights / 1e9:.3f} G "
        f"weights ({2 * n_weights / 1e9:.2f} GB bf16), made in {time.perf_counter() - t0:.1f} s")
    gen = torch.Generator().manual_seed(0)
    prompts = [torch.randint(2, cfg.vocab_size, (n,), generator=gen).tolist()
               for n in (5, 17, 30)]
    results = {}
    torch.cuda.reset_peak_memory_stats()
    for mode in MOE_MODES:
        def inspect(engine, build_s: float, probes: int) -> dict:
            served = leaf_plans(P, engine.params)
            if served:
                log(f"moe {mode}: served plans {served} (leaves), built in {build_s:.1f} s")
            return dict(served_plans=served)

        results[mode], _ = run_engine(torch, K, P, card, cfg, params, prompts,
                                      f"moe {mode}", inspect=inspect, quant_mode=mode)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return dict(config=dict(name=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
                            n_experts=cfg.n_experts, top_k=cfg.experts_per_token,
                            d_ff=cfg.d_ff, vocab=cfg.vocab_size, weights=n_weights),
                modes=results)


# the kernels each packed mode launches, in decode (M <= 16) and in 64-row
# prefill chunks (M > 16); a sliding window prefills one token a chunk, so
# its prefill runs the M <= 16 kernels only
MODE_KERNELS = {"int4_packed": ("int4_matmul", "int4_matmul_tc"),
                "dsp_tuned": ("packed_matmul_prepacked", "packed_matmul_prepacked_tiled"),
                "dsp_packed": ("packed_matmul", "packed_matmul_tiled")}


def serve_families(torch, K, P, card: str) -> tuple[dict, dict]:
    """The five families at full width (``FAMILIES``: depth cut, bf16 seeded
    weights), each served greedily with phase 4's slots and requests in its
    modes, one engine built and freed at a time; each config's launch counts
    zeroed just before it and read just after, and every packed mode must
    have launched its kernels.  whisper also runs ``encode`` on 1500 frames
    and a decoder forward over its output (real cross-attention), llava a
    forward with its 2880 patch embeddings prepended; their logits must be
    finite.  Returns the numbers and the launches per config."""
    out, launches = {}, {}
    for arch, cut, modes in FAMILIES:
        zero_counts(K)
        cfg = P.dataclasses.replace(P.get_config(arch), **cut)
        t0 = time.perf_counter()
        params = P.T.init_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
        torch.cuda.synchronize()
        n_weights = sum(t.numel() for t in tree_leaves(params))
        log(f"families: {arch} at full width, {cfg.n_layers} layers, {n_weights / 1e9:.3f} G "
            f"weights ({2 * n_weights / 1e9:.2f} GB bf16), made in "
            f"{time.perf_counter() - t0:.1f} s")
        gen = torch.Generator().manual_seed(0)
        prompts = [torch.randint(2, cfg.vocab_size, (n,), generator=gen).tolist()
                   for n in (5, 17, 30)]
        extra = {}
        with torch.inference_mode():
            tokens = torch.tensor([prompts[0]], device="cuda")
            if cfg.family == "encdec":
                frames = torch.randn((1, cfg.encoder_len, cfg.d_model), generator=torch.Generator(
                    device="cuda").manual_seed(1), device="cuda", dtype=torch.bfloat16)
                enc = P.T.encode(params, cfg, frames)
                logits = P.T.forward(params, cfg, tokens, encoder_out=enc)[0]
                extra["encoder_out"] = list(enc.shape)
            elif cfg.family == "vlm":
                pe = torch.randn((1, cfg.n_patches, cfg.d_model), generator=torch.Generator(
                    device="cuda").manual_seed(1), device="cuda", dtype=torch.bfloat16)
                logits = P.T.forward(params, cfg, tokens, patch_embeds=pe)[0]
                extra["patch_embeds"] = list(pe.shape)
            if extra:
                if not bool(torch.isfinite(logits).all()):
                    raise RuntimeError(f"{arch}: non-finite logits with {extra}")
                log(f"families: {arch} forward with {extra}: logits {list(logits.shape)}, "
                    "finite")
                del logits
        results = {}
        torch.cuda.reset_peak_memory_stats()
        for mode in modes:
            def inspect(engine, build_s: float, probes: int) -> dict:
                served = leaf_plans(P, engine.params)
                if served:
                    log(f"{arch} {mode}: served plans {served} (leaves)")
                return dict(served_plans=served)

            results[mode], _ = run_engine(torch, K, P, card, cfg, params, prompts,
                                          f"{arch} {mode}", inspect=inspect, quant_mode=mode)
            prefill_m = 4 if cfg.sliding_window else 64
            for kernel in MODE_KERNELS.get(mode, ())[:1 if prefill_m <= 16 else 2]:
                if results[mode]["launches"][kernel] < 1:
                    raise RuntimeError(f"{kernel} never launched serving {arch} {mode}")
        launches[arch] = kernel_counts(K)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        out[arch] = dict(config=dict(name=cfg.name, family=cfg.family, n_layers=cfg.n_layers,
                                     d_model=cfg.d_model, vocab=cfg.vocab_size,
                                     weights=n_weights, **extra),
                         modes=results)
        log(f"families: {arch} launches {launches[arch]}")
    return out, launches


def agreement(torch, P, cfg, params, mode: str, table=None, widths=None,
              prompts=None, max_len: int = 32) -> dict:
    """Kernel engine against plain-version engine at a smoke config, greedy
    tokens identical with prefill chunks of 4 rows x 2 slots (the M <= 16
    kernels) and of 16 (the M > 16 ones).  ``dsp_mixed`` runs its
    sensitivity pass once, in the first kernel engine, and hands that
    allocation to the other three."""
    prompts = prompts or [[5, 17, 33, 2, 9], list(range(40, 51)), [7, 8, 9]]
    allocation, out = None, {}
    extra = {} if widths is None else dict(width_candidates=widths)
    for chunk in (4, 16):
        toks = []
        for uk in (True, False):
            eng = P.Engine(cfg, params, P.ServeConfig(
                n_slots=2, max_len=max_len, prefill_chunk=chunk, max_new=6, quant_mode=mode,
                device="cuda", use_kernel=uk, **extra), plan_table=table,
                mixed_allocation=allocation)
            if mode == "dsp_mixed" and allocation is None:
                allocation = eng.mixed_allocation
                out["assignments"] = {p: f"a{a}w{w}" for p, (a, w)
                                      in sorted(allocation.assignments.items())}
            toks.append(eng.generate(prompts))
            del eng
        if toks[0] != toks[1]:
            raise RuntimeError(f"{cfg.name} {mode} chunk {chunk}: kernel engine {toks[0]} "
                               f"!= plain engine {toks[1]}")
        log(f"agreement {cfg.name} {mode} (prefill chunk {chunk}): kernel and plain "
            "engines emit identical tokens"
            + (f" (one allocation, {allocation.distinct_widths} widths over "
               f"{len(allocation.assignments)} paths)" if allocation is not None else ""))
    return out

# ---- phase 9: the plan search on the card ------------------------------------


def plan_search(torch, K, P, card: str, checks: list) -> dict:
    """The tuner's ranking from a cold score cache, its kernel-variant
    sweep at an 8192 x 8192 linear (prefill and decode), the top plan's
    winners held against the plain version, then dsp_tuned engines at the
    smoke config on one temporary plan database: cold, warm, autotuned."""
    tuner = P.tuner
    tuner._SCORE_CACHE.clear()
    n0 = tuner.SCORED["specs"]
    t0 = time.perf_counter()
    ranked = tuner.rank_plans(4, 4, error_budget=0.5)
    cold_s = time.perf_counter() - t0
    n_scored = tuner.SCORED["specs"] - n0
    log(f"plan search: {n_scored} plans scored, {len(ranked)} within budget 0.5, head "
        f"{ranked[0].name}, {cold_s:.2f} s (cold score cache)")
    t0 = time.perf_counter()
    timed = tuner.rank_plans(4, 4, error_budget=0.5, autotune=True, shape=SWEEP_SHAPE,
                             decode_shape=SWEEP_DECODE, device="cuda")
    autotune_s = time.perf_counter() - t0
    ranking = [dict(plan=r.name, block=r.block, us_per_call=r.us_per_call,
                    decode_block=r.decode_block, decode_us_per_call=r.decode_us_per_call)
               for r in timed]
    log(f"plan search with autotune on {card}: {autotune_s:.1f} s, head {timed[0].name} "
        f"({timed[0].block} {timed[0].us_per_call:.1f} us / {timed[0].decode_block} "
        f"{timed[0].decode_us_per_call:.1f} us)")
    # every in-budget plan's variants at both probes (the ranking keeps the
    # winner, and sweeps decode for its head alone)
    # and how many winners differ from the wrapper's own choice by M
    sweep, off_rule = [], 0
    for r in timed:
        row = dict(plan=r.name)
        for phase, shape in (("prefill", SWEEP_SHAPE), ("decode", SWEEP_DECODE)):
            timings = P.autotune.autotune_block(r.spec, shape, device="cuda")
            row[phase] = {t.block: t.us_per_call for t in timings}
            off_rule += timings[0].block != K.prepacked_variant(shape[0], r.spec)
        sweep.append(row)
        log(f"sweep {r.name:26s} " + "; ".join(
            f"M={shape[0]}: " + ", ".join(f"{v} {us:.1f} us" for v, us in row[phase].items())
            for phase, shape in (("prefill", SWEEP_SHAPE), ("decode", SWEEP_DECODE))))
    log(f"sweep: {off_rule} of {2 * len(timed)} winners differ from the wrapper's choice by M")
    # the top plan's winners against the plain version at the probe shapes
    top = timed[0]
    gen = torch.Generator(device="cuda").manual_seed(9)
    for (m, k, n), variant in ((SWEEP_SHAPE, top.block), (SWEEP_DECODE, top.decode_block)):
        spec = top.spec
        w = torch.randint(-(1 << (spec.bits_w - 1)), 1 << (spec.bits_w - 1), (k, n),
                          generator=gen, device="cuda", dtype=torch.int32)
        packed = P.ref.pack_weight_words(w, spec)
        x = torch.randn((m, k), generator=gen, device="cuda")
        zp = 1 << (spec.bits_a - 1)
        scale = x.abs().amax(-1, keepdim=True).clamp_min(1e-8) / (zp - 1)
        got = K.packed_matmul_prepacked(x, *packed, spec, x_scale=scale, x_zp=zp,
                                        variant=variant)
        want = K.packed_matmul_prepacked_plain(x, *packed, spec, x_scale=scale, x_zp=zp)
        checks.append((variant, f"sweep winner {spec.name()} M={m} K={k} N={n}",
                       max_diff(torch, got, want)))
        del w, packed, got, want
    # engine builds on one plan database at the smoke config
    smoke = P.dataclasses.replace(P.get_config("qwen1.5-110b", smoke=True), dtype="float32")
    sparams = P.T.init_params(smoke, seed=0, dtype=torch.float32, device="cuda")
    prompts = [[5, 17, 33, 2, 9], list(range(40, 51)), [7, 8, 9]]
    builds, tuned_table = {}, None
    with P.tempfile.TemporaryDirectory() as db:
        for name, autotune in (("cold", False), ("warm", False), ("autotune", True)):
            tuner._SCORE_CACHE.clear()
            n0 = tuner.SCORED["specs"]
            t0 = time.perf_counter()
            eng = P.Engine(smoke, sparams, P.ServeConfig(
                n_slots=2, max_len=32, prefill_chunk=4, max_new=6, quant_mode="dsp_tuned",
                autotune_plans=autotune, plan_db=db, device="cuda"))
            build_s = time.perf_counter() - t0
            stats = eng.stats()["plan_db"]
            builds[name] = dict(
                build_s=build_s, scored=tuner.SCORED["specs"] - n0, hits=stats["hits"],
                misses=stats["misses"], stale=stats["stale"],
                plans=sorted({f"{r.name} ({r.block} / {r.decode_block})"
                              for r in eng.plan_table.values()}),
                tokens=eng.generate(prompts))
            log(f"plan db {name}: build {build_s:.2f} s, {builds[name]['scored']} plans "
                f"scored, {stats['hits']} hit / {stats['misses']} miss, plans "
                f"{builds[name]['plans']}")
            if autotune:
                tuned_table = dict(eng.plan_table)
            del eng
        # dsp_mixed on the same database: the cold build runs the sensitivity
        # pass (and stores its allocation), the warm one runs no probe
        for name in ("mixed cold", "mixed warm"):
            p0 = P.PROBES.count
            t0 = time.perf_counter()
            eng = P.Engine(smoke, sparams, P.ServeConfig(
                n_slots=2, max_len=32, prefill_chunk=4, max_new=6, quant_mode="dsp_mixed",
                plan_db=db, device="cuda"))
            build_s = time.perf_counter() - t0
            stats = eng.stats()["plan_db"]
            builds[name] = dict(
                build_s=build_s, probes=P.PROBES.count - p0, hits=stats["hits"],
                misses=stats["misses"], stale=stats["stale"],
                assignments={p: f"a{a}w{w}" for p, (a, w)
                             in sorted(eng.mixed_allocation.assignments.items())},
                tokens=eng.generate(prompts))
            log(f"plan db {name}: build {build_s:.2f} s, {builds[name]['probes']} probes, "
                f"{stats['hits']} hit / {stats['misses']} miss, "
                f"{eng.mixed_allocation.distinct_widths} widths")
            del eng
    # the autotuned plans, their kernel variants forced, against the plain
    # version: prefill chunks of 4 rows x 2 slots run decode_block, of 16
    # the prefill block
    for chunk in (4, 16):
        toks = [P.Engine(smoke, sparams, P.ServeConfig(
                    n_slots=2, max_len=32, prefill_chunk=chunk, max_new=6,
                    quant_mode="dsp_tuned", device="cuda", use_kernel=uk),
                    plan_table=tuned_table).generate(prompts)
                for uk in (True, False)]
        if toks[0] != toks[1]:
            raise RuntimeError(f"autotuned plans, chunk {chunk}: kernel engine {toks[0]} != "
                               f"plain engine {toks[1]}")
        log(f"agreement autotuned dsp_tuned (prefill chunk {chunk}): kernel and plain "
            "engines emit identical tokens")
    del sparams
    cold, warm = builds["cold"], builds["warm"]
    if (cold["misses"], cold["hits"]) != (1, 0) or cold["scored"] < 1:
        raise RuntimeError(f"plan db: the cold build was not a scored miss: {cold}")
    if (warm["misses"], warm["hits"], warm["scored"]) != (0, 1, 0):
        raise RuntimeError(f"plan db: the warm build was not an unscored hit: {warm}")
    if (warm["plans"], warm["tokens"]) != (cold["plans"], cold["tokens"]):
        raise RuntimeError("plan db: the warm build serves other plans or tokens")
    if builds["autotune"]["misses"] != 1:
        raise RuntimeError("plan db: autotune_plans must key another entry")
    mcold, mwarm = builds["mixed cold"], builds["mixed warm"]
    if (mcold["misses"], mcold["hits"]) != (1, 0) or mcold["probes"] < 1:
        raise RuntimeError(f"plan db: the cold dsp_mixed build was not a probed miss: {mcold}")
    if (mwarm["misses"], mwarm["hits"], mwarm["probes"]) != (0, 1, 0):
        raise RuntimeError(f"plan db: the warm dsp_mixed build was not an unprobed hit: "
                           f"{mwarm}")
    if (mwarm["assignments"], mwarm["tokens"]) != (mcold["assignments"], mcold["tokens"]):
        raise RuntimeError("plan db: the warm dsp_mixed build serves other widths or tokens")
    return dict(cold_rank_s=cold_s, n_scored=n_scored, n_within=len(ranked),
                proxy_head=ranked[0].name, autotune_rank_s=autotune_s, ranking=ranking,
                sweep=sweep, winners_off_rule=off_rule,
                builds={k: {n: v for n, v in b.items() if n != "tokens"}
                        for k, b in builds.items()})


# ---- phase 6: the paper's arithmetic on the card -----------------------------


def paper_on_card(torch, K, M) -> list[dict]:
    """Tables I/II computed on the card, each equal to the same call on the
    CPU; the quickstart's packed matmul against the exact integer matmul."""
    configs = {
        "INT4 delta=3": M.packing.int4_packing(3),
        "INT4 delta=-2": M.packing.int4_packing(-2),
        "6 x (4x5) delta=-2": M.packing.intn_packing((4, 4, 4), (5, 5), -2),
    }
    rows = []
    for label, cfg in configs.items():
        for scheme in M.correction.SCHEMES:
            t0 = time.perf_counter()
            card = M.correction.scheme_stats(cfg, scheme, device="cuda")
            torch.cuda.synchronize()
            card_s = time.perf_counter() - t0
            cpu = M.correction.scheme_stats(cfg, scheme, device="cpu")
            if dataclasses.astuple(card) != dataclasses.astuple(cpu):
                raise RuntimeError(f"{label} {scheme}: card {card} != CPU {cpu}")
            rows.append(dict(config=label, scheme=scheme, mae=card.mae_bar,
                             ep=card.ep_bar, wce=card.wce_bar, card_s=card_s))
            log(f"table {label:18s} {scheme:8s}: {card.row()} "
                f"(card {card_s:.2f} s, equal to the CPU)")
    six = configs["6 x (4x5) delta=-2"]
    log(f"six 4x5-bit products per DSP: density {six.packing_density():.3f}, "
        f"fits DSP48E2: {six.fits_dsp48()}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    x_q = torch.randint(0, 16, (8, 32), generator=gen, device=dev, dtype=torch.int32)
    w_q = torch.randint(-8, 8, (32, 8), generator=gen, device=dev, dtype=torch.int8)
    diff = max_diff(torch, K.packed_matmul(x_q, w_q, M.ref.INT4_EXACT),
                    M.ref.ref_quantized_matmul(x_q, w_q))
    if diff:
        raise RuntimeError(f"quickstart packed matmul differs from the exact matmul by {diff}")
    log("quickstart: packed matmul (INT4_EXACT) == exact integer matmul on the card")
    return rows


# ---- phase 7: addition packing, the SNN path ---------------------------------


def snn_addpack(torch, K, A, checks: list) -> dict:
    """One SNN layer's membrane potentials accumulated by the addpack kernel
    (launch count zeroed just before, read just after), then the kernel
    against its plain version, its oracle and ``torch.sum``."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    n = SNN_HALF
    w = torch.randint(-8, 8, (SNN_IN, 2 * n), generator=gen, device=dev,
                      dtype=torch.float32)  # int4 weights
    spikes = (torch.rand((SNN_STEPS, SNN_IN), generator=gen, device=dev) < 0.15).float()
    torch.cuda.synchronize()
    zero_counts(K)
    t0 = time.perf_counter()
    drive = spikes @ w  # exact in f32 (TF32 off): |drive| <= 512 * 8
    terms = drive.reshape(SNN_STEPS, 2, n).to(torch.int32)  # lane 0: first half
    potentials = K.addpack_accumulate(terms)
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t0
    launches = {k: f.launches for k, f in K.WRAPPERS.items()}
    if launches["addpack_accumulate"] < 1:
        raise RuntimeError("addpack_accumulate never launched on the SNN path")
    fired = int((potentials.reshape(2 * n) > SNN_THRESHOLD).sum())
    log(f"snn: {SNN_IN} inputs x {2 * n} neurons x {SNN_STEPS} steps in {path_s:.3f} s, "
        f"{fired} neurons over the threshold {SNN_THRESHOLD}, launches {launches}")
    del drive, w
    where = f"SNN T={SNN_STEPS} N={n}"
    checks.append(("addpack_accumulate", where + " vs plain",
                   max_diff(torch, potentials, A.plain_addpack_accumulate(terms))))
    checks.append(("addpack_accumulate", where + " vs oracle",
                   max_diff(torch, potentials, A.ref_addpack_accumulate(terms))))
    checks.append(("addpack_accumulate", where + " vs torch.sum",
                   max_diff(torch, potentials, torch.sum(terms, 0))))
    # the reference tests' shapes: odd and even T, several N, out of range
    gen = torch.Generator(device=dev).manual_seed(11)
    small = torch.randint(-2000, 2000, (64, 2, 256), generator=gen, device=dev,
                          dtype=torch.int32)
    checks.append(("addpack_accumulate", "T=64 N=256",
                   max_diff(torch, K.addpack_accumulate(small),
                            A.ref_addpack_accumulate(small))))
    cpu = torch.Generator().manual_seed(12)
    steps = [1, 3, 47] + torch.randint(1, 49, (9,), generator=cpu).tolist()
    for i, t in enumerate(steps):
        nn = 256 * (1, 2, 3, 5, 64, 2048)[i % 6]
        x = torch.randint(-4096, 4096, (t, 2, nn), generator=gen, device=dev,
                          dtype=torch.int32)
        got = K.addpack_accumulate(x)
        checks.append(("addpack_accumulate", f"T={t} N={nn} vs plain",
                       max_diff(torch, got, A.plain_addpack_accumulate(x))))
        checks.append(("addpack_accumulate", f"T={t} N={nn} vs oracle",
                       max_diff(torch, got, A.ref_addpack_accumulate(x))))
    for t, nn, block_n in ((5, 512, 256), (9, 250, 2)):  # wraps per chunk; N % 4 != 0
        x = torch.randint(-(1 << 15), 1 << 15, (t, 2, nn), generator=gen, device=dev,
                          dtype=torch.int32)
        checks.append(("addpack_accumulate", f"out of range T={t} N={nn} vs plain",
                       max_diff(torch, K.addpack_accumulate(x, block_n=block_n),
                                A.plain_addpack_accumulate(x))))
    torch.cuda.synchronize()
    ms = cuda_ms(torch, lambda: K.addpack_accumulate(terms), 20)
    plain_ms = cuda_ms(torch, lambda: A.plain_addpack_accumulate(terms), 3)
    lib_ms = cuda_ms(torch, lambda: torch.sum(terms, 0, dtype=torch.int32), 20)
    b_ms, b_by = bound(4 * terms.numel() + 4 * 2 * n, terms.numel(), CUDA_CORE_OPS_PER_S)
    log(f"time addpack_accumulate T={SNN_STEPS} N={n}: {ms:.4f} ms (bound {b_ms:.4f} ms "
        f"by {b_by}, plain {plain_ms:.4f} ms, torch.sum {lib_ms:.4f} ms)")
    return dict(launches=launches["addpack_accumulate"], path_s=path_s, fired=fired,
                ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                at=f"T={SNN_STEPS} N={n}")


# ---- phase 8: flash attention at qwen1.5-110b's width ------------------------


def attn_err(torch, got, want, dtype: str) -> tuple[float, bool]:
    """Max abs difference in f32, and whether every element is within the
    stated tolerance ``atol + rtol * |want|``."""
    atol, rtol = ATTN_TOL[dtype]
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    ok = bool(torch.isfinite(g).all()) and bool((diff <= atol + rtol * w.abs()).all())
    return float(diff.max()), ok


def attention_path(torch, K, F, args, route: str) -> tuple:
    """One ``flash_attention`` call with every launch count zeroed just
    before and read just after; fails unless ``route``'s kernel launched."""
    torch.cuda.synchronize()
    zero_counts(K)
    t0 = time.perf_counter()
    out = K.flash_attention(*args)
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t0
    launches = {name: f.launches for name, f in K.WRAPPERS.items()}
    routes = dict(F.flash_attention.route_launches)
    if routes[route] < 1:
        raise RuntimeError(f"{route} never launched on its attention path ({routes})")
    return out, path_s, launches, routes


def flash_qwen(torch, K, F, P, attn_checks: list) -> dict:
    """Causal attention at qwen1.5-110b's width through the bf16 and f16
    routes, K/V expanded from the config's KV heads as the model's
    attention does, then through the f32 route at 8 heads; each path with
    the launch counts zeroed just before and read just after.  Then the
    checks against the plain version and the route's emulation, at the
    reference tests' shapes and ragged S; then the timings, the f32 route
    beside the CUDA-core kernel it replaced."""
    cfg = P.get_config("qwen1.5-110b")
    h, kv, hd, s = cfg.n_heads, cfg.n_kv_heads, cfg.hd, ATTN_SEQ
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    paths = {}
    for dt in (torch.bfloat16, torch.float16):
        q = torch.randn((1, s, h, hd), generator=gen, device=dev, dtype=dt)
        k = torch.randn((1, s, kv, hd), generator=gen, device=dev, dtype=dt)
        v = torch.randn((1, s, kv, hd), generator=gen, device=dev, dtype=dt)
        args = (q.transpose(1, 2).contiguous(),  # (B, H, S, hd)
                P.repeat_kv(k, h // kv).transpose(1, 2).contiguous(),
                P.repeat_kv(v, h // kv).transpose(1, 2).contiguous())
        name = str(dt).removeprefix("torch.")
        paths[name] = (args, f"B=1 H={h} S={s} hd={hd} {name}")
        del q, k, v
    x32 = tuple(torch.randn((1, kv, s, hd), generator=gen, device=dev) for _ in range(3))
    paths["float32"] = (x32, f"B=1 H={kv} S={s} hd={hd} float32")

    def check(got, args, dtype: str, at: str) -> None:
        err, ok = attn_err(torch, got, F.plain_flash_attention(*args), dtype)
        attn_checks.append((ROUTE_NAMES[dtype], at + " vs plain", err, ok))
        emulate = (F.emulate_split_f32_flash if dtype == "float32"
                   else F.emulate_tensor_core_flash)
        err, ok = attn_err(torch, got, emulate(*args), dtype)
        attn_checks.append((ROUTE_NAMES[dtype], at + " vs emulation", err, ok))

    driven = {}
    for name, (args, where) in paths.items():
        route = F.ROUTES[args[0].dtype]
        out, path_s, launches, routes = attention_path(torch, K, F, args, route)
        log(f"attention {where}" + (f" (K/V from {kv} heads)" if name != "float32" else "")
            + f": {path_s:.3f} s, launches {launches}, routes {routes}")
        driven[name] = (path_s, routes[route])
        check(out, args, name, where)
        del out
    # the reference tests' shapes, then hd 64 and ragged S (bq, bk dividing
    # S, as the wrapper's contract asks; the kernels ignore them); then hd 16
    # (every smoke config) and 120 (h2o-danube-3-4b), which the kernels run
    # at their hd 64 and 128 instantiations, on every route
    gen = torch.Generator(device=dev).manual_seed(5)
    for b, hh, ss, d, bq, bk, dts in (
            (1, 2, 512, 64, 256, 128, (torch.float32, torch.float16)),
            (2, 1, 256, 128, 128, 128, (torch.float32, torch.float16)),
            (1, 3, 96, 64, 32, 32, (torch.float32, torch.float16)),
            (1, 4, 1024, 64, 256, 256, (torch.bfloat16, torch.float16)),
            (1, 8, 4096, 64, 256, 256, (torch.bfloat16, torch.float16, torch.float32)),
            (1, 3, 96, 128, 32, 32, (torch.bfloat16, torch.float16)),
            (1, 2, 4160, 128, 64, 64, (torch.bfloat16, torch.float16, torch.float32)),
            (1, 2, 512, 16, 256, 128, (torch.float32, torch.float16)),
            (1, 2, 512, 120, 256, 128, (torch.float32, torch.float16)),
            (1, 4, 1024, 16, 256, 256, (torch.bfloat16,)),
            (1, 8, 4096, 120, 256, 256, (torch.bfloat16, torch.float32)),
            (1, 2, 4160, 120, 64, 64, (torch.bfloat16, torch.float16))):
        for dt in dts:
            x = [torch.randn((b, hh, ss, d), generator=gen, device=dev, dtype=dt)
                 for _ in range(3)]
            name = str(dt).removeprefix("torch.")
            check(K.flash_attention(*x, bq=bq, bk=bk), x, name,
                  f"B={b} H={hh} S={ss} hd={d} {name}")
    # float64: the f32 route on copies rounded to f32, returned as float64,
    # held to the plain version on those copies and counted under the route
    f32_route = F.ROUTES[torch.float32]
    for d in (16, 128):
        x = [torch.randn((1, 2, 512, d), generator=gen, device=dev, dtype=torch.float64)
             for _ in range(3)]
        before = F.flash_attention.route_launches[f32_route]
        got = K.flash_attention(*x)
        err, ok = attn_err(torch, got, F.plain_flash_attention(*(t.float() for t in x)),
                           "float32")
        ok = ok and got.dtype == torch.float64 and \
            F.flash_attention.route_launches[f32_route] == before + 1
        attn_checks.append((ROUTE_NAMES["float32"],
                            f"B=1 H=2 S=512 hd={d} float64 vs plain", err, ok))
    # the CUDA-core f32 kernel, on no route but timed below: held to the
    # plain version at the f32 path's shape and at ragged S with hd 120
    x = [torch.randn((1, 2, 4160, 120), generator=gen, device=dev) for _ in range(3)]
    for args, where in ((x32, paths["float32"][1]), (x, "B=1 H=2 S=4160 hd=120 float32")):
        err, ok = attn_err(torch, K.flash_kernels["flash_attention"](*args),
                           F.plain_flash_attention(*args), "float32")
        attn_checks.append((CUDA_CORE_NAME, where + " vs plain", err, ok))
    torch.cuda.synchronize()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = {}
    for name, (args, where) in paths.items():
        bb, hh, ss, d = args[0].shape
        ops = 2 * 2 * bb * hh * (ss * ss / 2) * d  # QK^T and PV over the causal half
        _, terms, p_terms = F.TC_DESIGN[args[0].dtype]
        # the route's own products: (term pairs of S + term pairs of P V) / 2
        # per product of the function, each a bf16/f16 tensor-core product
        own = sum(i + j < terms for i in range(terms) for j in range(terms))
        own_pv = sum(i + j < p_terms for i in range(p_terms) for j in range(terms))
        design_ops = ops * (own + own_pv) / 2
        iters = 10 if name == "float32" else 20
        row = dict(
            ms=cuda_ms(torch, lambda: K.flash_attention(*args), iters),
            plain_ms=cuda_ms(torch, lambda: F.plain_flash_attention(*args), 2),
            library_ms=cuda_ms(torch, lambda: sdpa(*args, is_causal=True), iters),
            path_s=driven[name][0], launches=driven[name][1], at=where,
            design_bound_ms=design_ops / BF16_TENSOR_OPS_PER_S * 1e3)
        nbytes = 4 * args[0].numel() * args[0].element_size()
        if name == "float32":
            # the least time: the design's own products on the tensor cores
            # (the f32 function at the CUDA-core rate beside it)
            row["bound_ms"], row["bound_by"] = bound(nbytes, design_ops, BF16_TENSOR_OPS_PER_S)
            row["bound_basis"] = "design"
            row["cuda_core_bound_ms"] = ops / CUDA_CORE_OPS_PER_S * 1e3
            row["cuda_core_kernel_ms"] = cuda_ms(
                torch, lambda: K.flash_kernels["flash_attention"](*args), iters)
        else:
            row["bound_ms"], row["bound_by"] = bound(nbytes, ops, BF16_TENSOR_OPS_PER_S)
            row["bound_basis"] = "function"
        rows[ROUTE_NAMES[name]] = row
    # the bf16 kernel at 8 heads, hd 64 and 128: the same scores, half the
    # products at hd 64, so the ratio shows what the per-score work weighs;
    # hd 16 and 120 at the hd 64 and 128 instantiations (their columns past
    # hd read as zero)
    for d in (64, 128, 16, 120):
        x = [torch.randn((1, kv, s, d), generator=gen, device=dev, dtype=torch.bfloat16)
             for _ in range(3)]
        rows["flash_attention"][f"ms_H{kv}_hd{d}"] = cuda_ms(
            torch, lambda: K.flash_attention(*x), 20)
    for name, r in rows.items():
        log(f"time {name} {r['at']}: {r['ms']:.4f} ms (bound {r['bound_ms']:.4f} ms by "
            f"{r['bound_by']}, counting the {r['bound_basis']}'s operations; "
            f"{r['design_bound_ms']:.4f} ms for the route's own products"
            + (f", {r['cuda_core_bound_ms']:.4f} ms for the function on the CUDA cores; "
               f"the CUDA-core kernel {r['cuda_core_kernel_ms']:.4f} ms"
               if "cuda_core_kernel_ms" in r else "")
            + f"; plain {r['plain_ms']:.4f} ms, scaled_dot_product_attention "
            f"{r['library_ms']:.4f} ms)")
    r = rows["flash_attention"]
    log(f"time flash_attention B=1 H={kv} S={s} bf16: "
        + ", ".join(f"hd {d} {r[f'ms_H{kv}_hd{d}']:.4f} ms" for d in (64, 128, 16, 120)))
    return rows


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", type=Path, default=None, metavar="PATH",
                    help="also write the full timing and serving tables here")
    json_path = ap.parse_args(argv).json
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the card",
              file=sys.stderr)
        return 2
    src = ROOT / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run it from a checkout of the repository "
              "(src/repro_torch not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    t_start = time.perf_counter()
    import types

    from repro_torch.core import correction, packing
    from repro_torch.core.packed_params import (
        fuse_projection_weights,
        is_dsp_tuned_leaf,
        iter_packable_weights,
        split_expert_stacks,
    )
    from repro_torch.kernels import addpack_acc as A
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import flash_attention as F
    from repro_torch.kernels import int4_matmul as i4
    from repro_torch.kernels import packed_matmul as pm
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import _repeat_kv
    from repro_torch.models.moe import HOST_READS
    from repro_torch.models.registry import get_config
    from repro_torch.serving import Engine, ServeConfig
    from repro_torch.tuning import DEFAULT_WIDTH_CANDIDATES, PROBES, autotune, tuner

    P = types.SimpleNamespace(dataclasses=dataclasses, ref=ref, T=T, Engine=Engine,
                              ServeConfig=ServeConfig, get_config=get_config,
                              iter_packable_weights=iter_packable_weights,
                              fuse_projection_weights=fuse_projection_weights,
                              is_dsp_tuned_leaf=is_dsp_tuned_leaf,
                              repeat_kv=_repeat_kv, tuner=tuner, autotune=autotune,
                              tempfile=tempfile, PROBES=PROBES, HOST_READS=HOST_READS,
                              DEFAULT_WIDTH_CANDIDATES=DEFAULT_WIDTH_CANDIDATES)
    M = types.SimpleNamespace(packing=packing, correction=correction, ref=ref)

    class K:  # the kernels' wrappers and plain versions
        int4_matmul, int4_matmul_plain = i4.int4_matmul, i4.int4_matmul_plain
        int4_variant, packed_variant = i4.variant_for, pm.variant_for
        int4_kernels, packed_kernels = i4.KERNELS, pm.KERNELS
        prepacked_variant, prepacked_kernels = pm.prepacked_variant_for, pm.PREPACKED_KERNELS
        packed_matmul, packed_matmul_plain = pm.packed_matmul, pm.packed_matmul_plain
        packed_matmul_prepacked = pm.packed_matmul_prepacked
        packed_matmul_prepacked_plain = pm.packed_matmul_prepacked_plain
        addpack_accumulate = A.addpack_accumulate
        flash_attention, flash_kernels = F.flash_attention, F.KERNELS
        WRAPPERS = {"int4_matmul": i4.int4_matmul, "packed_matmul": pm.packed_matmul,
                    "packed_matmul_prepacked": pm.packed_matmul_prepacked,
                    "addpack_accumulate": A.addpack_accumulate,
                    "flash_attention": F.flash_attention}

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    # phase 1: the card
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")

    # phase 2: build
    t0 = time.perf_counter()
    times = build.build_all(("-Xptxas", "-v"))
    log(f"build: {time.perf_counter() - t0:.1f} s wall "
        f"({', '.join(f'{k} {v:.1f} s' for k, v in times.items()) or 'cached'})")

    # phase 3: kernels against their plain versions, then timed
    checks: list = []
    t0 = time.perf_counter()
    check_kernels(torch, K, ref, checks)
    check_geometries(torch, K, ref, checks, MOE_SHAPES, MOE_ROWS, "moe", 2)
    check_geometries(torch, K, ref, checks, FAMILY_SHAPES, FAMILY_ROWS, "families", 3)
    rows = time_kernels(torch, K, ref, checks)
    bad = [c for c in checks if c[2] != 0]
    for c in bad:
        log(f"MISMATCH {c[0]} {c[1]}: max abs diff {c[2]}")
    if bad:
        raise RuntimeError(f"{len(bad)} of {len(checks)} kernel checks disagree")
    log(f"kernels: {len(checks)} checks bit-exact against the plain versions "
        f"({time.perf_counter() - t0:.1f} s)")

    # phase 4: the main path at full width, launch counts zeroed just before
    zero_counts(K)
    t0 = time.perf_counter()
    serving_out = serve_full_width(torch, K, P, card)
    launches = kernel_counts(K)
    log(f"main path: {time.perf_counter() - t0:.1f} s, launches {launches}")
    need = {"int4_matmul": "int4_packed", "int4_matmul_tc": "int4_packed",
            "packed_matmul_prepacked": "dsp_tuned",
            "packed_matmul_prepacked_tiled": "dsp_tuned", "packed_matmul": "dsp_packed",
            "packed_matmul_tiled": "dsp_packed"}
    for kernel, mode in need.items():
        if serving_out[mode]["launches"][kernel] < 1 or launches[kernel] < 1:
            raise RuntimeError(f"{kernel} never launched on the main path ({mode})")
    for kernel in ("packed_matmul_prepacked", "packed_matmul_prepacked_tiled"):
        if serving_out["dsp_mixed"]["launches"][kernel] < 1:
            raise RuntimeError(f"{kernel} never launched serving dsp_mixed")

    # the MoE path: moonshot-v1-16b-a3b at full width, counts zeroed just
    # before and read just after
    zero_counts(K)
    t0 = time.perf_counter()
    moe_out = serve_moe(torch, K, P, card)
    moe_launches = kernel_counts(K)
    log(f"moe path: {time.perf_counter() - t0:.1f} s, launches {moe_launches}")
    for kernel, mode in need.items():
        if moe_out["modes"][mode]["launches"][kernel] < 1:
            raise RuntimeError(f"{kernel} never launched on the MoE path ({mode})")

    # the families: five configs at full width, each config's counts zeroed
    # just before it and read just after
    t0 = time.perf_counter()
    fam_out, fam_launches = serve_families(torch, K, P, card)
    log(f"families: {time.perf_counter() - t0:.1f} s")

    # phase 5: kernel engine vs plain-version engine at the smoke configs;
    # prefill chunks of 4 rows x 2 slots run the M <= 16 kernels, of 16 the
    # M > 16 ones; dsp_mixed on one allocation handed to all four engines
    plan = ref.spec_from_name(MAIN_PLAN)
    agree = {}
    for arch in ("qwen1.5-110b", "moonshot-v1-16b-a3b") + tuple(f[0] for f in FAMILIES):
        smoke = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
        sparams = T.init_params(smoke, seed=0, dtype=torch.float32, device="cuda")
        mixed = arch in ("qwen1.5-110b", "moonshot-v1-16b-a3b", "xlstm-1.3b")
        served = dict(max_len=32)
        if smoke.sliding_window:  # a prompt that crosses the window, and room for it
            gen = torch.Generator().manual_seed(1)
            wrap = torch.randint(2, smoke.vocab_size, (WRAP_PROMPT_LEN,), generator=gen)
            served = dict(max_len=48, prompts=[[5, 17, 33, 2, 9], list(range(40, 51)),
                                               wrap.tolist()])
        for mode in PACKED_MODES + (("dsp_mixed",) if mixed else ()):
            # the main plan by hand on every path served, each expert's too
            table = ({p: plan for p, _ in iter_packable_weights(split_expert_stacks(sparams))}
                     if mode == "dsp_tuned" else None)
            agree[f"{arch} {mode}"] = agreement(torch, P, smoke, sparams, mode, table,
                                                **served)
        del sparams
    gc.collect()
    torch.cuda.empty_cache()

    # phase 6: the paper's arithmetic (Tables I/II) on the card
    t0 = time.perf_counter()
    paper_rows = paper_on_card(torch, K, M)
    log(f"paper: {len(paper_rows)} tables equal on card and CPU "
        f"({time.perf_counter() - t0:.1f} s)")

    # phase 7: the SNN path through addpack_accumulate, then its checks
    n_checks = len(checks)
    snn = snn_addpack(torch, K, A, checks)
    bad = [c for c in checks[n_checks:] if c[2] != 0]
    for c in bad:
        log(f"MISMATCH {c[0]} {c[1]}: max abs diff {c[2]}")
    if bad:
        raise RuntimeError(f"{len(bad)} addpack_accumulate checks disagree")
    log(f"addpack_accumulate: {len(checks) - n_checks} checks bit-exact")
    gc.collect()
    torch.cuda.empty_cache()

    # phase 8: flash attention, bf16 at qwen1.5-110b's width and f32, then
    # its checks
    attn_checks: list = []
    attn = flash_qwen(torch, K, F, P, attn_checks)
    for name, where, err, ok in attn_checks:
        log(f"{'ok' if ok else 'MISMATCH'} {name} {where}: max abs err {err:.3g}")
    bad = [c for c in attn_checks if not c[3]]
    if bad:
        raise RuntimeError(f"{len(bad)} of {len(attn_checks)} flash_attention checks "
                           f"outside the tolerance {ATTN_TOL}")
    gc.collect()
    torch.cuda.empty_cache()

    # phase 9: the plan search on the card: the tuner, its kernel-variant
    # sweep (every candidate bit-exact to the first, the winners to the
    # plain version) and the plan database
    n_checks = len(checks)
    search = plan_search(torch, K, P, card, checks)
    bad = [c for c in checks[n_checks:] if c[2] != 0]
    for c in bad:
        log(f"MISMATCH {c[0]} {c[1]}: max abs diff {c[2]}")
    if bad:
        raise RuntimeError(f"{len(bad)} sweep winners disagree with the plain version")
    log(f"plan search: {len(checks) - n_checks} sweep winners bit-exact")
    gc.collect()
    torch.cuda.empty_cache()

    head = {r["kernel"]: r for r in rows if (r["M"], r["K"], r["N"]) == HEADLINE}
    head.update({r["kernel"]: r for r in rows
                 if (r["M"], r["K"], r["N"]) == HEADLINE_PREFILL and r["parent_ms"] is not None})
    where = {
        "int4_matmul": ("src/repro_torch/kernels/csrc/int4_matmul.cu",
                        "src/repro/kernels/int4_matmul.py:61"),
        "int4_matmul_tc": ("src/repro_torch/kernels/csrc/int4_matmul.cu",
                           "src/repro/kernels/int4_matmul.py:61"),
        "packed_matmul_prepacked": ("src/repro_torch/kernels/csrc/packed_matmul.cu",
                                    "src/repro/kernels/packed_matmul.py:277"),
        "packed_matmul_prepacked_tiled": ("src/repro_torch/kernels/csrc/packed_matmul.cu",
                                          "src/repro/kernels/packed_matmul.py:277"),
        "packed_matmul": ("src/repro_torch/kernels/csrc/packed_matmul.cu",
                          "src/repro/kernels/packed_matmul.py:127"),
        "packed_matmul_tiled": ("src/repro_torch/kernels/csrc/packed_matmul.cu",
                                "src/repro/kernels/packed_matmul.py:127"),
    }
    kernels = []
    for name, (source, replaces) in where.items():
        r = head[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": (launches[name] + moe_launches[name]
                         + sum(c[name] for c in fam_launches.values())),
            "launches_by_path": {"qwen1.5-110b": launches[name],
                                 "moonshot-v1-16b-a3b": moe_launches[name],
                                 **{a: c[name] for a, c in fam_launches.items()}},
            "max_abs_err": max(c[2] for c in checks if c[0] == name),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "at": f"M={r['M']} K={r['K']} N={r['N']}",
        })
        if r["parent_ms"] is not None:
            kernels[-1]["m16_kernel_ms"] = r["parent_ms"]
        if r["graph_ms"] is not None:
            kernels[-1]["graph_ms"] = r["graph_ms"]
    def attn_max(name: str, against: str) -> float:
        return max(c[2] for c in attn_checks if c[0] == name and c[1].endswith(against))

    kernels.append({
        "name": "addpack_accumulate", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/addpack_acc.cu",
        "replaces": "src/repro/kernels/addpack_acc.py:66", "launches": snn["launches"],
        "max_abs_err": max(c[2] for c in checks if c[0] == "addpack_accumulate"),
        "ms": snn["ms"], "plain_ms": snn["plain_ms"], "bound_ms": snn["bound_ms"],
        "bound_by": snn["bound_by"], "library_ms": snn["library_ms"], "at": snn["at"],
    })
    for name in ROUTE_NAMES.values():
        r = attn[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention_sm90.cu",
            "replaces": "src/repro/kernels/flash_attention.py:72",
            "launches": r["launches"], "max_abs_err": attn_max(name, "vs plain"),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"], "at": r["at"],
            "bound_basis": r["bound_basis"], "design_bound_ms": r["design_bound_ms"],
            "max_abs_err_emulation": attn_max(name, "vs emulation"),
        })
        if "cuda_core_kernel_ms" in r:
            kernels[-1].update(cuda_core_kernel_ms=r["cuda_core_kernel_ms"],
                               cuda_core_bound_ms=r["cuda_core_bound_ms"],
                               cuda_core_max_abs_err=attn_max(CUDA_CORE_NAME, "vs plain"))
    if json_path is not None:
        json_path.parent.mkdir(parents=True, exist_ok=True)
        json_path.write_text(json.dumps({
            "card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
            "kernels": kernels, "timings": rows, "serving": serving_out, "moe": moe_out,
            "families": fam_out,
            "agreement": agree,
            "paper": paper_rows, "snn": snn, "attention": attn, "plan_search": search,
            "attention_checks": attn_checks,
            "checks": len(checks), "seconds": time.perf_counter() - t_start,
        }, indent=1))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
