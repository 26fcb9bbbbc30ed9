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
   at M 1, 4, 17, 64, and at serve_lm's (``EXAMPLE_SHAPES``, the
   example's d_model 256 model) at M 1, 4, 17, 32; then each kernel timed with CUDA
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
   then four serving paths, each with its counts zeroed just before it
   and read just after: the continuous path (qwen1.5-110b at full width,
   4 layers): ``ContinuousEngine`` in native, int4_packed and dsp_tuned on
   the same requests, its greedy tokens and its kernel launches a decode
   step equal to the fixed-slot engine's, then a mixed load in
   int4_packed (16 requests on 8 lanes, prompts of 5-60 tokens, half of
   them opening with a registered 32-token system prompt, 8-24 new tokens,
   max_len 128, a pool of 20 pages of 16 that preempts), reporting decode
   ms/step, prefill tok/s, TTFT p50/p99, peak pages, preemptions,
   copy-on-write copies and peak memory, every stream equal to the same
   request served alone (at least one preemption and one copy); the
   governor path (2 layers, dsp_tuned, a plan database): the tiers'
   certified MAE, the build with the tier search and warm from the
   database (no tier search, the same tiers), one swap by ``set_tier``
   and one by queue depth (and back), decode ms/step on each tier; the
   replica path: ``ReplicaFront`` over two int4_packed engines, each
   request's route, the routed tokens equal one replica's; the CLI path:
   ``launch.serve`` at the smoke config with ``--engine continuous``,
   ``--governor --deadline-ms`` and ``--replicas 2`` on the card;
5. whole-path agreement at the smoke configs (qwen1.5-110b,
   moonshot-v1-16b-a3b and the five families): the kernel engine and the
   plain-version engine emit identical greedy tokens in int4_packed,
   dsp_tuned (mr plan, each expert's too), dsp_packed and, for qwen,
   moonshot and xlstm, dsp_mixed (one allocation, from the first kernel
   engine's sensitivity pass, handed to the other three), with prefill
   chunks of 8 rows and of 32 (the M > 16 kernels); h2o-danube with a
   30-token prompt that crosses its 32-token window; and in int4_packed
   and dsp_tuned, ``ContinuousEngine`` (two lanes, pages of 8, prefill
   chunks of 16) kernel against plain version, its tokens identical and
   equal to the fixed-slot kernel engine's;
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
10. training on the card (launch counts zeroed just before and read just
    after: the path runs none of the five kernels, as the reference's
    training reaches no Pallas kernel): h2o-danube-3-4b at full width
    (d_model 3840, 32 heads with 8 KV heads, d_ff 10240, vocab 32000), 8 of
    its 24 layers, bf16 compute over f32 parameters and AdamW state, global
    batch 8 x 512 tokens of the synthetic stream, a cosine schedule (peak
    3e-4, warmup 2, floor 0.1): 20 steps native, 10 qat4, 10 with
    compress_grads, each with finite losses and grad norms and the last 5
    losses' mean below the first 5's (median step ms, tokens/s, peak GB,
    6 N tokens TFLOP/s); two uninterrupted 10-step native runs bit-equal,
    the top 5 operators of one native step by ``torch.profiler``, and the
    step-5 checkpoint (``Checkpointer``, 17.8 GB) restored and run to step
    10 bit-equal to the uninterrupted run; the first step at the
    qwen1.5-110b smoke config in f32 on the card against the CPU (loss
    rtol 1e-5, grad norm 1e-4); then ``python -m repro_torch.launch.train``
    at xlstm-1.3b's full config (48 layers, 8 x 128 tokens) as a
    subprocess, 3 steps with a checkpoint directory under ``build/``, and a
    relaunch that resumes from step 3 and runs 2 more.
11. tensor-parallel serving (each rank's launch counts zeroed just before
    its path and read just after: the path runs none of the kernels, as
    the reference's tensor-parallel path reaches no Pallas kernel):
    qwen1.5-110b at full width, 2 of its 80 layers, bf16 seeded weights,
    phase 4's slots and requests, served at tp=2 by two spawned ranks
    (gloo when they share the one card, NCCL with a card a rank; the
    backend and its rule printed) in native, int4_packed, dsp_tuned (the
    shard-aware tuner's plans) and dsp_tuned on a word-path plan (an mr plan not proven
    exact on every path: the row leaves sum int32 packed words across
    ranks), and by ``ContinuousEngine`` in int4_packed; rank 0 first
    serves each alone at tp=1 on the card (the word-path mode on the
    widened plan on its row paths), and every rank's tp=2 tokens must
    equal tp=1's; decode ms/step, prefill tok/s and peak GB per rank at
    both; then ``launch.serve --tp 2`` at the smoke config, its tokens
    equal to ``--tp 1``'s.  A rank that fails or hangs (collectives time
    out after ``TP_TIMEOUT_S``; the ranks are ended after
    ``TP_DEADLINE_S``) fails the run.
12. sharded training (each rank's launch counts zeroed just before its
    path and read just after: the path runs none of the kernels, as the
    reference's sharded training reaches no Pallas kernel):
    h2o-danube-3-4b at full width, 2 of its 24 layers, bf16 compute over
    f32 state, phase 10's global batch, on two spawned ranks (gloo when
    they share the one card; the backend and its rule printed); rank 0
    first trains 3 steps mesh-free alone on the card; then 3 steps at mesh
    (2, 1) ("data", "model": FSDP over "data") and one with compress_grads
    at (1, 2), each with finite losses and grad norms and its first loss
    within rtol 1e-2 of the mesh-free one (median step ms, state and peak
    GB per rank); rank 0's mesh-free state saved and restored onto (2, 1),
    the shards gathered bit-equal to it, one more step from them within
    rtol 1e-2 of the mesh-free step; ``pipeline_forward`` over 2 stages
    ("pod", "data", "model") = (2, 1, 1), 4 microbatches of 2, against rank
    0's sequential forward: max abs difference 0 at qwen1.5-110b's smoke
    config in f32 (16 tokens), at most 2e-3 at the full width in f32 (512
    tokens); the qwen1.5-110b smoke config in f32, one step at (2, 1) on
    the card against the CPU's mesh-free step (loss rtol 1e-5, grad norm
    1e-4); then ``python -m torch.distributed.run --nproc-per-node 2 -m
    repro_torch.launch.train`` at h2o-danube-3-4b's smoke config with
    ``--mesh local``, 3 steps, and a relaunch that resumes and runs 2
    more.  A rank that fails or hangs (collectives time out after
    ``MESH_TIMEOUT_S``; the ranks are ended after ``MESH_DEADLINE_S``)
    fails the run.
13. the examples and the dry run: ``examples/torch_quickstart.py``,
    ``torch_serve_lm.py``, ``torch_snn_addpack.py`` and ``torch_train_lm.py``
    (20 steps) as subprocesses on the card, side by side, each starting its
    launch counts at 0 and printing them: quickstart's packed matmul equal
    to the exact product through ``packed_matmul``, serve_lm's six runs with
    int4_packed through ``int4_matmul``, dsp_packed through
    ``packed_matmul`` and dsp_tuned through ``packed_matmul_prepacked``,
    and each of those three runs served again in this process through the
    plain versions (dsp_tuned on the plans the example printed), whose
    greedy tokens must equal the kernels'; train_lm's loss falling; the dry run (``repro_torch.launch.dryrun``,
    meta tensors) at full width: ``--packed-tp 8`` printing EXPERIMENTS.md's
    figures for the three archs, qwen1.5-110b ``train_4k`` and
    ``decode_32k`` on pod16x16 ok, their records printed; then the dry run
    of h2o-danube-3-4b at full width, 2 layers, mesh-free, one train step
    at 8 x 512 (``lower_cell(depth_groups=2)``) against the real step on
    the card: its argument bytes equal to the real state's and batch's,
    its FLOPs to ``FlopCounterMode``'s count of the real step, and its
    predicted peak (arguments plus temp) printed beside
    ``torch.cuda.max_memory_allocated()``.

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
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import types
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
# phase 3: the serve_lm example's shapes (K, N) (d_model 256, k/v 128, d_ff
# 1024, vocab 4096) at its rows: decode at 4 slots, prefill chunks of 4
# slots x 8 tokens (1 and 17 each kernel's edge)
EXAMPLE_SHAPES = [(256, 256), (256, 128), (256, 1024), (1024, 256), (256, 4096)]
EXAMPLE_ROWS = (1, 4, 17, 32)
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
# the training path: h2o-danube-3-4b at full width, 8 of its 24 layers, bf16
# compute over f32 parameters and AdamW state; global batch 8 x 512 tokens
# of the synthetic stream (seed 0); a cosine schedule, peak lr 3e-4, warmup
# 2 steps, floor 0.1, over each run's steps
TRAIN_ARCH, TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ = "h2o-danube-3-4b", 8, 8, 512
TRAIN_LR, TRAIN_WARMUP = 3e-4, 2
# (name, linear mode, steps, compress_grads); compress_grads runs 10 steps,
# not 5, so that the first-5 / last-5 loss check compares disjoint windows
TRAIN_RUNS = (("native", "native", 20, False), ("qat4", "qat4", 10, False),
              ("compress_grads", "native", 10, True))
TRAIN_RESUME_AT, TRAIN_RESUME_TO = 5, 10
# the train CLI at xlstm-1.3b's full config (48 layers): 3 steps, then a
# relaunch that resumes and runs 2 more
CLI_TRAIN = ["--arch", "xlstm-1.3b", "--global-batch", "8", "--seq-len", "128",
             "--log-every", "1"]


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
               inspect=None, table=None, allocation=None, engine_cls=None,
               **scfg) -> tuple[dict, list]:
    """Build one engine (``P.Engine`` unless ``engine_cls``; 4 slots, max_len
    64, prefill chunk 16, no EOS), serve a 2-token warm-up request, then
    ``prompts`` greedily to 8 tokens each; returns its numbers (build
    seconds, sensitivity probes run in the build, prefill tok/s, median
    decode ms/step, launches per kernel in the serving and in the build,
    MoE host reads per decode step, peak memory, the tokens) and the tokens.
    A decode step is a step that starts with the queue empty and no lane
    prefilling (the fixed-slot engine's steps after the first, which
    admits; the continuous engine's after the last prefill chunk).
    ``inspect(engine, build_s)`` adds its own entries."""
    engine_cls = engine_cls or P.Engine
    at_build = kernel_counts(K)
    probes0, reads0 = P.PROBES.count, P.HOST_READS["count"]
    t0 = time.perf_counter()
    engine = engine_cls(cfg, params, P.ServeConfig(
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
        prefilling = getattr(engine, "_prefilling", None)
        pure = not sch.n_queued and (prefilling is None or not prefilling.any())
        r0, l0 = P.HOST_READS["count"], sum(kernel_counts(K).values())
        t0 = time.perf_counter()
        engine.step()
        if pure:
            step_ms.append((time.perf_counter() - t0) * 1e3)
            step_reads.append(P.HOST_READS["count"] - r0)
            step_launches.append(sum(kernel_counts(K).values()) - l0)
    if hasattr(engine, "peek_logits"):
        logits = torch.from_numpy(engine.peek_logits())
        if not bool(torch.isfinite(logits).all()):
            raise RuntimeError(f"{key}: non-finite logits")
        del logits
    tokens = [list(engine.outputs[r]) for r in rids]
    lengths = [len(t) for t in tokens]
    if lengths != [8] * len(prompts) or len(next(iter(warm.values()))) != 2:
        raise RuntimeError(f"{key}: expected {len(prompts)} x 8 tokens, got {lengths}")
    after = kernel_counts(K)
    decode = sorted(step_ms)
    launches = {k: after[k] - before[k] for k in after}
    out = dict(
        build_s=build_s, probes=probes,
        prefill_tok_s=(sch.prefill_tokens - tok0) / (sch.prefill_time_s - time0),
        decode_ms_per_step=decode[len(decode) // 2],
        decode_ms_steps=decode,  # every decode step, sorted: the spread
        decode_steps=len(decode),
        launches=launches,
        build_launches={k: before[k] - at_build[k] for k in before},
        host_reads_per_decode_step=max(step_reads, default=0),
        # kernel launches of each decode step
        decode_step_launches=step_launches,
        peak_gb=torch.cuda.max_memory_allocated() / 1e9,
        tokens=tokens,
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
    del engine
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

# ---- the continuous, governor, replica and CLI paths --------------------------

# the continuous path's mixed load (int4_packed): 16 requests on 8 lanes,
# prompts of 5-60 tokens, half of them opening with a registered 32-token
# system prompt (one of them the prompt alone, so that its adoption copies
# the prefix's last page), 8-24 new tokens each; a pool of 20 pages of 16
# (two lanes of max_len 128 need 16) preempts twice (the host's admission
# and growth decide it, the same at any width)
LOAD = dict(n_slots=8, max_len=128, prefill_chunk=16, page_size=16, n_pages=20,
            watermark_pages=2, eos_token=-1)
LOAD_REQUESTS, LOAD_PREFIX = 16, 32
CONT_MODES = ("native", "int4_packed", "dsp_tuned")
# the governor's controller in the governor path: degrade at a queue of 3
GOVERNOR = dict(queue_high=3, queue_low=1, emergency_queue_high=24, hold_steps=2)
# the governor path's depth: bf16 float weights (2 B a weight) and the two
# tiers' leaves (2.51 B a packable weight each) beside the build's
# transient, about 38 GB while the lm_head (8192 x 152064) is quantized
# onto a pair-packed plan (phase 4's dsp_tuned engine peaks at 70.8 GB
# over 15.9 GB of float weights and 16.7 GB of leaves); 3 layers run out of
# the card's 80 GB, 2 reckon to about 58 GB
GOVERNOR_LAYERS = 2


def mixed_load(torch, vocab: int) -> tuple[list, list, list]:
    """The mixed load's shared prefix, prompts and budgets, from a seed."""
    gen = torch.Generator().manual_seed(2)
    prefix = torch.randint(2, vocab, (LOAD_PREFIX,), generator=gen).tolist()
    prompts, max_new = [], []
    for i in range(LOAD_REQUESTS):
        if i % 2 == 0:  # the system prompt, then 0-28 tokens of the request's own
            own = 0 if i == 8 else int(torch.randint(1, 29, (), generator=gen))
            prompts.append(prefix + torch.randint(2, vocab, (own,), generator=gen).tolist())
        else:
            n = int(torch.randint(5, 61, (), generator=gen))
            prompts.append(torch.randint(2, vocab, (n,), generator=gen).tolist())
        max_new.append(int(torch.randint(8, 25, (), generator=gen)))
    return prefix, prompts, max_new


def serve_continuous(torch, K, P, card: str, engine_runs: dict) -> dict:
    """The continuous path at qwen1.5-110b's full width (phase 4's depth,
    bf16 seeded weights): ``ContinuousEngine`` in native, int4_packed and
    dsp_tuned on phase 4's requests, its tokens and its kernel launches a
    decode step equal to phase 4's fixed-slot ``Engine``'s
    (``engine_runs``); then the mixed load in int4_packed (``LOAD``), every
    stream equal to the same request served alone by a fixed-slot engine,
    at least one preemption and one copy-on-write copy."""
    cfg = P.dataclasses.replace(P.get_config("qwen1.5-110b"), n_layers=4)
    params = P.T.init_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    gen = torch.Generator().manual_seed(0)
    prompts = [torch.randint(2, cfg.vocab_size, (n,), generator=gen).tolist()
               for n in (5, 17, 30)]
    results = {}
    torch.cuda.reset_peak_memory_stats()
    for mode in CONT_MODES:
        results[mode], tokens = run_engine(torch, K, P, card, cfg, params, prompts,
                                           f"continuous {mode}", quant_mode=mode,
                                           engine_cls=P.ContinuousEngine)
        slot = engine_runs[mode]
        if tokens != slot["tokens"]:
            raise RuntimeError(f"continuous {mode}: tokens {tokens} != the fixed-slot "
                               f"engine's {slot['tokens']}")
        got, want = set(results[mode]["decode_step_launches"]), set(slot["decode_step_launches"])
        if got != want:
            raise RuntimeError(f"continuous {mode}: {sorted(got)} launches a decode step, "
                               f"the fixed-slot engine {sorted(want)}")
        log(f"continuous {mode}: tokens and launches a decode step ({sorted(got)}) equal "
            "the fixed-slot engine's")
    results["load"] = serve_load(torch, K, P, card, cfg, params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return results


def serve_load(torch, K, P, card: str, cfg, params) -> dict:
    """The mixed load through ``ContinuousEngine`` in int4_packed; each
    request then served alone by a one-slot fixed-slot engine, greedy
    tokens identical."""
    prefix, prompts, budgets = mixed_load(torch, cfg.vocab_size)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = P.ContinuousEngine(cfg, params, P.ServeConfig(
        quant_mode="int4_packed", device="cuda", **LOAD))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    # no warm-up request: the prefix is registered before any submission
    # (phase 4's engines warmed the process)
    engine.register_shared_prefix(prefix)
    rids = [engine.submit(p, max_new=m, admit=False) for p, m in zip(prompts, budgets)]
    decode_ms, steps = [], 0
    t_load = time.perf_counter()
    while engine.active.any() or engine.scheduler.n_queued:
        pure = not engine.scheduler.n_queued and not engine._prefilling.any()
        t0 = time.perf_counter()
        engine.step()
        steps += 1
        if pure:
            decode_ms.append((time.perf_counter() - t0) * 1e3)
    load_s = time.perf_counter() - t_load
    st = engine.stats()
    streams = [list(engine.outputs[r]) for r in rids]
    if [len(t) for t in streams] != budgets:
        raise RuntimeError(f"load: {[len(t) for t in streams]} tokens, budgets {budgets}")
    decode_ms.sort()
    out = dict(
        requests=len(prompts), prompt_lengths=[len(p) for p in prompts], max_new=budgets,
        build_s=build_s, load_s=load_s, steps=steps,
        decode_ms_per_step=decode_ms[len(decode_ms) // 2] if decode_ms else None,
        decode_only_steps=len(decode_ms),
        prefill_tok_s=st["prefill_tok_s"], decode_tok_s=st["decode_tok_s"],
        p50_ttft_ms=st["p50_ttft_s"] * 1e3, p99_ttft_ms=st["p99_ttft_s"] * 1e3,
        peak_pages=st["peak_pages_in_use"], n_pages=st["n_pages"],
        preempted=st["preempted"], cow_copies=st["cow_copies"],
        admissions=st["admissions"],
        peak_gb=torch.cuda.max_memory_allocated() / 1e9,
    )
    engine.alloc.check()
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    if out["preempted"] < 1 or out["cow_copies"] < 1:
        raise RuntimeError(f"load: {out['preempted']} preemptions, {out['cow_copies']} "
                           "copy-on-write copies; expected at least one of each")
    alone = P.Engine(cfg, params, P.ServeConfig(
        quant_mode="int4_packed", device="cuda", n_slots=1, max_len=LOAD["max_len"],
        prefill_chunk=LOAD["prefill_chunk"], eos_token=-1))
    for i, (p, m) in enumerate(zip(prompts, budgets)):
        want = alone.generate([p], max_new=m)
        if streams[i] != next(iter(want.values())):
            raise RuntimeError(f"load: request {i}'s stream {streams[i]} != served alone "
                               f"{next(iter(want.values()))}")
    del alone
    gc.collect()
    torch.cuda.empty_cache()
    log(f"load on {card}: {out['requests']} requests on {LOAD['n_slots']} lanes in "
        f"{out['steps']} steps ({load_s:.2f} s): decode {out['decode_ms_per_step']:.2f} "
        f"ms/step (median of {out['decode_only_steps']} decode-only steps), prefill "
        f"{out['prefill_tok_s']:.1f} tok/s, TTFT p50 {out['p50_ttft_ms']:.1f} ms / p99 "
        f"{out['p99_ttft_ms']:.1f} ms, peak pages {out['peak_pages']}/{out['n_pages']}, "
        f"{out['preempted']} preemptions, {out['cow_copies']} copy-on-write copies, "
        f"{out['admissions']} admissions, peak {out['peak_gb']:.1f} GB; every stream "
        "equals the request served alone")
    return out


def serve_governor(torch, K, P, card: str) -> dict:
    """The governor at qwen1.5-110b's full width, ``GOVERNOR_LAYERS`` deep,
    dsp_tuned, on a temporary plan database: a cold build (the tuner's and
    the tier search), then, with the controller detached, one swap by
    ``set_tier`` (phase 4's requests on the narrow tier, then on the
    primary), then the controller re-attached and a burst of ten requests
    on four lanes that swaps by queue depth and back; then the engine
    freed and built warm from the database (no tier search, the same
    tiers)."""
    cfg = P.dataclasses.replace(P.get_config("qwen1.5-110b"), n_layers=GOVERNOR_LAYERS)
    params = P.T.init_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    n_packable = sum(leaf.numel() for _, leaf in P.iter_packable_weights(params))
    n_weights = sum(t.numel() for t in tree_leaves(params))
    gen = torch.Generator().manual_seed(0)
    prompts = [torch.randint(2, cfg.vocab_size, (n,), generator=gen).tolist()
               for n in (5, 17, 30)]
    burst = [torch.randint(2, cfg.vocab_size, (n,), generator=gen).tolist()
             for n in (6, 9, 12, 15, 18, 21, 24, 27, 30, 33)]
    gcfg = P.GovernorConfig(**GOVERNOR)
    out = dict(layers=cfg.n_layers, weights=n_weights, packable_weights=n_packable,
               reckoned_gb=(2 * n_weights + 2 * 2.51 * n_packable) / 1e9 + 38)
    torch.cuda.reset_peak_memory_stats()
    with P.tempfile.TemporaryDirectory() as db:
        scfg = P.ServeConfig(n_slots=4, max_len=64, prefill_chunk=16, eos_token=-1,
                             quant_mode="dsp_tuned", device="cuda", plan_db=db,
                             governor=gcfg)
        builds = []
        for warm in (False, True):
            P.TIER_SEARCHES.reset()
            P.tuner._SCORE_CACHE.clear()  # the cold build scores every plan
            t0 = time.perf_counter()
            engine = P.ContinuousEngine(cfg, params, scfg)
            torch.cuda.synchronize()
            builds.append(dict(build_s=time.perf_counter() - t0,
                               tier_searches=P.TIER_SEARCHES.count,
                               plan_db=dict(engine.plan_db_stats),
                               tiers=[dict(t.summary(), plans=sorted(
                                   {r.name for r in t.plan_table.values()}))
                                   for t in engine.tiers]))
            if warm:
                break
            out.update(_govern(torch, K, P, engine, prompts, burst))
            del engine
            gc.collect()
            torch.cuda.empty_cache()
        del engine
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["cold"], out["warm"] = builds
    del params
    gc.collect()
    torch.cuda.empty_cache()
    if out["warm"]["tier_searches"] != 0 or out["cold"]["tier_searches"] != 1:
        raise RuntimeError(f"governor: tier searches {out['cold']['tier_searches']} cold, "
                           f"{out['warm']['tier_searches']} warm; expected 1 and 0")
    if out["warm"]["tiers"] != out["cold"]["tiers"]:
        raise RuntimeError("governor: the warm build's tiers differ from the cold build's")
    log(f"governor on {card}: {cfg.n_layers} layers ({n_weights / 1e9:.3f} G weights, "
        f"reckoned {out['reckoned_gb']:.1f} GB, peak {out['peak_gb']:.1f} GB); tiers "
        + "; ".join(f"{t['name']} {t['plans']} MAE {t['max_certified_mae']:g}"
                    for t in out["cold"]["tiers"])
        + f"; build {out['cold']['build_s']:.1f} s cold ({out['cold']['tier_searches']} "
        f"tier search), {out['warm']['build_s']:.1f} s warm (0 tier searches, plan db "
        f"{out['warm']['plan_db']['hits']} hit); decode ms/step by set_tier: primary "
        f"{out['set_tier']['primary']['decode_ms_per_step']:.2f}, narrow "
        f"{out['set_tier']['narrow']['decode_ms_per_step']:.2f}; queue-depth swaps "
        f"{out['queue']['history']}, decode ms/step there by tier {out['queue']['decode_ms']}")
    return out


def _govern(torch, K, P, engine, prompts, burst) -> dict:
    """The two swaps on a governed engine (see ``serve_governor``)."""
    engine.generate([prompts[0][:4]], max_new=2)  # warm-up request
    controller, engine.governor = engine.governor, None
    by_tier = {}
    for tier in (1, 0):
        engine.set_tier(tier)
        name = engine.tiers[tier].name
        ms = []
        rids = [engine.submit(p, max_new=8, admit=False) for p in prompts]
        while engine.active.any() or engine.scheduler.n_queued:
            pure = not engine.scheduler.n_queued and not engine._prefilling.any()
            t0 = time.perf_counter()
            engine.step()
            if pure:
                ms.append((time.perf_counter() - t0) * 1e3)
        ms.sort()
        by_tier[name] = dict(decode_ms_per_step=ms[len(ms) // 2], decode_ms_steps=ms,
                             tokens=[engine.outputs[r] for r in rids])
    engine.governor = controller
    tiers, per_tier = [], {}
    rids = [engine.submit(p, max_new=8, admit=False) for p in burst]
    for _ in range(200):
        if not (engine.active.any() or engine.scheduler.n_queued):
            break
        pure = not engine.scheduler.n_queued and not engine._prefilling.any()
        t0 = time.perf_counter()
        engine.step()
        if pure:
            per_tier.setdefault(engine.tiers[engine.active_tier].name, []).append(
                (time.perf_counter() - t0) * 1e3)
        tiers.append(engine.active_tier)
    for _ in range(GOVERNOR["hold_steps"] + 1):  # calm observations recover the tier
        engine.step()
        tiers.append(engine.active_tier)
    g = engine.stats()["governor"]
    if [h[1:] for h in g["history"]] != [(0, 1), (1, 0)]:
        raise RuntimeError(f"governor: queue-depth swaps {g['history']}, expected one "
                           "down and one back")
    if any(len(engine.outputs[r]) != 8 for r in rids):
        raise RuntimeError("governor: a burst request did not complete")
    return dict(set_tier=by_tier, queue=dict(
        history=g["history"], tiers=tiers,
        decode_ms={k: sorted(v)[len(v) // 2] for k, v in per_tier.items()}))


def serve_replicas(torch, K, P, card: str) -> dict:
    """``ReplicaFront`` over two int4_packed fixed-slot engines at
    qwen1.5-110b's full width (phase 4's depth), six requests with steps
    between some, each request's route printed; the routed tokens equal one
    replica serving all six."""
    cfg = P.dataclasses.replace(P.get_config("qwen1.5-110b"), n_layers=4)
    params = P.T.init_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    gen = torch.Generator().manual_seed(3)
    prompts = [torch.randint(2, cfg.vocab_size, (n,), generator=gen).tolist()
               for n in (5, 17, 30, 9, 24, 12)]
    scfg = P.ServeConfig(n_slots=4, max_len=64, prefill_chunk=16, eos_token=-1,
                         quant_mode="int4_packed", device="cuda")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    front = P.ReplicaFront(cfg, params, scfg, n_replicas=2)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    grids = []
    t0 = time.perf_counter()
    for i, p in enumerate(prompts):
        grids.append(front.submit(p, max_new=8))
        if i % 2 == 1:
            front.step()
    while any(r.active.any() or r.scheduler.n_queued for r in front.replicas):
        front.step()
    serve_s = time.perf_counter() - t0
    routes = [front.replica_of(g) for g in grids]
    routed = [front.outputs[g] for g in grids]
    single = list(front.replicas[0].generate(prompts, max_new=8).values())
    if routed != single:
        raise RuntimeError(f"replicas: routed tokens {routed} != one replica's {single}")
    out = dict(routes=routes, build_s=build_s, serve_s=serve_s,
               finished=front.stats()["finished"],
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    for g, r in zip(grids, routes):
        log(f"replicas on {card}: request {g} -> replica {r}")
    log(f"replicas: 2 int4_packed engines built in {build_s:.1f} s, six requests served "
        f"in {serve_s:.2f} s, routes {routes}; tokens equal one replica serving all six")
    del front, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def serve_cli(torch, P, card: str) -> dict:
    """``python -m repro_torch.launch.serve`` at the smoke config on its
    default device, the card: the continuous engine, the governor with a
    deadline, two replicas (their routes printed); each run's last lines."""
    import contextlib
    import io

    base = ["--arch", "qwen1.5-110b", "--smoke", "--requests", "4", "--max-new", "6"]
    runs = {"continuous": ["--engine", "continuous", "--page-size", "8", "--n-pages", "12",
                           "--quant", "int4_packed"],
            "governor": ["--engine", "continuous", "--governor", "--quant", "dsp_tuned",
                         "--deadline-ms", "60000"],
            "replicas": ["--replicas", "2", "--quant", "int4_packed"]}
    out = {}
    for name, flags in runs.items():
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            P.serve.main(base + flags)
        lines = buf.getvalue().splitlines()
        out[name] = lines
        for line in lines:
            if "replica" in line or "pages:" in line or "governor" in line or "shed" in line:
                log(f"cli {name} on {card}: {line}")
    return out


# ---- training ------------------------------------------------------------


def train_steps(torch, R, cfg, state, n: int, start: int = 0, compress: bool = False,
                total: int | None = None, on_step=None) -> tuple[dict, list]:
    """``n`` train steps from step ``start`` of the seeded stream (schedule
    over ``total`` steps, default ``n``); returns the state and one record a
    step: loss, ce, aux, grad norm, lr and the host ms to a device sync."""
    total = total or n
    step_fn = R.make_train_step(cfg, R.AdamWConfig(lr=TRAIN_LR), compress_grads=compress,
                                lr_schedule=R.cosine_with_warmup(TRAIN_LR, TRAIN_WARMUP,
                                                                 total))
    data = R.SyntheticStream(R.DataConfig(cfg.vocab_size, TRAIN_SEQ + 1, TRAIN_BATCH, seed=0))
    records = []
    for i in range(start, start + n):
        batch = {k: torch.from_numpy(v).cuda() for k, v in data.batch_at(i).items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        m = {k: float(v) for k, v in m.items()}  # waits for the step
        m["ms"] = (time.perf_counter() - t0) * 1e3
        records.append(m)
        if on_step is not None:
            on_step(i + 1, state)
    return state, records


def max_param_diff(a: list, b: list) -> float:
    return max(float((x.detach().float() - y.detach().float()).abs().max())
               for x, y in zip(a, b))


def train_figures(records: list, n_params: int) -> dict:
    """Median step ms (the first step, the allocator's warm-up, left out),
    tokens/s and achieved TFLOP/s (6 * N * tokens over the step time)."""
    ms = sorted(r["ms"] for r in records[1:])
    med = ms[len(ms) // 2]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    return {"step_ms_median": med, "tokens_per_s": tokens / med * 1e3,
            "tflops": 6 * n_params * tokens / (med * 1e-3) / 1e12}


def check_losses(name: str, records: list) -> None:
    """Finite losses and grad norms; the last 5 losses' mean below the
    first 5's."""
    if not all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]) for r in records):
        raise RuntimeError(f"training {name}: a loss or grad norm is not finite: {records}")
    losses = [r["loss"] for r in records]
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    if not last < first:
        raise RuntimeError(f"training {name}: the mean of the last 5 losses {last:.4f} is "
                           f"not below the first 5's {first:.4f}")


def top_ops(torch, fn, k: int = 5) -> list:
    """The ``k`` operators of ``fn()`` with the most device time of their
    own, by ``torch.profiler`` (empty when it records no device time)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()

    def device_us(e) -> float:
        for attr in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(e, attr):
                return float(getattr(e, attr))
        return 0.0

    # operators only (their kernels are listed too, under the kernels' names)
    events = sorted((e for e in prof.key_averages() if e.key.startswith("aten::")),
                    key=device_us, reverse=True)
    return [{"op": e.key, "device_ms": device_us(e) / 1e3, "calls": e.count}
            for e in events[:k] if device_us(e) > 0]


def train_path(torch, R, card: str) -> dict:
    """The training path (module docstring): three runs at h2o-danube-3-4b's
    full width, the resume check, the card against the CPU at the smoke
    config, and the train CLI at xlstm-1.3b's full config."""
    import os
    import shutil

    out: dict = {"card": card, "arch": TRAIN_ARCH, "n_layers": TRAIN_LAYERS,
                 "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "lr": TRAIN_LR,
                 "schedule": f"cosine, warmup {TRAIN_WARMUP}, floor 0.1, over each run"}
    base = dataclasses.replace(R.get_config(TRAIN_ARCH), n_layers=TRAIN_LAYERS)
    ckpt_dir = ROOT / "build" / "train_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    ckpt = R.Checkpointer(str(ckpt_dir), keep=1)
    snapshot: dict = {}

    def keep_resume_points(done: int, state: dict) -> None:
        # the native run saves at step 5 and is read at step 10
        if done == TRAIN_RESUME_AT:
            t0 = time.perf_counter()
            ckpt.save(done, state, extra={"train_step": done})
            snapshot["save_s"] = time.perf_counter() - t0
        if done == TRAIN_RESUME_TO:
            snapshot["params"] = [p.detach().clone() for p in tree_leaves(state["params"])]

    runs = {}
    for name, mode, n, compress in TRAIN_RUNS:
        cfg = dataclasses.replace(base, quant=R.LinearSpec(mode=mode))
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state = R.build_state(cfg, seed=0, compress_grads=compress, device="cuda")
        n_params = sum(p.numel() for p in tree_leaves(state["params"]))
        state, records = train_steps(
            torch, R, cfg, state, n, compress=compress,
            on_step=keep_resume_points if name == "native" else None)
        check_losses(name, records)
        fig = train_figures(records, n_params)
        fig.update(steps=n, n_params=n_params, records=records,
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                   first_step_ms=records[0]["ms"])
        runs[name] = fig
        log(f"train {name} on {card}: {n} steps, loss {records[0]['loss']:.4f} -> "
            f"{records[-1]['loss']:.4f}, median {fig['step_ms_median']:.1f} ms/step, "
            f"{fig['tokens_per_s']:.0f} tok/s, {fig['tflops']:.1f} TFLOP/s "
            f"(6 N tokens, N {n_params / 1e9:.3f} G), peak {fig['peak_gb']:.1f} GB")
        del state
    out["runs"] = runs
    out["save_s"] = snapshot["save_s"]

    # the resume check: a second uninterrupted run first (determinism), then
    # the step-5 checkpoint restored and run to step 10, on the native run's
    # schedule
    native_steps = TRAIN_RUNS[0][2]
    gc.collect()
    torch.cuda.empty_cache()
    twin = R.build_state(base, seed=0, device="cuda")
    twin, _ = train_steps(torch, R, base, twin, TRAIN_RESUME_TO, total=native_steps)
    spread = max_param_diff(snapshot["params"], tree_leaves(twin["params"]))
    out["uninterrupted_spread"] = spread
    log(f"train resume: two uninterrupted {TRAIN_RESUME_TO}-step runs "
        f"{'bit-equal' if spread == 0 else f'differ by up to {spread:.3g}'}")
    if spread != 0:
        raise RuntimeError("two identical uninterrupted runs differ on the card (max abs "
                           f"diff {spread:.3g}): run the resume check under "
                           "torch.use_deterministic_algorithms(True)")
    holder = {"state": twin}
    del twin

    def one_native_step():  # traced; the twin is discarded after
        holder["state"], _ = train_steps(torch, R, base, holder["state"], 1,
                                         start=TRAIN_RESUME_TO, total=native_steps)

    out["top_ops"] = top_ops(torch, one_native_step)
    for op in out["top_ops"]:
        log(f"train top op on {card}: {op['op']} {op['device_ms']:.2f} ms "
            f"({op['calls']} calls)")
    holder.clear()
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    restored, extra = ckpt.restore(TRAIN_RESUME_AT,
                                   R.build_state(base, seed=1, device="cuda"))
    out["restore_s"] = time.perf_counter() - t0
    if extra != {"train_step": TRAIN_RESUME_AT}:
        raise RuntimeError(f"resume: the checkpoint's extra is {extra}")
    restored, _ = train_steps(torch, R, base, restored, TRAIN_RESUME_TO - TRAIN_RESUME_AT,
                              start=TRAIN_RESUME_AT, total=native_steps)
    diff = max_param_diff(snapshot["params"], tree_leaves(restored["params"]))
    out["resume_diff"] = diff
    log(f"train resume: saved at step {TRAIN_RESUME_AT} ({out['save_s']:.1f} s), restored "
        f"({out['restore_s']:.1f} s), run to {TRAIN_RESUME_TO}: "
        f"{'bit-equal' if diff == 0 else f'differs by up to {diff:.3g}'} to the "
        "uninterrupted run")
    if diff != 0:
        raise RuntimeError(f"the resumed run differs from the uninterrupted one ({diff:.3g})")
    del restored
    snapshot.clear()
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()

    # the card against the CPU: the first step's loss and gradient norm at
    # the smoke config in f32 (TF32 is off for the whole script)
    smoke = dataclasses.replace(R.get_config("qwen1.5-110b", smoke=True), dtype="float32")
    cpu_params = R.build_state(smoke, seed=0, device="cpu")["params"]
    b = R.SyntheticStream(R.DataConfig(smoke.vocab_size, 33, 8, seed=1)).batch_at(0)
    got = {}
    for where in ("cpu", "cuda"):
        params = R.tree_map(lambda p: p.detach().clone().to(where), cpu_params)
        loss, _, grads = R.loss_and_grads(
            params, smoke, {k: torch.from_numpy(v).to(where) for k, v in b.items()})
        gnorm = math.sqrt(sum(float(torch.sum(g.double() ** 2)) for g in tree_leaves(grads)))
        got[where] = (float(loss), gnorm)
    loss_rel = abs(got["cuda"][0] - got["cpu"][0]) / abs(got["cpu"][0])
    gnorm_rel = abs(got["cuda"][1] - got["cpu"][1]) / got["cpu"][1]
    out["card_vs_cpu"] = {"loss": got, "loss_rel": loss_rel, "gnorm_rel": gnorm_rel}
    log(f"train card vs CPU (qwen1.5-110b smoke, f32, TF32 off): loss {got['cuda'][0]:.7f} "
        f"vs {got['cpu'][0]:.7f} (rel {loss_rel:.2e}), grad norm {got['cuda'][1]:.6f} vs "
        f"{got['cpu'][1]:.6f} (rel {gnorm_rel:.2e})")
    if not (loss_rel <= 1e-5 and gnorm_rel <= 1e-4):
        raise RuntimeError("the card's first step disagrees with the CPU's beyond "
                           "rtol 1e-5 (loss) / 1e-4 (grad norm)")

    # the train CLI at xlstm-1.3b's full config: 3 steps, then a relaunch
    # that resumes from the step-3 checkpoint and runs 2 more
    cli_dir = ROOT / "build" / "train_cli"
    shutil.rmtree(cli_dir, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cli = {}
    for steps in (3, 5):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", *CLI_TRAIN,
             "--steps", str(steps), "--ckpt-dir", str(cli_dir)],
            capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
        lines = proc.stdout.splitlines()
        cli[str(steps)] = {"s": time.perf_counter() - t0, "lines": lines}
        for line in lines:
            log(f"train cli on {card}: {line}")
        if proc.returncode != 0 or not lines or lines[-1] != "[train] done":
            raise RuntimeError(f"train CLI --steps {steps} failed ({proc.returncode}): "
                               f"{proc.stderr[-2000:]}")
        logged = [(float(line.split("loss=")[1].split()[0]),
                   float(line.split("gnorm=")[1].split()[0])) for line in lines
                  if line.startswith("[train] step=")]
        if len(logged) != (3 if steps == 3 else 2):
            raise RuntimeError(f"train CLI --steps {steps}: steps logged {logged}")
        if not all(math.isfinite(x) for pair in logged for x in pair):
            raise RuntimeError(f"train CLI --steps {steps}: (loss, gnorm) {logged}")
    if "[train] resumed from step 3" not in cli["5"]["lines"]:
        raise RuntimeError("the train CLI's relaunch did not resume from step 3")
    shutil.rmtree(cli_dir, ignore_errors=True)
    out["cli"] = cli
    log(f"train cli on {card}: 3 steps in {cli['3']['s']:.1f} s, the relaunch "
        f"resumed to 5 in {cli['5']['s']:.1f} s")
    return out


def agreement_continuous(torch, P, cfg, params, mode: str, table=None, prompts=None,
                         max_len: int = 32) -> list:
    """Continuous engine, kernel against plain version, at a smoke config:
    two lanes, pages of 8, prefill chunks of 16 (two lanes of 16 rows: the
    M > 16 kernels; decode the M <= 16 ones); greedy tokens identical, and
    equal to the fixed-slot kernel engine's at the same chunk."""
    prompts = prompts or [[5, 17, 33, 2, 9], list(range(40, 51)), [7, 8, 9]]
    toks = []
    for engine_cls, uk in ((P.ContinuousEngine, True), (P.ContinuousEngine, False),
                           (P.Engine, True)):
        eng = engine_cls(cfg, params, P.ServeConfig(
            n_slots=2, max_len=max_len, prefill_chunk=16, max_new=6, quant_mode=mode,
            page_size=8, device="cuda", use_kernel=uk), plan_table=table)
        toks.append(eng.generate(prompts))
        del eng
    if not toks[0] == toks[1] == toks[2]:
        raise RuntimeError(f"{cfg.name} {mode} continuous: kernel engine {toks[0]}, plain "
                           f"engine {toks[1]}, fixed-slot engine {toks[2]}")
    log(f"agreement {cfg.name} {mode} continuous: kernel and plain engines emit identical "
        "tokens, the fixed-slot engine's")
    return list(toks[0].values())

# ---- phase 11: tensor-parallel serving --------------------------------------

# the tensor-parallel path: qwen1.5-110b at full width, TP_LAYERS of its 80
# layers, bf16, phase 4's slots and requests, at tp=TP_RANKS against tp=1 on
# the same card; two ranks share the one card over gloo (NCCL with a card a
# rank where the machine has as many); every rank's collectives time out
# after TP_TIMEOUT_S, and the parent ends the ranks after TP_DEADLINE_S
TP_LAYERS, TP_RANKS, TP_TIMEOUT_S, TP_DEADLINE_S = 2, 2, 300, 900
# (key, quant mode): "dsp_tuned" plans by the shard-aware tuner (proven
# exact off the kernels: the f32 shard paths); "+words" serves on every path
# the first mr plan of the shard-aware ranking (rank_plans(4, 4,
# shard_groups=2)) that is not proven exact, so that no leaf carries w_f32
# and the row leaves sum int32 words, against a tp=1 engine serving the
# widened plan on the row paths
TP_MODES = (("native", "native"), ("int4_packed", "int4_packed"),
            ("dsp_tuned", "dsp_tuned"), ("dsp_tuned+words", "dsp_tuned"))


def tp_serve(torch, W, build, prompts, key: str, tp: int, rank: int) -> dict:
    """Build an engine (``build()``; tp > 1: the ranks one at a time on a
    shared card), serve a 2-token warm-up request, then ``prompts`` greedily
    to 8 tokens; its build seconds, prefill tok/s, median decode ms/step
    (steps with no prefill), peak GB of this process and tokens."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = W.mesh.in_turns(build) if tp > 1 else build()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    engine.generate([prompts[0][:4]], max_new=2)
    sch = engine.scheduler
    tok0, time0 = sch.prefill_tokens, sch.prefill_time_s
    rids = [engine.submit(p, max_new=8, admit=False) for p in prompts]
    steps = []
    while engine.active.any() or sch.n_queued:
        prefilling = getattr(engine, "_prefilling", None)
        pure = not sch.n_queued and (prefilling is None or not prefilling.any())
        t0 = time.perf_counter()
        engine.step()
        if pure:
            torch.cuda.synchronize()
            steps.append((time.perf_counter() - t0) * 1e3)
    tokens = [list(engine.outputs[r]) for r in rids]
    if [len(t) for t in tokens] != [8] * len(prompts):
        raise RuntimeError(f"{key} tp={tp}: tokens {tokens}")
    out = dict(build_s=build_s, use_kernel=engine.use_kernel,
               prefill_tok_s=(sch.prefill_tokens - tok0) / (sch.prefill_time_s - time0),
               decode_ms_per_step=sorted(steps)[len(steps) // 2], decode_ms_steps=sorted(steps),
               peak_gb=torch.cuda.max_memory_allocated() / 1e9, tokens=tokens)
    if tp > 1:
        kinds: dict = {}
        for leaf in tree_leaves(engine.params):
            if isinstance(leaf, W.TpLinear):
                f32 = (leaf.inner.get("w_f32") if isinstance(leaf.inner, dict)
                       else leaf.inner.w_f32) is not None
                k = f"{leaf.kind} {'f32' if f32 else 'words'}"
                kinds[k] = kinds.get(k, 0) + 1
        out["tp_leaves"] = kinds
    if rank == 0:
        log(f"tp {key} tp={tp} rank 0: build {build_s:.1f} s, prefill "
            f"{out['prefill_tok_s']:.1f} tok/s, decode {out['decode_ms_per_step']:.2f} "
            f"ms/step, peak {out['peak_gb']:.1f} GB, use_kernel {engine.use_kernel}"
            + (f", partitioned leaves {out['tp_leaves']}" if tp > 1 else ""))
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return out


def tp_worker(rank: int, world: int, init_method: str, outdir: str) -> None:
    """One rank of the tensor-parallel path (a spawned process): join the
    group, zero its launch counts, serve every mode of ``TP_MODES`` and one
    ``ContinuousEngine`` at tp=``world`` (rank 0 first serves each at tp=1
    alone on the card, the others waiting), read the counts, write this
    rank's numbers to ``outdir/rank<rank>.json``."""
    import types

    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from repro_torch.core.packed_params import iter_packable_weights
    from repro_torch.kernels import addpack_acc as A
    from repro_torch.kernels import flash_attention as F
    from repro_torch.kernels import int4_matmul as i4
    from repro_torch.kernels import packed_matmul as pm
    from repro_torch.kernels.ref import widen_for_shards
    from repro_torch.launch.mesh import init_serving_world, make_serving_mesh
    from repro_torch.models import transformer as T
    from repro_torch.models.registry import get_config
    from repro_torch.runtime.sharding import linear_partition
    from repro_torch.runtime.tp_packed import TpLinear
    from repro_torch.serving import ContinuousEngine, Engine, ServeConfig
    from repro_torch.analysis.verify import certify_spec
    from repro_torch.tuning import rank_plans

    backend = init_serving_world(rank, world, init_method, "cuda", timeout_s=TP_TIMEOUT_S)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    mesh = make_serving_mesh(world, "cuda")
    K = types.SimpleNamespace(
        int4_matmul=i4.int4_matmul, packed_matmul=pm.packed_matmul,
        packed_matmul_prepacked=pm.packed_matmul_prepacked, flash_attention=F.flash_attention,
        WRAPPERS={"int4_matmul": i4.int4_matmul, "packed_matmul": pm.packed_matmul,
                  "packed_matmul_prepacked": pm.packed_matmul_prepacked,
                  "addpack_accumulate": A.addpack_accumulate,
                  "flash_attention": F.flash_attention})
    W = types.SimpleNamespace(mesh=mesh, TpLinear=TpLinear)
    cfg = dataclasses.replace(get_config("qwen1.5-110b"), n_layers=TP_LAYERS)
    gen = torch.Generator().manual_seed(0)
    prompts = [torch.randint(2, cfg.vocab_size, (n,), generator=gen).tolist()
               for n in (5, 17, 30)]
    words = next(r.spec for r in rank_plans(4, 4, shard_groups=world)
                 if r.spec.uses_mr and not certify_spec(r.spec).exact)
    out: dict = {"rank": rank, "backend": backend, "device": str(mesh.device),
                 "words_plan": words.name(), "modes": {}}
    zero_counts(K)

    def engine_for(mode: str, key: str, tp: int, engine_cls=Engine):
        def build():
            params = T.init_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
            table = None
            if key.endswith("+words"):
                paths = [p for p, _ in iter_packable_weights(params)]
                # tp=1 serves the widened plan where tp=2 sums row words
                table = {p: widen_for_shards(words, world)
                         if tp == 1 and linear_partition(p) == "row" else words
                         for p in paths}
            return engine_cls(cfg, params, ServeConfig(
                n_slots=4, max_len=64, prefill_chunk=16, max_new=8, eos_token=-1,
                device="cuda", quant_mode=mode, tp=tp, use_kernel=False),
                plan_table=table)
        return build

    runs = [(key, mode, Engine) for key, mode in TP_MODES]
    runs.append(("continuous int4_packed", "int4_packed", ContinuousEngine))
    for key, mode, engine_cls in runs:
        row = {}
        if rank == 0:
            row["tp1"] = tp_serve(torch, W, engine_for(mode, key, 1, engine_cls), prompts,
                                  key, 1, rank)
        mesh.barrier()
        row[f"tp{world}"] = tp_serve(torch, W, engine_for(mode, key, world, engine_cls),
                                     prompts, key, world, rank)
        out["modes"][key] = row
        mesh.barrier()
    out["launches"] = kernel_counts(K)
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    torch.distributed.destroy_process_group()


def run_ranks(torch, fn, world: int, args: tuple, deadline_s: float) -> None:
    """Start ``world`` spawned processes running ``fn(rank, *args)`` and
    wait; a rank that fails, or a run past ``deadline_s``, ends every rank
    and raises."""
    ctx = torch.multiprocessing.start_processes(fn, args=args, nprocs=world, join=False,
                                                start_method="spawn")
    t_end = time.monotonic() + deadline_s
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > t_end:
                raise RuntimeError(f"the ranks ran past {deadline_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()


def tp_path(torch, card: str) -> dict:
    """The tensor-parallel path (module docstring): ``TP_RANKS`` spawned
    ranks, each mode's tp=2 tokens held to tp=1's on the same card, and the
    serve CLI with ``--tp 2`` at the smoke config against ``--tp 1``."""
    import socket

    from repro_torch.launch import mesh as tp_mesh

    world = TP_RANKS
    backend = tp_mesh.choose_backend(world, "cuda")
    log(f"tp path: {world} ranks, backend {backend} on {torch.cuda.device_count()} "
        f"card(s) (rule: {tp_mesh.BACKEND_RULE}); staging: none, the collectives "
        "take the ranks' CUDA tensors as they are")
    outdir = ROOT / "build" / "tp_path"
    outdir.mkdir(parents=True, exist_ok=True)
    for old in outdir.glob("rank*.json"):
        old.unlink()
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    t0 = time.perf_counter()
    run_ranks(torch, tp_worker, world, (world, f"tcp://localhost:{port}", str(outdir)),
              TP_DEADLINE_S)
    ranks = [json.loads((outdir / f"rank{r}.json").read_text()) for r in range(world)]
    out = {"card": card, "layers": TP_LAYERS, "ranks": world, "backend": ranks[0]["backend"],
           "rule": tp_mesh.BACKEND_RULE,
           "words_plan": ranks[0]["words_plan"], "seconds": time.perf_counter() - t0,
           "modes": {}, "launches": {k: sum(r["launches"][k] for r in ranks)
                                     for k in ranks[0]["launches"]}}
    tpk = f"tp{world}"
    for key, row in ranks[0]["modes"].items():
        want = row["tp1"]["tokens"]
        for r in ranks:
            if r["modes"][key][tpk]["tokens"] != want:
                raise RuntimeError(f"tp {key}: rank {r['rank']}'s tp={world} tokens "
                                   f"{r['modes'][key][tpk]['tokens']} != tp=1's {want}")
        if row[tpk]["use_kernel"]:
            raise RuntimeError(f"tp {key}: tp={world} resolved use_kernel=True")
        out["modes"][key] = {
            "tp1": {k: v for k, v in row["tp1"].items() if k != "tokens"},
            tpk: {k: v for k, v in row[tpk].items() if k != "tokens"},
            "peak_gb_per_rank": [r["modes"][key][tpk]["peak_gb"] for r in ranks],
            "tokens": want}
        m = out["modes"][key]
        log(f"tp {key} on {card}: tp={world} tokens equal tp=1's; decode "
            f"{row['tp1']['decode_ms_per_step']:.2f} -> {row[tpk]['decode_ms_per_step']:.2f} "
            f"ms/step, prefill {row['tp1']['prefill_tok_s']:.1f} -> "
            f"{row[tpk]['prefill_tok_s']:.1f} tok/s, peak GB per rank "
            f"{[round(g, 1) for g in m['peak_gb_per_rank']]} (tp=1 "
            f"{row['tp1']['peak_gb']:.1f}), backend {out['backend']}")
    words = out["modes"]["dsp_tuned+words"][tpk]["tp_leaves"]
    if words.get("row words", 0) < 1 or words.get("row f32", 0) or words.get("col f32", 0):
        raise RuntimeError(f"tp dsp_tuned+words: the row leaves {words} are not all on "
                           "the word path")
    if any(out["launches"].values()):
        raise RuntimeError(f"the tensor-parallel path launched a kernel: {out['launches']}")
    # the CLI: --tp 2 starts its own ranks; its tokens equal --tp 1's
    cli = {}
    base = [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "qwen1.5-110b",
            "--smoke", "--requests", "3", "--max-new", "4", "--quant", "int4_packed"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    for tp in (1, world):
        t1 = time.perf_counter()
        proc = subprocess.run(base + ["--tp", str(tp)], capture_output=True, text=True,
                              env=env, cwd=ROOT, timeout=300)
        if proc.returncode:
            raise RuntimeError(f"serve CLI --tp {tp} failed: {proc.stderr[-2000:]}")
        lines = proc.stdout.splitlines()
        cli[tp] = dict(s=time.perf_counter() - t1, lines=lines,
                       tokens=[line.split("-> ")[1] for line in lines
                               if line.startswith("[serve] request")])
    if cli[world]["tokens"] != cli[1]["tokens"] or len(cli[1]["tokens"]) != 3:
        raise RuntimeError(f"serve CLI: --tp {world} tokens {cli[world]['tokens']} != "
                           f"--tp 1's {cli[1]['tokens']}")
    for line in cli[world]["lines"]:
        if line.startswith(f"[serve] tp={world}") or "tokens in" in line:
            log(f"tp cli on {card}: {line}")
    out["cli"] = {str(k): v for k, v in cli.items()}
    out["seconds"] = time.perf_counter() - t0
    return out


# ---- phase 12: sharded training -----------------------------------------------

# the sharded training path: h2o-danube-3-4b at full width, MESH_LAYERS of its
# 24 layers, bf16 compute over f32 state, phase 10's global batch (8 x 512 of
# the synthetic stream, seed 0) and peak lr at a constant schedule; MESH_RANKS
# ranks share the one card over gloo (NCCL with a card a rank where the
# machine has as many); collectives time out after MESH_TIMEOUT_S, and the
# parent ends the ranks after MESH_DEADLINE_S
MESH_LAYERS, MESH_RANKS, MESH_STEPS, MESH_TIMEOUT_S, MESH_DEADLINE_S = 2, 2, 3, 300, 600
# the pipeline: 2 stages over "pod", 4 microbatches; the smoke config's
# sequences are 16 tokens, the full width's 512
PIPE_MICRO, PIPE_MB = 4, 2
# the train CLI under torch.distributed.run: 2 ranks on the card, 3 steps,
# then a relaunch that resumes and runs 2 more
CLI_MESH = ["--arch", TRAIN_ARCH, "--smoke", "--mesh", "local", "--log-every", "1"]


def mesh_steps(torch, R, cfg, state, batches: list, mesh=None, p_shard=None,
               compress: bool = False, start: int = 0) -> tuple[dict, list]:
    """Train steps (the mesh's when ``mesh`` is given) on ``batches``
    from ``start``, at a constant lr; one record a step: loss, grad norm
    and the host ms to a device sync."""
    step_fn = R.make_train_step(cfg, R.AdamWConfig(lr=TRAIN_LR), mesh, compress_grads=compress,
                                grad_shardings=p_shard)
    records = []
    for b in batches[start:]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step_fn(state, b)
        rec = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}
        torch.cuda.synchronize()
        rec["ms"] = (time.perf_counter() - t0) * 1e3
        records.append(rec)
    return state, records


def state_gb(R, state) -> float:
    return sum(t.numel() * t.element_size() for t in R.tree_leaves(state)) / 1e9


def mesh_worker(rank: int, world: int, init_method: str, outdir: str) -> None:
    """One rank of the sharded training path (a spawned process): join the
    group, zero its launch counts, run every check of phase 12 that runs
    on the ranks (rank 0 first trains mesh-free alone, the other waiting),
    read the counts, write this rank's numbers to ``outdir/rank<rank>.json``."""
    import types

    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.data import DataConfig, SyntheticStream
    from repro_torch.kernels import addpack_acc as A
    from repro_torch.kernels import flash_attention as F
    from repro_torch.kernels import int4_matmul as i4
    from repro_torch.kernels import packed_matmul as pm
    from repro_torch.launch.mesh import init_serving_world, make_local_mesh, make_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import build_state, param_placement, state_shardings
    from repro_torch.models import transformer as T
    from repro_torch.models.registry import get_config
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.runtime.pipeline import pipeline_forward, split_stages
    from repro_torch.tree import tree_leaves, tree_map

    backend = init_serving_world(rank, world, init_method, "cuda", timeout_s=MESH_TIMEOUT_S)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    K = types.SimpleNamespace(
        int4_matmul=i4.int4_matmul, packed_matmul=pm.packed_matmul,
        packed_matmul_prepacked=pm.packed_matmul_prepacked, flash_attention=F.flash_attention,
        WRAPPERS={"int4_matmul": i4.int4_matmul, "packed_matmul": pm.packed_matmul,
                  "packed_matmul_prepacked": pm.packed_matmul_prepacked,
                  "addpack_accumulate": A.addpack_accumulate,
                  "flash_attention": F.flash_attention})
    R = types.SimpleNamespace(make_train_step=make_train_step, AdamWConfig=AdamWConfig,
                              tree_leaves=tree_leaves)
    zero_counts(K)
    out: dict = {"rank": rank, "backend": backend, "device": str(torch.cuda.current_device())}
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=MESH_LAYERS)
    data = SyntheticStream(DataConfig(cfg.vocab_size, TRAIN_SEQ + 1, TRAIN_BATCH, seed=0))
    batches = [{k: torch.from_numpy(v).cuda() for k, v in data.batch_at(i).items()}
               for i in range(MESH_STEPS + 1)]

    def fresh_peak():
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    # mesh-free, rank 0 alone on the card; its state is then saved
    # mesh-free and kept in host memory (the mesh's peaks are its own)
    free = None
    ckdir = os.path.join(outdir, "ckpt")
    if rank == 0:
        fresh_peak()
        free = build_state(cfg, seed=0, device="cuda")
        free, records = mesh_steps(torch, R, cfg, free, batches[:MESH_STEPS])
        out["free"] = {"records": records, "state_gb": state_gb(R, free),
                       "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        t0 = time.perf_counter()
        Checkpointer(ckdir, keep=1).save(MESH_STEPS, free, extra={"train_step": MESH_STEPS})
        out["save_s"] = time.perf_counter() - t0
        free = tree_map(lambda t: t.detach().cpu(), free)
    dist.barrier()

    # mesh (2, 1): FSDP over "data"; then (1, 2) with compress_grads
    runs = {}
    for name, (data_ax, model_ax), n, compress in (("data2", (world, 1), MESH_STEPS, False),
                                                  ("model2", (1, world), 1, True)):
        mesh = make_local_mesh(data=data_ax, model=model_ax)
        p_shard = param_placement(cfg, mesh)
        fresh_peak()
        state = build_state(cfg, seed=0, device="cuda", compress_grads=compress,
                            shardings=p_shard)
        gb = state_gb(R, state)
        state, records = mesh_steps(torch, R, cfg, state, batches[:n], mesh, p_shard,
                                    compress)
        runs[name] = {"mesh": mesh.shape, "records": records, "state_gb": gb,
                      "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        del state
    out["runs"] = runs

    # re-sharded restore: rank 0's mesh-free state after MESH_STEPS, saved
    # mesh-free, restored onto (2, 1); the shards gathered equal it bit for
    # bit; one more step from the restored shards against one mesh-free step
    mesh = make_local_mesh(data=world, model=1)
    p_shard = param_placement(cfg, mesh)
    fresh_peak()
    t0 = time.perf_counter()
    like = build_state(cfg, seed=1, device="cuda", shardings=p_shard)
    restored, extra = Checkpointer(ckdir).restore(MESH_STEPS, like,
                                                  shardings=state_shardings(p_shard))
    del like
    out["restore_s"] = time.perf_counter() - t0
    whole = tree_map(lambda t, sh: t if sh is None else sh.gather(t), restored,
                     state_shardings(p_shard))
    if rank == 0:
        out["restore_bit_equal"] = all(torch.equal(a.cpu(), b) for a, b in
                                       zip(tree_leaves(whole), tree_leaves(free)))
    del whole
    restored, rec = mesh_steps(torch, R, cfg, restored, batches, mesh, p_shard,
                               start=MESH_STEPS)
    out["restore_step"] = rec[0]
    out["restore_extra"] = extra
    del restored
    if rank == 0:
        free = tree_map(lambda t: t.cuda(), free)
        free, rec = mesh_steps(torch, R, cfg, free, batches, start=MESH_STEPS)
        out["free_step4"] = rec[0]
    del free
    fresh_peak()

    # the pipeline: 2 stages over "pod", against rank 0's sequential forward
    mesh3 = make_mesh((world, 1, 1), ("pod", "data", "model"))
    out["pipeline"] = {}
    gen = torch.Generator().manual_seed(3)
    for name, pcfg, seq in (("qwen1.5-110b smoke f32",
                             dataclasses.replace(get_config("qwen1.5-110b", smoke=True),
                                                 dtype="float32"), 16),
                            (f"{TRAIN_ARCH} full width f32",
                             dataclasses.replace(cfg, dtype="float32"), TRAIN_SEQ)):
        params = T.init_params(pcfg, seed=0, dtype=torch.float32, device="cuda")
        toks = torch.randint(0, pcfg.vocab_size, (PIPE_MICRO, PIPE_MB, seq),
                             generator=gen).cuda()
        with torch.no_grad():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = pipeline_forward(split_stages(params, world), pcfg, toks, mesh3)
            torch.cuda.synchronize()
            row = {"ms": (time.perf_counter() - t0) * 1e3}
            if rank == 0:
                want = torch.stack([T.forward(params, pcfg, t)[0] for t in toks])
                row["max_abs_diff"] = float((got - want).abs().max())
                row["finite"] = bool(torch.isfinite(got).all())
        out["pipeline"][name] = row
        del params, got
        fresh_peak()

    # the smoke config in f32: one sharded step on the card against the
    # CPU's mesh-free step, on parameters made on the CPU
    smoke = dataclasses.replace(get_config("qwen1.5-110b", smoke=True), dtype="float32")
    cpu_state = build_state(smoke, seed=0, device="cpu")
    b = SyntheticStream(DataConfig(smoke.vocab_size, 33, 8, seed=1)).batch_at(0)
    p_shard = param_placement(smoke, mesh)
    state = {"params": tree_map(lambda t, sh: sh.place(t.cuda()), cpu_state["params"],
                                p_shard)}
    state["opt"] = adamw_init(state["params"])
    _, rec = mesh_steps(torch, R, smoke, state,
                        [{k: torch.from_numpy(v).cuda() for k, v in b.items()}], mesh, p_shard)
    out["smoke_card"] = rec[0]
    if rank == 0:
        step = make_train_step(smoke, AdamWConfig(lr=TRAIN_LR))
        _, m = step(cpu_state, {k: torch.from_numpy(v) for k, v in b.items()})
        out["smoke_cpu"] = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}
    out["launches"] = kernel_counts(K)
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def mesh_path(torch, card: str) -> dict:
    """The sharded training path (module docstring): ``MESH_RANKS`` spawned
    ranks, then the train CLI under ``torch.distributed.run``."""
    import shutil
    import socket

    from repro_torch.launch import mesh as tp_mesh

    world = MESH_RANKS
    backend = tp_mesh.choose_backend(world, "cuda")
    log(f"mesh path: {world} ranks, backend {backend} on {torch.cuda.device_count()} "
        f"card(s) (rule: {tp_mesh.BACKEND_RULE})")
    outdir = ROOT / "build" / "mesh_path"
    shutil.rmtree(outdir, ignore_errors=True)
    outdir.mkdir(parents=True)

    def free_port() -> int:
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            return sock.getsockname()[1]

    t0 = time.perf_counter()
    run_ranks(torch, mesh_worker, world,
              (world, f"tcp://localhost:{free_port()}", str(outdir)), MESH_DEADLINE_S)
    ranks = [json.loads((outdir / f"rank{r}.json").read_text()) for r in range(world)]
    shutil.rmtree(outdir / "ckpt", ignore_errors=True)
    r0 = ranks[0]
    out = {"card": card, "arch": TRAIN_ARCH, "layers": MESH_LAYERS, "ranks": world,
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "backend": r0["backend"],
           "rule": tp_mesh.BACKEND_RULE, "free": r0["free"],
           "runs": {k: {**v, "state_gb_per_rank": [r["runs"][k]["state_gb"] for r in ranks],
                        "peak_gb_per_rank": [r["runs"][k]["peak_gb"] for r in ranks]}
                    for k, v in r0["runs"].items()},
           "launches": {k: sum(r["launches"][k] for r in ranks) for k in r0["launches"]}}
    free_loss = r0["free"]["records"][0]["loss"]
    for name, run in out["runs"].items():
        recs = [rec for r in ranks for rec in r["runs"][name]["records"]]
        if not all(math.isfinite(x["loss"]) and math.isfinite(x["grad_norm"]) for x in recs):
            raise RuntimeError(f"mesh {name}: a loss or grad norm is not finite: {recs}")
        rel = abs(run["records"][0]["loss"] - free_loss) / abs(free_loss)
        run["first_loss_rel"] = rel
        ms = sorted(x["ms"] for x in run["records"][1:]) or [run["records"][0]["ms"]]
        run["step_ms_median"] = ms[len(ms) // 2]
        log(f"mesh {name} {run['mesh']} on {card}: {len(run['records'])} step(s), loss "
            f"{run['records'][0]['loss']:.4f} -> {run['records'][-1]['loss']:.4f} (mesh-free "
            f"first {free_loss:.4f}, rel {rel:.2e}), median {run['step_ms_median']:.1f} "
            f"ms/step, state GB per rank {[round(g, 2) for g in run['state_gb_per_rank']]} "
            f"(mesh-free {r0['free']['state_gb']:.2f}), peak GB per rank "
            f"{[round(g, 2) for g in run['peak_gb_per_rank']]} (mesh-free "
            f"{r0['free']['peak_gb']:.2f})")
        if not rel <= 1e-2:
            raise RuntimeError(f"mesh {name}: the first loss is {rel:.2e} from the mesh-free "
                               "one, past rtol 1e-2")
    fms = sorted(x["ms"] for x in r0["free"]["records"][1:])
    out["free"]["step_ms_median"] = fms[len(fms) // 2]
    log(f"mesh-free on {card}: median {out['free']['step_ms_median']:.1f} ms/step")

    # the restore
    step_rel = abs(r0["restore_step"]["loss"] - r0["free_step4"]["loss"]) / \
        abs(r0["free_step4"]["loss"])
    out["restore"] = {"bit_equal": r0["restore_bit_equal"], "save_s": r0["save_s"],
                      "restore_s": [r["restore_s"] for r in ranks],
                      "step": r0["restore_step"], "free_step": r0["free_step4"],
                      "step_loss_rel": step_rel}
    log(f"mesh restore: saved mesh-free ({r0['save_s']:.1f} s), restored onto (2, 1) "
        f"({max(out['restore']['restore_s']):.1f} s), shards "
        f"{'bit-equal' if r0['restore_bit_equal'] else 'NOT equal'} to the saved state; "
        f"the next step's loss {r0['restore_step']['loss']:.4f} vs mesh-free "
        f"{r0['free_step4']['loss']:.4f} (rel {step_rel:.2e})")
    if not r0["restore_bit_equal"] or r0["restore_extra"] != {"train_step": MESH_STEPS}:
        raise RuntimeError("mesh restore: the restored shards differ from the saved state")
    if not step_rel <= 1e-2:
        raise RuntimeError(f"mesh restore: the next step's loss is {step_rel:.2e} from the "
                           "mesh-free one, past rtol 1e-2")

    # the pipeline
    out["pipeline"] = {}
    for name, row in r0["pipeline"].items():
        out["pipeline"][name] = {**row, "ms_per_rank": [r["pipeline"][name]["ms"]
                                                        for r in ranks]}
        log(f"mesh pipeline {name} on {card}: 2 stages, {PIPE_MICRO} microbatches of "
            f"{PIPE_MB}, max abs diff to the sequential forward {row['max_abs_diff']:.3g}, "
            f"{row['ms']:.1f} ms")
        limit = 0.0 if "smoke" in name else 2e-3
        if not (row["finite"] and row["max_abs_diff"] <= limit):
            raise RuntimeError(f"mesh pipeline {name}: max abs diff {row['max_abs_diff']} "
                               f"past {limit}")

    # the smoke config: the card's sharded step against the CPU's
    card_s, cpu_s = r0["smoke_card"], r0["smoke_cpu"]
    loss_rel = abs(card_s["loss"] - cpu_s["loss"]) / abs(cpu_s["loss"])
    gnorm_rel = abs(card_s["grad_norm"] - cpu_s["grad_norm"]) / cpu_s["grad_norm"]
    out["smoke_card_vs_cpu"] = {"card": card_s, "cpu": cpu_s, "loss_rel": loss_rel,
                                "gnorm_rel": gnorm_rel}
    log(f"mesh smoke (qwen1.5-110b, f32, (2, 1)) card vs CPU mesh-free: loss "
        f"{card_s['loss']:.7f} vs {cpu_s['loss']:.7f} (rel {loss_rel:.2e}), grad norm "
        f"{card_s['grad_norm']:.6f} vs {cpu_s['grad_norm']:.6f} (rel {gnorm_rel:.2e})")
    if not (loss_rel <= 1e-5 and gnorm_rel <= 1e-4):
        raise RuntimeError("mesh smoke: the card's sharded step disagrees with the CPU's "
                           "beyond rtol 1e-5 (loss) / 1e-4 (grad norm)")
    if any(out["launches"].values()):
        raise RuntimeError(f"the sharded training path launched a kernel: {out['launches']}")

    # the CLI: two ranks under torch.distributed.run, then a relaunch
    cli_dir = ROOT / "build" / "mesh_cli"
    shutil.rmtree(cli_dir, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cli = {}
    for steps in (3, 5):
        t1 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", str(world),
             "--master-addr", "localhost", "--master-port", str(free_port()),
             "-m", "repro_torch.launch.train", *CLI_MESH, "--steps", str(steps),
             "--ckpt-dir", str(cli_dir)],
            capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
        lines = proc.stdout.splitlines()
        cli[str(steps)] = {"s": time.perf_counter() - t1, "lines": lines}
        for line in lines:
            log(f"mesh cli on {card}: {line}")
        if proc.returncode != 0 or not lines or lines[-1] != "[train] done":
            raise RuntimeError(f"mesh CLI --steps {steps} failed ({proc.returncode}): "
                               f"{proc.stderr[-2000:]}")
        logged = [float(line.split("loss=")[1].split()[0]) for line in lines
                  if line.startswith("[train] step=")]
        if len(logged) != (3 if steps == 3 else 2) or not all(map(math.isfinite, logged)):
            raise RuntimeError(f"mesh CLI --steps {steps}: losses logged {logged}")
        if not lines[0].startswith(f"[train] mesh {{'data': {world}, 'model': 1}}"):
            raise RuntimeError(f"mesh CLI --steps {steps}: no mesh line: {lines[:1]}")
    if "[train] resumed from step 3" not in cli["5"]["lines"]:
        raise RuntimeError("the mesh CLI's relaunch did not resume from step 3")
    shutil.rmtree(cli_dir, ignore_errors=True)
    out["cli"] = cli
    out["seconds"] = time.perf_counter() - t0
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


# ---- phase 13: the examples, the dry run, and the dry run against the card ----

# the port's four examples, each a subprocess on the card (train_lm at 20
# steps), run side by side; each prints its kernel launches (every
# subprocess starts with its counts at 0)
EXAMPLE_RUNS = (("torch_quickstart.py", ()), ("torch_serve_lm.py", ()),
                ("torch_snn_addpack.py", ()), ("torch_train_lm.py", ("--steps", "20")))
EXAMPLE_TIMEOUT_S = 300
# serve_lm's packed runs and the wrapper each must launch
EXAMPLE_NEED = {"int4_packed": "int4_matmul", "dsp_packed": "packed_matmul",
                "dsp_tuned": "packed_matmul_prepacked"}
# the dry run's --packed-tp 8 figures of EXPERIMENTS.md §Dry-run: GiB of
# packed words a shard, GiB of replicated scales, MB a decode row
PACKED_TP8 = {"qwen1.5-110b": ("25.60", "0.038", "40.10"),
              "dbrx-132b": ("30.50", "0.068", "78.91"),
              "jamba-v0.1-52b": ("11.94", "0.037", "38.76")}
DRY_CELLS = (("qwen1.5-110b", "train_4k"), ("qwen1.5-110b", "decode_32k"))
# the cell the card holds: phase 12's h2o-danube-3-4b at full width, 2
# layers (depth_groups), mesh-free, one train step at 8 x 512
DRY_CARD_GROUPS = 2


def run_examples(torch, card: str) -> dict:
    """The four examples as subprocesses on the card; each must exit 0 and
    print its headline, quickstart's packed matmul equal the exact product
    through ``packed_matmul``, serve_lm's six runs each packed mode through
    its kernel, train_lm's loss fall over its 20 steps."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen([sys.executable, str(ROOT / "examples" / name), *args],
                                    cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)
             for name, args in EXAMPLE_RUNS}
    outs, seconds = {}, {}
    try:
        for name, proc in procs.items():
            out, err = proc.communicate(timeout=EXAMPLE_TIMEOUT_S)
            seconds[name] = time.perf_counter() - t0
            if proc.returncode != 0:
                raise RuntimeError(f"{name} exited {proc.returncode}: {err[-3000:]}")
            outs[name] = out.splitlines()
            for line in outs[name]:
                log(f"  {name}: {line}")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    launches: dict[str, int] = {}

    def add(counts: dict) -> None:
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    quick = outs["torch_quickstart.py"]
    if "   packed matmul == exact int matmul: True" not in quick:
        raise RuntimeError("quickstart: the packed matmul differs from the exact product")
    counts = json.loads(next(ln for ln in quick if ln.startswith("   kernel launches:"))
                        .split(":", 1)[1].split(" (")[0])
    if sum(counts.values()) < 1:
        raise RuntimeError(f"quickstart launched no packed_matmul kernel: {counts}")
    add(counts)
    serve = outs["torch_serve_lm.py"]
    heads = [ln for ln in serve if ln.startswith("[serve_lm] quant=")]
    if len(heads) != 6:
        raise RuntimeError(f"serve_lm printed {len(heads)} of its 6 runs")
    by_mode = {}
    for ln in serve:
        m = re.fullmatch(r"\[serve_lm\]\s+launches (\S+) (\{.*\})", ln)
        if m:
            by_mode[m[1]] = json.loads(m[2])
            add(by_mode[m[1]])
    for mode, wrapper in EXAMPLE_NEED.items():
        n = sum(v for k, v in by_mode.get(mode, {}).items() if k.startswith(wrapper)
                and (wrapper != "packed_matmul" or "prepacked" not in k))
        if n < 1:
            raise RuntimeError(f"serve_lm {mode} launched no {wrapper} kernel: {by_mode}")
    snn = outs["torch_snn_addpack.py"]
    if not any(ln.startswith("[snn] exact with 2 guard bits") for ln in snn):
        raise RuntimeError("snn_addpack: no exact packed accumulation")
    train = outs["torch_train_lm.py"]
    losses = [float(ln.split("loss=")[1].split()[0]) for ln in train if "loss=" in ln]
    if not (losses and all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]):
        raise RuntimeError(f"train_lm's loss did not fall: {losses}")
    return {"seconds": seconds, "launches": launches, "serve_launches": by_mode,
            "serve_lines": serve, "train_losses": losses, "headlines": {
                "torch_quickstart.py": quick[-3:], "torch_serve_lm.py": heads,
                "torch_snn_addpack.py": snn[-3:], "torch_train_lm.py": train[-1:]}}


def serve_lm_against_plain(torch, ref, lines: list[str]) -> dict:
    """Each packed run of serve_lm served again in this process through the
    kernels' plain versions (``run(..., use_kernel=False)``; ``dsp_tuned`` on
    the plans the subprocess printed): the greedy tokens must equal the
    kernels' the subprocess printed, and the plain runs launch no kernel."""
    import contextlib
    import importlib.util
    import io

    spec = importlib.util.spec_from_file_location("torch_serve_lm",
                                                  ROOT / "examples" / "torch_serve_lm.py")
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    printed = {}
    for ln in lines:
        m = re.fullmatch(r"\[serve_lm\]\s+(tokens (\S+) greedy|plans (\S+)) (.*)", ln)
        if m:
            printed[(m[1].split()[0], m[2] or m[3])] = json.loads(m[4])
    t0 = time.perf_counter()
    out = {}
    for mode in EXAMPLE_NEED:
        table = None
        if mode == "dsp_tuned":
            table = {p: ref.spec_from_name(n) for p, n in printed[("plans", mode)].items()}
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            plain = ex.run(mode, None, "cuda", use_kernel=False, plan_table=table)
        launched = {k: n for f in ex.WRAPPERS for k, n in f.variant_launches.items() if n}
        if plain != printed[("tokens", mode)]:
            raise RuntimeError(f"serve_lm {mode}: the kernels' tokens "
                               f"{printed[('tokens', mode)]} != the plain versions' {plain}")
        if launched:
            raise RuntimeError(f"serve_lm {mode}: the plain run launched {launched}")
        out[mode] = sum(len(t) for t in plain)
    log(f"serve_lm against the plain versions: greedy tokens identical in "
        f"{', '.join(f'{m} ({n} tokens)' for m, n in out.items())}, "
        f"{time.perf_counter() - t0:.1f} s")
    return out


def dryrun_full_width(D) -> dict:
    """The dry run's CLI in this process at full width: ``--packed-tp 8``
    against EXPERIMENTS.md's figures, then each of ``DRY_CELLS`` on
    pod16x16, which must be ok; the records are printed."""
    import contextlib
    import io

    out_dir = ROOT / "build" / "dryrun"
    shutil.rmtree(out_dir, ignore_errors=True)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code = D.main(["--packed-tp", "8", "--out", str(out_dir)])
    lines = buf.getvalue().splitlines()
    for line in lines:
        log(f"  {line}")
    if code != 0:
        raise RuntimeError(f"dryrun --packed-tp 8 exited {code}")
    for arch, (words, scales, net) in PACKED_TP8.items():
        want = (f"[dryrun] {arch} packed tp=8: {words} GiB packed words/shard + {scales} GiB "
                f"replicated scales, {net} MB interconnect per decode row")
        if want not in lines:
            raise RuntimeError(f"dryrun --packed-tp 8: no line {want!r}")
    records = {}
    for arch, shape in DRY_CELLS:
        t0 = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            code = D.main(["--arch", arch, "--shape", shape, "--out", str(out_dir)])
        print(buf.getvalue(), end="", flush=True)
        rec = json.loads((out_dir / f"{arch}__{shape}__pod16x16.json").read_text())
        if code != 0 or not rec["ok"]:
            raise RuntimeError(f"dryrun {arch} {shape}: {rec.get('error')}")
        records[f"{arch} {shape}"] = dict(rec, seconds=time.perf_counter() - t0)
    return records


def dryrun_against_card(torch, D, PS, R, card: str) -> dict:
    """One cell the card holds, built by ``lower_cell(depth_groups=...)``:
    its argument bytes must equal the real state's and batch's on the card,
    its FLOPs ``FlopCounterMode``'s count of the real step; its predicted
    peak (arguments plus temp) is printed beside ``max_memory_allocated``."""
    from torch.utils.flop_counter import FlopCounterMode

    shape = PS.ShapeSpec(f"train_{TRAIN_SEQ}", TRAIN_SEQ, TRAIN_BATCH, "train")
    t0 = time.perf_counter()
    lowered, cfg, _ = D.lower_cell(TRAIN_ARCH, "train_4k", False, depth_groups=DRY_CARD_GROUPS,
                                   shape=shape, mesh=None)
    dry = D.measure(lowered, None)
    dry_s = time.perf_counter() - t0
    del lowered
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    params = R.T.init_params(cfg, seed=0, dtype=torch.float32, device="cuda")
    state = {"params": params, "opt": R.adamw_init(params)}
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = {k: torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ), generator=gen,
                              device="cuda", dtype=torch.int32) for k in ("tokens", "labels")}
    held = sum(t.numel() * t.element_size()
               for t in R.tree_leaves(state) + list(batch.values()))
    step = R.make_train_step(cfg, R.AdamWConfig())
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with FlopCounterMode(display=False) as fc:
        _, metrics = step(state, batch)
        loss = float(metrics["loss"])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    flops = int(fc.get_total_flops())
    mem = dry["memory"]
    predicted = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    out = {"arch": TRAIN_ARCH, "layers": cfg.n_layers, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
           "dry_argument_bytes": mem["argument_size_in_bytes"], "card_argument_bytes": held,
           "card_allocated_before_step": base, "dry_flops": dry["flops"], "card_flops": flops,
           "dry_temp_bytes": mem["temp_size_in_bytes"], "dry_peak_bytes": predicted,
           "card_peak_bytes": peak, "peak_ratio": predicted / peak, "loss": loss,
           "dry_s": dry_s, "card": card}
    log(f"dry run against the card: {TRAIN_ARCH} {cfg.n_layers} layers {TRAIN_BATCH} x "
        f"{TRAIN_SEQ}: argument bytes {mem['argument_size_in_bytes']} dry, {held} card; "
        f"flops {dry['flops']} dry, {flops} card; peak {predicted / 1e9:.3f} GB dry "
        f"(arguments + temp) against max_memory_allocated {peak / 1e9:.3f} GB "
        f"(ratio {predicted / peak:.3f}); dry run {dry_s:.1f} s; {card}")
    if mem["argument_size_in_bytes"] != held:
        raise RuntimeError(f"dry-run argument bytes {mem['argument_size_in_bytes']} != the "
                           f"card's state and batch {held}")
    if dry["flops"] != flops:
        raise RuntimeError(f"dry-run flops {dry['flops']} != FlopCounterMode on the card {flops}")
    if not math.isfinite(loss):
        raise RuntimeError(f"the card's step gave loss {loss}")
    del state, params, batch, step
    gc.collect()
    torch.cuda.empty_cache()
    return out


def examples_and_dryrun(torch, card: str) -> dict:
    """Phase 13: (a) the examples on the card, (b) the dry run at full
    width, (c) the dry run against the card."""
    from repro_torch.kernels import ref
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import shapes as PS
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer as T
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.tree import tree_leaves

    R = types.SimpleNamespace(T=T, adamw_init=adamw_init, make_train_step=make_train_step,
                              AdamWConfig=AdamWConfig, tree_leaves=tree_leaves)
    t0 = time.perf_counter()
    out = {"examples": run_examples(torch, card)}
    log(f"examples: {time.perf_counter() - t0:.1f} s, launches {out['examples']['launches']}")
    out["serve_lm_plain"] = serve_lm_against_plain(torch, ref, out["examples"]["serve_lines"])
    t1 = time.perf_counter()
    out["dryrun"] = dryrun_full_width(D)
    log(f"dry run at full width: {time.perf_counter() - t1:.1f} s")
    out["dryrun_card"] = dryrun_against_card(torch, D, PS, R, card)
    out["seconds"] = time.perf_counter() - t0
    return out


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
    from repro_torch.launch import serve
    from repro_torch.models.registry import get_config
    from repro_torch.serving import (
        ContinuousEngine,
        Engine,
        GovernorConfig,
        ReplicaFront,
        ServeConfig,
    )
    from repro_torch.serving.governor import TIER_SEARCHES
    from repro_torch.tuning import DEFAULT_WIDTH_CANDIDATES, PROBES, autotune, tuner
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.core.packed_linear import LinearSpec
    from repro_torch.data import DataConfig, SyntheticStream
    from repro_torch.launch.steps import loss_and_grads, make_train_step
    from repro_torch.launch.train import build_state
    from repro_torch.optim import AdamWConfig, cosine_with_warmup
    from repro_torch.tree import tree_map

    P = types.SimpleNamespace(dataclasses=dataclasses, ref=ref, T=T, Engine=Engine,
                              ContinuousEngine=ContinuousEngine, ReplicaFront=ReplicaFront,
                              GovernorConfig=GovernorConfig, TIER_SEARCHES=TIER_SEARCHES,
                              serve=serve, ServeConfig=ServeConfig, get_config=get_config,
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
    check_geometries(torch, K, ref, checks, EXAMPLE_SHAPES, EXAMPLE_ROWS, "serve_lm", 4)
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

    # the continuous, governor, replica and CLI paths, each with its counts
    # zeroed just before it and read just after
    paths = {"continuous": lambda: serve_continuous(torch, K, P, card, serving_out),
             "governor": lambda: serve_governor(torch, K, P, card),
             "replicas": lambda: serve_replicas(torch, K, P, card),
             "cli": lambda: serve_cli(torch, P, card)}
    path_out, path_launches, path_s = {}, {}, {}
    for name, run in paths.items():
        zero_counts(K)
        t0 = time.perf_counter()
        path_out[name] = run()
        path_launches[name] = kernel_counts(K)
        path_s[name] = time.perf_counter() - t0
        log(f"{name} path: {path_s[name]:.1f} s, launches {path_launches[name]}")
    for kernel, mode in need.items():
        if mode in CONT_MODES and path_out["continuous"][mode]["launches"][kernel] < 1:
            raise RuntimeError(f"{kernel} never launched on the continuous path ({mode})")
    for name, kernels in (("governor", MODE_KERNELS["dsp_tuned"]),
                          ("replicas", MODE_KERNELS["int4_packed"])):
        for kernel in kernels:
            if path_launches[name][kernel] < 1:
                raise RuntimeError(f"{kernel} never launched on the {name} path")
    gc.collect()
    torch.cuda.empty_cache()

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
            if mode in ("int4_packed", "dsp_tuned"):
                agree[f"{arch} {mode} continuous"] = agreement_continuous(
                    torch, P, smoke, sparams, mode, table, **served)
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

    # phase 10: training on the card, the launch counts zeroed just before
    # and read just after (the training path reaches none of the kernels)
    R = types.SimpleNamespace(
        AdamWConfig=AdamWConfig, Checkpointer=Checkpointer, DataConfig=DataConfig,
        LinearSpec=LinearSpec, SyntheticStream=SyntheticStream, build_state=build_state,
        cosine_with_warmup=cosine_with_warmup, get_config=get_config,
        loss_and_grads=loss_and_grads, make_train_step=make_train_step, tree_map=tree_map)
    zero_counts(K)
    t0 = time.perf_counter()
    training = train_path(torch, R, card)
    training["launches"] = kernel_counts(K)
    training["seconds"] = time.perf_counter() - t0
    log(f"training: {training['seconds']:.1f} s, launches {training['launches']}")
    if any(training["launches"].values()):
        raise RuntimeError(f"the training path launched a kernel: {training['launches']}")
    gc.collect()
    torch.cuda.empty_cache()

    # phase 11: tensor-parallel serving, each rank's launch counts zeroed
    # just before its path and read just after (the path runs none of the
    # kernels: no kernel has a cross-rank reduction stage)
    tp = tp_path(torch, card)
    log(f"tp path: {tp['seconds']:.1f} s, launches {tp['launches']}")

    # phase 12: sharded training, each rank's launch counts zeroed just
    # before its path and read just after (the path runs none of the kernels)
    mesh_train = mesh_path(torch, card)
    log(f"mesh path: {mesh_train['seconds']:.1f} s, launches {mesh_train['launches']}")
    gc.collect()
    torch.cuda.empty_cache()

    # phase 13: the four examples on the card (each subprocess's launches,
    # from 0, read from its output), the dry run at full width, and the dry
    # run against the card
    phase13 = examples_and_dryrun(torch, card)
    ex_launches = phase13["examples"]["launches"]
    log(f"phase 13: {phase13['seconds']:.1f} s")

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
                         + sum(c[name] for c in fam_launches.values())
                         + sum(c[name] for c in path_launches.values())
                         + tp["launches"][name] + mesh_train["launches"][name]
                         + ex_launches.get(name, 0)),
            "launches_by_path": {"qwen1.5-110b": launches[name],
                                 "moonshot-v1-16b-a3b": moe_launches[name],
                                 **{a: c[name] for a, c in fam_launches.items()},
                                 **{a: c[name] for a, c in path_launches.items()},
                                 "tp": tp["launches"][name],
                                 "mesh_train": mesh_train["launches"][name],
                                 "examples": ex_launches.get(name, 0)},
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
            "families": fam_out, **path_out, "path_seconds": path_s,
            "agreement": agree,
            "paper": paper_rows, "snn": snn, "attention": attn, "plan_search": search,
            "attention_checks": attn_checks, "training": training, "tp": tp, "mesh_train": mesh_train,
            "phase13": phase13,
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
