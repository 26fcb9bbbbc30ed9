"""Serving CLI: batched requests through the slot or the paged engine.

  python -m repro_torch.launch.serve --arch qwen1.5-110b --smoke \\
      --quant dsp_tuned --plan-bits 4,4 --error-budget 0.5 --fuse all
  python -m repro_torch.launch.serve --arch qwen1.5-110b --smoke \\
      --engine continuous --page-size 8 --n-pages 12 --quant int4_packed

``--arch`` takes every architecture of the registry (``list_archs()``):
the dense and moe families, xlstm-1.3b (ssm), jamba-v0.1-52b (hybrid),
whisper-large-v3 (its decoder; the engine passes no encoder output),
llava-next-mistral-7b (vlm, served on tokens) and h2o-danube-3-4b (a
sliding window, prefilled one token a chunk).  Runs on the card by default (``--device cuda``, the CUDA kernels);
``--device cpu`` serves the plain versions.  Under ``--quant dsp_tuned``
the tuner picks each layer's plan for ``--plan-bits`` within
``--error-budget`` (MAE per extraction); ``--autotune-plans`` ranks the
plans by timing the CUDA kernels' variants on the card (the plain version
on the CPU) and prints each plan's variant per phase.  ``--quant
dsp_mixed`` (or ``--plan-bits auto``) measures each layer's sensitivity
on ``--calib-tokens`` seeded calibration tokens and allocates per-layer
widths within ``--mixed-budget``, and prints the allocation's summary.
``--plan-db DIR`` keeps the tuned tables and mixed allocations in a plan
database, so that a restarted engine builds without searching.  ``--fuse mlp`` joins up|gate at engine build,
``--fuse all`` also q|k|v (quantized modes; each output column stays
bit-identical).  ``--engine continuous`` serves through the continuous
engine over a paged KV cache (``--page-size``, ``--n-pages``,
``--watermark-pages``) and prints the pool's state at exit;
``--deadline-ms`` sheds requests past it; ``--governor`` (dsp_tuned and
dsp_mixed) holds a narrow exact weight tier beside the primary plans and
swaps under load; ``--replicas N`` serves through N engines behind a
join-shortest-queue front and prints each request's replica.

``--tp N`` shards the packed weights over N ranks (``runtime.tp_packed``;
tokens equal ``--tp 1``'s).  Under ``torchrun --nproc-per-node N`` each
launched process serves as its rank; a plain ``python -m
repro_torch.launch.serve --tp N`` starts its N ranks itself.  The backend
follows ``launch.mesh.BACKEND_RULE`` (nccl with a card a rank; gloo when
the ranks share one card, or on the CPU), and tensor-parallel serving
runs the plain versions (no CUDA kernel has a cross-rank reduction).
Every rank serves the same requests; only rank 0 prints.  ``--tp N
--replicas R`` runs R engines, each tensor-parallel over the same N ranks.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import time

import numpy as np
import torch
import torch.distributed as dist

from ..models import transformer as T
from ..models.registry import get_config, list_archs
from ..serving import ContinuousEngine, Engine, ReplicaFront, SamplingParams, ServeConfig
from .mesh import BACKEND_RULE, init_serving_world


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--prefill-chunk", type=int, default=16)
    ap.add_argument("--engine", default="slot", choices=["slot", "continuous"],
                    help="'slot': fixed slots over dense per-slot cache windows; "
                         "'continuous': continuous batching over a paged KV cache")
    ap.add_argument("--page-size", type=int, default=16,
                    help="continuous: KV tokens per physical cache page")
    ap.add_argument("--n-pages", type=int, default=None,
                    help="continuous: the page pool's size (default: the slot "
                         "engine's windows' worth)")
    ap.add_argument("--watermark-pages", type=int, default=None,
                    help="continuous: free-page floor admission keeps "
                         "(default: one growth page a lane)")
    ap.add_argument("--stream", action="store_true",
                    help="print (rid, token) pairs as they are emitted")
    ap.add_argument("--quant", default="native",
                    choices=["native", "none", "int8", "int4_packed", "dsp_packed",
                             "dsp_tuned", "dsp_mixed"])
    ap.add_argument("--error-budget", type=float, default=0.5,
                    help="dsp_tuned: max MAE per extraction a plan may incur")

    def _plan_bits(arg: str) -> tuple[int, int] | str:
        if arg == "auto":
            return "auto"
        try:
            a_bits, w_bits = (int(b) for b in arg.split(","))
        except ValueError:
            raise argparse.ArgumentTypeError(
                f"--plan-bits wants two comma-separated ints 'A,W' "
                f"(e.g. 8,8) or 'auto', got {arg!r}"
            )
        return a_bits, w_bits

    ap.add_argument("--plan-bits", type=_plan_bits, default=(4, 4),
                    metavar="A,W|auto",
                    help="dsp_tuned: operand widths to plan for, e.g. 8,8 "
                         "(8-bit widths serve multi-DSP column-packed "
                         "plans); 'auto' allocates widths per layer by "
                         "measured sensitivity (= --quant dsp_mixed)")
    ap.add_argument("--mixed-budget", type=float, default=0.05,
                    help="dsp_mixed: model-level error budget (total added "
                         "logit-KL on the calibration forward) the greedy "
                         "per-layer width allocator may spend; 0 serves the "
                         "uniform widest-candidate plan")
    ap.add_argument("--calib-tokens", type=int, default=32,
                    help="dsp_mixed: calibration tokens per sequence for "
                         "the sensitivity pass (seeded from --seed)")
    ap.add_argument("--autotune-plans", action="store_true",
                    help="dsp_tuned: rank plans by timing the kernel "
                         "variants per layer shape and serving phase")
    ap.add_argument("--plan-db", default=None, metavar="DIR",
                    help="persisted plan database directory: engine build "
                         "consults it before the dsp_tuned/dsp_mixed plan "
                         "searches and stores a cold search back")
    ap.add_argument("--no-prepack", dest="prepack", action="store_false",
                    help="dsp_tuned: pack the weight words on every call")
    ap.add_argument("--fuse", dest="fuse_projections", default="none",
                    choices=["none", "mlp", "all"],
                    help="engine-build projection fusion for packed modes: "
                         "'mlp' fuses up|gate, 'all' also fuses q|k|v")
    ap.add_argument("--governor", action="store_true",
                    help="load-adaptive precision governor (dsp_tuned and "
                         "dsp_mixed): hold a narrow exact weight tier beside the "
                         "primary plans and swap to it when the queue backs up")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request wall-clock deadline from submission; "
                         "requests past it are shed (finish reason 'deadline')")
    ap.add_argument("--replicas", type=int, default=1,
                    help="engines behind a join-shortest-queue front")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel degree: shard the packed weights over "
                         "N ranks (tokens equal --tp 1's); under torchrun each "
                         "process is a rank, else the CLI starts the N ranks")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the CUDA kernels) or cpu (plain versions)")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    return ap


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, world: int, init_method: str, args) -> None:
    """One rank of a tensor-parallel launch: join the group, serve."""
    init_serving_world(rank, world, init_method, args.device)
    try:
        _serve(args, rank)
    finally:
        dist.destroy_process_group()


def main(argv: list[str] | None = None) -> None:
    args = _parser().parse_args(argv)
    if args.tp > 1 and not dist.is_initialized():
        if "WORLD_SIZE" in os.environ and "RANK" in os.environ:  # torchrun
            _rank_main(int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]),
                       "env://", args)
        else:
            # start the ranks: a rank that fails ends the launch with its error
            torch.multiprocessing.start_processes(
                _rank_main, args=(args.tp, f"tcp://localhost:{_free_port()}", args),
                nprocs=args.tp, start_method="spawn")
        return
    _serve(args, dist.get_rank() if dist.is_initialized() else 0)


def _serve(args, rank: int) -> None:
    """Build the engine (or front) and serve; only rank 0 prints."""
    def say(*a, **k) -> None:
        if rank == 0:
            print(*a, **k)

    def say_tp(engine) -> None:
        mesh = engine.mesh
        if mesh is None:
            return
        say(f"[serve] tp={mesh.n_shards}: backend {mesh.backend} (rule: "
            f"{BACKEND_RULE}), rank 0 on {mesh.device}; "
            f"use_kernel={engine.use_kernel} (tensor-parallel serving runs "
            "the plain versions)")

    cfg = get_config(args.arch, smoke=args.smoke)
    params = T.init_params(cfg, seed=0, device=args.device)
    serve_cfg = ServeConfig(
        n_slots=args.slots, max_len=args.max_len,
        prefill_chunk=args.prefill_chunk, quant_mode=args.quant,
        prepack=args.prepack, fuse_projections=args.fuse_projections,
        plan_bits="auto" if args.quant == "dsp_mixed" else args.plan_bits,
        error_budget=args.error_budget, mixed_budget=args.mixed_budget,
        calib_tokens=args.calib_tokens,
        autotune_plans=args.autotune_plans, plan_db=args.plan_db,
        temperature=args.temperature, top_k=args.top_k,
        top_p=args.top_p, seed=args.seed, device=args.device,
        page_size=args.page_size, n_pages=args.n_pages,
        watermark_pages=args.watermark_pages, governor=args.governor,
        deadline_ms=args.deadline_ms, tp=args.tp,
    )
    engine_cls = ContinuousEngine if args.engine == "continuous" else Engine
    rng = np.random.default_rng(0)
    prompts = [
        [int(t) for t in rng.integers(2, cfg.vocab_size, size=rng.integers(4, 10))]
        for _ in range(args.requests)
    ]
    if args.replicas > 1:
        if args.stream:
            raise SystemExit("--replicas does not support --stream "
                             "(per-replica token streams interleave)")
        front = ReplicaFront(cfg, params, serve_cfg, n_replicas=args.replicas,
                             engine_cls=engine_cls)
        say_tp(front.replicas[0])
        t0 = time.time()
        outputs = front.generate(prompts, max_new=args.max_new)
        dt = time.time() - t0
        for grid, toks in sorted(outputs.items()):
            say(f"[serve] request {grid} (replica {front.replica_of(grid)}): "
                f"{len(toks)} tokens -> {toks[:8]}...")
        stats = front.stats()
        say(f"[serve] {sum(len(v) for v in outputs.values())} tokens in {dt:.2f}s "
            f"across {stats['n_replicas']} replicas (tp={args.tp}, engine={args.engine}, "
            f"quant={serve_cfg.quant_mode}, finished {stats['finished']})")
        return
    engine = engine_cls(cfg, params, serve_cfg)
    say_tp(engine)
    if engine.mixed_allocation is not None:
        alloc = engine.mixed_allocation
        say(f"[serve] mixed-precision allocation (budget {alloc.budget:.4g}, "
            f"predicted error {alloc.predicted_error:.4g}, cost "
            f"{alloc.cost_vs_uniform_base:.2f}x uniform "
            f"a{alloc.base_bits[0]}w{alloc.base_bits[1]}): "
            + json.dumps(alloc.summary(), sort_keys=True))
    elif engine.plan_table:
        plans = {r.name for r in engine.plan_table.values()}
        say(f"[serve] tuned packing plans (budget {args.error_budget}): "
            + ", ".join(sorted(plans)))
        if args.autotune_plans:
            per_phase = {
                f"{r.name}: prefill {r.block} / decode {r.decode_block}"
                for r in engine.plan_table.values()
            }
            say("[serve] per-phase tuned kernel variants: "
                + "; ".join(sorted(per_phase)))
    if engine.tiers is not None:
        say("[serve] governor tiers: " + "; ".join(
            f"{i}:{t.name} (certified MAE <= {t.max_certified_mae:g})"
            for i, t in enumerate(engine.tiers)))
    sampling = SamplingParams(args.temperature, args.top_k, args.top_p)
    t0 = time.time()
    if args.stream:
        rids = [engine.submit(p, max_new=args.max_new, sampling=sampling,
                              admit=False) for p in prompts]
        while engine.active.any() or engine.scheduler.n_queued:
            engine.step()
            for rid, tok in engine.drain_stream():
                say(f"[stream] rid {rid} -> {tok}")
        outputs = {r: list(engine.scheduler.requests[r].tokens) for r in rids}
    else:
        outputs = engine.generate(prompts, max_new=args.max_new,
                                  sampling=sampling)
    dt = time.time() - t0
    total_tokens = sum(len(v) for v in outputs.values())
    for rid, toks in sorted(outputs.items()):
        reason = engine.scheduler.requests[rid].finish_reason
        say(f"[serve] request {rid}: {len(toks)} tokens ({reason}) "
            f"-> {toks[:8]}...")
    stats = engine.stats()
    say(f"[serve] {total_tokens} tokens in {dt:.2f}s "
        f"(engine={args.engine}, device={engine.device}, tp={args.tp}, "
        f"quant={serve_cfg.quant_mode}, use_kernel={engine.use_kernel}, "
        f"prefill {stats['prefill_tok_s']:.1f} tok/s, "
        f"decode {stats['decode_tok_s']:.1f} tok/s, "
        f"ttft p50 {stats['p50_ttft_s'] * 1e3:.0f}ms / "
        f"p99 {stats['p99_ttft_s'] * 1e3:.0f}ms)")
    if args.engine == "continuous":
        say(f"[serve] pages: {stats['n_pages'] - stats['free_pages']}"
            f"/{stats['n_pages']} in use at exit (page_size {stats['page_size']}, "
            f"watermark {stats['watermark_pages']}, peak "
            f"{stats['peak_pages_in_use']}, preempted {stats['preempted']}, "
            f"copy-on-write copies {stats['cow_copies']})")
    if args.deadline_ms is not None:
        say(f"[serve] shed {stats['shed']} of "
            f"{stats['finished'] + stats['cancelled']} requests at the "
            f"{args.deadline_ms:.0f}ms deadline")
    if "plan_db" in stats:
        db = stats["plan_db"]
        warm = "warm" if db["hits"] else "cold"
        say(f"[serve] plan db {db['directory']}: {warm} build "
            f"({db['hits']} hit / {db['misses']} miss / "
            f"{db['stale']} stale, key {db['key'][:12]})")
    if "governor" in stats:
        g = stats["governor"]
        say(f"[serve] governor: tier {g['tier']} ({g['tier_name']}) "
            f"after {g['swaps']} swaps over {g['observations']} steps")


if __name__ == "__main__":
    main()
