"""Serving CLI: batched requests through the fixed-slot engine.

  python -m repro_torch.launch.serve --arch qwen1.5-110b --smoke \\
      --quant dsp_tuned --plan-bits 4,4 --error-budget 0.5 --fuse all

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
bit-identical).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from ..models import transformer as T
from ..models.registry import get_config, list_archs
from ..serving import Engine, SamplingParams, ServeConfig


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--prefill-chunk", type=int, default=16)
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
    ap.add_argument("--device", default="cuda",
                    help="cuda (the CUDA kernels) or cpu (plain versions)")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

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
    )
    engine = Engine(cfg, params, serve_cfg)
    if engine.mixed_allocation is not None:
        alloc = engine.mixed_allocation
        print(f"[serve] mixed-precision allocation (budget {alloc.budget:.4g}, "
              f"predicted error {alloc.predicted_error:.4g}, cost "
              f"{alloc.cost_vs_uniform_base:.2f}x uniform "
              f"a{alloc.base_bits[0]}w{alloc.base_bits[1]}): "
              + json.dumps(alloc.summary(), sort_keys=True))
    elif engine.plan_table:
        plans = {r.name for r in engine.plan_table.values()}
        print(f"[serve] tuned packing plans (budget {args.error_budget}): "
              + ", ".join(sorted(plans)))
        if args.autotune_plans:
            per_phase = {
                f"{r.name}: prefill {r.block} / decode {r.decode_block}"
                for r in engine.plan_table.values()
            }
            print("[serve] per-phase tuned kernel variants: "
                  + "; ".join(sorted(per_phase)))
    sampling = SamplingParams(args.temperature, args.top_k, args.top_p)
    rng = np.random.default_rng(0)
    prompts = [
        [int(t) for t in rng.integers(2, cfg.vocab_size, size=rng.integers(4, 10))]
        for _ in range(args.requests)
    ]
    t0 = time.time()
    if args.stream:
        rids = [engine.submit(p, max_new=args.max_new, sampling=sampling,
                              admit=False) for p in prompts]
        while engine.active.any() or engine.scheduler.n_queued:
            engine.step()
            for rid, tok in engine.drain_stream():
                print(f"[stream] rid {rid} -> {tok}")
        outputs = {r: list(engine.scheduler.requests[r].tokens) for r in rids}
    else:
        outputs = engine.generate(prompts, max_new=args.max_new,
                                  sampling=sampling)
    dt = time.time() - t0
    total_tokens = sum(len(v) for v in outputs.values())
    for rid, toks in sorted(outputs.items()):
        reason = engine.scheduler.requests[rid].finish_reason
        print(f"[serve] request {rid}: {len(toks)} tokens ({reason}) "
              f"-> {toks[:8]}...")
    stats = engine.stats()
    print(f"[serve] {total_tokens} tokens in {dt:.2f}s "
          f"(device={engine.device}, quant={serve_cfg.quant_mode}, "
          f"use_kernel={engine.use_kernel}, "
          f"prefill {stats['prefill_tok_s']:.1f} tok/s, "
          f"decode {stats['decode_tok_s']:.1f} tok/s)")
    if "plan_db" in stats:
        db = stats["plan_db"]
        warm = "warm" if db["hits"] else "cold"
        print(f"[serve] plan db {db['directory']}: {warm} build "
              f"({db['hits']} hit / {db['misses']} miss / "
              f"{db['stale']} stale, key {db['key'][:12]})")


if __name__ == "__main__":
    main()
