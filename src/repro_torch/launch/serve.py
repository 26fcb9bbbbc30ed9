"""Serving CLI: batched requests through the fixed-slot engine.

  python -m repro_torch.launch.serve --arch qwen1.5-110b --smoke \\
      --quant dsp_tuned --plan a4w4-p10-n32-mr+full-c2 --fuse all

Runs on the card by default (``--device cuda``, the CUDA kernels);
``--device cpu`` serves the plain versions.  ``--plan NAME`` serves one
tuned plan on every packable weight under ``--quant dsp_tuned``; it stands
in for the reference's plan search (``--plan-bits``/``--error-budget``)
until the tuner is ported (ROADMAP queue 6).  ``--fuse mlp`` joins up|gate
at engine build, ``--fuse all`` also q|k|v (packed modes; each output
column stays bit-identical).
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from ..core.packed_params import fuse_projection_weights, iter_packable_weights
from ..kernels.ref import spec_from_name
from ..models import transformer as T
from ..models.registry import get_config
from ..serving import Engine, SamplingParams, ServeConfig


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--prefill-chunk", type=int, default=16)
    ap.add_argument("--stream", action="store_true",
                    help="print (rid, token) pairs as they are emitted")
    ap.add_argument("--quant", default="native",
                    choices=["native", "int4_packed", "dsp_packed", "dsp_tuned"])
    ap.add_argument("--plan", default=None, metavar="NAME",
                    help="dsp_tuned: the plan served on every packable "
                         "weight, e.g. a4w4-p10-n32-mr+full-c2 (default: "
                         "the exact int4 preset)")
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
    if args.plan is not None and args.quant != "dsp_tuned":
        ap.error("--plan needs --quant dsp_tuned")

    cfg = get_config(args.arch, smoke=args.smoke)
    params = T.init_params(cfg, seed=0, device=args.device)
    plan_table = None
    if args.plan is not None:
        # the table is keyed by the served tree's paths: fuse here, and the
        # engine's own fusion finds nothing left to join
        if args.fuse_projections != "none":
            params = fuse_projection_weights(params,
                                             fuse_attn=args.fuse_projections == "all")
        spec = spec_from_name(args.plan)
        plan_table = {p: spec for p, _ in iter_packable_weights(params)}
    serve_cfg = ServeConfig(
        n_slots=args.slots, max_len=args.max_len,
        prefill_chunk=args.prefill_chunk, quant_mode=args.quant,
        prepack=args.prepack, fuse_projections=args.fuse_projections,
        temperature=args.temperature, top_k=args.top_k,
        top_p=args.top_p, seed=args.seed, device=args.device,
    )
    engine = Engine(cfg, params, serve_cfg, plan_table=plan_table)
    if engine.plan_table:
        print("[serve] packing plans: "
              + ", ".join(sorted({s.name() for s in engine.plan_table.values()})))
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


if __name__ == "__main__":
    main()
