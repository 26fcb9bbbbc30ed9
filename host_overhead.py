"""Where a narrow decode GEMV's time goes, and native serving alone.

    python3 host_overhead.py [--src DIR] [--json PATH] [--no-serve]

Imports the PyTorch/CUDA port from ``DIR`` (default: this checkout's
``src``), so that two trees, each unpacked with its own ``src``, can be run
in turns on one card.  Needs a CUDA card and nvcc; imports nothing of JAX.

1. Native serving at ``chip_smoke.py``'s phase 4 configuration
   (qwen1.5-110b at full width, 4 layers, random bf16 weights from seed 0,
   4 slots, prefill chunk 16, 3 greedy requests of 8 tokens), with nothing
   run on the card before it: one engine, a warm-up request, then three
   rounds, each giving decode ms/step (median over its steps, the first
   step left out as ``chip_smoke.py`` does) and prefill tok/s.
2. The three packed decode wrappers at M = 4 (``int4_matmul``,
   ``packed_matmul`` with INT4_EXACT, ``packed_matmul_prepacked`` with the
   mr plan), at the five main-path linear shapes of ``chip_smoke.py``
   (K x N = 8192 x 8192, 8192 x 1024, 8192 x 49152, 49152 x 8192,
   8192 x 152064), called as ``chip_smoke.py`` times them, on weight
   copies that overflow the L2:
   ``event_ms`` (CUDA events around 20 back-to-back calls, per call; what
   ``chip_smoke.py`` reports), ``host_us`` (host clock around the same
   calls before the sync: the enqueue time per call) and ``graph_ms`` (the
   same 20 calls captured in a CUDA graph and replayed, per call: the
   device's time with no host in the loop).  Where ``host_us`` is near
   ``event_ms`` and ``graph_ms`` is far below it, the loop times the host
   (the narrow shapes, 8192 x 1024 and 8192 x 8192).

``--no-serve`` leaves out step 1.  Prints one JSON object as its last
line (``--json`` also writes it).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

L2_BYTES = 50 * 2**20
MAIN_PLAN = "a4w4-p10-n32-mr+full-c2"
SHAPES = ((8192, 8192), (8192, 1024), (8192, 49152), (49152, 8192), (8192, 152064))
ITERS, REPS = 20, 7


def serve_native(torch, cfg, Engine, ServeConfig, T) -> list[dict]:
    params = T.init_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    gen = torch.Generator().manual_seed(0)
    prompts = [torch.randint(2, cfg.vocab_size, (n,), generator=gen).tolist()
               for n in (5, 17, 30)]
    engine = Engine(cfg, params, ServeConfig(
        n_slots=4, max_len=64, prefill_chunk=16, max_new=8, quant_mode="native",
        eos_token=-1, device="cuda"))
    engine.generate([prompts[0][:4]], max_new=2)  # warm-up request
    sch = engine.scheduler
    rounds = []
    for _ in range(3):
        tok0, time0 = sch.prefill_tokens, sch.prefill_time_s
        for p in prompts:
            engine.submit(p, max_new=8, admit=False)
        step_ms = []
        while engine.active.any() or sch.n_queued:
            t0 = time.perf_counter()
            engine.step()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        decode = sorted(step_ms[1:])
        rounds.append(dict(decode_ms_per_step=decode[len(decode) // 2],
                           decode_ms_steps=decode,
                           prefill_tok_s=(sch.prefill_tokens - tok0)
                           / (sch.prefill_time_s - time0)))
    del engine, params
    torch.cuda.empty_cache()
    return rounds


def timings(torch, call) -> dict:
    """``call(i)`` launches the wrapper on weight copy ``i % copies``."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    out = dict(event_ms=[], host_us=[], graph_ms=None, graph_error=None)
    for _ in range(REPS):
        call(0)
        torch.cuda.synchronize()
        start.record()
        t0 = time.perf_counter()
        for i in range(ITERS):
            call(i)
        host = time.perf_counter() - t0
        end.record()
        torch.cuda.synchronize()
        out["event_ms"].append(start.elapsed_time(end) / ITERS)
        out["host_us"].append(host / ITERS * 1e6)
    try:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            call(0)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for i in range(ITERS):
                call(i)
        graph.replay()
        torch.cuda.synchronize()
        out["graph_ms"] = []
        for _ in range(REPS):
            start.record()
            graph.replay()
            end.record()
            torch.cuda.synchronize()
            out["graph_ms"].append(start.elapsed_time(end) / ITERS)
        del graph
    except RuntimeError as e:  # a wrapper that cannot be captured: say so
        out["graph_error"] = str(e).splitlines()[0]
        torch.cuda.synchronize()
    return out


def time_wrappers(torch, i4, pm, ref) -> list[dict]:
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    main, exact = ref.spec_from_name(MAIN_PLAN), ref.INT4_EXACT
    m = 4

    def copies(make, nbytes):
        return [make() for _ in range(max(1, math.ceil(2 * L2_BYTES / nbytes)))]

    rows = []
    for k, n in SHAPES:
        xq = torch.randint(-127, 128, (m, k), generator=gen, device=dev, dtype=torch.int8)
        ws = copies(lambda: torch.randint(0, 256, (k // 2, n), generator=gen, device=dev,
                                          dtype=torch.uint8), k * n // 2)
        rows.append(dict(kernel="int4_matmul", M=m, K=k, N=n, **timings(
            torch, lambda i: i4.int4_matmul(xq, ws[i % len(ws)]))))
        del ws
        xf = torch.randn((m, k), generator=gen, device=dev)
        zp = 1 << (main.bits_a - 1)
        scale = xf.abs().amax(-1, keepdim=True).clamp_min(1e-8) / (zp - 1)
        pw = copies(lambda: ref.pack_weight_words(
            torch.randint(-8, 8, (k, n), generator=gen, device=dev, dtype=torch.int32), main),
            6 * k * n)
        rows.append(dict(kernel="packed_matmul_prepacked", M=m, K=k, N=n, **timings(
            torch, lambda i: pm.packed_matmul_prepacked(xf, *pw[i % len(pw)], main,
                                                        x_scale=scale, x_zp=zp))))
        del pw
        xu = torch.randint(0, 16, (m, k), generator=gen, device=dev, dtype=torch.int32)
        w8s = copies(lambda: torch.randint(-8, 8, (k, n), generator=gen, device=dev,
                                           dtype=torch.int8), k * n)
        rows.append(dict(kernel="packed_matmul", M=m, K=k, N=n, **timings(
            torch, lambda i: pm.packed_matmul(xu, w8s[i % len(w8s)], exact))))
        del w8s
        torch.cuda.empty_cache()
    return rows


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", type=Path, default=Path(__file__).resolve().parent / "src")
    ap.add_argument("--json", type=Path, default=None, metavar="PATH")
    ap.add_argument("--no-serve", action="store_true", help="time the wrappers only")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("host_overhead: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(args.src.resolve()))
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import int4_matmul as i4
    from repro_torch.kernels import packed_matmul as pm
    from repro_torch.models import transformer as T
    from repro_torch.models.registry import get_config
    from repro_torch.serving import Engine, ServeConfig

    torch.set_float32_matmul_precision("highest")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip().splitlines()[0]
    build.build_all()
    cfg = dataclasses.replace(get_config("qwen1.5-110b"), n_layers=4)
    result = dict(card=card, src=str(args.src),
                  native=[] if args.no_serve
                  else serve_native(torch, cfg, Engine, ServeConfig, T),
                  wrappers=time_wrappers(torch, i4, pm, ref))
    for r in result["native"]:
        print(f"[host_overhead] native: decode {r['decode_ms_per_step']:.2f} ms/step, "
              f"prefill {r['prefill_tok_s']:.1f} tok/s", flush=True)
    for r in result["wrappers"]:
        med = {key: (None if r[key] is None else sorted(r[key])[REPS // 2])
               for key in ("event_ms", "host_us", "graph_ms")}
        print(f"[host_overhead] {r['kernel']:24s} M={r['M']} K={r['K']} N={r['N']}: "
              f"event {med['event_ms']:.4f} ms, host {med['host_us']:.1f} us, graph "
              f"{med['graph_ms'] if med['graph_ms'] is None else round(med['graph_ms'], 4)}"
              f" ms{'' if r['graph_error'] is None else ' (' + r['graph_error'] + ')'}",
              flush=True)
    line = json.dumps(result)
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
