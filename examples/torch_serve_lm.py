"""Serve a small LM with batched requests and packed int4 weights, on the
PyTorch/CUDA port: the decode path is weight-bandwidth-bound, exactly
where DSP-packing's density pays off.

Demonstrates the serving stack end to end: chunked batched prefill, the
request scheduler, per-request sampling, and the packed-weight decode path
(``quant_mode="int4_packed"`` packs weights once at engine build and
decodes through the ``int4_matmul`` kernel; ``dsp_packed`` runs
``packed_matmul``, ``dsp_tuned`` ``packed_matmul_prepacked``).  Each run
prints the kernel launches it made, from the kernels' counters (0 on the
CPU, where the plain versions run), ``dsp_tuned`` the plans its tuner
picked, and every run the tokens it generated: ``run(...,
use_kernel=False, plan_table=...)`` serves the same requests through the
kernels' plain versions, whose tokens the kernels' must equal.

Run:  PYTHONPATH=src python examples/torch_serve_lm.py [--device cpu]
"""

import argparse
import json
import time

import numpy as np

from repro_torch.kernels import int4_matmul as i4
from repro_torch.kernels import packed_matmul as pm
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.serving import Engine, SamplingParams, ServeConfig

CFG = ModelConfig(
    name="serve-demo", family="dense", n_layers=4, d_model=256, n_heads=4,
    n_kv_heads=2, d_ff=1024, vocab_size=4096, dtype="float32",
)
# each matmul wrapper counts its launches per kernel (M <= 16 / M > 16)
WRAPPERS = (i4.int4_matmul, pm.packed_matmul, pm.packed_matmul_prepacked)
SAMPLED = SamplingParams(temperature=0.8, top_k=40, top_p=0.95)
# the reference's six runs: (mode, sampling)
RUNS = (("native", None), ("native", SAMPLED), ("int8", None), ("int4_packed", None),
        ("dsp_packed", None), ("dsp_tuned", None))


def run(quant_mode: str, sampling: SamplingParams | None, device: str,
        use_kernel: bool | None = None, plan_table: dict | None = None) -> list:
    """One run: prints its lines and returns its tokens, request by request.
    ``use_kernel`` and ``plan_table`` go to the engine as they are."""
    params = T.init_params(CFG, seed=0, device=device)
    eng = Engine(CFG, params, ServeConfig(
        n_slots=4, max_len=64, prefill_chunk=8, quant_mode=quant_mode, device=device,
        use_kernel=use_kernel,
    ), plan_table=plan_table)
    rng = np.random.default_rng(0)
    prompts = [list(map(int, rng.integers(2, 4096, size=6))) for _ in range(6)]
    for f in WRAPPERS:
        f.variant_launches.update(dict.fromkeys(f.variant_launches, 0))
    t0 = time.time()
    outs = eng.generate(prompts, max_new=12, sampling=sampling)
    dt = time.time() - t0
    stats = eng.stats()
    toks = sum(len(v) for v in outs.values())
    mode = "greedy" if sampling is None else "sampled"
    print(f"[serve_lm] quant={quant_mode:12s} {mode:7s} {toks} tokens in "
          f"{dt:.1f}s (prefill {stats['prefill_tok_s']:.1f} tok/s, "
          f"decode {stats['decode_tok_s']:.1f} tok/s)")
    if quant_mode in ("int4_packed", "dsp_packed", "dsp_tuned"):
        launches = {k: n for f in WRAPPERS for k, n in f.variant_launches.items()}
        print(f"[serve_lm]   launches {quant_mode} {json.dumps(launches)}")
    if quant_mode == "dsp_tuned":
        plans = {p: r.name for p, r in sorted(eng.plan_table.items())}
        print(f"[serve_lm]   plans {quant_mode} {json.dumps(plans)}")
    tokens = [outs[k] for k in sorted(outs)]
    print(f"[serve_lm]   tokens {quant_mode} {mode} {json.dumps(tokens)}", flush=True)
    return tokens


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()
    for mode, sampling in RUNS:
        run(mode, sampling, args.device)


if __name__ == "__main__":
    main()
