"""End-to-end driver on the PyTorch/CUDA port: train a ~100M-param LM with
int4 QAT (the paper's low-precision arithmetic as a first-class training
feature): AdamW, a cosine schedule with warmup, the synthetic data stream.

Quick smoke:
  PYTHONPATH=src python examples/torch_train_lm.py --steps 30

The full deliverable run (a few hundred steps):
  PYTHONPATH=src python examples/torch_train_lm.py --steps 300

On the CPU add ``--device cpu`` (and a small ``--batch``/``--seq``).
"""

import argparse
import dataclasses
import time

import torch

from repro_torch.core.packed_linear import LinearSpec
from repro_torch.data import DataConfig, SyntheticStream
from repro_torch.launch.steps import make_train_step
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.optim import AdamWConfig, adamw_init, cosine_with_warmup
from repro_torch.tree import tree_leaves

# ~100M params: 16 x (4*640^2 + 3*640*2560) + 2 * 8192*640 embeddings
CFG_100M = ModelConfig(
    name="lm-100m", family="dense", n_layers=16, d_model=640, n_heads=10,
    n_kv_heads=5, d_ff=2560, vocab_size=8192, dtype="float32",
    quant=LinearSpec(mode="qat4"), remat="none",
)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=6e-4)
    ap.add_argument("--no-qat", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()

    cfg = CFG_100M
    if args.no_qat:
        cfg = dataclasses.replace(cfg, quant=LinearSpec(mode="native"))
    params = T.init_params(cfg, seed=0, device=args.device)
    n = sum(x.numel() for x in tree_leaves(params))
    print(f"[train_lm] {cfg.name}: {n/1e6:.1f}M params, quant={cfg.quant.mode}")

    state = {"params": params, "opt": adamw_init(params)}
    sched = cosine_with_warmup(args.lr, warmup=20, total=args.steps)
    step_fn = make_train_step(cfg, AdamWConfig(lr=args.lr), lr_schedule=sched)
    data = SyntheticStream(
        DataConfig(cfg.vocab_size, args.seq + 1, args.batch, seed=0)
    ).start()

    t0 = time.time()
    first = None
    for step in range(args.steps):
        batch = {k: torch.from_numpy(v).to(args.device) for k, v in next(data).items()}
        state, metrics = step_fn(state, batch)
        if step % 10 == 0 or step == args.steps - 1:
            loss = float(metrics["loss"])
            first = loss if first is None else first
            print(
                f"[train_lm] step {step:4d} loss={loss:.4f} "
                f"({(time.time()-t0)/(step+1):.2f}s/step)", flush=True,
            )
    data.stop()
    print(f"[train_lm] loss {first:.3f} -> {float(metrics['loss']):.3f}")


if __name__ == "__main__":
    main()
