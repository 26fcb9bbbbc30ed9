"""The port's training CLI (the reference's ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-1.3b \\
        --smoke --steps 3 --global-batch 2 --seq-len 32 --device cpu

On the card drop ``--device cpu``.  The loop: f32 parameters and AdamW
state on the device, the train step of :mod:`launch.steps` (the forward in
``cfg.dtype``), a cosine schedule with a warmup of a tenth of the steps,
the synthetic data stream with its prefetch thread, a heartbeat every
step, an async checkpoint every ``--ckpt-every`` completed steps and a
last one at the end (each records the steps completed and the data
stream's position), and restart from the newest checkpoint on relaunch.  ``--mesh``
takes only ``local`` (one device); ``single`` and ``multi`` wait for
ROADMAP queue 10.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import torch

from ..checkpoint.checkpointer import Checkpointer
from ..core.packed_linear import LinearSpec
from ..data.pipeline import DataConfig, SyntheticStream
from ..device import resolve_device
from ..models import transformer as T
from ..models.config import ModelConfig
from ..models.registry import get_config
from ..optim.adamw import AdamWConfig, adamw_init
from ..optim.schedule import cosine_with_warmup
from ..runtime.compression import init_error_feedback
from ..runtime.fault_tolerance import Heartbeat
from .steps import make_train_step

__all__ = ["build_state", "main"]


def build_state(cfg: ModelConfig, seed: int = 0, compress_grads: bool = False,
                device: str | torch.device = "cuda") -> dict:
    """f32 parameters from ``seed``, zero AdamW state (and error buffer)."""
    params = T.init_params(cfg, seed=seed, dtype=torch.float32, device=device)
    state = {"params": params, "opt": adamw_init(params)}
    if compress_grads:
        state["error_buf"] = init_error_feedback(params)
    return state


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--quant", default="native",
                    choices=["native", "qat4", "qat8", "int8"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--mesh", default="local", choices=["local", "single", "multi"])
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="the card (default) or cpu; no silent fallback")
    args = ap.parse_args(argv)
    if args.mesh != "local":
        raise NotImplementedError(
            f"--mesh {args.mesh} is not ported yet: ROADMAP queue 10 (tensor "
            "parallelism); the port trains on one device (--mesh local)"
        )
    dev = resolve_device(args.device)

    cfg = get_config(args.arch, smoke=args.smoke)
    cfg = dataclasses.replace(cfg, quant=LinearSpec(mode=args.quant))
    opt_cfg = AdamWConfig(lr=args.lr)
    sched = cosine_with_warmup(args.lr, warmup=max(args.steps // 10, 1), total=args.steps)
    state = build_state(cfg, compress_grads=args.compress_grads, device=dev)

    data = SyntheticStream(DataConfig(cfg.vocab_size, args.seq_len + 1, args.global_batch))
    ckpt = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
    hb = Heartbeat(os.path.join(args.ckpt_dir, "hb"), 0) if args.ckpt_dir else None
    start_step = 0
    if ckpt and ckpt.latest_step() is not None:
        state, extra = ckpt.restore(ckpt.latest_step(), state)
        data.load_state_dict(extra["data"])
        start_step = extra["train_step"]
        print(f"[train] resumed from step {start_step}", flush=True)
    # the prefetch thread starts from the restored data step (started before
    # the restore, as the reference's CLI starts it, it would replay the
    # stream from step 0)
    data.start()
    try:
        step_fn = make_train_step(cfg, opt_cfg, lr_schedule=sched,
                                  compress_grads=args.compress_grads)
        t0 = time.time()
        for step in range(start_step, args.steps):
            batch = {k: torch.from_numpy(v).to(dev) for k, v in next(data).items()}
            state, metrics = step_fn(state, batch)
            if hb:
                hb.beat(step)
            if step % args.log_every == 0 or step == args.steps - 1:
                m = {k: float(v) for k, v in metrics.items()}
                dt = time.time() - t0
                print(
                    f"[train] step={step} loss={m['loss']:.4f} ce={m['ce']:.4f} "
                    f"gnorm={m['grad_norm']:.3f} lr={m['lr']:.2e} "
                    f"({dt / max(step - start_step + 1, 1):.2f}s/step)",
                    flush=True,
                )
            done = step + 1  # steps completed; a restart resumes at index `done`
            if ckpt and done % args.ckpt_every == 0 and done < args.steps:
                ckpt.save_async(done, state,
                                extra={"data": data.state_dict(), "train_step": done})
        if ckpt:
            ckpt.save(args.steps, state,
                      extra={"data": data.state_dict(), "train_step": args.steps})
            ckpt.wait()
    finally:
        data.stop()
    print("[train] done", flush=True)


if __name__ == "__main__":
    main()
