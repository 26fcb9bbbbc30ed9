"""The port's training CLI (the reference's ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-1.3b \\
        --smoke --steps 3 --global-batch 2 --seq-len 32 --device cpu

On the card drop ``--device cpu``.  The loop: f32 parameters and AdamW
state on the device, the train step of :mod:`launch.steps` (the forward in
``cfg.dtype``), a cosine schedule with a warmup of a tenth of the steps,
the synthetic data stream with its prefetch thread, a heartbeat every
step, an async checkpoint every ``--ckpt-every`` completed steps and a
last one at the end (each records the steps completed and the data
stream's position), and restart from the newest checkpoint on relaunch.

``--mesh local`` (the default) lays a ``("data", "model")`` mesh over the
ranks that ``torchrun`` started (``WORLD_SIZE``), all of them on "data";
one process is the single-device run.  Under more than one rank the
parameters, moments (and error buffer) are placed by
``runtime.sharding.param_shardings``, every rank draws the same global
batch and trains on its shard (``launch.steps``), the checkpoints are
gathered and written by rank 0, and a relaunch restores each rank's
shards; only rank 0 prints.  Two ranks on one card::

    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 2 \
        -m repro_torch.launch.train --arch h2o-danube-3-4b --smoke --steps 3

``--mesh single`` and ``multi`` build the production meshes of 256 and 512
ranks (``launch.mesh.make_production_mesh``), and raise, naming the ranks
needed, on a smaller world.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import torch
import torch.distributed as dist

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
from ..runtime.sharding import param_shardings
from ..tree import tree_map
from .mesh import BACKEND_RULE, init_serving_world, make_local_mesh, make_production_mesh
from .steps import make_train_step

__all__ = ["build_state", "main", "param_placement", "state_shardings"]


def param_placement(cfg: ModelConfig, mesh):
    """The parameters' placement on ``mesh``: ``param_shardings`` of the
    config's tree (its shapes, on the meta device)."""
    return param_shardings(T.init_params(cfg, dtype=torch.float32, device="meta"), mesh)


def state_shardings(p_shard, compress_grads: bool = False) -> dict:
    """The train state's placement: the moments and the error buffer as the
    parameters, the step whole."""
    out = {"params": p_shard, "opt": {"m": p_shard, "v": p_shard, "step": None}}
    if compress_grads:
        out["error_buf"] = p_shard
    return out


def build_state(cfg: ModelConfig, seed: int = 0, compress_grads: bool = False,
                device: str | torch.device = "cuda", shardings=None) -> dict:
    """f32 parameters from ``seed``, zero AdamW state (and error buffer).
    With ``shardings`` (:func:`param_placement`) every leaf is this rank's
    shard: the parameters are made whole from the seed and placed (the
    reference's ``out_shardings``), the rest made as the shards."""
    params = T.init_params(cfg, seed=seed, dtype=torch.float32, device=device)
    if shardings is not None:
        params = tree_map(lambda t, sh: sh.place(t), params, shardings)
    state = {"params": params, "opt": adamw_init(params)}
    if compress_grads:
        state["error_buf"] = init_error_feedback(params)
    return state


def _join_world(device: torch.device) -> str | None:
    """Under ``torchrun`` (``WORLD_SIZE`` > 1), join its process group
    (backend by ``BACKEND_RULE``) unless the caller already has; returns
    the backend, or None in one process."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if dist.is_initialized():
        return dist.get_backend()
    if world == 1:
        return None
    return init_serving_world(int(os.environ["RANK"]), world, "env://", device)


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
    dev = resolve_device(args.device)
    joined = not dist.is_initialized()
    backend = _join_world(dev)
    mesh = (make_local_mesh() if args.mesh == "local"
            else make_production_mesh(multi_pod=args.mesh == "multi"))
    lead = mesh.rank == 0

    def say(msg: str) -> None:
        if lead:
            print(msg, flush=True)

    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    cfg = get_config(args.arch, smoke=args.smoke)
    cfg = dataclasses.replace(cfg, quant=LinearSpec(mode=args.quant))
    opt_cfg = AdamWConfig(lr=args.lr)
    sched = cosine_with_warmup(args.lr, warmup=max(args.steps // 10, 1), total=args.steps)
    p_shard = param_placement(cfg, mesh) if mesh.size > 1 else None
    s_shard = None if p_shard is None else state_shardings(p_shard, args.compress_grads)
    if mesh.size > 1:
        say(f"[train] mesh {mesh.shape} over {mesh.size} ranks, backend {backend} "
            f"({BACKEND_RULE})")
    state = build_state(cfg, compress_grads=args.compress_grads, device=dev,
                        shardings=p_shard)

    data = SyntheticStream(DataConfig(cfg.vocab_size, args.seq_len + 1, args.global_batch))
    ckpt = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
    hb = Heartbeat(os.path.join(args.ckpt_dir, "hb"), mesh.rank) if args.ckpt_dir else None
    start_step = 0
    if ckpt and ckpt.latest_step() is not None:
        state, extra = ckpt.restore(ckpt.latest_step(), state, shardings=s_shard)
        data.load_state_dict(extra["data"])
        start_step = extra["train_step"]
        say(f"[train] resumed from step {start_step}")
    # the prefetch thread starts from the restored data step (started before
    # the restore, as the reference's CLI starts it, it would replay the
    # stream from step 0)
    data.start()
    try:
        step_fn = make_train_step(cfg, opt_cfg, mesh, lr_schedule=sched,
                                  compress_grads=args.compress_grads, grad_shardings=p_shard)
        t0 = time.time()
        for step in range(start_step, args.steps):
            batch = {k: torch.from_numpy(v).to(dev) for k, v in next(data).items()}
            state, metrics = step_fn(state, batch)
            if hb:
                hb.beat(step)
            if step % args.log_every == 0 or step == args.steps - 1:
                m = {k: float(v) for k, v in metrics.items()}
                dt = time.time() - t0
                say(
                    f"[train] step={step} loss={m['loss']:.4f} ce={m['ce']:.4f} "
                    f"gnorm={m['grad_norm']:.3f} lr={m['lr']:.2e} "
                    f"({dt / max(step - start_step + 1, 1):.2f}s/step)"
                )
            done = step + 1  # steps completed; a restart resumes at index `done`
            if ckpt and done % args.ckpt_every == 0 and done < args.steps:
                ckpt.save_async(done, state, shardings=s_shard,
                                extra={"data": data.state_dict(), "train_step": done})
        if ckpt:
            ckpt.save(args.steps, state, shardings=s_shard,
                      extra={"data": data.state_dict(), "train_step": args.steps})
            ckpt.wait()
        mesh.barrier()  # every rank ends after rank 0's last write
    finally:
        data.stop()
        if joined and dist.is_initialized():
            dist.destroy_process_group()
    say("[train] done")


if __name__ == "__main__":
    main()
