"""Spiking-neural-network accumulation with addition packing (paper §VII),
on the PyTorch/CUDA port.

An SNN layer integrates weighted spikes: ``v[t+1] = v[t] + W @ s[t]``.
With binary spikes the MAC degenerates to masked adds; the paper packs
several narrow accumulators into one 48-bit adder.  This demo packs four
10-bit membrane accumulators per adder (2 guard bits -> exact) and checks
a leaky integrate-and-fire layer end to end, through
``repro_torch.core.addpack`` (int64 tensor code on ``--device``).

Run:  PYTHONPATH=src python examples/torch_snn_addpack.py [--device cpu]
"""

import argparse

import numpy as np
import torch

from repro_torch.core.addpack import AddPackConfig, accumulate

N_IN, N_OUT, T_STEPS = 64, 16, 32
THRESHOLD = 64


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    dev = torch.device(ap.parse_args().device)
    rng = np.random.default_rng(0)

    w = rng.integers(-8, 8, (N_IN, N_OUT))        # int4 weights
    spikes = (rng.random((T_STEPS, N_IN)) < 0.15)  # Poisson-ish input spikes

    # per-timestep weighted spike sums (these are the narrow addends)
    drive = torch.from_numpy(spikes.astype(np.int64) @ w).to(dev)  # (T, N_OUT)

    cfg = AddPackConfig((10, 10, 10, 10), guard_bits=2)
    assert cfg.bits_used() <= 48

    # pack N_OUT accumulators into groups of 4 lanes
    groups = drive.reshape(T_STEPS, N_OUT // 4, 4).permute(1, 0, 2)
    v_packed = accumulate(cfg, groups).reshape(N_OUT).cpu().numpy()  # (groups, 4) -> N_OUT
    v_exact = drive.sum(0).cpu().numpy()

    print(f"[snn] membrane potentials (packed)  : {v_packed[:8]} ...")
    print(f"[snn] membrane potentials (exact)   : {v_exact[:8]} ...")
    assert (v_packed == v_exact).all(), "guard bits must make packing exact"
    print(f"[snn] exact with {cfg.guard_bits} guard bits; "
          f"{cfg.n_lanes} accumulators per 48-bit adder "
          f"(density {cfg.packing_density():.2f})")

    fired = v_packed > THRESHOLD
    print(f"[snn] neurons fired: {fired.sum()}/{N_OUT}")

    # without guard bits: approximate integration (bounded per-step LSB error)
    loose = AddPackConfig((12, 12, 12, 12), guard_bits=0)
    v_loose = accumulate(loose, groups, headroom_bits=0).reshape(N_OUT).cpu().numpy()
    err = np.abs(v_loose - v_exact)
    print(f"[snn] no-guard variant: max |error| = {err.max()} "
          f"(paper §VII: carry corrupts only the victim LSB)")


if __name__ == "__main__":
    main()
