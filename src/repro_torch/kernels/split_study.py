"""How far each tensor-core attention design sits from the plain version.

    python -m repro_torch.kernels.split_study [--device cpu|cuda]

Runs the emulations of :mod:`flash_attention`'s routes (the rounding each
CUDA route does, in PyTorch) against :func:`plain_flash_attention` on
seeded standard-normal inputs, at the reference tests' shapes and one
S = 4096, hd 128 head, and prints one JSON line per design and shape: the
worst element and how many elements fall outside the route's tolerance
(f32 ``atol 1e-5``; f16 ``atol 1e-5, rtol 2**-10``).  The designs: f32
operands split into three bf16 terms (the route) or two; f16 with P split
into two f16 terms (the route) or rounded once.  No card is needed; on
the CPU it takes about a minute.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from .flash_attention import (emulate_split_f32_flash, emulate_tensor_core_flash,
                              plain_flash_attention)

SHAPES = [(1, 2, 512, 64), (2, 1, 256, 128), (1, 3, 96, 64), (1, 2, 512, 128),
          (1, 1, 4096, 128)]
TOL = {torch.float32: (1e-5, 0.0), torch.float16: (1e-5, 2**-10)}
DESIGNS = {
    "f32, three bf16 terms (the route)": (torch.float32, lambda q, k, v:
                                          emulate_split_f32_flash(q, k, v)),
    "f32, two bf16 terms": (torch.float32, lambda q, k, v:
                            emulate_split_f32_flash(q, k, v, terms=2)),
    "f16, P in two f16 terms (the route)": (torch.float16, lambda q, k, v:
                                            emulate_tensor_core_flash(q, k, v)),
    "f16, P rounded once": (torch.float16, lambda q, k, v:
                            emulate_tensor_core_flash(q, k, v, split=False)),
}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cpu")
    dev = torch.device(ap.parse_args(argv).device)
    for design, (dtype, emulate) in DESIGNS.items():
        rng = np.random.default_rng(0)
        for shape in SHAPES:
            q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
                       .to(dev, dtype) for _ in range(3))
            want = plain_flash_attention(q, k, v).float()
            diff = (emulate(q, k, v).float() - want).abs()
            atol, rtol = TOL[dtype]
            print(json.dumps({
                "design": design, "shape": list(shape), "device": str(dev),
                "max_abs_err": float(diff.max()),
                "outside": int((diff > atol + rtol * want.abs()).sum()),
                "elements": diff.numel()}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
