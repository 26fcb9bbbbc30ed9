"""Quickstart, on the PyTorch/CUDA port: the paper's DSP-packing in five
minutes.

Sections 1-4 are the paper's arithmetic (``repro_torch.core``, int64
tensor code on ``--device``); section 5 runs the pair-packed matmul
kernel (``repro_torch.kernels.packed_matmul``) on the card against the
exact integer product.  On the CPU (``--device cpu``) section 5 runs the
kernel's plain version.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""

import argparse
import json

import numpy as np
import torch

from repro_torch.core.addpack import AddPackConfig, lane_add_expected, packed_lane_add
from repro_torch.core.correction import scheme_stats, simulate
from repro_torch.core.packing import int4_packing, intn_packing, outer_product_exact
from repro_torch.kernels import packed_matmul as pm
from repro_torch.kernels.ref import INT4_EXACT, ref_quantized_matmul


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    dev = torch.device(ap.parse_args().device)

    def np_(t: torch.Tensor) -> np.ndarray:
        return t.cpu().numpy()

    print("=" * 70)
    print("1. Pack four 4-bit multiplications into ONE wide multiply (paper §III)")
    cfg = int4_packing()
    a = torch.tensor([[3, 10]], device=dev)     # unsigned activations
    w = torch.tensor([[-7, 5]], device=dev)     # signed weights
    print(f"   a={np_(a)[0]}, w={np_(w)[0]}")
    print(f"   exact outer product   : {np_(outer_product_exact(cfg, a, w))[0]}")
    print(f"   naive (Xilinx) extract: {np_(simulate(cfg, a, w, 'naive'))[0]}  <- biased!")
    print(f"   full correction       : {np_(simulate(cfg, a, w, 'full'))[0]}")
    print(f"   approx correction     : {np_(simulate(cfg, a, w, 'approx'))[0]}")

    print()
    print("2. Exhaustive error statistics (paper Table I)")
    for scheme in ("naive", "full", "approx"):
        print(f"   {scheme:8s}: {scheme_stats(cfg, scheme, device=dev).row()}")

    print()
    print("3. Overpacking: six 4-bit multiplies per DSP at bounded error (§VI)")
    six = intn_packing((4, 4, 4), (5, 5), delta=-2)
    print(f"   density rho={six.packing_density():.3f} (INT4 baseline: 0.667)")
    over = int4_packing(delta=-2)
    print(f"   naive overpacking : {scheme_stats(over, 'naive', device=dev).row()}")
    print(f"   MR-overpacking    : {scheme_stats(over, 'mr', device=dev).row()}")
    print(f"   MR+round (ours)   : {scheme_stats(over, 'mr+full', device=dev).row()}")

    print()
    print("4. Addition packing (paper §VII): five 9-bit adders in one 48-bit add")
    apc = AddPackConfig((9, 9, 9, 9, 9), guard_bits=0)
    x = torch.tensor([[100, -200, 5, 17, -9]], device=dev)
    y = torch.tensor([[-50, 130, 25, -4, 77]], device=dev)
    print(f"   packed result: {np_(packed_lane_add(apc, x, y))[0]}")
    print(f"   expected     : {np_(lane_add_expected(apc, x, y))[0]}")

    print()
    print("5. The GPU adaptation: pair-packed int32 matmul (kernels/csrc/packed_matmul.cu)")
    rng = np.random.default_rng(0)
    x_q = torch.from_numpy(rng.integers(0, 16, (8, 32)).astype(np.int8)).to(dev)
    w_q = torch.from_numpy(rng.integers(-8, 8, (32, 8)).astype(np.int8)).to(dev)
    counts = pm.packed_matmul.variant_launches
    counts.update(dict.fromkeys(counts, 0))
    packed = pm.packed_matmul(x_q, w_q, INT4_EXACT)
    exact = ref_quantized_matmul(x_q, w_q)
    print(f"   packed matmul == exact int matmul: {bool((packed == exact).all())}")
    print(f"   kernel launches: {json.dumps(counts)} "
          f"({'the CUDA kernels' if dev.type == 'cuda' else 'none: the plain version on the CPU'})")
    print("   (one int32 multiply computes TWO int4 products)")


if __name__ == "__main__":
    main()
