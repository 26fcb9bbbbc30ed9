"""Block sweep for the prepacked pair-packed kernels, on the card.

The reference sweeps ``(bm, bn, bk)`` Pallas blocks for a plan.  The
port's kernels fix their tiles at compile time and choose their K split
themselves, so a "block" here is one kernel of
:func:`~repro_torch.kernels.packed_matmul.packed_matmul_prepacked` that
the wrapper can launch for the plan (``prepacked_variants``): the M <= 16
kernel ``packed_matmul_prepacked`` at any M, and
``packed_matmul_prepacked_tiled`` where its stage fits in shared memory.
On the CPU the plain version is the only candidate.  The TPU grids of the
reference (``DEFAULT_BLOCKS``, ``DECODE_BLOCKS``) have no meaning here and
are not kept.

Timing is pluggable: pass ``timer=`` any callable ``timer(fn, warmup=,
iters=) -> µs per call``, or use :func:`default_timer` (CUDA-graph replay
between CUDA events on the card, the host clock on the CPU).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch

from ..device import resolve_device
from ..kernels import ref
from ..kernels.packed_matmul import packed_matmul_prepacked, prepacked_variants
from ..kernels.ref import PackedDotSpec

__all__ = [
    "BlockTiming",
    "candidate_blocks",
    "autotune_block",
    "autotune_phase_blocks",
    "default_timer",
]


@dataclasses.dataclass(frozen=True)
class BlockTiming:
    block: str          # the kernel variant timed
    us_per_call: float


# device time one graph replay should span: enough that the replay's own
# launch is lost in it, little enough that a full-width probe (tens of ms a
# call) is replayed as a single call
_GRAPH_BUDGET_US = 2000.0


def default_timer(fn: Callable[[], object], warmup: int = 1, iters: int = 20,
                  device: str | torch.device = "cuda") -> float:
    """µs per call of ``fn()``, the median of three readings.

    On the card: ``warmup`` calls on a side stream (as graph capture
    asks), the last one between CUDA events; then as many calls as fill
    about ``_GRAPH_BUDGET_US`` at that pace, at most ``iters``, captured in
    one CUDA graph and replayed three times between CUDA events.  That is
    the device's time: an event-timed loop of M <= 16 calls runs at the
    host's enqueue rate.  The operands are the same in every call, so a
    weight that fits in L2 is timed warm.  On the CPU: three loops of
    ``iters`` calls on the host clock after ``warmup`` calls."""
    if torch.device(device).type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(max(warmup - 1, 0)):
                fn()
            start.record()
            fn()
            end.record()
        torch.cuda.current_stream().wait_stream(side)
        end.synchronize()
        once_us = start.elapsed_time(end) * 1e3
        n = max(1, min(iters, round(_GRAPH_BUDGET_US / max(once_us, 1.0))))
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(n):
                fn()
        readings = []
        for _ in range(3):
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            readings.append(start.elapsed_time(end) * 1e3 / n)
        del graph
        return sorted(readings)[1]
    for _ in range(warmup):
        fn()
    readings = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        readings.append((time.perf_counter() - t0) / iters * 1e6)
    return sorted(readings)[1]


def candidate_blocks(spec: PackedDotSpec, device: str | torch.device = "cuda") -> list[str]:
    """The variants ``packed_matmul_prepacked`` can launch for ``spec`` on
    ``device``."""
    return list(prepacked_variants(spec, device))


def autotune_block(
    spec: PackedDotSpec,
    shape: tuple[int, int, int],
    timer: Callable[..., float] | None = None,
    warmup: int = 1,
    iters: int = 20,
    seed: int = 0,
    device: str | torch.device = "cuda",
) -> list[BlockTiming]:
    """Time every candidate variant on a ``shape = (m, k, n)`` problem in
    the serving profile: the weights packed once outside the timed region,
    the f32 activations quantized inside the kernel's prologue.

    Returns timings sorted fastest-first.  Each candidate's output is
    checked bit-exact against the first candidate's: a variant may only be
    slow, never wrong."""
    dev = resolve_device(device)
    m, k, n = shape
    if timer is None:
        timer = lambda fn, warmup, iters: default_timer(fn, warmup, iters, dev)
    # operands drawn on the device: a host draw of a full-width weight
    # would take longer than timing both variants
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((m, k), generator=gen, device=dev)
    w = torch.randint(-(1 << (spec.bits_w - 1)), 1 << (spec.bits_w - 1), (k, n),
                      generator=gen, device=dev, dtype=torch.int32)
    packed = ref.pack_weight_words(w, spec)
    del w
    zp = 1 << (spec.bits_a - 1)
    x_scale = torch.clamp_min(x.abs().amax(dim=-1, keepdim=True), 1e-8) / (zp - 1)
    timings: list[BlockTiming] = []
    reference = None
    for block in candidate_blocks(spec, dev):
        def run(block=block):
            return packed_matmul_prepacked(x, packed.words, packed.wsc, spec,
                                           x_scale=x_scale, x_zp=zp, variant=block)

        out = run()
        if reference is None:
            reference = out
        elif not torch.equal(out, reference):
            bad = int((out.to(torch.int64) - reference).abs().max())
            raise AssertionError(
                f"{spec.name()}: variant {block} differs from {timings[0].block} "
                f"by up to {bad} at {shape}")
        timings.append(BlockTiming(block, timer(run, warmup=warmup, iters=iters)))
    return sorted(timings, key=lambda t: t.us_per_call)


def autotune_phase_blocks(
    spec: PackedDotSpec,
    shapes: dict[str, tuple[int, int, int]],
    **kwargs,
) -> dict[str, BlockTiming]:
    """Best variant per serving phase: ``shapes`` maps a phase name
    ("prefill"/"decode") to its (m, k, n) probe; each phase is swept on its
    own and the tuned plan carries one variant per phase."""
    return {phase: autotune_block(spec, shape, **kwargs)[0]
            for phase, shape in shapes.items()}
