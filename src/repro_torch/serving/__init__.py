"""Serving: engines, paged KV cache, governor, replicas, sampling, scheduler.

Two engines share the scheduler, the sampler and the quantized-weight
build: ``Engine`` (fixed slots over dense per-slot cache windows) and
``ContinuousEngine`` (continuous batching over a paged KV cache, with
preemption and prefix sharing).  Both shed requests past their deadline
and, with a governor, swap prebuilt weight tiers under load;
``ReplicaFront`` routes requests over several engines.  Recurrent and
sliding-window families reject ``register_shared_prefix``, naming the
feature that blocks it (their decode state is not shareable KV pages).
"""

from .engine import ContinuousEngine, Engine, ServeConfig
from .governor import Governor, GovernorConfig, Tier, build_tiers
from .paged_cache import OutOfPages, PageAllocator
from .replica import ReplicaFront
from .sampling import GREEDY, SamplingParams
from .scheduler import CANCEL_REASONS, Request, Scheduler, percentile

__all__ = [
    "Engine",
    "ContinuousEngine",
    "ServeConfig",
    "Governor",
    "GovernorConfig",
    "Tier",
    "build_tiers",
    "PageAllocator",
    "OutOfPages",
    "ReplicaFront",
    "SamplingParams",
    "GREEDY",
    "Request",
    "Scheduler",
    "percentile",
    "CANCEL_REASONS",
]
