"""Fixed-slot serving: sampling, scheduler and engine."""

from .engine import Engine, ServeConfig
from .sampling import SamplingParams
from .scheduler import Request, Scheduler

__all__ = ["Engine", "ServeConfig", "SamplingParams", "Request", "Scheduler"]
