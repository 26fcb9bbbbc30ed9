"""Runtime helpers of the serving engines."""

from .fault_tolerance import StragglerDetector

__all__ = ["StragglerDetector"]
