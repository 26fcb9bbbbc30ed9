"""Runtime helpers: fault tolerance (heartbeats, restarts, stragglers) and
gradient compression."""

from .compression import compressed_grads, init_error_feedback
from .fault_tolerance import Heartbeat, HeartbeatMonitor, RestartPolicy, StragglerDetector

__all__ = ["Heartbeat", "HeartbeatMonitor", "RestartPolicy", "StragglerDetector",
           "compressed_grads", "init_error_feedback"]
