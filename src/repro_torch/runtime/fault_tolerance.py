"""Fault tolerance and straggler machinery (launcher side).

The port's copy of the reference's ``repro.runtime.fault_tolerance``.
Every host runs a :class:`Heartbeat` writer and the job leader a
:class:`HeartbeatMonitor`; a missed deadline marks the host dead, and the
launcher restarts from ``Checkpointer.latest_step`` (:class:`RestartPolicy`).
:class:`StragglerDetector` tracks per-host step times; the continuous
serving engine records each decode step's wall time in it under one host
id, and the governor reads its rolling median as the slow-step signal.
Everything is plain files and the wall clock.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from collections import deque

__all__ = ["Heartbeat", "HeartbeatMonitor", "StragglerDetector", "RestartPolicy"]


class Heartbeat:
    """Per-host liveness beacon: an atomically replaced step-and-time file."""

    def __init__(self, directory: str, host_id: int):
        self.path = os.path.join(directory, f"host_{host_id:05d}.hb")
        os.makedirs(directory, exist_ok=True)

    def beat(self, step: int) -> None:
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"step": step, "time": time.time()}, f)
        os.replace(tmp, self.path)


class HeartbeatMonitor:
    """The hosts whose last beat is older than ``deadline_s``."""

    def __init__(self, directory: str, deadline_s: float = 60.0):
        self.directory = directory
        self.deadline_s = deadline_s

    def dead_hosts(self, now: float | None = None) -> list[int]:
        now = time.time() if now is None else now
        dead = []
        for name in sorted(os.listdir(self.directory)):
            if not name.endswith(".hb"):
                continue
            with open(os.path.join(self.directory, name)) as f:
                t = json.load(f)["time"]
            if now - t > self.deadline_s:
                dead.append(int(name.split("_")[1].split(".")[0]))
        return dead

    def healthy(self, now: float | None = None) -> bool:
        return not self.dead_hosts(now)


class StragglerDetector:
    """Rolling per-host step-time medians; flags hosts slower than
    ``threshold`` × fleet median (straggler mitigation trigger).

    Buffers are ``deque(maxlen=window)`` so ``record`` is O(1) and memory
    is O(window) per host regardless of how long the job runs (the old
    list-slice trim degenerated to unbounded growth at ``window=0`` and
    shifted the whole buffer every call); ``rolling_median`` is
    O(window log window) over the retained window only, never the full
    history.  Besides the fleet-relative ``stragglers`` view, the
    single-stream ``rolling_median`` is the serving governor's slow-step
    signal: the continuous engine records each decode step's wall time
    under one host id and the governor compares the rolling median
    against its configured ceiling.
    """

    def __init__(self, window: int = 16, threshold: float = 1.5):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.window = window
        self.threshold = threshold
        self._times: dict[int, deque[float]] = {}

    def record(self, host_id: int, step_time_s: float) -> None:
        buf = self._times.get(host_id)
        if buf is None:
            buf = self._times[host_id] = deque(maxlen=self.window)
        buf.append(step_time_s)

    @staticmethod
    def _median(xs) -> float:
        ys = sorted(xs)
        n = len(ys)
        return ys[n // 2] if n % 2 else 0.5 * (ys[n // 2 - 1] + ys[n // 2])

    def rolling_median(self, host_id: int = 0) -> float:
        """Median step time over ``host_id``'s retained window (0.0 when
        the host has recorded nothing — callers treat that as "no
        signal", matching the empty-phase-rate convention)."""
        buf = self._times.get(host_id)
        return self._median(buf) if buf else 0.0

    def n_recorded(self, host_id: int = 0) -> int:
        """Samples currently retained for ``host_id`` (<= window)."""
        buf = self._times.get(host_id)
        return len(buf) if buf else 0

    def stragglers(self) -> list[int]:
        if len(self._times) < 2:
            return []
        meds = {h: self._median(ts) for h, ts in self._times.items() if ts}
        fleet = self._median(list(meds.values()))
        return [h for h, m in meds.items() if m > self.threshold * fleet]


@dataclasses.dataclass
class RestartPolicy:
    """Launcher decision table after a fault."""

    max_restarts: int = 100
    restarts: int = 0

    def on_fault(self, dead_hosts: list[int], latest_step: int | None) -> dict:
        self.restarts += 1
        if self.restarts > self.max_restarts:
            return {"action": "abort", "reason": "restart budget exhausted"}
        return {
            "action": "restart",
            "from_step": latest_step or 0,
            "replace_hosts": dead_hosts,
        }
