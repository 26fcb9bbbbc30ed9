"""Step-time straggler detection.

The port's copy of the reference's ``StragglerDetector``
(``repro.runtime.fault_tolerance``).  The continuous serving engine records
each decode step's wall time in it under one host id, and the governor
reads its rolling median as the slow-step signal.
"""

from __future__ import annotations

from collections import deque

__all__ = ["StragglerDetector"]


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
