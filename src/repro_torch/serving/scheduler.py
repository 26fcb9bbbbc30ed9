"""Request scheduler for the serving engines.

Owns everything that is *not* device compute: the admission queue (FIFO),
per-request bookkeeping (prompt, budget, sampling params, emitted tokens,
finish reason) and the engine-wide throughput/latency counters.  The engine
asks it which requests to admit when capacity frees up and reports every
prefill/decode batch back so ``stats()`` can answer the operator questions
— queue depth, tokens/s by phase, time-to-first-token, request latency.

Host code, copied from the reference's ``repro.serving.scheduler``.  The
port's fixed-slot ``Engine`` pops whole batches with ``admit``; ``peek``,
``admit_front`` and ``requeue`` serve the continuous engine, which a later
slice ports (ROADMAP queue 9).

Accounting rules learned the hard way:

* ``note_prefill_done`` stamps TTFT per request, when *that request's* last
  prefill chunk completes — not once for the whole admission batch, which
  charged short prompts in a mixed batch for the longest prompt's chunks.
* ``running`` is tracked explicitly (admit +1, finish/requeue -1), never
  derived by subtraction — preemption made the subtraction lie.
* rate/percentile helpers return 0.0 for empty phases instead of the
  ``tokens / max(t, 1e-9)`` ~1e9 tok/s artifact.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque

from .sampling import GREEDY, SamplingParams

__all__ = ["Request", "Scheduler", "percentile", "CANCEL_REASONS"]

# Finish reasons that mean "the scheduler gave up on the request", not
# "the request completed": explicit caller cancellation and deadline
# shedding.  stats() counts these separately from completions and keeps
# them out of the latency metrics — a shed request has no latency, and
# folding its short life into p99 would make load-shedding look like a
# latency win.
CANCEL_REASONS = ("cancelled", "deadline")


def percentile(xs: list[float], q: float) -> float:
    """Linear-interpolated percentile (q in [0, 100]); empty -> 0.0.

    Used by ``stats()`` and the traffic bench — matches numpy's default
    ("linear") method without pulling an array dependency into the hot
    serving path.
    """
    if not xs:
        return 0.0
    s = sorted(xs)
    if len(s) == 1:
        return s[0]
    rank = (q / 100.0) * (len(s) - 1)
    lo = int(rank)
    hi = min(lo + 1, len(s) - 1)
    frac = rank - lo
    return s[lo] * (1.0 - frac) + s[hi] * frac


def _rate(tokens: int, t: float) -> float:
    """tokens/s with an honest 0.0 when the phase never ran."""
    return tokens / t if tokens and t > 0.0 else 0.0


def _mean(xs: list[float]) -> float:
    return sum(xs) / len(xs) if xs else 0.0


@dataclasses.dataclass
class Request:
    """One request's whole life: prompt, budget, sampling params, the
    tokens emitted so far, and the timestamps ``stats()`` turns into
    TTFT/latency.  ``finish_reason`` is the state machine — ``None``
    while queued/running, then exactly one of "eos" | "length" |
    "cancelled" | "deadline" (the last two are ``CANCEL_REASONS``:
    the scheduler gave up, the request did not complete)."""

    rid: int
    prompt: list[int]
    max_new: int
    sampling: SamplingParams = GREEDY
    submitted_at: float = 0.0
    prefill_done_at: float | None = None
    finished_at: float | None = None
    # "eos" | "length" | "cancelled" | "deadline" | None while running
    finish_reason: str | None = None
    tokens: list[int] = dataclasses.field(default_factory=list)
    # absolute clock time after which the request is shed (None = no
    # deadline); stamped at submit from the relative deadline_s budget
    deadline_at: float | None = None

    @property
    def done(self) -> bool:
        return self.finish_reason is not None

    @property
    def cancelled(self) -> bool:
        return self.finish_reason in CANCEL_REASONS


class Scheduler:
    """FIFO admission queue + per-request bookkeeping + engine counters.

    Pure host-side state — no device arrays, no knowledge of slots or
    pages; the engines translate its decisions into lane/cache moves.
    ``clock`` is injectable so the traffic bench and the deadline tests
    can drive virtual time deterministically.
    """

    def __init__(self, clock=time.monotonic):
        self._clock = clock
        self._queue: deque[int] = deque()
        self._next_rid = 0
        self.requests: dict[int, Request] = {}
        # throughput/latency counters
        self.prefill_tokens = 0
        self.decode_tokens = 0
        self.prefill_time_s = 0.0
        self.decode_time_s = 0.0
        self.n_finished = 0
        self.n_running = 0
        self.n_preempted = 0
        self.n_cancelled = 0
        self.n_shed = 0  # the "deadline" subset of n_cancelled
        # unfinished rids carrying a deadline — expired() scans only these,
        # so engines without deadlines pay nothing per step
        self._deadlined: set[int] = set()

    # ---- queue ---------------------------------------------------------
    def submit(self, prompt: list[int], max_new: int,
               sampling: SamplingParams = GREEDY,
               deadline_s: float | None = None) -> int:
        """``deadline_s`` is a relative wall-clock budget from submission;
        a request still unfinished ``deadline_s`` after submit is eligible
        for shedding (``expired`` → ``cancel(reason="deadline")``)."""
        if not prompt:
            raise ValueError("empty prompt")
        if deadline_s is not None and deadline_s <= 0:
            raise ValueError(f"deadline_s must be > 0, got {deadline_s}")
        rid = self._next_rid
        self._next_rid += 1
        now = self._clock()
        self.requests[rid] = Request(
            rid, list(prompt), max_new, sampling, submitted_at=now,
            deadline_at=None if deadline_s is None else now + deadline_s,
        )
        if deadline_s is not None:
            self._deadlined.add(rid)
        self._queue.append(rid)
        return rid

    @property
    def n_queued(self) -> int:
        return len(self._queue)

    @property
    def next_rid(self) -> int:
        """The rid the next ``submit`` will assign (lets callers bracket a
        window of requests, e.g. to compute metrics over one replay)."""
        return self._next_rid

    def admit(self, n_free: int) -> list[Request]:
        """Pop up to ``n_free`` queued requests for prefill."""
        out = []
        while self._queue and len(out) < n_free:
            out.append(self.requests[self._queue.popleft()])
        self.n_running += len(out)
        return out

    def peek(self) -> Request | None:
        """Front of the queue without popping (continuous admission asks
        whether the front request's pages fit before committing)."""
        return self.requests[self._queue[0]] if self._queue else None

    def admit_front(self) -> Request:
        """Pop exactly the front request (strict FIFO admission)."""
        req = self.requests[self._queue.popleft()]
        self.n_running += 1
        return req

    def requeue(self, rid: int) -> None:
        """Push a preempted request back to the *front* of the queue.  Its
        emitted tokens are kept — re-admission re-prefills prompt+tokens and
        the (rid, position)-keyed sampler resumes the identical stream.
        ``prefill_done_at`` is kept too: TTFT measures the first token, and
        the request already produced it."""
        req = self.requests[rid]
        if req.done:
            raise RuntimeError(f"request {rid} is finished, cannot requeue")
        self._queue.appendleft(rid)
        self.n_running -= 1
        self.n_preempted += 1

    # ---- accounting ----------------------------------------------------
    def note_prefill(self, n_tokens: int, dt_s: float) -> None:
        """Throughput counters only — TTFT stamping is per-request via
        ``note_prefill_done`` (a mixed batch must not charge short prompts
        for the longest prompt's chunk time)."""
        self.prefill_tokens += n_tokens
        self.prefill_time_s += dt_s

    def note_prefill_done(self, reqs: list[Request]) -> None:
        """Stamp TTFT for requests whose own last prefill chunk just
        completed.  Idempotent per request — a preempted request keeps its
        original first-token stamp across re-prefill."""
        now = self._clock()
        for req in reqs:
            if req.prefill_done_at is None:
                req.prefill_done_at = now

    def note_decode(self, n_tokens: int, dt_s: float) -> None:
        self.decode_tokens += n_tokens
        self.decode_time_s += dt_s

    def finish(self, rid: int, reason: str) -> None:
        """Complete a request.  A still-queued rid (never admitted, or
        preempted back to the queue) is dequeued cleanly — it was not
        running, so ``n_running`` must not move for it (the old
        unconditional decrement corrupted the running count for every
        finish-from-queue path)."""
        req = self.requests[rid]
        if req.done:
            raise RuntimeError(f"request {rid} finished twice")
        if rid in self._queue:
            self._queue.remove(rid)
        else:
            self.n_running -= 1
        req.finish_reason = reason
        req.finished_at = self._clock()
        self.n_finished += 1
        self._deadlined.discard(rid)

    def cancel(self, rid: int, reason: str = "cancelled") -> bool:
        """Abort a request with a cancellation reason (``CANCEL_REASONS``).

        Queued requests are dequeued without ever being admitted; running
        requests are marked done here and the engine frees their
        lane/slot at its next step boundary.  Returns True when the
        request was still queued (the caller learns no device state needs
        releasing).  Counted under ``n_cancelled`` (and ``n_shed`` for
        deadline sheds) — never ``n_finished``.
        """
        if reason not in CANCEL_REASONS:
            raise ValueError(
                f"cancel reason {reason!r} not in {CANCEL_REASONS}"
            )
        req = self.requests[rid]
        if req.done:
            raise RuntimeError(f"request {rid} is finished, cannot cancel")
        was_queued = rid in self._queue
        if was_queued:
            self._queue.remove(rid)
        else:
            self.n_running -= 1
        req.finish_reason = reason
        req.finished_at = self._clock()
        self.n_cancelled += 1
        if reason == "deadline":
            self.n_shed += 1
        self._deadlined.discard(rid)
        return was_queued

    def expired(self, now: float | None = None) -> list[int]:
        """Unfinished rids past their deadline (queued and running alike),
        oldest first — the engine sheds these at step boundaries."""
        now = self._clock() if now is None else now
        return [
            rid for rid in sorted(self._deadlined)
            if now > self.requests[rid].deadline_at
        ]

    # ---- reporting -----------------------------------------------------
    def stats(self) -> dict:
        # completed only: a cancelled/shed request has no honest latency —
        # folding its short life into the percentiles would make shedding
        # itself look like a latency improvement
        done = [r for r in self.requests.values()
                if r.done and not r.cancelled]
        ttft = [r.prefill_done_at - r.submitted_at for r in done
                if r.prefill_done_at is not None]
        lat = [r.finished_at - r.submitted_at for r in done]
        # time-per-output-token over the decode phase (needs >= 2 tokens:
        # the first is charged to TTFT)
        tpot = [
            (r.finished_at - r.prefill_done_at) / (len(r.tokens) - 1)
            for r in done
            if r.prefill_done_at is not None and len(r.tokens) > 1
        ]
        return {
            "queued": self.n_queued,
            "running": self.n_running,
            "finished": self.n_finished,
            "cancelled": self.n_cancelled,
            "shed": self.n_shed,
            "preempted": self.n_preempted,
            "prefill_tokens": self.prefill_tokens,
            "decode_tokens": self.decode_tokens,
            "prefill_tok_s": _rate(self.prefill_tokens, self.prefill_time_s),
            "decode_tok_s": _rate(self.decode_tokens, self.decode_time_s),
            "mean_ttft_s": _mean(ttft),
            "p50_ttft_s": percentile(ttft, 50.0),
            "p99_ttft_s": percentile(ttft, 99.0),
            "mean_latency_s": _mean(lat),
            "p50_latency_s": percentile(lat, 50.0),
            "p99_latency_s": percentile(lat, 99.0),
            "p50_tpot_s": percentile(tpot, 50.0),
            "p99_tpot_s": percentile(tpot, 99.0),
        }
