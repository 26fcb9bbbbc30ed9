"""Continuous batching over a paged KV cache.

Counterpart of the reference's ``repro.serving.engine.ContinuousEngine``.
Where ``Engine`` pins a request to a slot-sized dense cache window for its
whole life, this engine decouples *lanes* (rows of the batched forward,
``n_slots`` of them) from *memory* (a shared pool of ``n_pages`` KV pages,
``serving.paged_cache``):

* **continuous admission** — a request is admitted the moment a lane and
  its pages are free; it prefills one chunk a step beside the lanes that
  are already decoding, and joins the decode batch the step after its own
  last chunk lands.
* **memory by need** — a request holds ``ceil(len / page_size)`` pages and
  grows one page every ``page_size`` decode steps; admission keeps
  ``watermark_pages`` free.  When growth still runs dry, the youngest
  request is preempted (pages freed, requeued at the front); its
  re-admission re-prefills prompt and emitted tokens, and the sampler,
  keyed by (seed, rid, position), continues the same stream.
* **prefix sharing** — :meth:`ContinuousEngine.register_shared_prefix`
  marks a common system prompt; its pages are prefilled once and adopted
  by every later request that starts with it (refcounted, copied on write
  when a write lands in a shared page).

For the same requests this engine emits the tokens ``Engine`` emits: the
paged attention branch masks to the same positions, the per-lane window
is the dense engine's chunk-padded grid, and the sampler draws from the
same (rid, position) streams.  Every registry family serves here: the
recurrent state of ssm and hybrid is per-lane state beside the KV pools
(reset when a lane takes a new request), advanced only over each lane's
own tokens (``valid``); a sliding window pages its ring (prefill chunk 1,
as in ``Engine``); a pure ssm model holds no pages.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..models import transformer as T
from ..models.config import ModelConfig
from ..runtime.fault_tolerance import StragglerDetector
from .engine import ServeConfig, _rows, _ServingEngine
from .paged_cache import OutOfPages, PageAllocator

__all__ = ["ContinuousEngine"]

_POOLS = ("pages_k", "pages_v")


def _map_lanes(fn, cache):
    """``fn`` over the per-lane leaves of a paged cache (lane axis first);
    the page pools (``pages_k``, ``pages_v``) pass through."""
    if isinstance(cache, dict):
        return {k: v if k in _POOLS else _map_lanes(fn, v) for k, v in cache.items()}
    if isinstance(cache, list):
        return [_map_lanes(fn, v) for v in cache]
    return fn(cache)


def _pools(cache):
    """Every page pool of a paged cache."""
    if isinstance(cache, dict):
        for k, v in cache.items():
            if k in _POOLS:
                yield v
            else:
                yield from _pools(v)
    elif isinstance(cache, list):
        for v in cache:
            yield from _pools(v)


class ContinuousEngine(_ServingEngine):
    """Continuous-batching engine over a paged KV cache (module docstring).

    The surface is ``Engine``'s: :meth:`submit`, :meth:`step`,
    :meth:`cancel`, :meth:`generate`, :attr:`outputs`, :meth:`drain_stream`,
    :meth:`set_tier` and :meth:`stats`, which adds the page pool's gauges,
    the admissions, the copy-on-write copies, the most pages in use at once
    and the rolling median of the decode step's wall time.
    """

    def __init__(self, cfg: ModelConfig, params, serve_cfg: ServeConfig,
                 plan_table=None, mixed_allocation=None):
        self._build(cfg, params, serve_cfg, plan_table, mixed_allocation)
        cfg = self.cfg
        # per-step decode wall times feed the governor's slow-step signal
        self.straggler = StragglerDetector(
            window=self.governor.config.window if self.governor is not None else 16)
        b, ps = serve_cfg.n_slots, serve_cfg.page_size
        # the per-lane logical window is the chunk-padded grid, as the dense
        # engine's cache window: identical windows give identical tokens
        grid = -(-serve_cfg.max_len // self._chunk) * self._chunk
        if cfg.family == "ssm":
            self._max_blocks = 0   # pure recurrent state: nothing to page
        elif cfg.sliding_window:
            # ring pages: a lane never addresses more than the window
            self._max_blocks = -(-min(grid, cfg.sliding_window) // ps)
        else:
            self._max_blocks = -(-grid // ps)
        n_pages = (serve_cfg.n_pages if serve_cfg.n_pages is not None
                   else max(1, b * self._max_blocks))
        if n_pages < self._max_blocks:
            raise ValueError(
                f"n_pages={n_pages} cannot hold one max-length request "
                f"({self._max_blocks} blocks of {ps})"
            )
        wm = serve_cfg.watermark_pages if serve_cfg.watermark_pages is not None else b
        self.alloc = PageAllocator(n_pages, ps, min(wm, n_pages - 1))
        self.cache = T.init_paged_cache(cfg, n_pages, ps, batch=b, device=self.device)
        self._has_state = cfg.family in ("ssm", "hybrid")
        self._prefilling = np.zeros(b, bool)     # lane still prefilling
        self._n_seq = np.zeros(b, np.int64)      # tokens to prefill
        self._last_idx = np.zeros(b, np.int64)   # n_seq - 1
        self._lane_rid = np.full(b, -1, np.int64)
        self._seq: dict[int, np.ndarray] = {}    # lane -> prefill tokens
        self._last_hidden = torch.zeros((b, cfg.d_model), dtype=T.compute_dtype(cfg),
                                        device=self.device)
        # shared system-prompt prefix (register_shared_prefix)
        self._shared_prefix: list[int] | None = None
        self._shared_key: tuple | None = None
        self._shared_ready = False
        self._shared_pending_rid = -1
        self.n_admissions = 0
        self.n_cow_copies = 0
        self.peak_pages_in_use = 0

    # ---- pages -----------------------------------------------------------
    def _note_pages(self) -> None:
        self.peak_pages_in_use = max(self.peak_pages_in_use,
                                     self.alloc.n_pages - self.alloc.n_free)

    def _grow(self, rid: int, n_blocks: int) -> list[int]:
        fresh = self.alloc.grow(rid, n_blocks)
        self._note_pages()
        return fresh

    def _make_writable(self, rid: int, blk: int) -> None:
        """Copy-on-write of ``rid``'s block ``blk`` before a write lands in
        it: a shared page is copied into a private one, in every pool."""
        page, src = self.alloc.make_writable(rid, blk)
        self._note_pages()
        if src is not None:
            for pool in _pools(self.cache):
                pool[page] = pool[src]
            self.n_cow_copies += 1

    def _table(self, mask: np.ndarray) -> torch.Tensor:
        """The lanes' page table, the sentinel on every lane outside
        ``mask`` (their writes go nowhere)."""
        table = self.alloc.table_array(self._lane_rid, self._max_blocks)
        table[~mask] = self.alloc.invalid
        return self._tensor(table)

    # ---- shared prefix ---------------------------------------------------
    def register_shared_prefix(self, tokens: list[int]) -> None:
        """Declare a common system prompt.  The first admitted request that
        starts with it prefills it once; every later request that starts
        with it adopts those pages (refcounted, copied on write) and
        prefills only its own suffix."""
        if self.cfg.family == "ssm":
            raise ValueError(
                f"register_shared_prefix: unsupported for {self.cfg.name!r} "
                "(family 'ssm'); blocking feature: recurrent state — the "
                "prefix's decode state is a per-lane array, not shareable "
                "KV pages"
            )
        if self.cfg.family == "hybrid":
            raise ValueError(
                f"register_shared_prefix: unsupported for {self.cfg.name!r} "
                "(family 'hybrid'); blocking feature: mamba recurrent "
                "state — shared KV pages capture only the attention "
                "layers' prefix state, so an adopting request would resume "
                "from a zero mamba state"
            )
        if self.cfg.sliding_window:
            raise ValueError(
                f"register_shared_prefix: unsupported for {self.cfg.name!r}"
                f"; blocking feature: sliding_window={self.cfg.sliding_window}"
                " — ring slots are position-ambiguous across requests "
                "(slot = pos % window), so prefix pages cannot be adopted"
            )
        if self._shared_prefix is not None:
            raise ValueError("shared prefix already registered")
        if not tokens:
            raise ValueError("empty shared prefix")
        if self.scheduler.requests:
            raise ValueError("register the shared prefix before submitting requests")
        blocks = self.alloc.blocks_for(len(tokens))
        if self.alloc.n_pages < self._max_blocks + blocks:
            raise ValueError(
                f"n_pages={self.alloc.n_pages} cannot pin a {blocks}-block "
                f"shared prefix and still hold one max-length request "
                f"({self._max_blocks} blocks)"
            )
        self._shared_prefix = list(tokens)
        self._shared_key = ("prefix", tuple(tokens))

    def _matches_prefix(self, prompt: list[int]) -> bool:
        sp = self._shared_prefix
        return sp is not None and len(prompt) >= len(sp) and list(prompt[:len(sp)]) == sp

    # ---- request lifecycle ----------------------------------------------
    def _admission_plan(self, req) -> tuple[list[int], int, int, int]:
        """``(seq, start, blocks_total, pages_needed)`` for admitting
        ``req``: ``seq`` is the prompt and the tokens already emitted (a
        preempted request re-prefills its own output), ``start`` skips the
        adopted shared-prefix tokens (at least the last token is
        prefilled, for a hidden state to sample from), ``pages_needed``
        counts fresh pages: the blocks past the adopted ones, and one more
        where the first written block is shared (its copy)."""
        seq = list(req.prompt) + list(req.tokens)
        n_seq = len(seq)
        start = adopted = 0
        if self._shared_ready and self._matches_prefix(seq):
            start = min(len(self._shared_prefix), n_seq - 1)
            adopted = self.alloc.shared_blocks(self._shared_key)
        n_chunks = -(-(n_seq - start) // self._chunk)
        blocks_total = min(self.alloc.blocks_for(start + n_chunks * self._chunk),
                           self._max_blocks)
        need = max(0, blocks_total - adopted)
        if adopted and start // self.alloc.page_size < adopted:
            need += 1  # the copy of the partial shared page the prefill writes
        return seq, start, blocks_total, need

    @torch.inference_mode()
    def _admit(self) -> None:
        """Admit queued requests into free lanes, strictly FIFO: if the
        front request's pages would dip the free list below the watermark,
        nobody skips ahead of it.  An idle engine ignores the watermark,
        which exists to protect running lanes."""
        while True:
            free = np.flatnonzero(~self.active)
            req = self.scheduler.peek()
            if len(free) == 0 or req is None:
                break
            seq, start, blocks_total, need = self._admission_plan(req)
            if not (self.alloc.can_admit(need)
                    or (not self.active.any() and need <= self.alloc.n_free)):
                break
            req = self.scheduler.admit_front()
            self.n_admissions += 1
            lane = int(free[0])
            self.alloc.open_table(req.rid)
            if start > 0:
                self.alloc.adopt_shared(self._shared_key, req.rid)
            self._grow(req.rid, blocks_total)
            # every block the prefill writes into must be private (only a
            # shared partial page ever copies)
            for blk in range(start // self.alloc.page_size, blocks_total):
                self._make_writable(req.rid, blk)
            if self._has_state:
                # the new occupant starts from zero recurrent state
                lane_mask = np.zeros(self.scfg.n_slots, bool)
                lane_mask[lane] = True
                fresh = self._tensor(lane_mask)
                self.cache = _map_lanes(
                    lambda leaf: leaf.masked_fill(_rows(fresh, leaf), 0), self.cache)
            self._lane_rid[lane] = req.rid
            self.active[lane] = True
            self._prefilling[lane] = True
            self._seq[lane] = np.asarray(seq, np.int64)
            self._n_seq[lane] = len(seq)
            self._last_idx[lane] = len(seq) - 1
            self.positions[lane] = start
            self._set_sampling(lane, req)
            if (self._shared_prefix is not None and not self._shared_ready
                    and self._shared_pending_rid < 0
                    and self._matches_prefix(req.prompt)):
                # the first matching request prefills the prefix for all;
                # its pages are pinned once its prefill completes
                self._shared_pending_rid = req.rid

    def _prefill_step(self) -> list[int]:
        """One chunk of prefill for every prefilling lane, each at its own
        depth.  Lanes outside it get the sentinel page table (their writes
        go nowhere) and ``valid`` False over the chunk (their recurrent
        state stays), so no merge pass is needed.  Lanes whose last chunk
        landed sample their first token, get their TTFT stamp and decode
        from the next step."""
        lanes = np.flatnonzero(self._prefilling)
        if len(lanes) == 0:
            return []
        t0 = time.monotonic()
        b, c = self.scfg.n_slots, self._chunk
        tokens = np.zeros((b, c), np.int64)
        base = np.zeros(b, np.int64)
        n_tok = 0
        for lane in lanes:
            pos = int(self.positions[lane])
            chunk = self._seq[lane][pos:pos + c]
            tokens[lane, :len(chunk)] = chunk
            base[lane] = pos
            n_tok += len(chunk)
        row_mask = self._prefilling.copy()
        row_mask_t, base_t = self._tensor(row_mask), self._tensor(base)
        last_idx_t = self._tensor(self._last_idx)
        positions = base_t[:, None] + torch.arange(c, device=self.device)[None]
        valid = row_mask_t[:, None] & (positions <= last_idx_t[:, None])
        hidden, self.cache, _ = T.forward(
            self.params, self.cfg, self._tensor(tokens), positions=positions,
            cache=self.cache, return_hidden=True, valid=valid,
            page_table=self._table(row_mask),
        )
        idx = (last_idx_t - base_t).clamp(0, c - 1)
        row_hidden = hidden[torch.arange(b, device=self.device), idx]
        in_chunk = row_mask_t & (last_idx_t >= base_t) & (last_idx_t < base_t + c)
        self._last_hidden = torch.where(in_chunk[:, None],
                                        row_hidden.to(self._last_hidden.dtype),
                                        self._last_hidden)
        done_lanes = []
        for lane in lanes:
            if self.positions[lane] + c >= self._n_seq[lane]:
                self.positions[lane] = self._n_seq[lane]
                done_lanes.append(int(lane))
            else:
                self.positions[lane] += c
        finished: list[int] = []
        if done_lanes:
            # sampling reads the logits back: the TTFT stamp follows the work
            first = self._sample(self._lm_head(self._last_hidden), self._last_idx,
                                 self._lane_rid)
            done_reqs = []
            for lane in done_lanes:
                rid = int(self._lane_rid[lane])
                req = self.scheduler.requests[rid]
                done_reqs.append(req)
                self._prefilling[lane] = False
                self._seq.pop(lane, None)
                tok = int(first[lane])
                req.tokens.append(tok)
                self._stream.append((rid, tok))
                self.last_token[lane] = tok
                if rid == self._shared_pending_rid:
                    # the prefix pages hold real KV now: pin and publish them
                    self.alloc.register_shared(
                        self._shared_key, rid, self.alloc.blocks_for(len(self._shared_prefix)))
                    self._shared_ready = True
                    self._shared_pending_rid = -1
                fin = self._maybe_finish(lane, tok)
                if fin is not None:
                    finished.append(fin)
            self.scheduler.note_prefill_done(done_reqs)
        self.scheduler.note_prefill(n_tok, time.monotonic() - t0)
        return finished

    def _youngest_lane(self) -> int | None:
        """The lane holding the newest request (the preemption victim)."""
        best, best_rid = None, -1
        for lane in np.flatnonzero(self.active):
            rid = int(self._lane_rid[lane])
            if rid > best_rid:
                best, best_rid = int(lane), rid
        return best

    def _clear_lane(self, lane: int) -> None:
        self.active[lane] = False
        self._prefilling[lane] = False
        self._lane_rid[lane] = -1
        self._seq.pop(int(lane), None)

    def _preempt(self, lane: int) -> None:
        """Evict a lane: free its pages and requeue its request at the
        front of the queue, its emitted tokens kept."""
        rid = int(self._lane_rid[lane])
        if rid == self._shared_pending_rid:
            self._shared_pending_rid = -1  # its prefix pages never landed
        self.alloc.free(rid)
        self.scheduler.requeue(rid)
        self._clear_lane(lane)

    def _ensure_decode_pages(self, lanes: list[int]) -> None:
        """Grow each decoding lane's table to cover its next write, oldest
        request first; on ``OutOfPages`` preempt the youngest active
        request and retry."""
        for lane in sorted(lanes, key=lambda l: int(self._lane_rid[l])):
            if not self.active[lane]:
                continue  # preempted by an earlier lane's growth
            rid = int(self._lane_rid[lane])
            # a lane never addresses more than _max_blocks blocks: the ring
            # (sliding window) wraps, and a pure-ssm lane has no pages
            needed = min(int(self.positions[lane]) // self.alloc.page_size + 1,
                         self._max_blocks)
            if needed == 0:
                continue
            while True:
                try:
                    self._grow(rid, needed)
                    break
                except OutOfPages:
                    victim = self._youngest_lane()
                    if victim is None or (victim == lane and self.active.sum() <= 1):
                        raise  # one lone request outgrew the pool: configuration
                    self._preempt(victim)
                    if victim == lane:
                        break
            if not self.active[lane]:
                continue
            if self.cfg.sliding_window:
                # the next write lands at ring slot pos % window
                wblk = (int(self.positions[lane]) % self.cfg.sliding_window
                        ) // self.alloc.page_size
            else:
                wblk = needed - 1
            self._make_writable(rid, wblk)

    def _decode_once(self, decode_mask: np.ndarray) -> list[int]:
        """Advance the decode batch one token: the lanes of ``decode_mask``
        still active after page growth (which may preempt some).  Lanes
        outside it get the sentinel page table and ``valid`` False, so a
        still-prefilling lane neither writes nor advances its state."""
        if not (decode_mask & self.active).any():
            return []
        t0 = time.monotonic()
        self._ensure_decode_pages([int(l) for l in np.flatnonzero(decode_mask & self.active)])
        mask = decode_mask & self.active
        lanes = np.flatnonzero(mask)
        if len(lanes) == 0:
            return []
        logits, self.cache, _ = T.forward(
            self.params, self.cfg, self._tensor(self.last_token)[:, None],
            positions=self._tensor(self.positions)[:, None], cache=self.cache,
            valid=self._tensor(mask)[:, None], page_table=self._table(mask),
        )
        nxt = self._sample(logits[:, -1], self.positions, self._lane_rid)
        dt = time.monotonic() - t0
        self.scheduler.note_decode(len(lanes), dt)
        self.straggler.record(0, dt)
        finished = []
        for lane in lanes:
            self.positions[lane] += 1
            tok = int(nxt[lane])
            rid = int(self._lane_rid[lane])
            self.scheduler.requests[rid].tokens.append(tok)
            self._stream.append((rid, tok))
            self.last_token[lane] = tok
            fin = self._maybe_finish(int(lane), tok)
            if fin is not None:
                finished.append(fin)
        return finished

    def _maybe_finish(self, lane: int, tok: int) -> int | None:
        """Single termination path (EOS, budget, capacity), the bounds and
        reasons of ``Engine._maybe_finish``."""
        req = self.scheduler.requests[int(self._lane_rid[lane])]
        if tok == self.scfg.eos_token:
            return self._finish_lane(lane, "eos")
        if len(req.tokens) >= req.max_new:
            return self._finish_lane(lane, "length")
        if self.positions[lane] >= self.scfg.max_len:
            return self._finish_lane(lane, "length")
        return None

    def _finish_lane(self, lane: int, reason: str) -> int:
        rid = int(self._lane_rid[lane])
        self._clear_lane(lane)
        self.alloc.free(rid)  # shared pins survive through their own ref
        self.scheduler.finish(rid, reason)
        return rid

    def _release_rid(self, rid: int) -> None:
        """Free the lane and pages of a cancelled running request (the
        scheduler's accounting is done by ``Scheduler.cancel``)."""
        for lane in np.flatnonzero(self._lane_rid == rid):
            self._clear_lane(int(lane))
        if rid == self._shared_pending_rid:
            self._shared_pending_rid = -1  # its prefix pages never landed
        self.alloc.free(rid)

    def _govern(self, slow_step_ms: float | None = None) -> None:
        super()._govern(1e3 * self.straggler.rolling_median())

    @torch.inference_mode()
    def step(self) -> list[int]:
        """Shed expired requests, let the governor re-tier, admit what
        fits, prefill one chunk per prefilling lane, advance the decode
        batch one token.  A lane whose prefill completed this step decodes
        from the next (the decode batch is taken before the prefill).
        Returns the rids finished this step."""
        self._shed_expired()
        self._govern()
        self._admit()
        decode_mask = self.active & ~self._prefilling
        finished = self._prefill_step()
        finished += self._decode_once(decode_mask)
        return finished

    def _step_budget(self, prompts: list[list[int]], per_req: int) -> int:
        # prefill costs ceil(L / chunk) steps a request; doubled for the
        # re-prefills of preempted requests
        return 2 * (per_req * len(prompts) + sum(-(-len(p) // self._chunk) for p in prompts)
                    + len(prompts)) + 8

    def stats(self) -> dict:
        """``Engine.stats`` and the page pool: total and free pages, page
        size, the admission watermark, admissions, copy-on-write copies,
        the most pages in use at once (after any grow or copy), and the
        rolling median of the decode step's wall time in seconds."""
        s = super().stats()
        s.update(
            n_pages=self.alloc.n_pages,
            free_pages=self.alloc.n_free,
            page_size=self.alloc.page_size,
            watermark_pages=self.alloc.watermark,
            admissions=self.n_admissions,
            cow_copies=self.n_cow_copies,
            peak_pages_in_use=self.peak_pages_in_use,
            decode_median_step_s=self.straggler.rolling_median(),
        )
        return s
