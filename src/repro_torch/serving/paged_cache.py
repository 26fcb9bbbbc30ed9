"""Paged KV cache bookkeeping for the continuous-batching engine.

Host code on numpy, copied from the reference's
``repro.serving.paged_cache``.  The device side of the paged cache is
plain storage: every attention layer holds ``(n_pages, page_size, n_kv,
hd)`` K and V pools (``models.layers.init_paged_kv_cache``), and the
attention layer writes each call's K/V through a per-lane *page table*,
then gathers the lane's logical view back for the attend
(``models.layers.attention``'s paged branch).

Everything stateful lives here, on the host, in ``PageAllocator``:

* **free list** — physical page ids not owned by any request.  ``grow``
  hands pages to a request's table atomically (it checks the free count
  first, so a failed grow never half-mutates state), low pages first.
* **page tables** — per-request ``rid -> [page_id, ...]`` in logical block
  order.  ``table_array`` renders the per-lane device table; lanes without
  a request and table slots past a request's allocation carry the
  sentinel ``invalid == n_pages``: the attention layer sends writes to it
  nowhere and masks what a gather through it reads.
* **refcounts + prefix sharing** — a registered shared prefix (a common
  system prompt) is prefilled once; its pages are pinned and adopted by
  later requests (``adopt_shared``) with a refcount bump, so N requests
  with the same system prompt hold one physical copy.
* **copy-on-write** — ``make_writable`` is called by the engine for every
  block a write will touch: a block whose page is shared (refcount > 1)
  gets a fresh private page and the caller copies the device data over,
  so no request can corrupt a page another request is still reading.
* **admission watermark** — ``can_admit`` refuses a request whose pages
  would dip the free list below ``watermark``, keeping headroom for the
  already-decoding lanes to grow (each needs a fresh page every
  ``page_size`` tokens).  When decode growth still runs dry, the engine
  preempts the youngest request (``free``, then a re-prefill on
  re-admission).

``free`` is the single teardown path (finish and preemption both land
here); a page returns to the free list only when its refcount reaches
zero, and freeing an unknown rid raises — a double free is a structural
error, never silent.
"""

from __future__ import annotations

import numpy as np

__all__ = ["OutOfPages", "PageAllocator"]


class OutOfPages(RuntimeError):
    """The free list cannot satisfy an allocation (caller may preempt)."""


class PageAllocator:
    def __init__(self, n_pages: int, page_size: int, watermark: int = 0):
        if n_pages < 1:
            raise ValueError(f"n_pages must be >= 1, got {n_pages}")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        if not 0 <= watermark < n_pages:
            raise ValueError(
                f"watermark must be in [0, n_pages), got {watermark}"
            )
        self.n_pages = n_pages
        self.page_size = page_size
        self.watermark = watermark
        # pop() takes from the end: keep ids reversed so low pages go first
        self._free = list(range(n_pages - 1, -1, -1))
        self._refs = np.zeros(n_pages, np.int64)
        self._tables: dict[int, list[int]] = {}
        # shared-prefix registry: key -> pinned page ids (one permanent ref
        # each, so the prefix survives with zero active holders)
        self._shared: dict[tuple, list[int]] = {}

    # ---- capacity -------------------------------------------------------
    @property
    def invalid(self) -> int:
        """OOB page sentinel: device scatters drop, gathers clamp+mask."""
        return self.n_pages

    @property
    def n_free(self) -> int:
        return len(self._free)

    def blocks_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)

    def can_admit(self, n_blocks: int) -> bool:
        """Would allocating ``n_blocks`` keep ``watermark`` pages free?"""
        return self.n_free - n_blocks >= self.watermark

    # ---- request tables -------------------------------------------------
    def open_table(self, rid: int) -> None:
        if rid in self._tables:
            raise ValueError(f"request {rid} already holds a page table")
        self._tables[rid] = []

    def n_blocks(self, rid: int) -> int:
        return len(self._tables[rid])

    def grow(self, rid: int, n_blocks_total: int) -> list[int]:
        """Extend ``rid``'s table to ``n_blocks_total`` blocks; atomic —
        raises ``OutOfPages`` without mutating when the free list is
        short.  Returns the newly assigned page ids."""
        table = self._tables[rid]
        need = n_blocks_total - len(table)
        if need <= 0:
            return []
        if need > self.n_free:
            raise OutOfPages(
                f"request {rid} needs {need} page(s), {self.n_free} free"
            )
        fresh = [self._free.pop() for _ in range(need)]
        for p in fresh:
            self._refs[p] = 1
        table.extend(fresh)
        return fresh

    def make_writable(self, rid: int, block_idx: int) -> tuple[int, int | None]:
        """Copy-on-write: return ``(page, copy_src)`` for a block about to
        be written.  Exclusive pages return ``(page, None)``; shared pages
        get a fresh private page and the caller must copy the device data
        from ``copy_src`` into ``page`` before writing."""
        page = self._tables[rid][block_idx]
        if self._refs[page] <= 1:
            return page, None
        if not self._free:
            raise OutOfPages(
                f"copy-on-write for request {rid} block {block_idx}: "
                "no free page"
            )
        fresh = self._free.pop()
        self._refs[fresh] = 1
        self._refs[page] -= 1
        self._tables[rid][block_idx] = fresh
        return fresh, page

    def free(self, rid: int) -> None:
        """Release ``rid``'s pages (finish and preemption both land here).
        Unknown rids raise — a double free is a structural bug."""
        if rid not in self._tables:
            raise KeyError(f"request {rid} holds no page table (double free?)")
        for page in self._tables.pop(rid):
            self._refs[page] -= 1
            if self._refs[page] == 0:
                self._free.append(page)
            elif self._refs[page] < 0:
                raise AssertionError(f"page {page} refcount underflow")

    # ---- prefix sharing -------------------------------------------------
    def register_shared(self, key: tuple, rid: int, n_blocks: int) -> None:
        """Pin the first ``n_blocks`` pages of ``rid``'s table as the
        shared prefix for ``key`` (one permanent ref each, so the prefix
        outlives its prefiller)."""
        if key in self._shared:
            raise ValueError(f"shared prefix {key!r} already registered")
        pages = self._tables[rid][:n_blocks]
        if len(pages) < n_blocks:
            raise ValueError(
                f"request {rid} holds {len(pages)} block(s), "
                f"cannot share {n_blocks}"
            )
        for p in pages:
            self._refs[p] += 1
        self._shared[key] = list(pages)

    def shared_blocks(self, key: tuple) -> int:
        """Block count of a registered prefix (0 when unregistered)."""
        return len(self._shared.get(key, ()))

    def adopt_shared(self, key: tuple, rid: int) -> int:
        """Prepend the shared prefix's pages to ``rid``'s (empty) table
        with a refcount bump; returns the token count they cover."""
        pages = self._shared[key]
        table = self._tables[rid]
        if table:
            raise ValueError(
                f"request {rid} must adopt the shared prefix before "
                "allocating its own pages"
            )
        for p in pages:
            self._refs[p] += 1
        table.extend(pages)
        return len(pages) * self.page_size

    # ---- device view ----------------------------------------------------
    def table_array(self, lane_rids, max_blocks: int) -> np.ndarray:
        """(n_lanes, max_blocks) int32 device page table; empty lanes and
        unallocated blocks carry the ``invalid`` sentinel."""
        out = np.full((len(lane_rids), max_blocks), self.invalid, np.int32)
        for i, rid in enumerate(lane_rids):
            rid = int(rid)
            if rid >= 0 and rid in self._tables:
                t = self._tables[rid][:max_blocks]
                out[i, : len(t)] = t
        return out

    # ---- invariants -----------------------------------------------------
    def check(self) -> None:
        """Leak/double-free invariant: every page is free XOR referenced,
        and the books balance exactly."""
        free = set(self._free)
        if len(free) != len(self._free):
            raise AssertionError("free list holds duplicate pages")
        held = (self._refs > 0).nonzero()[0]
        if free & set(held.tolist()):
            raise AssertionError("page is both free and referenced")
        if len(free) + len(held) != self.n_pages:
            raise AssertionError(
                f"page leak: {len(free)} free + {len(held)} held "
                f"!= {self.n_pages}"
            )

    def reset(self) -> None:
        """Drop every table, shared pin and ref — a fresh allocator."""
        self._free = list(range(self.n_pages - 1, -1, -1))
        self._refs[:] = 0
        self._tables.clear()
        self._shared.clear()
