"""Data-parallel replica serving: N engines behind one front.

The port of the reference's ``repro.serving.replica``.  ``n_replicas``
complete engines run side by side and a front routes requests between
them.  Tensor parallelism (``ServeConfig.tp``) splits one engine's weights
over ranks; the two compose: with ``tp > 1`` every replica is a
tensor-parallel engine over the same ``tp`` ranks, and every rank runs
the same front on the same submissions, so every rank routes alike.

Routing is join-shortest-queue and deterministic: a request goes to the
replica with the least load (``queued + running`` from
:meth:`~repro_torch.serving.scheduler.Scheduler.stats`), ties broken by
the lowest replica index, so a replayed trace of submissions lands every
request on the same replica.

The front owns the request-id namespace: callers see *global* rids, the
front keeps the ``global rid -> (replica, local rid)`` mapping and
aggregates per-replica outputs and stats.  Replicas never see each other:
a request lives and dies on the replica it joined.
"""

from __future__ import annotations

from .engine import Engine, ServeConfig
from .sampling import SamplingParams

__all__ = ["ReplicaFront"]


class ReplicaFront:
    """Join-shortest-queue front over ``n_replicas`` serving engines.

    Each replica is built from the same ``(cfg, params, serve_cfg)``
    triple, so all replicas quantize to identical weights and any replica
    emits bit-identical tokens for a given prompt — routing affects
    latency, never content.

    ``engine_cls`` selects the replica engine (``Engine`` or
    ``ContinuousEngine``; both expose the same submit/step/outputs/stats
    surface).
    """

    def __init__(self, cfg, params, serve_cfg: ServeConfig,
                 n_replicas: int = 2, engine_cls=Engine):
        if n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
        self.replicas = [
            engine_cls(cfg, params, serve_cfg) for _ in range(n_replicas)
        ]
        self._route: dict[int, tuple[int, int]] = {}  # grid -> (rep, lrid)
        self._next_rid = 0

    # ---- routing ---------------------------------------------------------
    def _pick(self) -> int:
        """Least-loaded replica index (queued + running), lowest index on
        ties — a pure function of current scheduler stats."""
        loads = [
            (r.scheduler.stats()["queued"] + r.scheduler.stats()["running"], i)
            for i, r in enumerate(self.replicas)
        ]
        return min(loads)[1]

    def submit(self, prompt: list[int], max_new: int | None = None,
               sampling: SamplingParams | None = None, **kw) -> int:
        """Route one request to the least-loaded replica; returns a
        GLOBAL rid (the replica's local rid stays internal)."""
        rep = self._pick()
        lrid = self.replicas[rep].submit(
            prompt, max_new=max_new, sampling=sampling, **kw
        )
        grid = self._next_rid
        self._next_rid += 1
        self._route[grid] = (rep, lrid)
        return grid

    # ---- serving loop ----------------------------------------------------
    def step(self) -> list[int]:
        """Advance every replica that has work; returns the global rids
        finished this step (ascending)."""
        done_local = []
        for i, r in enumerate(self.replicas):
            s = r.scheduler.stats()
            if s["queued"] or s["running"]:
                for lrid in r.step():
                    done_local.append((i, lrid))
        inv = {v: k for k, v in self._route.items()}
        return sorted(inv[t] for t in done_local if t in inv)

    def generate(self, prompts: list[list[int]],
                 max_new: int | None = None) -> dict[int, list[int]]:
        """Serve a batch to completion across all replicas; returns
        ``{global rid: tokens}`` in submission order."""
        grids = [self.submit(p, max_new=max_new) for p in prompts]
        pending = set(grids)
        while pending:
            for g in self.step():
                pending.discard(g)
        return {g: self.outputs[g] for g in grids}

    # ---- aggregation -----------------------------------------------------
    @property
    def outputs(self) -> dict[int, list[int]]:
        """Global-rid view over every replica's emitted tokens."""
        out = {}
        for grid, (rep, lrid) in self._route.items():
            toks = self.replicas[rep].outputs.get(lrid)
            if toks:
                out[grid] = toks
        return out

    def replica_of(self, grid: int) -> int:
        """Which replica a global rid was routed to (for tests/ops)."""
        return self._route[grid][0]

    def stats(self) -> dict:
        """Aggregate counters summed across replicas, plus the full
        per-replica stats under ``"replicas"``."""
        per = [r.stats() for r in self.replicas]
        agg = {
            k: sum(s[k] for s in per)
            for k in ("queued", "running", "finished", "cancelled", "shed",
                      "prefill_tokens", "decode_tokens")
            if all(k in s for s in per)
        }
        agg["n_replicas"] = len(self.replicas)
        agg["replicas"] = per
        return agg
