"""Deterministic synthetic LM data pipeline (numpy only: the port's copy of
the reference's ``repro.data.pipeline``, batch for batch bit-identical).

Production posture on 1000+ nodes: each host materializes only its own
shard of the global batch (``host_slice``), the stream is seeded so any
host can reproduce any step's batch independently (no data server round
trips), state is a single ``(seed, step)`` pair that checkpoints with the
model, and a background prefetch thread keeps ``prefetch`` batches ready.

The token stream is a mixture of Zipf-distributed unigrams and seeded
Markov bigram structure, so cross-entropy actually *decreases* under
training (integration tests assert this).
"""

from __future__ import annotations

import dataclasses
import queue
import threading

import numpy as np

__all__ = ["DataConfig", "SyntheticStream"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0
    structure: float = 0.8  # probability of following the bigram chain

    @property
    def host_batch(self) -> int:
        return self.global_batch // self.n_hosts


class SyntheticStream:
    """Stateless-per-step synthetic stream with background prefetch."""

    def __init__(self, cfg: DataConfig, prefetch: int = 2):
        if cfg.global_batch % cfg.n_hosts:
            raise ValueError(f"global batch {cfg.global_batch} does not split "
                             f"over {cfg.n_hosts} hosts")
        self.cfg = cfg
        self._step = 0
        # fixed bigram successor table (the learnable structure)
        rng = np.random.default_rng(cfg.seed ^ 0x5EED)
        self._succ = rng.integers(0, cfg.vocab_size, size=cfg.vocab_size)
        self._queue: queue.Queue = queue.Queue(maxsize=max(prefetch, 1))
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # ---- deterministic batch synthesis --------------------------------
    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step, cfg.host_id))
        b, s = cfg.host_batch, cfg.seq_len
        zipf = rng.zipf(1.3, size=(b, s)).astype(np.int64)
        tokens = np.minimum(zipf, cfg.vocab_size - 1)
        follow = rng.random((b, s)) < cfg.structure
        for t in range(1, s):
            chained = self._succ[tokens[:, t - 1]]
            tokens[:, t] = np.where(follow[:, t], chained, tokens[:, t])
        return {
            "tokens": tokens[:, :-1].astype(np.int32),
            "labels": tokens[:, 1:].astype(np.int32),
        }

    # ---- iterator protocol with prefetch ------------------------------
    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            batch = self.batch_at(step)
            while not self._stop.is_set():
                try:
                    self._queue.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(target=self._worker, daemon=True)
            self._thread.start()
        return self

    def __next__(self):
        if self._thread is None:
            batch = self.batch_at(self._step)
            self._step += 1
            return batch
        step, batch = self._queue.get()
        self._step = step + 1
        return batch

    def __iter__(self):
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)

    # ---- checkpointable state ------------------------------------------
    def state_dict(self) -> dict:
        return {"step": self._step, "seed": self.cfg.seed}

    def load_state_dict(self, state: dict) -> None:
        if state["seed"] != self.cfg.seed:
            raise ValueError(f"data seed mismatch on restore: {state['seed']} "
                             f"saved, {self.cfg.seed} configured")
        self._step = int(state["step"])
