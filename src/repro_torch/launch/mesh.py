"""The serving mesh: the process group that tensor-parallel serving runs over.

Counterpart of the reference's ``launch/mesh.py::make_serving_mesh``.  The
reference is single-controller (one process, a ``(1, tp)`` device mesh);
the port is SPMD over processes on ``torch.distributed``: one process a
rank, every rank running the same engine on the same inputs and holding
its own shard of each partitioned packed leaf (``runtime.tp_packed``).
The launcher starts the ranks and calls :func:`init_serving_world`; an
engine with ``ServeConfig.tp > 1`` then takes :func:`make_serving_mesh`.

Backend rule (:data:`BACKEND_RULE`, :func:`choose_backend`): ``nccl`` when
each rank has a GPU of its own; ``gloo`` when ranks share a GPU (NCCL
refuses two ranks on one device) or run on the CPU.  gloo takes the
serving path's CUDA tensors (``all_reduce`` of int32 and f32,
``all_gather`` of f32) as they are; a collective it refused would raise
its own error at the first call.

Host decisions that read a rank's own clock (deadline sheds, the
governor's slow-step signal) are taken on rank 0 and broadcast as a small
host tensor over :attr:`ServingMesh.control`, a gloo group
(:meth:`ServingMesh.broadcast`).
Every collective carries the timeout given to :func:`init_serving_world`,
so a rank that dies or hangs fails the others instead of blocking them.
"""

from __future__ import annotations

import datetime
import gc
from typing import Any, Callable

import torch
import torch.distributed as dist

__all__ = [
    "BACKEND_RULE",
    "ServingMesh",
    "choose_backend",
    "init_serving_world",
    "make_serving_mesh",
]

BACKEND_RULE = ("nccl when each rank has a GPU of its own; gloo when ranks "
                "share a GPU (NCCL refuses two ranks on one device) or run on "
                "the CPU")

def choose_backend(world_size: int, device: str | torch.device = "cuda") -> str:
    """The backend of :data:`BACKEND_RULE` for ``world_size`` ranks."""
    dev = torch.device(device)
    if dev.type == "cuda" and torch.cuda.device_count() >= world_size:
        return "nccl"
    return "gloo"


def init_serving_world(rank: int, world_size: int, init_method: str = "env://",
                       device: str | torch.device = "cuda",
                       timeout_s: float = 600.0) -> str:
    """Join the process group of ``world_size`` ranks as ``rank`` with the
    backend of :data:`BACKEND_RULE`, make the rank's card current (its own
    under nccl, the shared one under gloo) and return the backend.  ``init_method`` is ``"env://"`` under torchrun,
    else ``tcp://localhost:<port>``; every collective times out after
    ``timeout_s``."""
    backend = choose_backend(world_size, device)
    dev = torch.device(device)
    if dev.type == "cuda":
        # under nccl each rank drives its own card; under gloo they share one
        torch.cuda.set_device(rank if backend == "nccl" else (dev.index or 0))
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    _MESHES.clear()  # meshes of an earlier process group hold its groups
    return backend


class ServingMesh:
    """A ``"model"`` axis of ``n_shards`` ranks, seen from one rank.

    ``group`` is the tensor-parallel process group (None at one shard),
    ``rank`` this process's index in it, ``device`` the rank's device,
    ``backend`` the group's backend.  ``shared_device``: the ranks
    share one card, so engines build their weights one rank at a time
    (:meth:`in_turns`) to keep the card's peak memory to one build.
    """

    def __init__(self, *, group, control, rank: int, n_shards: int,
                 device: torch.device, backend: str | None):
        self.group = group
        self.control = control
        self.rank = rank
        self.n_shards = n_shards
        self.device = device
        self.backend = backend
        self.shared_device = device.type == "cuda" and backend == "gloo"
        self._in_turn = False

    @property
    def shape(self) -> dict[str, int]:
        """Axis sizes, as the reference's mesh reads them."""
        return {"data": 1, "model": self.n_shards}

    def barrier(self) -> None:
        if self.n_shards > 1:
            dist.barrier(group=self.control)

    def broadcast(self, t: torch.Tensor) -> torch.Tensor:
        """Rank 0's host tensor ``t`` on every rank, in place: one
        collective over the control group (identity at one shard).  Every
        rank passes a tensor of the same shape and dtype."""
        if self.n_shards > 1:
            dist.broadcast(t, src=self._global(0), group=self.control)
        return t

    def in_turns(self, fn: Callable[[], Any]) -> Any:
        """``fn()`` on every rank, one rank after the other when the ranks
        share a card (each turn ends by returning its cached blocks to the
        card), at once otherwise.  Nested calls run ``fn`` directly, so a
        caller can make its own allocations inside an engine's turn."""
        if not self.shared_device or self._in_turn:
            return fn()
        out = None
        for turn in range(self.n_shards):
            if turn == self.rank:
                self._in_turn = True
                try:
                    out = fn()
                finally:
                    self._in_turn = False
                    gc.collect()
                    torch.cuda.empty_cache()
            self.barrier()
        return out

    def _global(self, rank: int) -> int:
        return dist.get_global_rank(self.group, rank) if self.group is not None else rank


_MESHES: dict[tuple[int, str], ServingMesh] = {}


def make_serving_mesh(tp: int, device: str | torch.device | None = None) -> ServingMesh:
    """The ``tp``-way serving mesh over the first ``tp`` ranks.

    Raises as the reference does for ``tp < 1`` and when ``tp`` exceeds
    the ranks that were started (one process without a process group is
    one rank).  Every rank of the world must call it at the same point
    (it may create groups); a second call with the same arguments returns
    the same mesh.  Ranks past the first ``tp`` raise: they hold no shard.
    """
    if tp < 1:
        raise ValueError(f"tp must be >= 1, got {tp}")
    world = dist.get_world_size() if dist.is_initialized() else 1
    if tp > world:
        raise ValueError(
            f"tp={tp} exceeds the {world} rank(s) started: launch the ranks "
            f"first (torchrun --nproc-per-node {tp}, or python -m "
            f"repro_torch.launch.serve --tp {tp}, which starts them itself)"
        )
    dev = torch.device(device if device is not None else
                       ("cuda" if torch.cuda.is_available() else "cpu"))
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    key = (tp, str(dev))
    if key in _MESHES:
        return _MESHES[key]
    if tp == 1:
        mesh = ServingMesh(group=None, control=None, rank=0, n_shards=1,
                           device=dev, backend=None)
    else:
        backend = dist.get_backend()
        ranks = list(range(tp))
        group = dist.group.WORLD if tp == world else dist.new_group(ranks)
        control = group if backend == "gloo" else dist.new_group(ranks, backend="gloo")
        rank = dist.get_rank()
        if rank >= tp:
            raise ValueError(f"rank {rank} is not among the first tp={tp} ranks")
        mesh = ServingMesh(group=group, control=control, rank=rank, n_shards=tp,
                           device=dev, backend=backend)
    _MESHES[key] = mesh
    return mesh

