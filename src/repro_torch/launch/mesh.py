"""The meshes: the process groups that serving and training run over.

Counterpart of the reference's ``launch/mesh.py``: :func:`make_serving_mesh`
(tensor-parallel serving) and the training meshes, :func:`make_local_mesh`
and :func:`make_production_mesh` (:class:`TrainingMesh`, below).

The serving mesh.  The
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
import itertools
import math
from typing import Any, Callable

import torch
import torch.distributed as dist

__all__ = [
    "BACKEND_RULE",
    "ServingMesh",
    "TrainingMesh",
    "choose_backend",
    "init_serving_world",
    "make_local_mesh",
    "make_mesh",
    "make_production_mesh",
    "make_serving_mesh",
    "production_mesh_shape",
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
    _TRAINING_MESHES.clear()
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


# ---- the training meshes ------------------------------------------------------


class TrainingMesh:
    """A mesh of ranks with named axes, seen from one rank.

    ``axis_names`` and ``shape`` (axis -> size) are what the reference's
    mesh offers the placement rules (``runtime.sharding``); ``coord`` is
    this rank's index on each axis.  Ranks are laid out row-major over the
    axes, as ``jax.make_mesh`` lays out devices: the last axis varies
    fastest.  The mesh holds one process group for every set of axes of
    more than one rank (the ranks that share this rank's coordinates on
    the other axes), made by every rank at construction, so the "fsdp"
    reductions run over the ranks that share a model coordinate.  One
    process without a process group is a mesh of size 1 whose collectives
    are the identity.  The groups take the backend of the world
    (:data:`BACKEND_RULE`); gloo takes CUDA tensors as they are."""

    def __init__(self, shape: tuple[int, ...], axis_names: tuple[str, ...]):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} for axes {axis_names}")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(axis_names, shape))
        self.size = math.prod(shape)
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        self.coord = self.coords(self.rank)
        self._groups: dict[frozenset, tuple] = {}
        self._extra: dict[tuple, Any] = {}
        if self.size > 1:
            for r in range(1, len(axis_names) + 1):
                for axes in itertools.combinations(axis_names, r):
                    self._make_group(axes)

    def coords(self, rank: int) -> dict[str, int]:
        """The coordinates of global rank ``rank``."""
        out = {}
        for a in reversed(self.axis_names):
            rank, out[a] = divmod(rank, self.shape[a])
        return {a: out[a] for a in self.axis_names}

    def rank_of(self, coord: dict[str, int]) -> int:
        r = 0
        for a in self.axis_names:
            r = r * self.shape[a] + coord[a]
        return r

    def _make_group(self, axes: tuple[str, ...]) -> None:
        """The groups over ``axes``, one for each coordinate of the other
        axes: every rank makes every group, in the same order."""
        if math.prod(self.shape[a] for a in axes) == 1:
            return
        others = [a for a in self.axis_names if a not in axes]
        mine = None
        for fixed in itertools.product(*(range(self.shape[a]) for a in others)):
            base = dict(zip(others, fixed))
            members = sorted(self.rank_of({**base, **dict(zip(axes, c))})
                             for c in itertools.product(*(range(self.shape[a]) for a in axes)))
            group = (dist.group.WORLD if len(members) == dist.get_world_size()
                     else dist.new_group(members))
            if self.rank in members:
                mine = (group, members)
        self._groups[frozenset(axes)] = mine

    def group(self, axes) -> tuple | None:
        """``(process group, its members' global ranks ascending)`` over the
        axes ``axes``; None where they hold one rank."""
        return self._groups.get(frozenset(axes))

    def all_gather(self, t: torch.Tensor, axes: tuple[str, ...], dim: int) -> torch.Tensor:
        """The ranks' ``t`` concatenated along ``dim`` in the order of their
        index over ``axes``, major to minor in the order given."""
        g = self.group(axes)
        if g is None:
            return t
        group, members = g
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in members]
        dist.all_gather(parts, t, group=group)

        def index(r: int) -> int:
            c, i = self.coords(r), 0
            for a in axes:
                i = i * self.shape[a] + c[a]
            return i

        order = sorted(range(len(members)), key=lambda i: index(members[i]))
        return torch.cat([parts[i] for i in order], dim=dim)

    def all_reduce(self, t: torch.Tensor, axes, op: str = "sum") -> torch.Tensor:
        """``t`` reduced (``"sum"`` or ``"max"``) over the ranks of ``axes``,
        in place; returns it."""
        g = self.group(axes)
        if g is not None:
            dist.all_reduce(t, op=dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX,
                            group=g[0])
        return t

    def broadcast(self, t: torch.Tensor, src: int, group) -> torch.Tensor:
        """``t`` broadcast from global rank ``src`` over ``group`` (one of
        :meth:`subgroups`, or the first item of :meth:`group`), in place;
        returns it."""
        dist.broadcast(t, src=src, group=group)
        return t

    def subgroups(self, member_lists: list[list[int]]) -> list:
        """A process group of each list of global ranks, made at the first
        call and kept: every rank of the mesh calls this with the same
        lists in the same order (making a group is collective)."""
        out = []
        for members in member_lists:
            key = tuple(sorted(members))
            if key not in self._extra:
                self._extra[key] = dist.new_group(list(key))
            out.append(self._extra[key])
        return out

    def barrier(self) -> None:
        if self.size > 1:
            dist.barrier()

    def __repr__(self) -> str:
        return f"TrainingMesh({self.shape}, rank {self.rank} at {self.coord})"


_TRAINING_MESHES: dict[tuple, TrainingMesh] = {}


def make_mesh(shape: tuple[int, ...], axis_names: tuple[str, ...]) -> TrainingMesh:
    """The mesh of ``shape`` over the ranks that were started (one process
    without a process group is one rank); raises where their number is
    not the mesh's size.  Every rank calls it at the same point (it makes
    groups); a second call with the same arguments returns the same mesh."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    shape, axis_names = tuple(shape), tuple(axis_names)
    if math.prod(shape) != world:
        raise ValueError(
            f"a {shape} {axis_names} mesh needs {math.prod(shape)} ranks; {world} "
            f"rank(s) were started (torchrun --nproc-per-node {math.prod(shape)})")
    key = (shape, axis_names)
    if key not in _TRAINING_MESHES:
        _TRAINING_MESHES[key] = TrainingMesh(shape, axis_names)
    return _TRAINING_MESHES[key]


def make_local_mesh(data: int | None = None, model: int = 1) -> TrainingMesh:
    """A ``("data", "model")`` mesh over the ranks that were started: all of
    them on "data" unless ``data`` or ``model`` say otherwise."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    data = data if data is not None else max(1, world // model)
    return make_mesh((data, model), ("data", "model"))


def production_mesh_shape(multi_pod: bool = False) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """The production mesh's shape and axes, without a world: (16, 16)
    ("data", "model"), or (2, 16, 16) ("pod", "data", "model") over two
    pods (``launch.dryrun`` lays its meshes out by it)."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False) -> TrainingMesh:
    """16 x 16 = 256 ranks a pod; 2 pods = 512 ranks when ``multi_pod``."""
    shape, axes = production_mesh_shape(multi_pod)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != math.prod(shape):
        raise ValueError(
            f"the production mesh {shape} {axes} needs {math.prod(shape)} ranks; "
            f"{world} rank(s) were started")
    return make_mesh(shape, axes)
