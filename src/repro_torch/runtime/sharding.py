"""Sharding policy: the reference's placements, realised on ranks.

Counterpart of the reference's ``repro.runtime.sharding``.  The serving
half (PR 25): ``COL_TOKENS``, ``ROW_TOKENS`` and :func:`linear_partition`,
read by the shard-aware plan search (``tuning``) and by
``runtime.tp_packed``.  Column-parallel linears shard their output dim
(each rank owns whole output channels, no reduction); row-parallel linears
shard their contraction dim and need one reduction a call.  Fused
projections (``wqkv``, ``upgate``) are column-parallel like their parts:
fusion concatenates along the output dim.

The training half: :func:`fsdp_axes`, :func:`param_pspec`,
:func:`param_shardings`, :func:`batch_pspec`, :func:`logits_pspec` and
:func:`cache_pspec`, entry for entry the reference's.  A spec is a plain
tuple with one entry per dimension: None, an axis name, or a tuple of
names (the reference's ``PartitionSpec``).  The mesh is read only through
``axis_names`` and ``shape`` (a dict of axis sizes), so these functions
take the reference tests' duck-typed meshes as well as
``launch.mesh.TrainingMesh``.

Mesh axes (``launch.mesh``): single-pod ``(16, 16)`` ``("data",
"model")``, multi-pod ``(2, 16, 16)`` ``("pod", "data", "model")``.
FSDP shards parameters, gradients and optimizer state over the composite
``fsdp`` axis ``("pod", "data")``; Megatron TP puts heads, the FFN's inner
dim, experts and the vocabulary on ``"model"``; the batch goes over fsdp.

:class:`NamedSharding` realises a spec on a ``TrainingMesh``: a rank holds
the slice of a leaf that its coordinates select (:meth:`NamedSharding.place`),
a tuple entry such as ``("pod", "data")`` splitting its dim major to minor
as JAX's ``NamedSharding`` does, and :meth:`NamedSharding.gather` rebuilds
the whole leaf from every rank's slice.  :func:`gather_for_compute` is the
differentiable gather of FSDP: its backward hands each rank its slice of
the gradient, summed over the fsdp ranks only.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..tree import keyed_leaves

__all__ = [
    "COL_TOKENS",
    "ROW_TOKENS",
    "NamedSharding",
    "batch_pspec",
    "cache_pspec",
    "fsdp_axes",
    "gather_for_compute",
    "linear_partition",
    "logits_pspec",
    "param_pspec",
    "param_shardings",
]

COL_TOKENS = frozenset({
    "wq", "wk", "wv", "wqkv", "up", "gate", "upgate", "in_proj", "wz",
    "wi", "wf", "wo_gate", "lm_head", "x_proj", "dt_proj", "patch_proj",
})
ROW_TOKENS = frozenset({"wo", "down", "out_proj"})

Spec = tuple


def linear_partition(path: str) -> str | None:
    """Partition kind of a linear weight's tree path: ``"col"`` (output
    dim sharded), ``"row"`` (contraction dim sharded, a reduction after
    the shard-local matmul) or None (replicated: norms, embeddings, router
    weights and anything the conventions do not name).  Tokens match the
    "/"-split path exactly, never by substring ('groups' must not match
    'up')."""
    tokens = set(path.lower().split("/"))
    if tokens & COL_TOKENS:
        return "col"
    if tokens & ROW_TOKENS:
        return "row"
    return None


# ---- the reference's placement rules (pure functions of path, shape, mesh) ----


def fsdp_axes(mesh) -> tuple[str, ...]:
    """The composite data/FSDP axis: ("pod", "data") when a pod axis exists."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def _divisible(size: int, mesh, axes) -> bool:
    n = 1
    for a in axes if isinstance(axes, tuple) else (axes,):
        n *= mesh.shape[a]
    return size % n == 0


def _fs(mesh):
    fsdp = fsdp_axes(mesh)
    return fsdp if len(fsdp) > 1 else fsdp[0]


def param_pspec(path: str, shape: tuple[int, ...], mesh) -> Spec:
    """One parameter's spec, by its reference path and reference shape
    (stacked axes lead; 2-D weights are (d_in, d_out)).  Megatron TP:
    column-parallel (out dim on "model") for up/QKV, row-parallel (in dim
    on "model") for down/out; the remaining large dim takes FSDP.  The
    reference's substring tests ("norm", "scale", "embed", "/moe/",
    "router") are kept as they are."""
    fs = _fs(mesh)
    name = path.lower()

    def ok(dim_size, axis) -> bool:
        return _divisible(dim_size, mesh, axis)

    # biases / norm scales / small vectors: replicated (possibly stacked)
    if len(shape) <= 1 or name.endswith("/b") or "scale" in name or "norm" in name:
        return (None,) * len(shape)

    ndim = len(shape)
    lead = ndim - 2  # stacked axes (groups, experts, slots...)
    d_in, d_out = shape[-2], shape[-1]
    kind = linear_partition(name)
    col, row = kind == "col", kind == "row"
    if "embed" in name:
        # (vocab, d): vocab on model (vocab-parallel), d on fsdp
        spec: list[Any] = [None] * ndim
        if ok(d_in, "model"):
            spec[-2] = "model"
        if ok(d_out, fs):
            spec[-1] = fs
        return tuple(spec)
    spec = [None] * ndim
    # expert parallelism: the innermost lead axis of a MoE expert stack
    if lead >= 1 and "/moe/" in name and "router" not in name:
        li = lead - 1
        if ok(shape[li], "model") and shape[li] >= 4:
            spec[li] = "model"
            big = -1 if d_out >= d_in else -2
            if ok(shape[big], fs):
                spec[big] = fs
            return tuple(spec)
    if col and ok(d_out, "model"):
        spec[-1] = "model"
        if ok(d_in, fs):
            spec[-2] = fs
    elif row and ok(d_in, "model"):
        spec[-2] = "model"
        if ok(d_out, fs):
            spec[-1] = fs
    else:  # fallback: FSDP the larger dim
        big = -1 if d_out >= d_in else -2
        if ok(shape[big], fs):
            spec[big] = fs
    return tuple(spec)


def _strip(spec: Spec, fsdp: set) -> Spec:
    """``spec`` without the fsdp axes (the serving placement)."""
    def keep(e):
        if e is None:
            return None
        if isinstance(e, tuple):
            kept = tuple(a for a in e if a not in fsdp)
            return kept if kept else None
        return None if e in fsdp else e

    return tuple(keep(e) for e in spec)


def _set(tree: dict, path: tuple, value) -> None:
    for p in path[:-1]:
        tree = tree[p]
    tree[path[-1]] = value


def _skeleton(tree):
    if isinstance(tree, dict):
        return {k: _skeleton(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_skeleton(v) for v in tree]
    return None


def param_shardings(params: Any, mesh, serving: bool = False) -> Any:
    """A port tree of WHOLE leaves (tensors or anything with ``shape``) ->
    the same tree of :class:`NamedSharding`.

    Each leaf's spec is the reference's :func:`param_pspec` at the
    reference's key and shape (the lists of groups stacked in front), less
    the entries of the stacked list axes, which the port does not shard
    (raises where the reference would).  ``serving=True`` strips the fsdp
    axes (parameters replicated over data/pod, sharded over model only):
    decode touches every weight every token."""
    fsdp = set(fsdp_axes(mesh))
    out = _skeleton(params)
    for path, key, shape, depth, _ in keyed_leaves(params):
        spec = param_pspec(key, shape, mesh)
        if serving:
            spec = _strip(spec, fsdp)
        if any(e is not None for e in spec[:depth]):
            raise ValueError(f"{key}: the reference shards a stacked axis ({spec}); the "
                             "port keeps that axis as a list and cannot")
        spec = spec[depth:]
        _set(out, path, NamedSharding(mesh, spec))
    return out


def batch_pspec(mesh, batch: int) -> Spec:
    return (_fs(mesh), None) if _divisible(batch, mesh, fsdp_axes(mesh)) else (None, None)


def logits_pspec(mesh, batch: int) -> Spec:
    b = _fs(mesh) if _divisible(batch, mesh, fsdp_axes(mesh)) else None
    return (b, None, "model")


def cache_pspec(mesh, cache_shape: tuple[int, ...], batch: int, path: str = "attn") -> Spec:
    """Decode caches, in the reference's stacked layout (the group axis
    leads): batch over fsdp when divisible, else the sequence axis
    (batch 1); heads/features over model when divisible.

    attn KV (G, B, S, kv, hd) where ``path`` names 'attn'; state caches
    (G, [stack], B, feat...) otherwise."""
    fsdp = fsdp_axes(mesh)
    fs = _fs(mesh)
    ndim = len(cache_shape)
    spec: list[Any] = [None] * ndim
    batch_ok = _divisible(batch, mesh, fsdp)

    if "attn" in path and ndim == 5:
        if batch_ok:
            spec[1] = fs
        elif _divisible(cache_shape[2], mesh, fsdp):
            spec[2] = fs  # sequence-parallel cache (batch 1)
        if spec[2] is None and _divisible(cache_shape[2], mesh, "model"):
            spec[2] = "model"  # decode KV parallelism over the sequence
        else:
            for feat in (4, 3):  # head_dim first, then kv heads
                if _divisible(cache_shape[feat], mesh, "model") and cache_shape[feat] > 1:
                    spec[feat] = "model"
                    break
        return tuple(spec)

    # state caches: the batch axis found by its size (dim 1 or 2)
    batch_axis = next((i for i in (1, 2) if i < ndim and cache_shape[i] == batch), None)
    if batch_axis is not None and batch_ok:
        spec[batch_axis] = fs
    start = (batch_axis or 0) + 1
    feats = [i for i in range(start, ndim) if spec[i] is None]
    if feats:
        biggest = max(feats, key=lambda i: cache_shape[i])
        if _divisible(cache_shape[biggest], mesh, "model") and cache_shape[biggest] > 1:
            spec[biggest] = "model"
    return tuple(spec)


# ---- realising a spec on the ranks of a TrainingMesh --------------------------


def _axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``jax.sharding.NamedSharding``).

    This rank holds, along each dim with an entry, the part its coordinates
    select: ``n`` equal parts for an entry over axes of ``n`` ranks in all,
    the index the axes' coordinates make, major to minor in the entry's
    order.  A dim must divide by its entry's ranks (the placement rules
    only shard such dims)."""

    mesh: Any
    spec: Spec

    def _parts(self, entry) -> tuple[int, int]:
        """(number of parts, this rank's part) along a dim with ``entry``."""
        n, idx = 1, 0
        for a in _axes(entry):
            n *= self.mesh.shape[a]
            idx = idx * self.mesh.shape[a] + self.mesh.coord[a]
        return n, idx

    @property
    def axes(self) -> set[str]:
        """The mesh axes the spec names."""
        return {a for e in self.spec for a in _axes(e)}

    def shard_shape(self, shape: tuple[int, ...]) -> tuple[int, ...]:
        return tuple(s // self._parts(e)[0] for s, e in zip(shape, self._full(shape)))

    def _full(self, shape) -> Spec:
        if len(self.spec) != len(shape):
            raise ValueError(f"spec {self.spec} for a leaf of shape {tuple(shape)}")
        return self.spec

    def slices(self, shape: tuple[int, ...]) -> tuple[slice, ...]:
        """This rank's index into a whole leaf of ``shape``."""
        out = []
        for size, entry in zip(shape, self._full(shape)):
            n, idx = self._parts(entry)
            if size % n:
                raise ValueError(f"dim of {size} does not split {n} ways ({self.spec})")
            out.append(slice(idx * (size // n), (idx + 1) * (size // n)))
        return tuple(out)

    def place(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's shard of the whole leaf ``full``: a copy that owns
        its memory (``full`` itself where the spec names no axis)."""
        if not self.axes or self.mesh.size == 1:
            return full
        return full[self.slices(full.shape)].clone()

    def owns(self) -> bool:
        """This rank holds the first copy of its shard: its coordinate is 0
        on every axis the spec does not name (a sum over the ranks counts
        each shard once)."""
        named = self.axes
        return all(c == 0 for a, c in self.mesh.coord.items() if a not in named)

    def gather(self, shard: torch.Tensor) -> torch.Tensor:
        """The whole leaf from every rank's shard: one all-gather a dim with
        an entry, over the ranks of the entry's axes (a collective: every
        rank of the mesh calls it)."""
        out = shard
        for dim, entry in enumerate(self._full(shard.shape)):
            if _axes(entry):
                out = self.mesh.all_gather(out, _axes(entry), dim)
        return out


class _GatherForCompute(torch.autograd.Function):
    """Forward: the whole leaf, cast to the compute dtype.  Backward: the
    gradient in the shard's dtype, summed over the fsdp ranks (the ranks
    along "model" computed the same batch, so summing over them would count
    it ``n_model`` times), then this rank's slice of it."""

    @staticmethod
    def forward(ctx, shard, sharding, dtype):
        ctx.sharding = sharding
        ctx.in_dtype = shard.dtype
        full = sharding.gather(shard)
        return full if dtype is None else full.to(dtype)

    @staticmethod
    def backward(ctx, grad):
        sh = ctx.sharding
        g = grad.to(ctx.in_dtype).contiguous()
        g = sh.mesh.all_reduce(g, fsdp_axes(sh.mesh))
        if sh.axes and sh.mesh.size > 1:
            g = g[sh.slices(g.shape)].contiguous()
        return g, None, None


def gather_for_compute(shard: torch.Tensor, sharding: NamedSharding,
                       dtype: torch.dtype | None = None) -> torch.Tensor:
    """The differentiable FSDP gather of one leaf (:class:`_GatherForCompute`);
    ``dtype`` casts the whole leaf as ``launch.steps.cast_for_compute``
    casts: f32 leaves of more than one dimension only."""
    if dtype is not None and not (shard.dtype == torch.float32 and shard.dim() > 1):
        dtype = None
    return _GatherForCompute.apply(shard, sharding, dtype)

