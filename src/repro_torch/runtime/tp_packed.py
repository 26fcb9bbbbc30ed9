"""Tensor-parallel packed serving over ``torch.distributed``.

Counterpart of the reference's ``repro.runtime.tp_packed``, which runs the
same arithmetic under ``shard_map`` in one process.  Here every rank is a
process running the same engine on the same inputs
(``launch.mesh.ServingMesh``); it holds only its shard of each partitioned
packed leaf, and the cross-rank steps are the two collectives of
:func:`all_reduce_sum` and :func:`all_gather_cols`, inside the linears.
Emitted tokens equal the single-device engine's.

The partition follows the Megatron conventions
(``runtime.sharding.linear_partition``): column-parallel linears shard
their output channels and gather them in rank order; row-parallel linears
shard the contraction axis and reduce once a call.  Where the row
reduction happens is the invariant (DESIGN.md §4, "the packed-word
reduction invariant"): for packed plans it runs in **int32 packed-word
space**.  Each rank accumulates its pair products into packed partial
words, an int32 ``all_reduce`` adds the words (wrapping addition is
associative and commutative, so the sum is order-independent bit for
bit), and field extraction and correction run once on the summed word.
That is the arithmetic of one device running the widened plan
(``kernels.ref.widen_for_shards``: ``n_shards * n_pairs`` products a
group), so a row sharding is legal exactly when the widened spec can be
constructed; the build re-proves it with ``analysis.verify.certify_spec``.

Bit-identity per path:

* **row, proven-exact plans** (a ``w_f32`` leaf): the activation row is
  quantized whole (its scale sees every channel), each rank contracts its
  K slice in an f32 GEMM and an f32 ``all_reduce`` adds the slices; every
  partial sum is an integer below 2**24, so the sum is exact in any order;
* **row, word path** (mr and overpacked plans): the int32 word sum above;
  mr contamination residues are summed the same way and masked once
  (``(a mod r + b mod r) mod r == (a + b) mod r``);
* **col**: each rank runs the single-device arithmetic on its own output
  channels and the outputs are gathered in rank order.

Float leaves (``native``, ``int8``, ``dsp_packed``) replicate: f32
reductions are not associative, and packed integer arithmetic is what
makes tensor-parallel decode exact.  No CUDA kernel has a cross-rank
reduction stage, so tensor-parallel serving runs the plain versions
(``use_kernel=False``), as the reference runs its jnp paths.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..core.packed_params import DspTunedLeaf, is_dsp_tuned_leaf, is_packed_leaf
from ..core.quantize import quantize_unsigned
from ..kernels import ops, ref
from .sharding import linear_partition

__all__ = ["TpLinear", "shard_params_tp", "shard_leaf", "apply_tp_linear",
           "all_reduce_sum", "all_gather_cols"]


class TpLinear:
    """A mesh-partitioned serving linear: one quantized weight leaf (a
    ``DspTunedLeaf`` or an int4 ``{"packed", "scale", "w_f32"}`` dict)
    holding this rank's shard, with its partition ``kind``, the mesh, the
    shard count and the mesh axis.  ``core.packed_linear.apply_linear``
    sends wrapped leaves to :func:`apply_tp_linear`."""

    def __init__(self, inner, *, kind: str, mesh, n_shards: int,
                 axis: str = "model"):
        if kind not in ("col", "row"):
            raise ValueError(f"kind {kind!r} not in ('col', 'row')")
        self.inner = inner
        self.kind = kind
        self.mesh = mesh
        self.n_shards = n_shards
        self.axis = axis


# ---- the collectives ------------------------------------------------------


def all_reduce_sum(t: torch.Tensor, mesh) -> torch.Tensor:
    """The elementwise sum of ``t`` over the mesh's ranks, on every rank
    (int32 wraps like int32)."""
    buf = t.contiguous()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=mesh.group)
    return buf


def all_gather_cols(t: torch.Tensor, mesh) -> torch.Tensor:
    """Every rank's ``t`` joined along dim 1 in rank order, on every rank."""
    src = t.contiguous()
    parts = [torch.empty_like(src) for _ in range(mesh.n_shards)]
    dist.all_gather(parts, src, group=mesh.group)
    return torch.cat(parts, dim=1)


# ---- wrapping (engine build) ----------------------------------------------


def _shard(t: torch.Tensor | None, dim: int, rank: int, n_shards: int):
    """Rank ``rank``'s equal slice of ``t`` along ``dim``, as its own
    storage (the full tensor can be freed)."""
    if t is None:
        return None
    size = t.shape[dim] // n_shards
    return t.narrow(dim, rank * size, size).contiguous()


def _widened_grouping(t: torch.Tensor, S: int, chunk_axis: int,
                      pairs_axis: int) -> torch.Tensor:
    """Regroup packed per-chunk operands onto the widened chunk grid.

    ``ref.pack_weight_words`` lays pair words out as (..., n_chunks,
    n_pairs, ...); the widened plan's extraction group is ``S``
    consecutive local chunks, so after zero-padding the chunk axis to a
    multiple of ``S`` (zero pairs are bit-transparent) the widened layout
    is a reshape to (..., n_chunks / S, S * n_pairs, ...).  Slice ``d`` of
    the merged pairs axis is local chunk ``c * S + d`` of every widened
    chunk ``c``: each rank owns whole local chunks.
    """
    n_chunks = t.shape[chunk_axis]
    pad = (-n_chunks) % S
    if pad:
        widths = [0, 0] * t.dim()
        widths[2 * (t.dim() - 1 - chunk_axis) + 1] = pad
        t = torch.nn.functional.pad(t, widths)
    shape = list(t.shape)
    shape[chunk_axis] = (n_chunks + pad) // S
    shape[pairs_axis] = S * shape[pairs_axis]
    return t.reshape(shape)


def _with(leaf: DspTunedLeaf, **fields) -> DspTunedLeaf:
    """A copy of ``leaf`` with ``fields`` replaced (nothing requantized)."""
    new = object.__new__(DspTunedLeaf)
    new.__dict__.update(leaf.__dict__)
    new.__dict__.update(fields)
    return new


def _wrap_tuned(leaf: DspTunedLeaf, path: str, mesh, S: int, axis: str):
    from ..analysis.verify import certify_spec

    kind = linear_partition(path)
    if kind is None or leaf.words is None:
        # an unnamed role, or a storage-only (prepack=False) leaf whose
        # apply path repacks per call: replicate
        return leaf
    r = mesh.rank
    if kind == "col":
        if leaf.scale.shape[-1] % S:
            return leaf  # replicate, as the reference's fallback
        last = lambda t: _shard(t, -1, r, S)
        new = _with(leaf, payload=last(leaf.payload), scale=last(leaf.scale),
                    words=last(leaf.words), wsc=last(leaf.wsc),
                    zp_row=last(leaf.zp_row), w_f32=last(leaf.w_f32))
        return TpLinear(new, kind="col", mesh=mesh, n_shards=S, axis=axis)

    # row: the cross-rank sum accumulates S shards' pair products in one
    # packed word before extraction, legal iff the widened spec exists;
    # widen_for_shards raises the constructor's clause-citing error
    try:
        wide = ref.widen_for_shards(leaf.spec, S)
    except ValueError as e:
        raise ValueError(f"illegal row sharding for {path!r}: {e}") from e
    certify_spec(wide)
    npair = leaf.spec.n_pairs
    words = _widened_grouping(leaf.words, S, leaf.words.dim() - 3, leaf.words.dim() - 2)
    words = words.narrow(-2, r * npair, npair).contiguous()
    wsc = None
    if leaf.wsc is not None:
        wsc = _widened_grouping(leaf.wsc, S, leaf.wsc.dim() - 4, leaf.wsc.dim() - 3)
        wsc = wsc.narrow(-3, r * npair, npair).contiguous()
    w_f32 = leaf.w_f32
    if w_f32 is not None:
        # ragged K: serve the word path instead
        w_f32 = None if w_f32.shape[-2] % S else _shard(w_f32, -2, r, S)
    new = _with(leaf, words=words, wsc=wsc, w_f32=w_f32)
    return TpLinear(new, kind="row", mesh=mesh, n_shards=S, axis=axis)


def _wrap_int4(leaf: dict, path: str, mesh, S: int, axis: str):
    kind = linear_partition(path)
    w_f32 = leaf.get("w_f32")
    if kind is None or w_f32 is None:
        # the nibble-unpacking path quantizes per call: replicate
        return leaf
    r = mesh.rank
    if kind == "col":
        if leaf["scale"].shape[-1] % S:
            return leaf
        new = {k: _shard(leaf[k], -1, r, S) for k in ("packed", "scale", "w_f32")}
        return TpLinear(new, kind="col", mesh=mesh, n_shards=S, axis=axis)
    if w_f32.shape[-2] % S:
        return leaf
    new = {"packed": leaf["packed"], "scale": leaf["scale"],
           "w_f32": _shard(w_f32, -2, r, S)}
    return TpLinear(new, kind="row", mesh=mesh, n_shards=S, axis=axis)


def shard_leaf(leaf, path: str, mesh, axis: str = "model"):
    """One quantized leaf at tree path ``path`` as :class:`TpLinear` over
    ``mesh`` (this rank's shard), or unchanged where it replicates."""
    S = mesh.n_shards
    if S == 1:
        return leaf
    if is_dsp_tuned_leaf(leaf):
        return _wrap_tuned(leaf, path, mesh, S, axis)
    if is_packed_leaf(leaf):
        return _wrap_int4(leaf, path, mesh, S, axis)
    return leaf


def shard_params_tp(params, mesh, *, axis: str = "model", use_kernel: bool = False):
    """Partition a quantized serving tree over ``mesh``'s ``axis``.

    Walks the tree (lists add no path component), classifies each packed
    linear by ``linear_partition`` of its path and keeps this rank's shard
    of it in a :class:`TpLinear`; leaves the conventions do not name, and
    float leaves, replicate.  Raises the clause-citing ``ValueError`` for
    a row sharding whose widened accumulation would overflow, naming the
    leaf.  ``use_kernel=True`` at more than one shard is rejected: no CUDA
    kernel has a cross-rank reduction stage.
    """
    S = mesh.shape[axis]
    if S > 1 and use_kernel:
        raise ValueError(
            "tensor-parallel packed serving (tp > 1) runs the plain "
            "versions; use_kernel=True is not supported"
        )
    if S == 1:
        return params

    def walk(tree, path=""):
        if isinstance(tree, list):
            return [walk(v, path) for v in tree]
        if isinstance(tree, dict) and not is_packed_leaf(tree):
            return {k: walk(v, f"{path}/{k}") for k, v in tree.items()}
        return shard_leaf(tree, path, mesh, axis)

    return walk(params)


# ---- apply (decode / prefill) ---------------------------------------------


def _k_slice(q: torch.Tensor, mesh, k: int) -> torch.Tensor:
    """This rank's ``k`` contraction columns of the whole-row ``q``."""
    return q[:, mesh.rank * k:(mesh.rank + 1) * k]


def _tuned_col(w: TpLinear, x: torch.Tensor) -> torch.Tensor:
    lf = w.inner
    local = ops.dsp_tuned_matmul_prepacked_f32(
        x, lf.words, lf.wsc, lf.zp_row, lf.scale, lf.w_f32, lf.spec,
        use_kernel=False, exact_f32=lf.w_f32 is not None,
    )
    return all_gather_cols(local, w.mesh)


def _tuned_row(w: TpLinear, x: torch.Tensor) -> torch.Tensor:
    lf = w.inner
    spec = lf.spec
    S = w.n_shards
    if lf.w_f32 is not None:
        # exact-f32 path: quantize the whole activation row (the per-row
        # scale sees every channel, as on one device), contract this
        # rank's K slice, sum in f32: exact, every partial sum being an
        # integer below 2**24 (the prepack's mantissa bound)
        ops.pin_full_f32()
        zp = 1 << (spec.bits_a - 1)
        x_scale = ops._row_scale(x, zp - 1)
        q = torch.round(x / x_scale) + zp
        acc = all_reduce_sum(_k_slice(q, w.mesh, lf.w_f32.shape[0]) @ lf.w_f32, w.mesh)
        acc = acc - lf.zp_row.to(torch.float32)[None, :]
        return acc * x_scale * lf.scale

    # packed-word path (mr and overpacked plans)
    xq = quantize_unsigned(x, bits=spec.bits_a, axis=-1)
    acc = _row_words(w, xq.values) - lf.zp_row[None, :]
    return acc.to(torch.float32) * xq.scale * lf.scale


def _row_words(w: TpLinear, x_u: torch.Tensor) -> torch.Tensor:
    """The row word path's int32 product of unsigned activations ``x_u``
    (m, K) and the whole (unsharded) weight, on every rank: the sum runs
    on int32 packed words before extraction, the widened-spec arithmetic
    the build certified."""
    lf = w.inner
    spec = lf.spec
    S = w.n_shards
    c, npair, n = lf.words.shape  # this rank's slice of every widened chunk
    kw = c * S * spec.chunk       # the widened chunk grid
    x_u = x_u.to(torch.int32)
    pad = kw - x_u.shape[1]
    if pad:
        x_u = torch.nn.functional.pad(x_u, (0, pad))
    m = x_u.shape[0]
    mine = slice(w.mesh.rank * npair, (w.mesh.rank + 1) * npair)
    acc = torch.zeros((m, n), dtype=torch.int32, device=x_u.device)
    for j in range(spec.n_columns):
        xa = ref.slice_column(x_u, spec, j).reshape(m, kw // 2, 2)
        a_words = (xa[:, :, 0] + (xa[:, :, 1] << spec.p)).reshape(m, c, S * npair)
        partial = ref.int_dot(a_words[:, :, mine].permute(1, 0, 2), lf.words)
        # int32 wrapping addition is associative and commutative: the
        # summed word is the one a device accumulating all S * n_pairs
        # products holds (the widened spec's word)
        partial = all_reduce_sum(partial, w.mesh)
        contam = None
        if spec.uses_mr:
            xa_l = xa.reshape(m, c, S * npair, 2)[:, :, mine]
            # residues mod 2**mr_bits compose across ranks: sum the masked
            # local terms, mask once
            contam = all_reduce_sum(ref.contamination_terms(xa_l, lf.wsc, spec),
                                    w.mesh) & ref.contamination_mask(spec)
        # extraction reads p, the extract width and the correction, which
        # the local and widened specs share
        field = ref.extract_accumulated_field(partial, spec, contam)
        col = field.sum(dim=0, dtype=torch.int64).to(torch.int32)
        shift = spec.column_shift(j)
        acc = acc + (col << shift if shift else col)
    return acc


def _int4_col(w: TpLinear, x: torch.Tensor) -> torch.Tensor:
    d = w.inner
    return all_gather_cols(ops.int4_prepacked_matmul_f32(x, d["w_f32"], d["scale"]),
                           w.mesh)


def _int4_row(w: TpLinear, x: torch.Tensor) -> torch.Tensor:
    # ops.int4_prepacked_matmul_f32 with the contraction split over ranks
    d = w.inner
    ops.pin_full_f32()
    scale = ops._row_scale(x, 127)
    q = torch.round(x / scale)
    acc = all_reduce_sum(_k_slice(q, w.mesh, d["w_f32"].shape[0]) @ d["w_f32"], w.mesh)
    return acc * scale * d["scale"]


def apply_tp_linear(w: TpLinear, x: torch.Tensor, quant_spec) -> torch.Tensor:
    """Serve one wrapped linear: (m, d_in) f32 -> (m, d_out) f32 on every
    rank, with the quantize recipes and scales of ``apply_linear``'s
    packed branches and the contraction reduced across the mesh.  The
    reference pins its input replicated here (``with_sharding_constraint``)
    so that XLA does not partition the upstream math; every rank of the
    port already holds the whole activation, so nothing is pinned."""
    if getattr(quant_spec, "use_kernel", False):
        raise ValueError(
            "tensor-parallel serving runs the plain versions; use_kernel=True "
            "is rejected at engine build"
        )
    if is_dsp_tuned_leaf(w.inner):
        return _tuned_col(w, x) if w.kind == "col" else _tuned_row(w, x)
    return _int4_col(w, x) if w.kind == "col" else _int4_row(w, x)
