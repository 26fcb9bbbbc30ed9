"""Multi-pod dry run: one rank's step on the meta device, every
(arch × shape × mesh) cell.

Counterpart of the reference's ``repro.launch.dryrun``, which lowers and
compiles each cell on 256 or 512 placeholder host devices and reads XLA's
``memory_analysis``, ``cost_analysis`` and the collectives in the HLO.
torch has no counterpart to that, so the port runs **one rank's step on
meta tensors**, seen from rank 0 of the production mesh, and counts what
that rank would hold, compute and move.  It never touches a device: the
meta device is its placeholder devices, and :class:`DryRunMesh` stands in
for ``launch.mesh.TrainingMesh`` without a process group.  Nothing here
sets ``XLA_FLAGS`` or starts a rank.

What a cell's record holds (``artifacts/dryrun/<arch>__<shape>__<mesh>
[__variant].json``, the reference's keys):

* ``flops``: the matmul and attention FLOPs of the full-depth step, as
  ``torch.utils.flop_counter.FlopCounterMode`` counts them
  (``flops_basis: "matmul"``).  XLA's ``cost_analysis`` also counts
  elementwise FLOPs, so the two are not the same number.
  ``scan_body``'s ``flops_1g``/``flops_2g`` come from the unrolled one-
  and two-group models (``depth_groups``); the full depth equals
  ``f1 + (G-1)(f2-f1)``, which the reference must extrapolate (XLA counts
  a scan body once) and the port counts directly.
* ``collectives``: the result bytes of every collective the rank's step
  calls through the mesh, under the reference's keys (``all-gather``,
  ``all-reduce``, ``collective-permute`` for the pipeline's hops, and
  ``total``; the port issues no ``reduce-scatter`` or ``all-to-all``).
* ``memory``: ``argument_size_in_bytes`` (rank 0's state shards, by
  ``runtime.sharding.param_shardings``; the batch as the port's steps take
  it, whole: the train and prefill steps cut their rows by ``batch_pspec``
  inside, the serve step decodes the whole batch; the decode cache's
  shards by ``cache_pspec``), ``output_size_in_bytes``,
  ``alias_size_in_bytes`` (the donated state or cache) and
  ``temp_size_in_bytes``: the peak of the bytes the step made and still
  holds (:class:`_LiveBytes`).  ``bytes_accessed`` is None: nothing here
  counts it.
* ``moe_rows: "capacity"`` for an arch with experts: the dispatch sizes an
  expert's rows from data, which meta tensors lack, so each expert runs
  ``min(cap, T·k)`` rows, the reference's ``E × cap`` buffers, which XLA
  counts.

**Stand-ins.**  Meta tensors carry no data, and a Python loop over a
32k-token sequence would dominate a cell, so :func:`measure` installs four
stand-ins in the model code for the step alone (:func:`meta_stand_ins`):
``models.moe._dispatch`` runs each expert at its capacity (``moe_rows``);
Mamba's in-chunk scan and sLSTM's recurrence run as one elementwise op
over the tokens, of the same shapes; mLSTM's chunk loop runs as at most
three calls, the middle chunks as rows of one batch.  The matmul FLOPs,
forward and backward, are the loops' (``tests/test_torch_dryrun.py`` holds
them to it); the peak bytes of an mLSTM forward without autograd are then
those of every middle chunk at once.  A stand-in raises on a tensor that
is not on the meta device.

**Where the port departs from the reference's accounting.**  Along
"model" the port computes in full on each rank (ROADMAP §2, item 12): the
state keeps the reference's placement, but every rank gathers each
group's whole weights and runs its batch shard with them.  A per-device
FLOP count along "model" is therefore not divided the way the reference's
is, and the gathers show up as ``all-gather`` bytes and temp.  Under a
mesh the port's serve step decodes the whole batch on the whole cache, so
a decode cell gathers its cache shards whole before the step.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-110b \\
      --shape train_4k [--multi-pod] [--smoke] [--variant V] [--all]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --packed-tp 8
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import itertools
import json
import math
import os
import sys
import time
import traceback
import weakref
from typing import Any, Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from ..models import moe, ssm
from ..models import transformer as T
from ..models.registry import get_config, list_archs
from ..optim.adamw import AdamWConfig, adamw_init
from ..runtime.sharding import NamedSharding, cache_pspec, param_shardings
from ..tree import keyed_leaves, tree_leaves, tree_map
from .mesh import TrainingMesh, production_mesh_shape
from .shapes import SHAPES, ShapeSpec, cache_specs, input_specs, supported
from .steps import make_prefill_step, make_serve_step, make_train_step

__all__ = ["COLLECTIVES", "DryRunMesh", "Lowered", "PACKED_TP_ARCHS", "VARIANTS",
           "lower_cell", "main", "measure", "meta_stand_ins", "packed_tp_projection",
           "run_cell"]

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class DryRunMesh(TrainingMesh):
    """A ``TrainingMesh`` seen from rank 0, with no process group.

    It has the axes, shape, size and coordinates of the real mesh, and its
    collectives return what they would return without moving anything:
    ``all_gather`` a meta tensor of the gathered shape, ``all_reduce`` and
    ``broadcast`` their argument.  Each call over more than one rank adds
    its result bytes to :attr:`collectives` under the reference's key
    (the reference's ``collective_bytes`` counts result bytes).  In place
    of a process group, :meth:`group` and :meth:`subgroups` hand out the
    key a broadcast over that group counts under: over an axis (the
    pipeline's last stage to the pod) the reference's ``all-reduce``,
    between two stages its ``collective-permute``."""

    def __init__(self, shape: tuple[int, ...], axis_names: tuple[str, ...] = ("data", "model")):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} for axes {axis_names}")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(axis_names, shape))
        self.size = math.prod(shape)
        self.rank = 0
        self.coord = self.coords(0)
        self.collectives = dict.fromkeys(COLLECTIVES, 0)

    def _ranks(self, axes) -> int:
        return math.prod(self.shape[a] for a in axes)

    def _record(self, kind: str, t: torch.Tensor) -> None:
        self.collectives[kind] += _nbytes(t)

    def group(self, axes) -> tuple | None:
        """``("all-reduce", members)``: the members rank 0's group would
        have; None where the axes hold one rank."""
        if self._ranks(axes) == 1:
            return None
        others = {a: c for a, c in self.coord.items() if a not in axes}
        members = sorted(self.rank_of({**others, **dict(zip(axes, c))})
                         for c in itertools.product(*(range(self.shape[a]) for a in axes)))
        return "all-reduce", members

    def all_gather(self, t: torch.Tensor, axes: tuple[str, ...], dim: int) -> torch.Tensor:
        n = self._ranks(axes)
        if n == 1:
            return t
        shape = list(t.shape)
        shape[dim] *= n
        out = torch.empty(shape, dtype=t.dtype, device="meta")
        self._record("all-gather", out)
        return out

    def all_reduce(self, t: torch.Tensor, axes, op: str = "sum") -> torch.Tensor:
        if self._ranks(axes) > 1:
            self._record("all-reduce", t)
        return t

    def broadcast(self, t: torch.Tensor, src: int, group: str) -> torch.Tensor:
        self._record(group, t)
        return t

    def subgroups(self, member_lists: list[list[int]]) -> list:
        return ["collective-permute"] * len(member_lists)

    def barrier(self) -> None:
        pass

    def __repr__(self) -> str:
        return f"DryRunMesh({self.shape})"


class _LiveBytes(TorchDispatchMode):
    """The bytes of every tensor an op makes (not a view, not written into
    an input's storage) while the mode is on, each freed when its tensor
    is (``weakref.finalize``); :attr:`peak` is the most held at once."""

    def __init__(self):
        super().__init__()
        self.live = self.peak = 0

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        seen = {t.untyped_storage()._cdata for t in tree_flatten((args, kwargs))[0]
                if isinstance(t, torch.Tensor)}
        for t in tree_flatten(out)[0]:
            if not isinstance(t, torch.Tensor) or t._is_view():
                continue
            key = t.untyped_storage()._cdata
            if key in seen:
                continue
            seen.add(key)
            n = t.untyped_storage().nbytes()
            self.live += n
            weakref.finalize(t, self._free, n)
        self.peak = max(self.peak, self.live)
        return out


def _meta_only(t: torch.Tensor) -> None:
    if not t.is_meta:
        raise ValueError(f"the dry run's stand-ins take meta tensors, not {t.device} ones")


def _meta_dispatch(flat_e: torch.Tensor, e: int, cap: int, mesh) -> tuple:
    """``moe._dispatch`` on meta: every expert at its capacity; under a mesh
    the all-gather of the counts is issued, as on the card."""
    _meta_only(flat_e)
    order = torch.argsort(flat_e, stable=True)
    if mesh is not None:
        moe._lower_counts(mesh, flat_e.new_empty(e))
    return order, [0] * e, [min(cap, flat_e.numel())] * e


def _meta_mamba_chunk(h: torch.Tensor, a: torch.Tensor, dt_c, b_c, c_c, u_c):
    """``ssm._mamba_chunk`` with its per-token recurrence as one op."""
    _meta_only(h)
    decay = torch.exp(dt_c[..., None] * a[None, None])          # (B, C, di, ds)
    drive = (dt_c * u_c)[..., None] * b_c[:, :, None, :]         # (B, C, di, ds)
    h_t = decay * h[:, None] + drive
    return h_t[:, -1], torch.einsum("bcds,bcs->bcd", h_t, c_c)


def _meta_mlstm_scan(carry, q, k, v, ig, lf):
    """``ssm._mlstm_scan`` in at most three ``_mlstm_chunk`` calls: the first
    chunk, the middle ones as rows of the batch each started from the
    first's carry, and the last from the middle's.  Every carry that needs
    a gradient in the loop needs one here, so the FLOPs of the forward and
    of the backward are the loop's."""
    _meta_only(q)
    b, h = q.shape[:2]
    n, cl = ssm._chunks(q.shape[2])

    def part(t, lo: int, hi: int, m: int):  # chunks lo..hi (B, H, ., ...) -> (B·m, H, cl, ...)
        t = t[:, :, lo * cl:hi * cl]
        t = t.reshape(b, h, m, cl, *t.shape[3:]).transpose(1, 2)
        return t.reshape(b * m, h, cl, *t.shape[4:])

    carry, y = ssm._mlstm_chunk(carry, *(part(t, 0, 1, 1) for t in (q, k, v, ig, lf)))
    ys = [y]
    if n > 2:
        m = n - 2
        start = tuple(c.repeat_interleave(m, dim=0) for c in carry)
        new, y = ssm._mlstm_chunk(start, *(part(t, 1, n - 1, m) for t in (q, k, v, ig, lf)))
        ys.append(y.reshape(b, m, h, cl, -1).transpose(1, 2).reshape(b, h, m * cl, -1))
        carry = tuple(c.reshape(b, m, *c.shape[1:])[:, -1] for c in new)
    if n > 1:
        carry, y = ssm._mlstm_chunk(carry, *(part(t, n - 1, n, 1) for t in (q, k, v, ig, lf)))
        ys.append(y)
    return carry, torch.cat(ys, dim=2)


def _meta_slstm_scan(z, ig, fg, og, carry, valid):
    """``ssm._slstm_scan`` with each step's op run once over every token
    (the dry run's steps pass no ``valid``)."""
    _meta_only(z)
    if valid is not None:
        raise ValueError("the dry run's sLSTM stand-in takes no valid mask")
    c, n, m = carry
    logf = -ssm._softplus(-fg)
    m_all = torch.maximum(logf + m[:, None], ig)
    i_s = torch.exp(ig - m_all)
    f_s = torch.exp(logf + m[:, None] - m_all)
    c_all = f_s * c[:, None] + i_s * z
    n_all = f_s * n[:, None] + i_s
    h = og * c_all / torch.clamp_min(n_all, 1.0)
    return h, (c_all[:, -1], n_all[:, -1], m_all[:, -1])


_STAND_INS = ((moe, "_dispatch", _meta_dispatch), (ssm, "_mamba_chunk", _meta_mamba_chunk),
              (ssm, "_mlstm_scan", _meta_mlstm_scan), (ssm, "_slstm_scan", _meta_slstm_scan))


@contextlib.contextmanager
def meta_stand_ins():
    """The stand-ins of the module docstring installed in ``models.moe`` and
    ``models.ssm`` for the block, the originals put back after it."""
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in _STAND_INS]
    for mod, name, fn in _STAND_INS:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


@dataclasses.dataclass
class Lowered:
    """One rank's step with its meta arguments: ``step(*args)``; ``donated``
    indexes the arguments the step updates in place or gives up (the
    reference's ``donate_argnums``)."""

    step: Callable
    args: tuple
    donated: tuple[int, ...]


def _tree_bytes(tree) -> int:
    return sum(_nbytes(t) for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor))


def measure(lowered: Lowered, mesh: DryRunMesh | None, memory: bool = True) -> dict[str, Any]:
    """Run the step once on its meta arguments, under
    :func:`meta_stand_ins`: ``{"flops", "collectives", "memory"}`` (module
    docstring); ``memory=False`` leaves the live bytes untracked (their temp
    reads 0), about half of the two modes' per-op cost."""
    if mesh is not None:
        mesh.collectives = dict.fromkeys(COLLECTIVES, 0)
    arg_bytes = _tree_bytes(lowered.args)
    alias = sum(_tree_bytes(lowered.args[i]) for i in lowered.donated)
    live = _LiveBytes()
    with meta_stand_ins(), FlopCounterMode(display=False) as flops, \
            live if memory else contextlib.nullcontext():
        out = lowered.step(*lowered.args)
        out_bytes = _tree_bytes(out)
        del out
    coll = dict(mesh.collectives) if mesh is not None else dict.fromkeys(COLLECTIVES, 0)
    coll["total"] = sum(coll.values())
    return {
        "flops": int(flops.get_total_flops()),
        "collectives": coll,
        "memory": {"argument_size_in_bytes": arg_bytes, "output_size_in_bytes": out_bytes,
                   "temp_size_in_bytes": live.peak, "alias_size_in_bytes": alias},
    }


VARIANTS = (
    "baseline", "flash", "tp_serve", "int4_serve", "flash_rs", "mb4",
    "flash_mb4", "tp_fix", "tp_fix_flash",
)


def _apply_variant(cfg, variant: str):
    if variant in ("flash", "flash_rs", "tp_fix_flash"):
        return dataclasses.replace(cfg, attention_chunk=1024)
    if variant == "mb4":
        return dataclasses.replace(cfg, remat="full")
    if variant == "flash_mb4":
        return dataclasses.replace(cfg, attention_chunk=1024, remat="full")
    return cfg


def _placed(tree, shardings):
    return tree if shardings is None else tree_map(lambda t, sh: sh.place(t), tree, shardings)


def _cache_shardings(cache, mesh, batch: int):
    """The cache's placement: ``cache_pspec`` at each leaf's reference key
    and stacked shape, less the entries of the stacked list axes (never
    sharded: the group axis leads)."""
    out = tree_map(lambda _: None, cache)
    for path, key, shape, depth, _ in keyed_leaves(cache):
        spec = cache_pspec(mesh, shape, batch, path=key)
        if any(e is not None for e in spec[:depth]):
            raise ValueError(f"{key}: the reference shards a stacked axis ({spec})")
        node = out
        for p in path[:-1]:
            node = node[p]
        node[path[-1]] = NamedSharding(mesh, spec[depth:])
    return out


_PRODUCTION = "production"


def lower_cell(
    arch: str,
    shape_name: str,
    multi_pod: bool,
    smoke: bool = False,
    depth_groups: int | None = None,
    variant: str = "baseline",
    *,
    shape: ShapeSpec | None = None,
    mesh: DryRunMesh | None | str = _PRODUCTION,
    cfg=None,
):
    """Build one rank's step of a cell on meta tensors: ``(Lowered, cfg,
    mesh)``.

    ``depth_groups`` replaces the model with an unrolled ``k``-group-deep
    one (the encoder's depth too), as the reference does; None is the full
    depth.  ``variant`` as the reference's (:data:`VARIANTS`): ``flash``
    chunked attention, ``tp_serve`` serving parameters placed over "model"
    only, ``int4_serve`` those packed to int4 nibbles
    (``quantize_params_for_serving``), ``mb4``/``flash_mb4`` four
    microbatches; ``flash_rs`` is ``flash`` here (the port's gradients
    always land in the parameters' placement).  ``shape``, ``mesh`` (a
    :class:`DryRunMesh`, or None for the mesh-free step) and ``cfg`` (a
    ``ModelConfig`` in place of the registry's) override the cell's."""
    cfg = _apply_variant(cfg if cfg is not None else get_config(arch, smoke=smoke), variant)
    if depth_groups is not None:
        enc = {"n_encoder_layers": depth_groups} if cfg.family == "encdec" else {}
        cfg = dataclasses.replace(cfg, n_layers=depth_groups * cfg.group_size,
                                  scan_layers=False, **enc)
    shape = shape if shape is not None else SHAPES[shape_name]
    ok, reason = supported(cfg, shape)
    if not ok:
        raise ValueError(f"unsupported cell: {reason}")
    if isinstance(mesh, str):
        mesh = DryRunMesh(*production_mesh_shape(multi_pod))
    batch = input_specs(cfg, shape)

    if shape.kind == "train":
        params = T.init_params(cfg, dtype=torch.float32, device="meta")
        p_shard = None if mesh is None else param_shardings(params, mesh)
        params = _placed(params, p_shard)
        state = {"params": params, "opt": adamw_init(params)}
        step = make_train_step(cfg, AdamWConfig(), mesh, grad_shardings=p_shard,
                               microbatches=4 if variant in ("mb4", "flash_mb4") else 1)
        return Lowered(step, (state, batch), (0,)), cfg, mesh

    params = T.init_params(cfg, dtype=torch.bfloat16, device="meta")
    if variant == "int4_serve":
        from ..core.packed_params import quantize_params_for_serving

        params = quantize_params_for_serving(params)
    p_shard = (None if mesh is None else
               param_shardings(params, mesh, serving=variant in ("tp_serve", "int4_serve")))
    params = _placed(params, p_shard)
    if shape.kind == "prefill":
        return Lowered(make_prefill_step(cfg, mesh, p_shard), (params, batch), ()), cfg, mesh

    # decode: the cache's shards, gathered whole for the port's serve step
    cache = cache_specs(cfg, shape)
    c_shard = None if mesh is None else _cache_shardings(cache, mesh, shape.global_batch)
    serve = make_serve_step(cfg, mesh, p_shard)

    def serve_step(params, cache, batch):
        if c_shard is not None:
            cache = tree_map(lambda t, sh: sh.gather(t), cache, c_shard)
        return serve(params, cache, batch)

    return Lowered(serve_step, (params, _placed(cache, c_shard), batch), (1,)), cfg, mesh


def _packing_plan_verdicts(cfg) -> dict:
    """Each packable layer's serving plan and its certificate's verdict,
    from the meta tree's shapes (``tuning.plan_linear_layers`` reads
    shapes only), as ``quantize_for_serving`` would build them."""
    from ..tuning.tuner import plan_linear_layers

    params = T.init_params(cfg, dtype=torch.bfloat16, device="meta")
    out = {}
    for lpath, report in plan_linear_layers(params).items():
        cert = report.certificate
        out[lpath] = {"plan": report.name, "verdict": cert.verdict,
                      "wce_per_extraction": cert.wce_per_extraction}
    return out


def _n_params(cfg) -> int:
    return sum(t.numel() for t in
               tree_leaves(T.init_params(cfg, dtype=torch.float32, device="meta")))


def run_cell(
    arch: str, shape_name: str, multi_pod: bool, out_dir: str,
    smoke: bool = False, variant: str = "baseline",
) -> dict:
    """One cell's record (module docstring), written to ``out_dir``; a
    record already there is returned as it is."""
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    tag = f"{arch}__{shape_name}__{mesh_name}"
    if variant != "baseline":
        tag += f"__{variant}"
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{tag}.json")
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    t0 = time.time()
    record: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_name, "ok": False,
                    "variant": variant}
    try:
        lowered, cfg, mesh = lower_cell(arch, shape_name, multi_pod, smoke, variant=variant)
        t_lower = time.time() - t0
        full = measure(lowered, mesh)
        del lowered
        t_run = time.time() - t0 - t_lower
        # the unrolled 1- and 2-group models (the full model where that is
        # its depth: the same model)
        per_group = [full["flops"] if g == cfg.n_groups else
                     measure(*lower_cell(arch, shape_name, multi_pod, smoke, g,
                                         variant=variant)[::2], memory=False)["flops"]
                     for g in (1, 2)]
        record.update(
            ok=True,
            flops=full["flops"],
            flops_basis="matmul",
            bytes_accessed=None,
            collectives=full["collectives"],
            scan_body={"flops_1g": per_group[0], "flops_2g": per_group[1]},
            memory=full["memory"],
            n_devices=mesh.size,
            n_params=_n_params(cfg),
            lower_s=round(t_lower, 1),
            compile_s=round(t_run, 1),
        )
        if cfg.n_experts:
            record["moe_rows"] = "capacity"
        print(f"[dryrun] {tag}: OK flops/dev={record['flops']:.3e} "
              f"coll={record['collectives']['total']:.3e}B lower={t_lower:.0f}s "
              f"run={t_run:.0f}s", flush=True)
        if variant == "int4_serve":
            try:
                record["packing_plans"] = _packing_plan_verdicts(cfg)
                for lpath, row in sorted(record["packing_plans"].items()):
                    extra = ("" if row["verdict"] == "exact"
                             else f" wce/extraction={row['wce_per_extraction']}")
                    print(f"[dryrun]   {lpath}: {row['plan']} [{row['verdict']}{extra}]",
                          flush=True)
            except Exception as e:  # noqa: BLE001 — a planning failure is recorded beside the cell
                record["packing_plans_error"] = f"{type(e).__name__}: {e}"
                print(f"[dryrun]   packing plans unavailable: {e}", flush=True)
    except Exception as e:  # noqa: BLE001 — the failure is the cell's record
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc()[-2000:]
        print(f"[dryrun] {tag}: FAIL {record['error'][:200]}", flush=True)
    with open(path, "w") as f:
        json.dump(record, f, indent=1)
    return record


PACKED_TP_ARCHS = ("qwen1.5-110b", "dbrx-132b", "jamba-v0.1-52b")


def packed_tp_projection(arch: str, tp: int, smoke: bool = False) -> dict:
    """Per-shard packed-serving memory and interconnect projection, from
    shapes alone (the reference's arithmetic, number for number).

    What ``runtime.tp_packed.shard_params_tp`` would place on each of
    ``tp`` devices, prepacked int32 words plus per-column scales, and what
    one decode step moves, from the meta tree.  A packable path's ``lead``
    is the product of its stacked dims (the port's lists of groups and
    inner stacks, and an expert stack's E), its shape the reference's
    stacked one.  Per (…, K, N) leaf: words ``lead · K/2 · N · 4`` bytes,
    divided by ``tp`` along N (column-parallel) or K (row-parallel) where
    it divides, else replicated; scales ``lead · N · 4`` replicated;
    decode bytes for one row, ``(tp-1)/tp · N·4`` for a column-parallel
    all-gather and ``2·(tp-1)/tp · N·4`` for a row-parallel all-reduce."""
    from ..core.packed_params import iter_packable_weights
    from ..runtime.sharding import linear_partition

    cfg = get_config(arch, smoke=smoke)
    params = T.init_params(cfg, dtype=torch.bfloat16, device="meta")
    stacked = {"/" + key: shape for _, key, shape, _, _ in keyed_leaves(params)}
    rows = {}
    tot_shard = tot_repl = tot_net = 0.0
    for path in dict.fromkeys(p for p, _ in iter_packable_weights(params)):
        shape = stacked[path]
        *lead, k_dim, n_dim = shape
        lead_n = math.prod(lead) if lead else 1
        words = lead_n * (k_dim // 2) * n_dim * 4.0
        scales = lead_n * n_dim * 4.0
        kind = linear_partition(path)
        if kind == "col" and n_dim % tp == 0:
            shard, net = words / tp, (tp - 1) / tp * n_dim * 4.0
        elif kind == "row" and k_dim % tp == 0:
            shard, net = words / tp, 2 * (tp - 1) / tp * n_dim * 4.0
        else:
            kind, shard, net = "replicate", words, 0.0
        rows[path] = {
            "shape": list(shape), "partition": kind,
            "words_bytes_per_shard": shard, "scale_bytes": scales,
            "decode_net_bytes": lead_n * net,
        }
        tot_shard += shard
        tot_repl += scales
        tot_net += lead_n * net
    return {
        "arch": arch, "tp": tp,
        "packed_words_bytes_per_shard": tot_shard,
        "replicated_scale_bytes": tot_repl,
        "decode_step_interconnect_bytes": tot_net,
        "layers": rows,
    }


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true", help="every supported cell")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--variant", default="baseline", choices=list(VARIANTS))
    ap.add_argument("--packed-tp", type=int, default=None, metavar="N",
                    help="project per-shard packed-weight HBM and per-"
                         "decode-step interconnect bytes for an N-way "
                         "tensor-parallel packed engine (shapes only, no "
                         "weights; default archs: " + ", ".join(PACKED_TP_ARCHS) + ")")
    args = ap.parse_args(argv)

    if args.packed_tp is not None:
        archs = [args.arch] if args.arch else list(PACKED_TP_ARCHS)
        for arch in archs:
            rec = packed_tp_projection(arch, args.packed_tp, args.smoke)
            gib = 1 << 30
            print(f"[dryrun] {arch} packed tp={args.packed_tp}: "
                  f"{rec['packed_words_bytes_per_shard'] / gib:.2f} GiB "
                  f"packed words/shard + "
                  f"{rec['replicated_scale_bytes'] / gib:.3f} GiB "
                  f"replicated scales, "
                  f"{rec['decode_step_interconnect_bytes'] / 1e6:.2f} MB "
                  f"interconnect per decode row", flush=True)
            os.makedirs(args.out, exist_ok=True)
            with open(os.path.join(args.out, f"{arch}__packed_tp{args.packed_tp}.json"),
                      "w") as f:
                json.dump(rec, f, indent=1)
        return 0

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    n_fail = 0
    if args.all:
        n_ok = n_skip = 0
        for arch in list_archs():
            cfg = get_config(arch)
            for shape_name, shape in SHAPES.items():
                ok, reason = supported(cfg, shape)
                if not ok:
                    n_skip += 1
                    print(f"[dryrun] {arch}__{shape_name}: SKIP ({reason})", flush=True)
                    continue
                for mp in meshes:
                    rec = run_cell(arch, shape_name, mp, args.out, args.smoke, args.variant)
                    n_ok += rec["ok"]
                    n_fail += not rec["ok"]
        print(f"[dryrun] done: ok={n_ok} fail={n_fail} skipped-cells={n_skip}")
        return 1 if n_fail else 0

    if args.arch is None or args.shape is None:
        ap.error("--arch and --shape (or --all, or --packed-tp)")
    for mp in meshes:
        rec = run_cell(args.arch, args.shape, mp, args.out, args.smoke, args.variant)
        if rec["ok"]:
            print(json.dumps({k: v for k, v in rec.items() if k != "traceback"}, indent=1))
        n_fail += not rec["ok"]
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
