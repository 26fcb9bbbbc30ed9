"""Fixed-slot batched serving engine.

Counterpart of the reference's ``repro.serving.engine.Engine``: a fixed
pool of ``n_slots`` sequences shares one decode cache; the scheduler admits
queued requests into free slots and finished sequences free them.

* **batched chunked prefill** — admitted prompts are padded onto a shared
  ``(n_slots, prefill_chunk)`` grid and every chunk is one forward call;
  rows not being prefilled are masked out of the cache merge, so
  admission can overlap slots that are mid-decode.  The last prompt
  position's hidden state is gathered per row and the lm_head runs once.
* **decode step** — advances every active slot one token per call, with
  per-row positions so slots sit at different depths.
* **sampling** — greedy or temperature/top-k/top-p per slot
  (``serving.sampling``).

Every family of the registry is served.  The cache holds each slot's
state in row ``slot`` of every leaf: K/V, and the f32 recurrent state of
the ssm and hybrid families, which a prefill chunk advances by each row's
valid tokens only (``valid``), so that chunked prefill equals chunk-1
prefill.  A sliding window (h2o-danube) prefills one token a chunk, as the
reference does.  The encdec decoder runs without an encoder output, as the
reference's engine runs it: its cross-attention is roped self-attention
over each call's tokens, bidirectional inside a prefill chunk, so its
tokens depend on ``prefill_chunk``.

``quant_mode`` selects the weight path (``native`` or its alias
``none``, ``int8``, ``int4_packed``, ``dsp_packed``, ``dsp_tuned``,
``dsp_mixed``), converted once at build
(``core.packed_params.quantize_for_serving``); ``fuse_projections`` first
joins q|k|v and up|gate in the quantized modes
(``core.packed_params.fuse_projection_weights``).  Under ``dsp_tuned`` the
tuner (``tuning.plan_linear_layers``) picks per layer the fastest plan of
``plan_bits`` whose MAE per extraction fits ``error_budget``, ranking
proven-exact plans first off the kernels, as the reference does.  Under
``dsp_mixed`` (or ``plan_bits="auto"``) the sensitivity pass and the
greedy width allocator of ``tuning.mixed`` choose each path's
``(a_bits, w_bits)`` within ``mixed_budget`` and serve it through the
``dsp_tuned`` arithmetic; :attr:`Engine.mixed_allocation` holds the
verdict, and a ``mixed_allocation`` given to the constructor is served as
it is.  With ``plan_db`` the build consults the persisted plan database
first (``tuning.plandb``, ``"tuned"`` and ``"mixed"`` entries) and stores
a cold search back.  :attr:`Engine.plan_table` maps each packable path of
the served (fused) tree to its ``tuning.PlanReport``.  A
``plan_table={path: PackedDotSpec}`` given to the constructor overrides
the ``dsp_tuned`` search (a path absent from it serves
:data:`INT4_EXACT`).  MoE layers dispatch dropless in prefill and decode
(``valid``: the prompt rows of the chunk, the active slots).  Termination
goes through one code path (``_finish_slot``): EOS, per-request
``max_new`` and the cache capacity; :meth:`Engine.cancel` aborts a request
from outside.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque

import numpy as np
import torch

from ..core.packed_params import (
    SERVING_MODES,
    fuse_projection_weights,
    iter_packable_weights,
    quantize_for_serving,
    split_expert_stacks,
)
from ..device import resolve_device
from ..kernels.ref import INT4_EXACT, PackedDotSpec
from ..models import transformer as T
from ..models.config import ModelConfig
from ..tuning import PlanDB, PlanReport, plan_key, plan_linear_layers
from ..tuning.mixed import DEFAULT_WIDTH_CANDIDATES, MixedAllocation, mixed_precision_plan
from ..tuning.plandb import (
    allocation_from_json,
    allocation_to_json,
    report_from_json,
    report_to_json,
)
from ..tuning.tuner import plan_report
from .sampling import SamplingParams, row_seed, sample_tokens
from .scheduler import Scheduler

__all__ = ["ServeConfig", "Engine"]

# reference knobs of later slices: rejected by name while unported
_LATER = {
    "governor": "ROADMAP queue 9 (load policy)",
    "deadline_ms": "ROADMAP queue 9 (load policy)",
    "page_size": "ROADMAP queue 9 (paged continuous serving)",
    "n_pages": "ROADMAP queue 9 (paged continuous serving)",
    "watermark_pages": "ROADMAP queue 9 (paged continuous serving)",
    "tp": "ROADMAP queue 10 (tensor parallelism)",
}


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Everything the engine decides at build time, in one frozen record.

    ``device`` defaults to ``"cuda"`` and ``use_kernel`` (``None``) to
    "the CUDA kernels on a CUDA device".  ``plan_bits``, ``error_budget``
    and ``autotune_plans`` steer the ``dsp_tuned`` plan search (the
    wall-clock sweep times the CUDA kernels' variants on the card);
    ``plan_bits="auto"`` promotes ``dsp_tuned`` to ``dsp_mixed``, whose
    sensitivity pass reads ``width_candidates`` (None: the four default
    pairs), ``calib_tokens`` and ``seed`` and whose allocator spends
    ``mixed_budget``; ``plan_db`` names a plan-database directory.  The
    reference's governor, tensor parallelism, deadlines and paged-cache
    settings are fields so that a reference configuration reads the same;
    setting one raises, naming the roadmap queue that ports it.
    """

    n_slots: int = 8
    max_len: int = 512
    prefill_chunk: int = 16
    max_new: int = 64          # default per-request budget (submit can override)
    eos_token: int = 1
    quant_mode: str = "native"
    use_kernel: bool | None = None
    prepack: bool = True       # dsp_tuned: build the pair words once
    # quantized modes: "mlp" fuses up|gate at build, "all" (or True) also
    # q|k|v; each output column stays bit-identical
    fuse_projections: bool | str = "none"
    # dsp_tuned plan search: operand widths, MAE-per-extraction budget and
    # the wall-clock sweep of the kernel variants (off: the cost proxy)
    plan_bits: tuple[int, int] | str = (4, 4)
    error_budget: float = 0.5
    autotune_plans: bool = False
    # dsp_mixed: the allocator's model-level budget (added mean logit-KL),
    # the candidate widths (None: tuning.mixed.DEFAULT_WIDTH_CANDIDATES) and
    # calibration tokens per sequence of the sensitivity pass
    mixed_budget: float = 0.05
    width_candidates: tuple[tuple[int, int], ...] | None = None
    calib_tokens: int = 32
    # persisted plan database directory (tuning.plandb); None = always search
    plan_db: str | None = None
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0
    device: str = "cuda"
    governor: bool = False
    deadline_ms: float | None = None
    page_size: int | None = None
    n_pages: int | None = None
    watermark_pages: int | None = None
    tp: int = 1

    def __post_init__(self) -> None:
        for name, queue in _LATER.items():
            default = ServeConfig.__dataclass_fields__[name].default
            if getattr(self, name) != default:
                raise NotImplementedError(
                    f"ServeConfig.{name} is not ported yet: {queue}"
                )
        if self.quant_mode not in SERVING_MODES:
            raise ValueError(
                f"quant_mode {self.quant_mode!r} not in {SERVING_MODES}"
            )
        if self.plan_bits == "auto":
            # "auto" means per-layer width allocation — that is dsp_mixed
            if self.quant_mode == "dsp_tuned":
                object.__setattr__(self, "quant_mode", "dsp_mixed")
            elif self.quant_mode != "dsp_mixed":
                raise ValueError(
                    'plan_bits="auto" needs quant_mode "dsp_tuned" or '
                    f'"dsp_mixed", got {self.quant_mode!r}'
                )
        elif isinstance(self.plan_bits, str):
            raise ValueError(
                f"plan_bits {self.plan_bits!r} must be a (a_bits, w_bits) "
                'pair or "auto"'
            )
        if self.mixed_budget < 0:
            raise ValueError(
                f"mixed_budget must be >= 0, got {self.mixed_budget}"
            )
        if self.quant_mode == "dsp_mixed" and self.autotune_plans:
            # the width allocator selects plans by cost proxy only; a
            # silent no-op here would let the flag lie about what ran
            raise ValueError(
                "autotune_plans is not supported with dsp_mixed: per-layer "
                "width allocation ranks plans by the cost proxy (use "
                "dsp_tuned for wall-clock block sweeps)"
            )
        if self.fuse_projections not in (True, False, "none", "mlp", "all"):
            raise ValueError(
                f"fuse_projections {self.fuse_projections!r} not in "
                "(True, False, 'none', 'mlp', 'all')"
            )
        if self.n_slots < 1 or self.max_len < 1 or self.prefill_chunk < 1:
            raise ValueError("n_slots, max_len and prefill_chunk must be >= 1")


def _tuned_plans(cfg: ModelConfig, params, scfg: ServeConfig, use_kernel: bool,
                 device: torch.device, plan_table):
    """The ``dsp_tuned`` plan table over every packable path of the served
    tree, and the plan database's counters (None without one).  A given
    ``plan_table`` is served as given ({path: PackedDotSpec or PlanReport},
    ``INT4_EXACT`` where a path is absent; MoE experts by their per-expert
    paths) and bypasses the database; otherwise the database is consulted,
    then the tuner searches and the table is stored back (keyed, as the
    reference's, by the tree before the expert split: a per-expert path
    then serves ``INT4_EXACT``, as it does in the reference)."""
    if plan_table is not None:
        def report(plan):
            return plan_report(plan) if isinstance(plan, PackedDotSpec) else plan

        return {p: report(plan_table.get(p, INT4_EXACT))
                for p, _ in iter_packable_weights(split_expert_stacks(params))}, None
    db = key = None
    if scfg.plan_db:
        db = PlanDB(scfg.plan_db)
        key = plan_key(cfg, scfg, params)
        entry = db.get(key)
        if entry is not None and entry.get("kind") == "tuned":
            table = {p: report_from_json(r) for p, r in entry["plans"].items()}
            return table, _db_stats(db, key)
    a_bits, w_bits = scfg.plan_bits
    table = plan_linear_layers(
        params, a_bits=a_bits, w_bits=w_bits, error_budget=scfg.error_budget,
        autotune=scfg.autotune_plans, device=device,
        # off the kernels, proven-exact plans run through the f32-GEMM
        # shortcut: rank those first (see tuning.rank_plans)
        exact_first=not use_kernel,
    )
    if db is not None:
        db.put(key, {"kind": "tuned",
                     "plans": {p: report_to_json(r) for p, r in table.items()}})
    return table, None if db is None else _db_stats(db, key)


def _db_stats(db: PlanDB, key: str) -> dict:
    return {"directory": db.directory, "key": key, "hits": db.n_hits,
            "misses": db.n_misses, "stale": db.n_stale}


def _mixed_allocation(cfg: ModelConfig, params, scfg: ServeConfig, use_kernel: bool,
                      allocation: MixedAllocation | None):
    """The ``dsp_mixed`` allocation over the served tree, and the plan
    database's counters (None without one).  A given ``allocation`` is
    served as given and bypasses the database in both directions;
    otherwise the database is consulted, then the sensitivity pass and the
    allocator run and the allocation is stored back."""
    if allocation is not None:
        return allocation, None
    db = key = None
    if scfg.plan_db:
        db = PlanDB(scfg.plan_db)
        key = plan_key(cfg, scfg, params)
        entry = db.get(key)
        if entry is not None and entry.get("kind") == "mixed":
            return allocation_from_json(entry["allocation"]), _db_stats(db, key)
    # sensitivity pass + greedy width allocation on calibration tokens:
    # per-layer (a_bits, w_bits) under the model-level mixed_budget, every
    # width's plan provably exact
    allocation = mixed_precision_plan(
        params, cfg, mixed_budget=scfg.mixed_budget,
        widths=scfg.width_candidates or DEFAULT_WIDTH_CANDIDATES,
        n_calib_tokens=scfg.calib_tokens, seed=scfg.seed,
        exact_first=not use_kernel,
    )
    if db is not None:
        db.put(key, {"kind": "mixed", "allocation": allocation_to_json(allocation)})
    return allocation, None if db is None else _db_stats(db, key)


def _prepare_serving_params(cfg: ModelConfig, params, scfg: ServeConfig,
                            use_kernel: bool, device: torch.device, plan_table,
                            mixed_allocation=None):
    """Switch the arithmetic mode, fuse same-input projections if asked, run
    the ``dsp_tuned`` plan search or the ``dsp_mixed`` allocation and
    quantize the weights onto the mode.  ``dsp_mixed`` leaves run the
    ``dsp_tuned`` arithmetic, each with its own plan.  Returns ``(cfg,
    params, plan_table, mixed_allocation, plan_db_stats)``."""
    if plan_table is not None and scfg.quant_mode != "dsp_tuned":
        raise ValueError(
            f"plan_table was given but quant_mode is {scfg.quant_mode!r}; "
            "it is only served under 'dsp_tuned'"
        )
    if mixed_allocation is not None and scfg.quant_mode != "dsp_mixed":
        # dropping a caller-measured allocation would silently serve
        # different plans than the caller benchmarked
        raise ValueError(
            "mixed_allocation was given but quant_mode is "
            f"{scfg.quant_mode!r}; it is only served under \"dsp_mixed\""
        )
    if scfg.quant_mode in ("native", "none"):
        return cfg, params, {}, None, None
    linear_mode = "dsp_tuned" if scfg.quant_mode == "dsp_mixed" else scfg.quant_mode
    cfg = dataclasses.replace(
        cfg, quant=dataclasses.replace(
            cfg.quant, mode=linear_mode, use_kernel=use_kernel
        ),
    )
    fuse = scfg.fuse_projections
    if fuse not in (False, "none"):
        params = fuse_projection_weights(params, fuse_attn=fuse in (True, "all"),
                                         fuse_mlp=True)
    table, db_stats = {}, None
    if scfg.quant_mode == "dsp_tuned":
        table, db_stats = _tuned_plans(cfg, params, scfg, use_kernel, device,
                                       plan_table)
    elif scfg.quant_mode == "dsp_mixed":
        mixed_allocation, db_stats = _mixed_allocation(cfg, params, scfg, use_kernel,
                                                       mixed_allocation)
        table = mixed_allocation.plans
    params = quantize_for_serving(
        params, scfg.quant_mode, plans=table, prepack=scfg.prepack,
        use_kernel=use_kernel,
    )
    return cfg, params, table, mixed_allocation, db_stats


def _rows(mask: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """The (n_slots,) ``mask`` shaped to broadcast over ``leaf``'s dim 0."""
    return mask.reshape((-1,) + (1,) * (leaf.dim() - 1))


def _map_cache(fn, *trees):
    """``fn`` over the leaves of one or more caches of the same structure
    (lists of group dicts, inner lists for the recurrent stacks)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _map_cache(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, list):
        return [_map_cache(fn, *items) for items in zip(*trees)]
    return fn(*trees)


class Engine:
    """Fixed-slot batched serving engine.

    :meth:`submit` queues a prompt (``admit=True`` pulls it into a free slot
    at once); :meth:`step` admits what fits, then decodes one token per
    active slot and returns the rids finished this step; :meth:`cancel`
    aborts a queued or running request; tokens are read back from
    :attr:`outputs` or :meth:`drain_stream`, counters via :meth:`stats`;
    :meth:`generate` wraps the loop for batch callers.
    ``params`` must already lie on ``serve_cfg.device``.
    ``mixed_allocation`` (a ``tuning.MixedAllocation``) skips the
    ``dsp_mixed`` sensitivity pass and serves the given per-path plans; its
    paths must match this engine's tree (same fusion settings).
    """

    def __init__(self, cfg: ModelConfig, params, serve_cfg: ServeConfig,
                 plan_table: dict[str, PackedDotSpec | PlanReport] | None = None,
                 mixed_allocation: MixedAllocation | None = None):
        self.device = resolve_device(serve_cfg.device)
        use_kernel = (self.device.type == "cuda" if serve_cfg.use_kernel is None
                      else serve_cfg.use_kernel)
        if use_kernel and self.device.type != "cuda":
            raise ValueError("use_kernel=True runs the CUDA kernels: it needs "
                             "device='cuda'")
        embed = params["embed"]["w"]
        if embed.device.type != self.device.type:
            raise ValueError(f"params lie on {embed.device}, the engine serves "
                             f"on {self.device}")
        self.use_kernel = use_kernel
        (cfg, params, self.plan_table, self.mixed_allocation,
         self.plan_db_stats) = _prepare_serving_params(
            cfg, params, serve_cfg, use_kernel, self.device, plan_table,
            mixed_allocation,
        )
        self.cfg = cfg
        self.params = params
        self.scfg = serve_cfg
        b = serve_cfg.n_slots
        # a sliding window's ring cache takes one position a call: a chunk
        # landing in the ring would overwrite slots that earlier queries of
        # the chunk still read, so sliding windows prefill one token a chunk,
        # as the reference's engine does
        self._chunk = 1 if cfg.sliding_window else max(
            1, min(serve_cfg.prefill_chunk, serve_cfg.max_len))
        # the prefill grid is padded to whole chunks: allocate the cache on
        # the same grid so the last chunk's writes never clamp
        window = -(-serve_cfg.max_len // self._chunk) * self._chunk
        self.cache = T.init_cache(cfg, b, window, device=self.device)
        self.positions = np.zeros(b, np.int64)
        self.active = np.zeros(b, bool)
        self.last_token = np.zeros(b, np.int64)
        self._slot_rid = np.full(b, -1, np.int64)
        self._temperature = np.zeros(b, np.float32)
        self._top_k = np.zeros(b, np.int64)
        self._top_p = np.ones(b, np.float32)
        self.scheduler = Scheduler()
        self._stream: deque[tuple[int, int]] = deque()

    # ---- device steps ---------------------------------------------------
    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _sample(self, logits: torch.Tensor, positions: np.ndarray) -> np.ndarray:
        seeds = [row_seed(self.scfg.seed, int(rid), int(pos)) if t > 0 and rid >= 0
                 else 0
                 for rid, pos, t in zip(self._slot_rid, positions, self._temperature)]
        return sample_tokens(
            logits, seeds, self._tensor(self._temperature),
            self._tensor(self._top_k), self._tensor(self._top_p),
        ).cpu().numpy()

    @staticmethod
    def _merge(cache, new_cache, row_mask: torch.Tensor):
        """Take ``new_cache`` rows where ``row_mask``, ``cache`` elsewhere,
        in every leaf (the slot axis is dim 0 of each)."""
        return _map_cache(lambda old, new: torch.where(_rows(row_mask, old), new, old),
                          cache, new_cache)

    def _prefill_chunk(self, cache, tokens, base: int, row_mask, last_idx,
                       last_hidden):
        """One chunk of batched prefill over positions ``[base, base + C)``;
        collects each admitted row's last-prompt-position hidden state."""
        b, c = tokens.shape
        positions = (base + torch.arange(c, device=self.device))[None].expand(b, c)
        # per-row prefix mask: MoE layers dispatch only the real prompt tokens
        valid = row_mask[:, None] & (positions <= last_idx[:, None])
        hidden, new_cache, _ = T.forward(
            self.params, self.cfg, tokens, positions=positions, cache=cache,
            return_hidden=True, valid=valid,
        )
        cache = self._merge(cache, new_cache, row_mask)
        idx = (last_idx - base).clamp(0, c - 1)
        row_hidden = hidden[torch.arange(b, device=self.device), idx]
        in_chunk = row_mask & (last_idx >= base) & (last_idx < base + c)
        last_hidden = torch.where(in_chunk[:, None],
                                  row_hidden.to(last_hidden.dtype), last_hidden)
        return cache, last_hidden

    def _lm_head(self, hidden: torch.Tensor) -> torch.Tensor:
        """(n_slots, d) hidden -> (n_slots, V) f32 logits (``T.forward``'s head)."""
        if self.cfg.tie_embeddings:
            return hidden.to(torch.float32) @ self.params["embed"]["w"].T.to(torch.float32)
        from ..core.packed_linear import apply_linear

        return apply_linear(self.params["lm_head"], hidden, self.cfg.quant).to(
            torch.float32)

    # ---- request lifecycle ----------------------------------------------
    def submit(self, prompt: list[int], max_new: int | None = None,
               sampling: SamplingParams | None = None,
               admit: bool = True) -> int:
        """Enqueue a request; it is admitted as soon as a slot frees up.
        ``admit=False`` defers admission to the next :meth:`step` so that a
        burst of submissions shares one batched prefill.  Returns the rid."""
        if len(prompt) > self.scfg.max_len:
            raise ValueError(
                f"prompt length {len(prompt)} > max_len ({self.scfg.max_len})"
            )
        if max_new is None:
            max_new = self.scfg.max_new
        if max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {max_new}")
        if sampling is None:
            sampling = SamplingParams(
                self.scfg.temperature, self.scfg.top_k, self.scfg.top_p
            )
        rid = self.scheduler.submit(prompt, max_new, sampling)
        if admit:
            self._admit()
        return rid

    @torch.inference_mode()
    def _admit(self) -> list[int]:
        """Move queued requests into free slots: batched chunked prefill and
        the first-token sample.  Returns rids finished during admission."""
        free = np.flatnonzero(~self.active)
        admitted = self.scheduler.admit(len(free))
        if not admitted:
            return []
        t0 = time.monotonic()
        b, c = self.scfg.n_slots, self._chunk
        lmax = max(len(r.prompt) for r in admitted)
        n_chunks = -(-lmax // c)
        tokens = np.zeros((b, n_chunks * c), np.int64)
        row_mask = np.zeros(b, bool)
        last_idx = np.zeros(b, np.int64)
        for slot, req in zip(free, admitted):
            ln = len(req.prompt)
            tokens[slot, :ln] = req.prompt
            row_mask[slot] = True
            last_idx[slot] = ln - 1
            self.positions[slot] = ln
            self.active[slot] = True
            self._slot_rid[slot] = req.rid
            self._temperature[slot] = req.sampling.temperature
            self._top_k[slot] = req.sampling.top_k
            self._top_p[slot] = req.sampling.top_p

        # a fresh request must not see the previous occupant's KV or
        # recurrent state: its rows of every cache leaf are zeroed
        fresh = self._tensor(row_mask)
        cache = _map_cache(lambda leaf: leaf.masked_fill(_rows(fresh, leaf), 0),
                           self.cache)
        last_hidden = torch.zeros((b, self.cfg.d_model), dtype=T.compute_dtype(self.cfg),
                                  device=self.device)
        last_idx_t = self._tensor(last_idx)
        for ci in range(n_chunks):
            base = ci * c
            # rows whose prompt is already written skip later chunks
            mask_c = self._tensor(row_mask & (last_idx >= base))
            cache, last_hidden = self._prefill_chunk(
                cache, self._tensor(tokens[:, base:base + c]), base, mask_c,
                last_idx_t, last_hidden,
            )
            own_done = [r for r in admitted if (len(r.prompt) - 1) // c == ci]
            if own_done:
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                self.scheduler.note_prefill_done(own_done)
        self.cache = cache
        first = self._sample(self._lm_head(last_hidden), last_idx)
        n_prompt_tokens = sum(len(r.prompt) for r in admitted)
        self.scheduler.note_prefill(n_prompt_tokens, time.monotonic() - t0)
        finished = []
        for slot, req in zip(free, admitted):
            tok = int(first[slot])
            req.tokens.append(tok)
            self._stream.append((req.rid, tok))
            self.last_token[slot] = tok
            rid = self._maybe_finish(slot, tok)
            if rid is not None:
                finished.append(rid)
        return finished

    def _maybe_finish(self, slot: int, tok: int) -> int | None:
        """Single termination path: EOS, per-request budget, cache capacity."""
        req = self.scheduler.requests[int(self._slot_rid[slot])]
        if tok == self.scfg.eos_token:
            return self._finish_slot(slot, "eos")
        if len(req.tokens) >= req.max_new:
            return self._finish_slot(slot, "length")
        # positions[slot] is the next cache write index: the last admissible
        # decode reads position max_len - 1
        if self.positions[slot] >= self.scfg.max_len:
            return self._finish_slot(slot, "length")
        return None

    def _finish_slot(self, slot: int, reason: str) -> int:
        rid = int(self._slot_rid[slot])
        self.active[slot] = False
        self._slot_rid[slot] = -1
        self.scheduler.finish(rid, reason)
        return rid

    def _release_rid(self, rid: int) -> None:
        """Free the slot of a cancelled running request (the scheduler's
        accounting is done by ``Scheduler.cancel``)."""
        for slot in np.flatnonzero(self._slot_rid == rid):
            self.active[slot] = False
            self._slot_rid[slot] = -1

    def cancel(self, rid: int, reason: str = "cancelled") -> None:
        """Abort an unfinished request at once: a queued rid leaves the
        queue without admission, a running rid's slot frees for the next
        admission.  Tokens emitted before stay in :attr:`outputs`."""
        if not self.scheduler.cancel(rid, reason):
            self._release_rid(rid)

    @torch.inference_mode()
    def step(self) -> list[int]:
        """Admit what fits, then advance every active slot one token.
        Returns the rids that finished this step."""
        finished = self._admit()
        if not self.active.any():
            return finished
        t0 = time.monotonic()
        # valid=active: inactive rows neither advance their recurrent state
        # nor reach an MoE expert
        logits, self.cache, _ = T.forward(
            self.params, self.cfg, self._tensor(self.last_token)[:, None],
            positions=self._tensor(self.positions)[:, None], cache=self.cache,
            valid=self._tensor(self.active)[:, None],
        )
        nxt = self._sample(logits[:, -1], self.positions)
        active_slots = np.flatnonzero(self.active)
        self.scheduler.note_decode(len(active_slots), time.monotonic() - t0)
        for slot in active_slots:
            self.positions[slot] += 1
            tok = int(nxt[slot])
            rid_s = int(self._slot_rid[slot])
            self.scheduler.requests[rid_s].tokens.append(tok)
            self._stream.append((rid_s, tok))
            self.last_token[slot] = tok
            rid = self._maybe_finish(slot, tok)
            if rid is not None:
                finished.append(rid)
        return finished

    def generate(self, prompts: list[list[int]], max_new: int | None = None,
                 sampling: SamplingParams | None = None) -> dict[int, list[int]]:
        """Drive a batch of prompts to completion."""
        rids = [self.submit(p, max_new=max_new, sampling=sampling, admit=False)
                for p in prompts]
        per_req = max_new if max_new is not None else self.scfg.max_new
        for _ in range(per_req * len(prompts) + len(prompts) + 1):
            if not (self.active.any() or self.scheduler.n_queued):
                break
            self.step()
        if self.active.any() or self.scheduler.n_queued:
            raise RuntimeError("generate() exceeded its step budget")
        return {r: list(self.scheduler.requests[r].tokens) for r in rids}

    # ---- introspection --------------------------------------------------
    @property
    def outputs(self) -> dict[int, list[int]]:
        """rid -> tokens emitted so far, for every request that produced
        any (finished, running or cancelled)."""
        return {r.rid: r.tokens for r in self.scheduler.requests.values()
                if r.tokens}

    def drain_stream(self) -> list[tuple[int, int]]:
        """Pop every ``(rid, token)`` emitted since the last drain."""
        out = list(self._stream)
        self._stream.clear()
        return out

    @torch.inference_mode()
    def peek_logits(self) -> np.ndarray:
        """(n_slots, V) next-token logits for the current state, without
        advancing it."""
        logits, _, _ = T.forward(
            self.params, self.cfg, self._tensor(self.last_token)[:, None],
            positions=self._tensor(self.positions)[:, None], cache=self.cache,
        )
        return logits[:, -1].to(torch.float32).cpu().numpy()

    def stats(self) -> dict:
        """Scheduler counters: queue depth, per-phase tok/s, TTFT/latency;
        with a plan database also its consultation (``"plan_db"``: hits,
        misses, stale, the key and the directory)."""
        s = self.scheduler.stats()
        if self.plan_db_stats is not None:
            s["plan_db"] = dict(self.plan_db_stats)
        return s
