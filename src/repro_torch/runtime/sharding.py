"""The Megatron partition conventions of serving-time tensor parallelism.

Counterpart of the reference's ``repro.runtime.sharding`` for its serving
half: ``COL_TOKENS``, ``ROW_TOKENS`` and :func:`linear_partition`, read by
the shard-aware plan search (``tuning``) and by ``runtime.tp_packed``.
Column-parallel linears shard their output dim (each rank owns whole
output channels, no reduction); row-parallel linears shard their
contraction dim and need one reduction a call.  Fused projections
(``wqkv``, ``upgate``) are column-parallel like their parts: fusion
concatenates along the output dim.
"""

from __future__ import annotations

__all__ = ["COL_TOKENS", "ROW_TOKENS", "linear_partition"]

COL_TOKENS = frozenset({
    "wq", "wk", "wv", "wqkv", "up", "gate", "upgate", "in_proj", "wz",
    "wi", "wf", "wo_gate", "lm_head", "x_proj", "dt_proj", "patch_proj",
})
ROW_TOKENS = frozenset({"wo", "down", "out_proj"})


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
