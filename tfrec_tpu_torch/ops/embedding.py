"""Embedding-table primitives: specs, seeded init, the row gather (of one
table, or of many in one launch) and the duplicate-id combine.

The counterpart of ``tfrec_tpu/ops/embedding.py``. The sentinel row id
``vocab`` (one past the end) marks bag padding; ``gather`` clamps it, and
negative ids, to a real row as ``jnp.take(mode="clip")`` does, and callers
mask those rows. ``combine_duplicate_ids`` sums the gradient rows that
share an id before a sparse update. ``run_first_index`` and
``run_last_index_plus1`` bound each element's run of equal values (the
tie spans of ``eval.metrics.auc``). The batched variants of the reference
(``combine_duplicate_ids_grouped`` and ``_multi``) and host-computed sort
orders are not ported (ROADMAP Queue 1 items 2 and 5).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import torch

from tfrec_tpu_torch.kernels.gather_cuda import gather_rows, gather_rows_multi


def run_first_index(x: torch.Tensor) -> torch.Tensor:
    """``searchsorted(x, x, side="left")`` for a 1-D tensor whose equal
    values are contiguous (a sorted one, say): the first index of each
    element's run, int32, as an O(n) ``cummax``. A run of a value elsewhere
    indexes its own run, as in the reference."""
    n = x.shape[0]
    is_start = torch.ones(n, dtype=torch.bool, device=x.device)
    is_start[1:] = x[1:] != x[:-1]
    idx = torch.arange(n, device=x.device)
    return torch.cummax(torch.where(is_start, idx, 0), 0).values.to(torch.int32)


def run_last_index_plus1(x: torch.Tensor) -> torch.Tensor:
    """``searchsorted(x, x, side="right")`` under the contiguity contract of
    ``run_first_index``: one past the last index of each element's run,
    int32 (a reversed ``cummin`` of the run ends)."""
    n = x.shape[0]
    is_end = torch.ones(n, dtype=torch.bool, device=x.device)
    is_end[:-1] = x[1:] != x[:-1]
    idx = torch.arange(n, device=x.device)
    ends = torch.cummin(torch.where(is_end, idx, n - 1).flip(0), 0).values.flip(0)
    return (ends + 1).to(torch.int32)


@dataclasses.dataclass(frozen=True)
class TableSpec:
    """One logical embedding table."""

    name: str
    vocab: int
    dim: int
    # Initializer: "normal" (std = init_scale or 1/sqrt(dim)) | "zeros".
    initializer: str = "normal"
    init_scale: float | None = None

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.vocab, self.dim)


def init_table(
    generator: torch.Generator, spec: TableSpec, device: torch.device | str,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """One table drawn from ``generator``, which must live on ``device``."""
    if spec.initializer == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    scale = spec.init_scale if spec.init_scale is not None else 1.0 / (spec.dim**0.5)
    t = torch.randn(spec.shape, generator=generator, dtype=torch.float32, device=device)
    return t.mul_(scale).to(dtype)


def init_tables(
    generator: torch.Generator, specs: Sequence[TableSpec],
    device: torch.device | str, dtype: torch.dtype = torch.float32,
) -> Dict[str, torch.Tensor]:
    """Tables drawn one after another from one generator. The numbers differ
    from the JAX package's for the same seed; load JAX params through
    ``convert.params_from_jax`` where the two must agree."""
    return {s.name: init_table(generator, s, device, dtype) for s in specs}


def gather(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Row gather ``table[clip(ids, 0, V-1)]``: table [V, D] f32, ids [N]
    int32 -> [N, D]. Launches the CUDA kernel for CUDA tensors."""
    return gather_rows(table, ids)


def gather_many(tables: Sequence[torch.Tensor], ids: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """``gather`` of every (table, ids) pair at once -> one [N_f, D_f] result
    per pair, each a contiguous view of one allocation. On a card it is one
    launch of the CUDA kernel for all of them (per 64 tables)."""
    return gather_rows_multi(tables, ids)


def combine_duplicate_ids(
    ids: torch.Tensor, grads: torch.Tensor, sentinel: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sum gradient rows that share an id, with static output shapes.

    ids [N] int32 (may repeat; negative ids count as the sentinel), grads
    [N, D] f32 aligned with them, ``sentinel`` normally the vocab size ->
    (uids [N] int32, combined [N, D]): slot j < number of distinct ids
    holds the j-th smallest distinct id and the sum of its rows, taken in
    the order of a stable sort of the ids (so in batch order); the other
    slots hold ``sentinel`` and zeros. ``uids`` ascends and each real id
    appears once, as the reference promises its scatters.

    The sums are ``torch.segment_reduce`` over the sorted rows: each output
    element is one sequential pass over its segment in sorted order (one
    thread each on CUDA, a loop on the CPU), with no atomics, so results
    repeat bit for bit on either device (``chip_smoke.py`` checks it on the
    card at the training path's shapes and against the CPU). Neither
    ``index_add_`` (float atomics on CUDA) nor ``index_put_(accumulate=True)``
    (parallel adds on a multi-threaded CPU) repeats. This serves every
    sparse optimizer, not only the fused Adagrad kernel, and keeps that
    kernel's inputs the reference's.
    """
    n = ids.shape[0]
    # Negative ids become the sentinel BEFORE the sort, as in the
    # reference: they are dropped by every update and keep uids ascending.
    ids = torch.where(ids < 0, torch.full_like(ids, sentinel), ids)
    sids, order = torch.sort(ids, stable=True)
    sorted_grads = grads.index_select(0, order)
    starts = torch.ones(n, dtype=torch.int64, device=ids.device)
    if n > 1:
        starts[1:] = (sids[1:] != sids[:-1]).to(torch.int64)
    seg = torch.cumsum(starts, dim=0) - 1  # segment of each sorted slot
    # Segment lengths, [N] with zeros past the last segment (integer adds
    # are exact in any order). Empty segments sum to zero.
    lengths = torch.zeros(n, dtype=torch.int64, device=ids.device).index_add_(
        0, seg, torch.ones_like(seg))
    combined = torch.segment_reduce(sorted_grads, "sum", lengths=lengths, axis=0, unsafe=True)
    # Every member of a segment writes the same id, so the result is fixed.
    uids = torch.full_like(ids, sentinel).scatter_(0, seg, sids)
    return uids, combined
