"""Embedding-table primitives: specs, seeded init, the row gather (of one
table, or of many in one launch) and the duplicate-id combine.

The counterpart of ``tfrec_tpu/ops/embedding.py``. The sentinel row id
``vocab`` (one past the end) marks bag padding; ``gather`` clamps it, and
negative ids, to a real row as ``jnp.take(mode="clip")`` does, and callers
mask those rows. ``combine_duplicate_ids`` sums the gradient rows that
share an id before a sparse update. ``run_first_index`` and
``run_last_index_plus1`` bound each element's run of equal values (the
tie spans of ``eval.metrics.auc``). ``combine_duplicate_ids`` takes a
stable argsort computed on the host (``order``, train.host_dedup), and
``combine_duplicate_ids_grouped`` combines many same-shaped tables in one
batched sort, bit for bit the per-table combine. ``dedup_ids_sorted``
(unique ids with the inverse and the stable order) serves the row-sharded
exchange (``parallel/embedding.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import torch

from tfrec_tpu_torch.kernels.gather_cuda import gather_rows, gather_rows_multi


def run_first_index(x: torch.Tensor) -> torch.Tensor:
    """``searchsorted(x, x, side="left")`` along the last axis of a tensor
    whose equal values are contiguous (a sorted one, say): the first index
    of each element's run, int32, as an O(n) ``cummax``. A run of a value
    elsewhere indexes its own run, as in the reference."""
    n = x.shape[-1]
    is_start = torch.ones(x.shape, dtype=torch.bool, device=x.device)
    is_start[..., 1:] = x[..., 1:] != x[..., :-1]
    idx = torch.arange(n, device=x.device)
    return torch.cummax(torch.where(is_start, idx, 0), -1).values.to(torch.int32)


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
    # Lane-packed tables (``models/ctr_base.CTRBase.enable_lane_packing``):
    # this table holds ``lane_groups`` logical tables side by side along its
    # width (dim = G * d), and the rowwise optimizer keeps its statistics
    # per group ([V, G]), so each follows its own per-table rule.
    lane_groups: int = 1

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


def _run_starts(sorted_keys: torch.Tensor) -> torch.Tensor:
    """1 where a run of equal keys starts along the last axis, else 0
    (int64)."""
    starts = torch.ones(sorted_keys.shape, dtype=torch.int64, device=sorted_keys.device)
    starts[..., 1:] = (sorted_keys[..., 1:] != sorted_keys[..., :-1]).to(torch.int64)
    return starts


SUM_RUN = 512  # the longest run of rows that one thread sums in a pass


def _one_pass(seg: torch.Tensor, sorted_grads: torch.Tensor) -> torch.Tensor:
    lengths = torch.zeros(seg.shape[0], dtype=torch.int64, device=seg.device).index_add_(
        0, seg, torch.ones_like(seg))
    return torch.segment_reduce(sorted_grads, "sum", lengths=lengths, axis=0, unsafe=True)


def _segment_sums(seg: torch.Tensor, sorted_grads: torch.Tensor) -> torch.Tensor:
    """[M, D] sums of the rows of ``sorted_grads`` by ``seg``, [M] int64,
    ascending, each row's segment: row j of the result is segment j's sum
    (zeros for a segment no row names).

    ``torch.segment_reduce`` makes each output element one sequential pass
    over its segment in sorted order (one thread each on CUDA, a loop on the
    CPU), with no atomics, so results repeat bit for bit on either device
    (``chip_smoke.py`` checks it on the card at the training path's shapes
    and against the CPU). Neither ``index_add_`` (float atomics on CUDA) nor
    ``index_put_(accumulate=True)`` (parallel adds on a multi-threaded CPU)
    repeats. Segment lengths are integer adds, exact in any order.

    One thread walking a segment of a hot id would be the whole kernel's
    time (a Zipf id that takes a sixth of a 1.6 M-id bag field: 0.4 s on an
    H100), so a segment sums in two passes, still in a fixed order: its runs
    of ``SUM_RUN`` rows first, then those partial sums. A segment of at most
    ``SUM_RUN`` rows is one run: its sum is the one-pass sum bit for bit."""
    m = seg.shape[0]
    # Each segment's first row and length by binary search (no atomics on a
    # hot segment's count), each row's place in its segment, then its run.
    every = torch.arange(m, device=seg.device)
    first = torch.searchsorted(seg, every)
    lengths = torch.searchsorted(seg, every, right=True) - first
    pos = every - first[seg]
    run = torch.cumsum((pos % SUM_RUN == 0).to(torch.int64), 0) - 1
    partial = _one_pass(run, sorted_grads)
    # A segment's runs are consecutive rows of ``partial``, as many as its
    # length takes; the rows past the last run (zeros) belong to no segment,
    # and the sum leaves them out.
    runs = torch.div(lengths + (SUM_RUN - 1), SUM_RUN, rounding_mode="floor")
    return torch.segment_reduce(partial, "sum", lengths=runs, axis=0, unsafe=True)


def combine_duplicate_ids(
    ids: torch.Tensor, grads: torch.Tensor, sentinel: int, order: torch.Tensor | None = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sum gradient rows that share an id, with static output shapes.

    ids [N] int32 (may repeat; negative ids count as the sentinel), grads
    [N, D] f32 aligned with them, ``sentinel`` normally the vocab size ->
    (uids [N] int32, combined [N, D]): slot j < number of distinct ids
    holds the j-th smallest distinct id and the sum of its rows, taken in
    the order of a stable sort of the ids (so in batch order); the other
    slots hold ``sentinel`` and zeros. ``uids`` ascends and each real id
    appears once, as the reference promises its scatters.

    ``order`` (train.host_dedup): a stable argsort of the ids computed on
    the host (``train.step.host_dedup_sorts``), [N] int32 on the ids'
    device; the combine then skips its own sort and is bit for bit the same.

    The sums are ``_segment_sums`` over the sorted rows. This serves every
    sparse optimizer, not only the fused Adagrad kernel, and keeps that
    kernel's inputs the reference's.
    """
    # Negative ids become the sentinel BEFORE the sort, as in the
    # reference: they are dropped by every update and keep uids ascending.
    ids = torch.where(ids < 0, torch.full_like(ids, sentinel), ids)
    if order is None:
        sids, order = torch.sort(ids, stable=True)
    else:
        sids = ids.index_select(0, order)
    seg = torch.cumsum(_run_starts(sids), dim=0) - 1  # segment of each sorted slot
    combined = _segment_sums(seg, grads.index_select(0, order))
    # Every member of a segment writes the same id, so the result is fixed.
    uids = torch.full_like(ids, sentinel).scatter_(0, seg, sids)
    return uids, combined


def combine_duplicate_ids_grouped(
    ids: torch.Tensor, grads: torch.Tensor, sentinels: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``combine_duplicate_ids`` of F same-shaped tables in one batched
    sort, gather, segment sum and scatter: ids [F, N] int32 (row f
    addressing table f), grads [F, N, D] f32, ``sentinels`` [F, 1] pad ids
    on ids' device (each table's vocab) -> (uids [F, N], combined [F, N,
    D]), row f bit for bit ``combine_duplicate_ids(ids[f], grads[f],
    sentinels[f])``: the same stable order within a row, and each segment
    summed alone in it."""
    f, n = ids.shape
    sent = sentinels.to(ids.dtype).reshape(f, 1)
    ids = torch.where(ids < 0, sent.expand(f, n), ids)
    sids, order = torch.sort(ids, dim=-1, stable=True)
    sg = torch.take_along_dim(grads, order[..., None], dim=1)
    seg = torch.cumsum(_run_starts(sids), dim=-1) - 1  # [F, N], each row from 0
    # Row-strided, the segments ascend over the flattened [F * N].
    flat_seg = (seg + torch.arange(f, device=ids.device)[:, None] * n).reshape(-1)
    combined = _segment_sums(flat_seg, sg.reshape(f * n, -1)).reshape(f, n, -1)
    uids = sent.expand(f, n).clone().scatter_(1, seg, sids)
    return uids, combined


def fill_like(x: torch.Tensor, value) -> torch.Tensor:
    """A new tensor of ``x``'s shape and dtype holding ``value``: a number,
    or a tensor broadcast to it (one value a row of a batch of tables)."""
    if isinstance(value, torch.Tensor):
        return value.to(x.dtype).expand(x.shape).clone()
    return torch.full_like(x, value)


def dedup_ids_sorted(ids: torch.Tensor, sentinel):
    """Unique ids with the inverse and the stable order, at static shapes,
    along the last axis: ids [..., N] -> (uids [..., N], inv [..., N]
    int64, order [..., N]) with ``uids[inv] == ids``; slot j < the number
    of distinct values holds the j-th smallest, the other slots
    ``sentinel`` (a number, or one a row as an [F, 1] tensor). Negative ids
    are values like any other (they sort first), as in the reference's
    ``dedup_ids``; the exchange counts them. ``order`` is the stable
    argsort of ``ids``: ``inv[order]`` ascends, and each run of it lists an
    id's positions in batch order (the order in which its gradient rows
    are summed)."""
    sids, order = torch.sort(ids, dim=-1, stable=True)
    seg = torch.cumsum(_run_starts(sids), dim=-1) - 1
    uids = fill_like(ids, sentinel).scatter_(-1, seg, sids)
    inv = torch.empty_like(seg).scatter_(-1, order, seg)
    return uids, inv, order
