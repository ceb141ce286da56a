"""Rowwise sparse optimizers for embedding tables.

The counterpart of ``tfrec_tpu/ops/sparse_optim.py``. A dense optimizer
step would read and write every row of a table and of its state; these
touch only the rows a batch gathered. Duplicate ids are combined first
(``ops.embedding.combine_duplicate_ids``), then each distinct real id's
state and row are updated; sentinel slots (ids >= V) are dropped.

- ``sgd``: no state.
- ``rowwise_adagrad``: one accumulator per row. Its ``apply_deduped`` is
  ``kernels.adagrad_cuda.fused_rowwise_adagrad`` and its
  ``apply_deduped_many`` ``fused_rowwise_adagrad_multi`` (every table in
  one launch): the CUDA kernel on a CUDA tensor, its plain version on a CPU
  tensor.
- ``rowwise_adam``: per-element first moment, per-row second moment and
  per-row step count (lazy bias correction).

Unlike the reference, which returns new arrays, tables and their states are
updated IN PLACE and returned (the TPU kernel aliases them too). Duplicate
ids give one combined update, not two in turn, as in the reference.

Lane-packed tables (``TableSpec.lane_groups`` G > 1, ``init(table,
lane_groups=G)``) keep their rowwise statistics per group: Adagrad's
``acc`` and Adam's ``v`` and ``t`` are [V, G], and group j of a row (lanes
[j*d, (j+1)*d)) follows its own per-table rule, bit for bit. Grouped
Adagrad goes to the same kernel (``[V, G]`` accumulators); grouped Adam
needs to know which groups a batch touched, which a zero gradient does not
say, so its ``apply`` takes each id's lane group (``slots``) and carries a
one-hot touch channel through the duplicate combine.

On a column-sharded table (``parallel/embedding.col_update``) a rank holds
D/T of each row's columns, so the rowwise statistic is the sum of g^2 over
its columns, summed over the table axis and divided by the full width (the
reference's ``_row_stat`` with ``stat_axis`` and ``full_dim``;
``parallel/embedding.col_update`` computes it), and ``apply_deduped(...,
stat=)`` takes it in place of the local mean. The reference runs that update through XLA, not
its Pallas kernel, and so does the port: Adagrad with a ``stat`` runs the
plain rowwise rule (``fused_rowwise_adagrad_multi`` takes the mean over its
own row and cannot take a shard's partial sum). Lane-grouped state on such
a table is refused, as in the reference. SGD has no statistic.

Not ported: the reference's XLA lowering switches
(``TFREC_SCATTER_HINT_MAX_ELEMS``, ``TFREC_PACKED_SCATTER``), which chose
between TPU scatter lowerings and have no counterpart here.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Tuple

import torch

from tfrec_tpu_torch.kernels.adagrad_cuda import fused_rowwise_adagrad, fused_rowwise_adagrad_multi
from tfrec_tpu_torch.ops.embedding import combine_duplicate_ids

State = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class SparseOptimizer:
    """init(table, lane_groups=1) -> state; apply(table, state, ids, grads,
    lr, slots=None, stat=None) -> (table, state); ``apply_deduped`` is
    ``apply`` after the duplicate combine (uids and summed grads from
    ``combine_duplicate_ids``; ``stat``, where given, each slot's rowwise
    statistic, that of a column-sharded row);
    ``apply_deduped_many(tables, states, uids, grads, lr) -> (tables,
    states)`` is ``apply_deduped`` over lists of tables, one lr for all."""

    name: str
    init: Callable[..., State]
    apply: Callable[..., Tuple[torch.Tensor, State]]
    apply_deduped: Callable[..., Tuple[torch.Tensor, State]]
    apply_deduped_many: Callable[..., Tuple[List[torch.Tensor], List[State]]]


def _one_by_one(apply_deduped):
    """``apply_deduped_many`` as ``apply_deduped`` on each table in turn."""

    def apply_deduped_many(tables, states, uids, grads, lr):
        out = [apply_deduped(t, s, u, g, lr) for t, s, u, g in zip(tables, states, uids, grads)]
        return [t for t, _ in out], [s for _, s in out]

    return apply_deduped_many


def _real(table: torch.Tensor, uids: torch.Tensor, g: torch.Tensor):
    """The real slots: (row indices, their grads). Sentinels drop here."""
    valid = (uids >= 0) & (uids < table.shape[0])
    return uids[valid].long(), g[valid]


def scatter_add_rows(table: torch.Tensor, uids: torch.Tensor, upd: torch.Tensor) -> torch.Tensor:
    """``table[u] += upd`` for each real id u in place (ids >= V and < 0
    dropped); real ids must be distinct, as ``combine_duplicate_ids`` gives
    them. Returns the table."""
    rows, upd = _real(table, uids, upd)
    table[rows] = table[rows] + upd
    return table


def _row_stat(g: torch.Tensor, lane_groups: int = 1) -> torch.Tensor:
    """Rowwise mean square, as the sum over the row divided by its width;
    with ``lane_groups`` G > 1 each group's over its own d = D / G lanes,
    [n, G], each summed as a row of d alone."""
    if lane_groups > 1:
        n, width = g.shape
        return _row_stat(g.reshape(n * lane_groups, width // lane_groups)).reshape(n, lane_groups)
    return (g * g).sum(dim=-1) / g.shape[-1]


def _no_grouped_stat(state: State, stat) -> None:
    if stat is not None and any(v.dim() == 2 and k != "m" for k, v in state.items()):
        raise ValueError("lane-packed tables do not support column sharding (the feature split "
                         "would cut across lane groups)")


def _stat_shape(table: torch.Tensor, lane_groups: int) -> Tuple[int, ...]:
    return (table.shape[0],) if lane_groups <= 1 else (table.shape[0], lane_groups)


def _sgd_init(table: torch.Tensor, lane_groups: int = 1) -> State:
    return {}


def _sgd_apply_deduped(table, state, uids, g, lr, stat=None):
    return scatter_add_rows(table, uids, -lr * g), state


def _sgd_apply(table, state, ids, grads, lr, slots=None, stat=None):
    uids, g = combine_duplicate_ids(ids, grads, sentinel=table.shape[0])
    return _sgd_apply_deduped(table, state, uids, g, lr)


def _adagrad_init_fn(initial_accumulator: float):
    def init(table: torch.Tensor, lane_groups: int = 1) -> State:
        return {"acc": torch.full(_stat_shape(table, lane_groups), initial_accumulator,
                                  dtype=torch.float32, device=table.device)}

    return init


def _adagrad_apply_fn(eps: float):
    def apply_deduped(table, state, uids, g, lr, stat=None):
        if stat is None:
            table, acc = fused_rowwise_adagrad(table, state["acc"], uids, g, lr, eps)
            return table, {"acc": acc}
        # The reference's XLA rule with a column-sharded statistic. The
        # combine puts the real ids first: the slots past them repeat the
        # last real slot, so every write to a row carries one value and
        # nothing waits on the host for their count (with no real id, row
        # V - 1 is written unchanged).
        _no_grouped_stat(state, stat)
        valid = (uids >= 0) & (uids < table.shape[0])
        last = (valid.sum() - 1).clamp(min=0)
        src = torch.where(valid, torch.arange(uids.shape[0], device=uids.device), last)
        rows = uids[src].clamp(0, table.shape[0] - 1).long()
        ok = valid[src]
        acc = state["acc"]
        acc_rows = acc[rows] + torch.where(ok, stat[src], 0.0)
        scale = lr / (acc_rows.sqrt() + eps)
        table[rows] = table[rows] + torch.where(ok[:, None], -scale[:, None] * g[src], 0.0)
        acc[rows] = acc_rows
        return table, {"acc": acc}

    def apply_deduped_many(tables, states, uids, grads, lr):
        tables, accs = fused_rowwise_adagrad_multi(
            tables, [s["acc"] for s in states], uids, grads, lr, eps)
        return tables, [{"acc": a} for a in accs]

    def apply(table, state, ids, grads, lr, slots=None, stat=None):
        uids, g = combine_duplicate_ids(ids, grads, sentinel=table.shape[0])
        return apply_deduped(table, state, uids, g, lr, stat)

    return apply, apply_deduped, apply_deduped_many


def _adam_init(table: torch.Tensor, lane_groups: int = 1) -> State:
    """m [V, D]; v and t [V], or [V, G] per lane group: Adam's moving
    averages decay on every update of a row, so a packed row's groups keep
    their own second moments and step counts."""
    v, d = table.shape
    return {
        "m": torch.zeros((v, d), dtype=torch.float32, device=table.device),
        "v": torch.zeros(_stat_shape(table, lane_groups), dtype=torch.float32, device=table.device),
        "t": torch.zeros(_stat_shape(table, lane_groups), dtype=torch.int32, device=table.device),
    }


def _adam_apply_fn(b1: float, b2: float, eps: float):
    def apply_deduped(table, state, uids, g, lr, stat=None):
        _no_grouped_stat(state, stat)
        if state["v"].dim() == 2:
            raise ValueError(
                "lane-packed rowwise_adam needs each id's lane group: call apply(..., slots=...) "
                "(the step passes them from model.lane_slot_widths)")
        # The statistic of every slot, then the real ones (a row's
        # statistic does not depend on the others).
        stat = _row_stat(g) if stat is None else stat
        valid = (uids >= 0) & (uids < table.shape[0])
        rows, g, stat = uids[valid].long(), g[valid], stat[valid]
        t_rows = state["t"][rows] + 1
        m_rows = b1 * state["m"][rows] + (1.0 - b1) * g
        v_rows = b2 * state["v"][rows] + (1.0 - b2) * stat
        tf = t_rows.to(torch.float32)
        m_hat = m_rows / (1.0 - b1**tf)[:, None]
        v_hat = v_rows / (1.0 - b2**tf)
        table[rows] = table[rows] + -lr * m_hat / (v_hat.sqrt() + eps)[:, None]
        state["m"][rows] = m_rows
        state["v"][rows] = v_rows
        state["t"][rows] = t_rows
        return table, state

    def apply_grouped_deduped(table, state, uids, g, touched, lr):
        """The lane-packed rule: ``touched`` [n, G] marks the groups of each
        combined row that the batch addressed (from the ids' slots, not
        from g == 0, so a zero gradient in a touched group still decays).
        Untouched groups keep m, v and t and get a zero table delta; every
        touched group's arithmetic is the per-table rule's, element by
        element."""
        groups = state["v"].shape[1]
        rows, g = _real(table, uids, g)
        touched = touched[(uids >= 0) & (uids < table.shape[0])]
        d = g.shape[1] // groups
        mask_l = touched.repeat_interleave(d, dim=1)
        t_rows = state["t"][rows] + touched.to(torch.int32)
        m_prev = state["m"][rows]
        m_rows = torch.where(mask_l, b1 * m_prev + (1.0 - b1) * g, m_prev)
        v_prev = state["v"][rows]
        v_rows = torch.where(touched, b2 * v_prev + (1.0 - b2) * _row_stat(g, groups), v_prev)
        # max(t, 1): an untouched group may have t == 0, and 1 - b**0 = 0
        # would put inf or NaN in lanes the where() below drops.
        tf = t_rows.to(torch.float32).clamp_min(1.0)
        m_hat = m_rows / (1.0 - b1**tf).repeat_interleave(d, dim=1)
        v_hat = v_rows / (1.0 - b2**tf)
        denom = (v_hat.sqrt() + eps).repeat_interleave(d, dim=1)
        update = torch.where(mask_l, -lr * m_hat / denom, 0.0)
        table[rows] = table[rows] + update
        state["m"][rows] = m_rows
        state["v"][rows] = v_rows
        state["t"][rows] = t_rows
        return table, state

    def apply(table, state, ids, grads, lr, slots=None, stat=None):
        if state["v"].dim() == 2:
            _no_grouped_stat(state, stat)
            groups = state["v"].shape[1]
            if slots is None:
                raise ValueError(
                    "lane-packed rowwise_adam needs the per-id slot array (which lane group each "
                    "id addresses); the step passes it from model.lane_slot_widths")
            # A one-hot touch channel rides the combine: a group of a row
            # was addressed iff its summed count is > 0.
            touch = torch.nn.functional.one_hot(slots.long(), groups).to(grads.dtype)
            uids, cg = combine_duplicate_ids(ids, torch.cat([grads, touch], dim=1),
                                             sentinel=table.shape[0])
            return apply_grouped_deduped(table, state, uids, cg[:, :-groups].contiguous(),
                                         cg[:, -groups:] > 0, lr)
        uids, g = combine_duplicate_ids(ids, grads, sentinel=table.shape[0])
        return apply_deduped(table, state, uids, g, lr, stat)

    return apply, apply_deduped


def make_sparse_optimizer(
    name: str,
    *,
    adagrad_init: float = 0.0,
    adam_b1: float = 0.9,
    adam_b2: float = 0.999,
    eps: float = 1e-8,
) -> SparseOptimizer:
    if name == "sgd":
        return SparseOptimizer("sgd", _sgd_init, _sgd_apply, _sgd_apply_deduped,
                               _one_by_one(_sgd_apply_deduped))
    if name == "rowwise_adagrad":
        return SparseOptimizer("rowwise_adagrad", _adagrad_init_fn(adagrad_init),
                               *_adagrad_apply_fn(eps))
    if name == "rowwise_adam":
        apply, apply_deduped = _adam_apply_fn(adam_b1, adam_b2, eps)
        return SparseOptimizer("rowwise_adam", _adam_init, apply, apply_deduped,
                               _one_by_one(apply_deduped))
    raise ValueError(f"unknown sparse optimizer {name!r}")
