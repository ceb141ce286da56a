"""Retrieval evaluation on a live sharded train state: the counterpart of
``tfrec_tpu/parallel/eval.py``.

``sharded_row_gather`` takes [B] rows of a row-sharded table, replicated:
each rank gathers its local hits (``gather_rows_multi`` on the clamped
local index), zeroes the others and an ``all_sum`` over ``data`` merges
them, B x D on the wire, never the table. ``ShardedRetrievalEvaluator``
runs the single-device ``eval/retrieval.RetrievalEvaluator``'s
full-catalog protocol for a dot-product scorer (``model.dot_decomposition``)
on the state in its training layout, a batch of users at a time: the user
rows, the model's query transform, ``parallel/topk.sharded_topk_dot``
against each rank's block of the item table, and the ranking metrics on the
replicated [B, k] ids; its metrics are the single-device evaluator's.

The reference's jit reshards a column-sharded item table to rows through
GSPMD; the port has no partitioner, so ``table_rows`` builds each data
index's block of rows at full width itself: rows [d * rps, (d + 1) * rps)
(``rps = pad_vocab(V, N) / N``, zero rows past V) of its [V, D/T] columns,
all-gathered over ``table``. Under ``"replicated"`` each rank takes the
same block of the whole table. User rows come from ``gather_rows`` by
plan: ``sharded_row_gather`` for a row-sharded table, the column lookup
(local gather, ``all_gather`` over ``table``) for a column-sharded one, the
local gather for a replicated one.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from tfrec_tpu_torch.eval.metrics import ranking_metrics_from_topk
from tfrec_tpu_torch.eval.retrieval import padded_positives
from tfrec_tpu_torch.ops.embedding import gather_many
from tfrec_tpu_torch.parallel.embedding import ColShardedTable, RowShardedTable, col_lookup, pad_vocab
from tfrec_tpu_torch.parallel.mesh import Mesh
from tfrec_tpu_torch.parallel.topk import sharded_topk_dot


def sharded_row_gather(mesh: Mesh, block: torch.Tensor, ids: torch.Tensor,
                       axis: str = "data") -> torch.Tensor:
    """[B, D] rows of ``ids`` (global, the same on every rank) from a table
    whose rows [i * rps, (i + 1) * rps) rank i of ``axis`` holds as
    ``block``; ids past the table read zeros. A collective."""
    rps = block.shape[0]
    local = ids.long() - mesh.index(axis) * rps
    ok = (local >= 0) & (local < rps)
    (rows,) = gather_many([block], [local.clamp(0, rps - 1).to(torch.int32)])
    return mesh.all_sum(torch.where(ok[:, None], rows, 0.0), axis)


def gather_rows(builder, tables, name: str, ids: torch.Tensor) -> torch.Tensor:
    """[B, D] rows of table ``name`` for ``ids`` (the same on every rank)
    from a live sharded state's ``tables``, replicated, whatever the
    table's plan (a collective). Ids clamp to [0, V - 1], as the
    single-device gather does."""
    plan = builder.plans.get(name)
    vocab = plan.vocab if plan is not None else tables[name].shape[0]
    ids = ids.clamp(0, vocab - 1)
    if isinstance(plan, RowShardedTable):
        if plan.permute:
            raise ValueError("row-permuted tables hold physical rows; gather logical ids from "
                             "builder.unpadded_tables")
        return sharded_row_gather(builder.mesh, tables[name], ids)
    if isinstance(plan, ColShardedTable):
        (rows,), _ = col_lookup(builder.mesh, [plan], [tables[name]], [ids])
        return rows
    (rows,) = gather_many([tables[name]], [ids])
    return rows


def table_rows(builder, tables, name: str) -> Tuple[torch.Tensor, int]:
    """(this data index's block of rows of table ``name`` at full width,
    [rps, D], its first row) from a live sharded state's ``tables``. A
    collective where the table is column-sharded."""
    plan = builder.plans.get(name)
    table = tables[name]
    mesh = builder.mesh
    if isinstance(plan, RowShardedTable):
        return table, plan.base
    vocab = plan.vocab if plan is not None else table.shape[0]
    rps = pad_vocab(vocab, mesh.size) // mesh.size
    base = mesh.data_index * rps
    block = torch.zeros((rps, table.shape[1]), dtype=table.dtype, device=table.device)
    real = max(min(vocab - base, rps), 0)
    block[:real] = table[base:base + real]
    return (plan.unshard(block) if plan is not None else block), base


class ShardedRetrievalEvaluator:
    """Full-catalog ranking evaluation over a live sharded train state for
    a dot-product scorer, metric for metric the single-device
    ``RetrievalEvaluator`` (the same users, padding and metrics)."""

    def __init__(self, builder, model, dataset, ks: Sequence[int], user_batch: int = 256):
        spec = model.dot_decomposition()
        if spec is None:
            raise ValueError(f"{type(model).__name__} has no dot decomposition; sharded retrieval "
                             "eval needs a dot-product scorer")
        self.builder = builder
        self.mesh = builder.mesh
        self.spec = spec
        self.num_items = dataset.num_items
        self.ks = tuple(ks)
        self.user_batch = user_batch
        device = self.mesh.device
        train_padded, train_counts = padded_positives(dataset.train_csr)
        test_padded, test_counts = padded_positives(dataset.test_csr)
        self.users_with_test = np.flatnonzero(test_counts > 0).astype(np.int32)
        self.train_padded, self.train_counts = (torch.from_numpy(train_padded).to(device),
                                                torch.from_numpy(train_counts).to(device))
        self.test_padded, self.test_counts = (torch.from_numpy(test_padded).to(device),
                                              torch.from_numpy(test_counts).to(device))

    @torch.no_grad()
    def __call__(self, state) -> Dict[str, float]:
        """The metrics of ``state`` (a collective: every rank calls it)."""
        spec, builder, tables = self.spec, self.builder, state["tables"]
        items, _ = table_rows(builder, tables, spec.item_table)
        bias = (table_rows(builder, tables, spec.bias_table)[0][:, 0]
                if spec.bias_table is not None else None)
        max_k = max(self.ks)
        sums: Dict[str, torch.Tensor] = {}
        total_users = 0.0
        for start in range(0, len(self.users_with_test), self.user_batch):
            batch_users = self.users_with_test[start:start + self.user_batch]
            n_real = len(batch_users)
            if n_real < self.user_batch:  # padded with user 0 at no test items
                batch_users = np.concatenate(
                    [batch_users, np.zeros(self.user_batch - n_real, dtype=np.int32)])
            users = torch.from_numpy(batch_users).to(self.mesh.device)
            ulong = users.long()
            tst_c = self.test_counts[ulong].clone()
            tst_c[n_real:] = 0
            q = spec.user_vecs(state["dense"], gather_rows(builder, tables, spec.user_table, users))
            _, topk_ids = sharded_topk_dot(
                self.mesh, q, items, max_k, self.num_items, item_bias=bias,
                exclude_padded=self.train_padded[ulong], exclude_counts=self.train_counts[ulong])
            metrics = ranking_metrics_from_topk(topk_ids, self.test_padded[ulong], tst_c, self.ks)
            n_users = (tst_c > 0).to(torch.float32).sum()
            total_users += float(n_users)
            for key, val in metrics.items():
                sums[key] = sums.get(key, 0.0) + float(val * n_users)
        return {k: sums[k] / max(total_users, 1.0) for k in sorted(sums)}
