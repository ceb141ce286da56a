"""The user-item graph of the graph models (LightGCN, NGCF), as edge lists.

The counterpart of the edge lists of ``tfrec_tpu/models/lightgcn.py``: the
train interactions become a 0/1 bipartite adjacency (a repeated pair is one
edge), each edge weighted 1 / sqrt(deg_u * deg_i) with degrees clamped at
1, listed twice, sorted by user and sorted by item. A layer of propagation
is then a gather of the source rows, a scale by the edge weights and a sum
into each destination: the symmetrically normalised A_hat applied to both
sides at once (``aggregate``).

The sums are ``torch.segment_reduce`` over the destination-sorted runs:
each output element is one sequential pass over its run in sorted order,
with no atomics, so a propagation repeats bit for bit on the card
(``index_add_``'s float atomics do not). A_hat is symmetric, so the
gradient of a layer is the same aggregation of the output gradients,
swapped between the sides: ``aggregate``'s backward runs the same sorted
sums, and so does ``take_rows``' (a gather of propagated rows, whose
gradient sums the rows of repeated ids through ``combine_duplicate_ids``).
The reference's ``jax.ops.segment_sum`` adds in XLA's order; the two agree
to rounding.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from tfrec_tpu_torch.ops.embedding import combine_duplicate_ids


@dataclasses.dataclass(frozen=True)
class Edges:
    """One side's edge list, sorted by destination: ``src`` [E] the
    source nodes, ``coef`` [E] f32 the weights, ``lengths`` [N] int64 each
    destination's number of edges (its run in the sorted list)."""

    src: torch.Tensor
    coef: torch.Tensor
    lengths: torch.Tensor

    def to(self, device) -> "Edges":
        return Edges(self.src.to(device), self.coef.to(device), self.lengths.to(device))


def bipartite_edges(users: np.ndarray, items: np.ndarray, num_users: int,
                    num_items: int) -> Tuple[Edges, Edges]:
    """The reference's ``attach_graph`` from the train interactions: (the
    user side, sorted by user: each user's items; the item side, sorted by
    item: each item's users), on the CPU. The reference's ``u_dst`` is
    ``repeat(arange(U), user side's lengths)``, ``u_src`` and ``u_coef`` its
    ``src`` and ``coef``; the same for ``i_*``."""
    keys = np.unique(np.asarray(users).astype(np.int64) * num_items + np.asarray(items))
    u = (keys // num_items).astype(np.int32)
    i = (keys % num_items).astype(np.int32)
    du = np.bincount(u, minlength=num_users).astype(np.float32)
    di = np.bincount(i, minlength=num_items).astype(np.float32)
    coef = 1.0 / np.sqrt(np.maximum(du[u], 1.0) * np.maximum(di[i], 1.0))

    def side(dst, src, n):
        order = np.argsort(dst, kind="stable")
        return Edges(torch.from_numpy(src[order].astype(np.int64)), torch.from_numpy(coef[order]),
                     torch.from_numpy(np.bincount(dst, minlength=n).astype(np.int64)))

    return side(u, i, num_users), side(i, u, num_items)


def _sums(x: torch.Tensor, edges: Edges) -> torch.Tensor:
    """[N, D]: each destination's sum of coef * x[src] over its edges."""
    msgs = x.index_select(0, edges.src) * edges.coef[:, None]
    return torch.segment_reduce(msgs, "sum", lengths=edges.lengths, axis=0, unsafe=True)


class _Aggregate(torch.autograd.Function):
    """(A_hat applied to the items for the users, and to the users for the
    items); its own adjoint, so the backward is the forward of the output
    gradients with the sides swapped."""

    @staticmethod
    def forward(ctx, eu, ei, u_edges, i_edges):
        ctx.edges = (u_edges, i_edges)
        ctx.shapes = (eu.shape, ei.shape)
        return _sums(ei, u_edges), _sums(eu, i_edges)

    @staticmethod
    def backward(ctx, g_u, g_i):
        u_edges, i_edges = ctx.edges
        if g_u is None:
            g_u = torch.zeros(ctx.shapes[0], dtype=g_i.dtype, device=g_i.device)
        if g_i is None:
            g_i = torch.zeros(ctx.shapes[1], dtype=g_u.dtype, device=g_u.device)
        return _sums(g_i, u_edges), _sums(g_u, i_edges), None, None


def aggregate(eu: torch.Tensor, ei: torch.Tensor, u_edges: Edges,
              i_edges: Edges) -> Tuple[torch.Tensor, torch.Tensor]:
    """One layer's messages: ([U, D] sums of the items' rows a user, [V, D]
    of the users' rows an item), each edge weighted."""
    return _Aggregate.apply(eu, ei, u_edges, i_edges)


class _TakeRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ids):
        ctx.save_for_backward(ids)
        ctx.rows = x.shape[0]
        return x.index_select(0, ids)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        n = ctx.rows
        uids, summed = combine_duplicate_ids(ids, g, sentinel=n)
        # Distinct real ids, so each row is written once; the sentinel slots
        # write zeros to the extra row.
        out = torch.zeros((n + 1, g.shape[1]), dtype=g.dtype, device=g.device)
        return out.index_copy_(0, uids.long(), summed)[:n], None


def take_rows(x: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``x[ids]`` ([N] int ids in range) whose gradient sums repeated ids'
    rows in a fixed order (a sort, then ``segment_reduce``)."""
    return _TakeRows.apply(x, ids.long())
