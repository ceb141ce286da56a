"""LightGCN (He et al. 2020): the counterpart of
``tfrec_tpu/models/lightgcn.py``.

The user and item embeddings are propagated over the symmetrically
normalised user-item graph of the train split, E^(k+1) = A_hat E^(k), with
no transform or nonlinearity; a node is the mean of its layers 0..K, and a
score is a dot product (trained pairwise, BPR). Every step touches every
node, so the embeddings are dense params (``user_emb``, ``item_emb``) under
the dense optimizer, and ``table_specs`` is empty: a step launches no
gather or Adagrad kernel. The propagation is ``ops/graph.aggregate``, sums
over destination-sorted edge lists with no atomics, which repeat bit for
bit on the card, forward and backward; the propagated rows a batch names
are taken by ``ops/graph.take_rows``, whose gradient is as fixed.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from tfrec_tpu_torch.models.base import DataSpec, DotRetrieval, RecModel, copy_once
from tfrec_tpu_torch.ops.embedding import TableSpec
from tfrec_tpu_torch.ops.graph import Edges, aggregate, bipartite_edges, take_rows


class LightGCN(RecModel):
    def __init__(self, data_spec: DataSpec, embed_dim: int = 64, num_layers: int = 3):
        super().__init__()
        if data_spec.kind != "interaction":
            raise ValueError(f"{type(self).__name__} needs an interaction DataSpec, got {data_spec.kind!r}")
        self.data_spec = data_spec
        self.embed_dim = embed_dim
        self.num_layers = num_layers
        self._graph = None  # (user side, item side) Edges on the CPU
        self._graph_on: Dict[str, Tuple[Edges, Edges]] = {}

    def needs_graph(self) -> bool:
        return True

    def attach_graph(self, users, items) -> None:
        """The edge lists of the train interactions (the trainer's call)."""
        self._graph = bipartite_edges(users, items, self.data_spec.num_users, self.data_spec.num_items)
        self._graph_on = {}

    def graph(self, device) -> Tuple[Edges, Edges]:
        """The edge lists on ``device``, copied once."""
        if self._graph is None:
            raise ValueError(
                f"{type(self).__name__}.propagate needs attach_graph(train_users, train_items) (the "
                "trainer does this from the train split)")
        return copy_once(self._graph_on, device, lambda d: tuple(side.to(d) for side in self._graph))

    def table_specs(self) -> Tuple[TableSpec, ...]:
        return ()

    def init_dense(self, generator: torch.Generator, device: torch.device | str):
        d = self.embed_dim
        return {
            "user_emb": torch.randn((self.data_spec.num_users, d), generator=generator, device=device) * 0.1,
            "item_emb": torch.randn((self.data_spec.num_items, d), generator=generator, device=device) * 0.1,
        }

    def lookup_ids(self, batch) -> Dict[str, torch.Tensor]:
        return {}

    def propagate(self, dense, *, generator=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """(users [U, D], items [V, D]): the mean over layers 0..K."""
        u_edges, i_edges = self.graph(dense["user_emb"].device)
        eu, ei = dense["user_emb"], dense["item_emb"]
        acc_u, acc_i = eu, ei
        for _ in range(self.num_layers):
            eu, ei = aggregate(eu, ei, u_edges, i_edges)
            acc_u = acc_u + eu
            acc_i = acc_i + ei
        k1 = 1.0 / (self.num_layers + 1)
        return acc_u * k1, acc_i * k1

    def forward(self, dense, gathered, batch, *, generator=None) -> torch.Tensor:
        """Pairwise {"pos", "neg"}: s_pos - s_neg [B]; pointwise: [B]."""
        pu, qi = self.propagate(dense, generator=generator)
        u = take_rows(pu, batch["user"])
        if not self.is_pairwise(batch):
            return (u * take_rows(qi, batch["item"])).sum(dim=-1)
        if "negs" in batch or "neg" not in batch:
            raise NotImplementedError(
                f"{type(self).__name__} supports single-negative pairwise (bpr/hinge) and pointwise batches")
        b = u.shape[0]
        rows = take_rows(qi, torch.cat([batch["pos"], batch["neg"]]))
        return (u * rows[:b]).sum(dim=-1) - (u * rows[b:]).sum(dim=-1)

    def score_all(self, params, user_ids: torch.Tensor) -> torch.Tensor:
        pu, qi = self.propagate(params["dense"])
        return torch.matmul(pu.index_select(0, user_ids.long()), qi.T)

    def dot_decomposition(self) -> DotRetrieval | None:
        return None  # the propagated rows are computed, not a table's
