"""Matrix factorization (MF): the model of config 1 (MF + BPR).

The counterpart of ``tfrec_tpu/models/mf.py``: score(u, i) = <p_u, q_i> +
b_i over a user table, an item table and an item-bias table [V, 1]
(zeros at init). Training gathers the rows a batch names (one launch of
the gather kernel for the three tables on a card) and differentiates the
forward below; the full catalog is scored as one ``torch.matmul`` of the
gathered user rows against the item table, as the reference leaves it to
XLA.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from tfrec_tpu_torch.models.base import DataSpec, DotRetrieval, RecModel
from tfrec_tpu_torch.ops.embedding import TableSpec, gather_many


class MF(RecModel):
    def __init__(self, data_spec: DataSpec, embed_dim: int, use_bias: bool = True):
        super().__init__()
        if data_spec.kind != "interaction":
            raise ValueError(f"MF needs an interaction DataSpec, got {data_spec.kind!r}")
        self.data_spec = data_spec
        self.embed_dim = embed_dim
        self.use_bias = use_bias

    def table_specs(self) -> Tuple[TableSpec, ...]:
        u, v, d = self.data_spec.num_users, self.data_spec.num_items, self.embed_dim
        specs = [TableSpec("user_emb", u, d), TableSpec("item_emb", v, d)]
        if self.use_bias:
            specs.append(TableSpec("item_bias", v, 1, initializer="zeros"))
        return tuple(specs)

    def init_dense(self, generator: torch.Generator, device: torch.device | str):
        return {}

    def lookup_ids(self, batch) -> Dict[str, torch.Tensor]:
        """user_emb takes the users; item_emb and item_bias the same item ids
        ([pos; negs] for a pairwise batch)."""
        items = self.pair_item_ids(batch) if self.is_pairwise(batch) else batch["item"]
        ids = {"user_emb": batch["user"], "item_emb": items}
        if self.use_bias:
            ids["item_bias"] = items
        return ids

    @staticmethod
    def _score(u_vec, i_vec, i_bias) -> torch.Tensor:
        s = (u_vec * i_vec).sum(dim=-1)
        return s if i_bias is None else s + i_bias[:, 0]

    def forward(self, dense, gathered, batch, *, generator=None) -> torch.Tensor:
        """Pointwise: [B] scores. Pairwise with "neg": s_pos - s_neg [B];
        with "negs" [B, K]: the [B, 1+K] score matrix, column 0 the positive;
        with "pos" alone (in-batch negatives): the [B, B] matrix of every
        user against every row's positive."""
        u = gathered["user_emb"]
        i = gathered["item_emb"]
        b = gathered.get("item_bias")
        if not self.is_pairwise(batch):
            return self._score(u, i, b)
        bsz = u.shape[0]
        if "negs" in batch:
            k = batch["negs"].shape[1]
            # Items are [pos (B); negs (B*K, user-major)].
            u_rep = torch.cat([u, u.repeat_interleave(k, dim=0)])
            s = self._score(u_rep, i, b)
            return torch.cat([s[:bsz, None], s[bsz:].reshape(bsz, k)], dim=1)
        if "neg" not in batch:
            scores = torch.matmul(u, i.T)
            return scores if b is None else scores + b[:, 0][None, :]
        s_pos = self._score(u, i[:bsz], None if b is None else b[:bsz])
        s_neg = self._score(u, i[bsz:], None if b is None else b[bsz:])
        return s_pos - s_neg

    def dot_decomposition(self) -> DotRetrieval:
        return DotRetrieval("user_emb", "item_emb", "item_bias" if self.use_bias else None)

    def score_all(self, params, user_ids: torch.Tensor) -> torch.Tensor:
        """[B, V] scores: the user rows through the gather kernel (one
        ``gather_many`` launch; ids clamp to [0, U-1], where the reference's
        ``jnp.take`` fills NaN rows for ids out of range, so only in-range
        ids agree), then one product against the item table and the bias
        added in place."""
        t = params["tables"]
        (user_rows,) = gather_many([t["user_emb"]], [user_ids])
        scores = torch.matmul(user_rows, t["item_emb"].T)
        if self.use_bias:
            scores.add_(t["item_bias"][:, 0][None, :])
        return scores
