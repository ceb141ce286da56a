"""FISM: factored item similarity, the counterpart of
``tfrec_tpu/models/fism.py``.

A user is the mean of the P rows of their train history, the scored item
left out, against the item's Q row::

    score(u, i) = b_i + <sum_{j in R_u \\ {i}} p_j / n_eff^alpha, q_i>,
    n_eff = max(|R_u| - hits of i, 1)

Tables ``item_p``, ``item_q`` and ``item_bias`` [V, 1] (zeros at init). A
step gathers the batch's B * H history ids into ``item_p`` and the items
into ``item_q`` and ``item_bias`` in one launch; the self-exclusion is a
masked subtraction. ``score_all`` scores the catalog from the attached
history (no exclusion: the evaluator masks train items) in one product.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from tfrec_tpu_torch.models.base import DataSpec
from tfrec_tpu_torch.models.history_base import HistoryRecModel
from tfrec_tpu_torch.ops.embedding import TableSpec, gather_many


def _single_negative(model, batch) -> None:
    if "negs" in batch or "neg" not in batch:
        raise NotImplementedError(
            f"{type(model).__name__} supports single-negative pairwise (bpr/hinge) and pointwise batches")


class FISM(HistoryRecModel):
    def __init__(self, data_spec: DataSpec, embed_dim: int, alpha: float = 0.5, max_history: int = 50):
        super().__init__()
        if data_spec.kind != "interaction":
            raise ValueError(f"{type(self).__name__} needs an interaction DataSpec, got {data_spec.kind!r}")
        self.data_spec = data_spec
        self.embed_dim = embed_dim
        self.alpha = alpha
        self.max_history = max_history

    def table_specs(self) -> Tuple[TableSpec, ...]:
        v, d = self.data_spec.num_items, self.embed_dim
        return (TableSpec("item_p", v, d), TableSpec("item_q", v, d),
                TableSpec("item_bias", v, 1, initializer="zeros"))

    def init_dense(self, generator: torch.Generator, device: torch.device | str):
        return {}

    def lookup_ids(self, batch) -> Dict[str, torch.Tensor]:
        """``item_p`` the flattened history; ``item_q`` and ``item_bias``
        the items ([pos; neg] for a pairwise batch)."""
        items = self.pair_item_ids(batch) if self.is_pairwise(batch) else batch["item"]
        return {"item_p": self.batch_history(batch).reshape(-1), "item_q": items, "item_bias": items}

    def _user_terms(self, p_rows: torch.Tensor, hist: torch.Tensor):
        """(masked P rows [B, H, D], their sum [B, D], the count [B])."""
        b, h = hist.shape
        valid = self._valid(hist)
        rows = torch.where(valid[:, :, None], p_rows.reshape(b, h, -1), 0.0)
        return rows, rows.sum(dim=1), valid.sum(dim=1)

    def _score(self, rows, base_sum, n, hist, items, q, bias) -> torch.Tensor:
        """score(u, items) [B] with ``items`` left out of each history."""
        hit = hist == items[:, None]
        excl = torch.einsum("bh,bhd->bd", hit.to(rows.dtype), rows)
        n_eff = (n - hit.sum(dim=1)).clamp_min(1).to(rows.dtype)
        u_vec = (base_sum - excl) / (n_eff[:, None] ** self.alpha)
        return (u_vec * q).sum(dim=-1) + bias[:, 0]

    def forward(self, dense, gathered, batch, *, generator=None) -> torch.Tensor:
        """Pairwise {"pos", "neg"}: s_pos - s_neg [B]; pointwise: [B]."""
        hist = self.batch_history(batch)
        rows, base_sum, n = self._user_terms(gathered["item_p"], hist)
        q, bias = gathered["item_q"], gathered["item_bias"]
        if self.is_pairwise(batch):
            _single_negative(self, batch)
            b = hist.shape[0]
            s_pos = self._score(rows, base_sum, n, hist, batch["pos"], q[:b], bias[:b])
            s_neg = self._score(rows, base_sum, n, hist, batch["neg"], q[b:], bias[b:])
            return s_pos - s_neg
        return self._score(rows, base_sum, n, hist, batch["item"], q, bias)

    def score_all(self, params, user_ids: torch.Tensor) -> torch.Tensor:
        """[B, V]: the users' history rows in one gather launch, then one
        product against ``item_q``."""
        hist = self._history(user_ids.device)[0][user_ids.long()]
        t = params["tables"]
        (p_rows,) = gather_many([t["item_p"]], [hist.reshape(-1)])
        _, base_sum, n = self._user_terms(p_rows, hist)
        u_vec = base_sum / (n.clamp_min(1).to(base_sum.dtype)[:, None] ** self.alpha)
        scores = torch.matmul(u_vec, t["item_q"].T)
        return scores.add_(t["item_bias"][:, 0][None, :])
