"""FPMC, factorized personalized Markov chains (Rendle et al. 2010), on the
sequential protocol of ``models/seq_base.py``.

The counterpart of ``tfrec_tpu/models/fpmc.py``: score(u, i | last item l)
= <v_u, v_i> + <t_l, v_i>, so the hidden state at position t is the user's
row plus the transition row of seq_t. Three tables ride the sparse path:
``item_emb`` (targets and negatives), ``user_emb`` and ``trans_emb``,
whose ids are the input positions only. The dense tree is empty.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from tfrec_tpu_torch.models.base import DataSpec
from tfrec_tpu_torch.models.seq_base import SequentialRecModel
from tfrec_tpu_torch.ops.embedding import TableSpec, gather_many


class FPMC(SequentialRecModel):
    uses_user = True

    def __init__(self, data_spec: DataSpec, embed_dim: int, max_history: int = 50):
        super().__init__(data_spec, embed_dim, max_history)
        self.user_dim = embed_dim

    def table_specs(self) -> Tuple[TableSpec, ...]:
        return super().table_specs() + (TableSpec("trans_emb", self.data_spec.num_items, self.embed_dim),)

    def lookup_ids(self, batch) -> Dict[str, torch.Tensor]:
        ids = super().lookup_ids(batch)
        # The input positions' transition rows (negatives and scored items
        # never act as a previous item).
        seq = batch["seq"] if "seq" in batch else self._pointwise_seq(batch)
        ids["trans_emb"] = seq.reshape(-1)
        return ids

    def init_dense(self, generator: torch.Generator, device: torch.device | str):
        return {}

    def _encode(self, dense, rows, seq, user_rows, *, generator, gathered=None):
        b, lx = seq.shape
        # The input positions' transition rows, cut to this encode's window
        # (training looked up L = Lx + 1 positions, pointwise scoring Lx).
        flat = gathered["trans_emb"]
        trans = flat.reshape(b, flat.shape[0] // b, -1)[:, :lx]
        trans = torch.where((seq < self.data_spec.num_items)[:, :, None], trans, 0.0)
        return user_rows[:, None, :] + trans

    def _last_hidden(self, params, user_ids: torch.Tensor) -> torch.Tensor:
        """The user's row plus the last valid item's transition row (no
        encode of the whole sequence), one gather launch for both."""
        hist, hist_len = self._history(user_ids.device)
        users = user_ids.long()
        v = self.data_spec.num_items
        last_item = self._at_last(hist[users], hist_len[users])
        t = params["tables"]
        trans, user_rows = gather_many([t["trans_emb"], t["user_emb"]],
                                       [torch.clamp_max(last_item, v - 1), user_ids])
        return user_rows + torch.where((last_item < v)[:, None], trans, 0.0)
