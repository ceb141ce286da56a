"""CDAE: collaborative denoising autoencoder (Wu et al. 2016), the
counterpart of ``tfrec_tpu/models/cdae.py``::

    z     = sigmoid(sum over the corrupted history of enc1 rows + v_u + b1)
    x_hat = z W_out + b_out    (over the whole catalog)

The encoder is an embedding bag over table ``enc1`` [V, H1] at the batch's
history ids, beside the user's own row of ``user_node`` [U, H1] (both
gathered in one launch on a card); corruption drops history members as
Mult-VAE's input dropout does. The [H1, V] decoder is one ``torch.matmul``.
Trained with the ``cdae`` loss (BCE against the multi-hot history) on
``UserHistorySampler`` batches; a batch with "item" (a served request)
gives the logits at those items. ``score_all`` reconstructs from the
attached history with no corruption.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from tfrec_tpu_torch.models.base import DataSpec
from tfrec_tpu_torch.models.history_base import HistoryRecModel
from tfrec_tpu_torch.models.multvae import corrupt
from tfrec_tpu_torch.ops.embedding import TableSpec, gather_many


class CDAE(HistoryRecModel):
    def __init__(self, data_spec: DataSpec, hidden_dim: int = 256, dropout: float = 0.2,
                 max_history: int = 50):
        super().__init__()
        if data_spec.kind != "interaction":
            raise ValueError(f"{type(self).__name__} needs an interaction DataSpec, got {data_spec.kind!r}")
        self.data_spec = data_spec
        self.hidden_dim = hidden_dim
        self.dropout = dropout
        self.max_history = max_history

    def table_specs(self) -> Tuple[TableSpec, ...]:
        v, u, h = self.data_spec.num_items, self.data_spec.num_users, self.hidden_dim
        return (TableSpec("enc1", v, h), TableSpec("user_node", u, h, init_scale=0.01))

    def init_dense(self, generator: torch.Generator, device: torch.device | str):
        v, h = self.data_spec.num_items, self.hidden_dim
        lim = (6.0 / (h + v)) ** 0.5
        w_out = torch.rand((h, v), generator=generator, device=device).mul_(2 * lim).sub_(lim)
        return {"b1": torch.zeros(h, device=device), "w_out": w_out, "b_out": torch.zeros(v, device=device)}

    def lookup_ids(self, batch) -> Dict[str, torch.Tensor]:
        return {"enc1": self.batch_history(batch).reshape(-1), "user_node": batch["user"]}

    def _reconstruct(self, dense, bag_rows, user_rows, hist, *, generator) -> torch.Tensor:
        b, h = hist.shape
        valid = corrupt(self._valid(hist), self.dropout, generator)
        bag = torch.einsum("bh,bhd->bd", valid, bag_rows.reshape(b, h, -1))
        z = torch.sigmoid(bag + user_rows + dense["b1"])
        return torch.matmul(z, dense["w_out"]) + dense["b_out"]

    def forward(self, dense, gathered, batch, *, generator=None) -> torch.Tensor:
        logits = self._reconstruct(dense, gathered["enc1"], gathered["user_node"],
                                   self.batch_history(batch), generator=generator)
        if "item" in batch:
            return logits.gather(1, batch["item"].long()[:, None].clamp(0, logits.shape[1] - 1))[:, 0]
        return logits

    def score_all(self, params, user_ids: torch.Tensor) -> torch.Tensor:
        t = params["tables"]
        hist = self._history(user_ids.device)[0][user_ids.long()]
        rows, user_rows = gather_many([t["enc1"], t["user_node"]], [hist.reshape(-1), user_ids])
        return self._reconstruct(params["dense"], rows, user_rows, hist, generator=None)
