"""GRU4Rec, recurrent next-item recommendation (Hidasi et al. 2016), on the
sequential protocol of ``models/seq_base.py``.

The counterpart of ``tfrec_tpu/models/gru4rec.py``. The input half of the
three gates is one [B*Lx, D] @ [D, 3H] matmul before the recurrence; the
recurrence is an explicit loop over time with the gate order [reset |
update | candidate], n = tanh(nx + r * nh) where nh includes bh, and a pad
position carries the state through unchanged (``torch.nn.GRU`` cannot
express that carry). Each step of the loop is a few kernel launches; a
final projection returns from the hidden width H to the item width D.
"""

from __future__ import annotations

import torch

from tfrec_tpu_torch.models.base import DataSpec
from tfrec_tpu_torch.models.seq_base import SequentialRecModel, glorot, make_dropout


class GRU4Rec(SequentialRecModel):
    def __init__(self, data_spec: DataSpec, embed_dim: int, hidden_dim: int = 0, num_layers: int = 1,
                 dropout: float = 0.0, max_history: int = 50):
        super().__init__(data_spec, embed_dim, max_history)
        self.hidden_dim = hidden_dim or embed_dim
        self.num_layers = num_layers
        self.dropout = dropout

    def init_dense(self, generator: torch.Generator, device: torch.device | str):
        d, h = self.embed_dim, self.hidden_dim
        params = {"proj": glorot(generator, h, d, device)}
        for i in range(self.num_layers):
            params[f"l{i}"] = {
                # gate order: [reset | update | candidate]
                "wx": glorot(generator, d if i == 0 else h, 3 * h, device),
                "wh": glorot(generator, h, 3 * h, device),
                "bx": torch.zeros((3 * h,), device=device),
                "bh": torch.zeros((3 * h,), device=device),
            }
        return params

    def _encode(self, dense, rows, seq, user_rows, *, generator, gathered=None):
        b, lx, _ = rows.shape
        h = self.hidden_dim
        ok = (seq < self.data_spec.num_items)[:, :, None]  # [B, Lx, 1]
        drop = make_dropout(generator, self.dropout)
        x = drop(rows)
        for i in range(self.num_layers):
            p = dense[f"l{i}"]
            # Every input-side gate pre-activation in one matmul.
            gx = (x.reshape(b * lx, -1) @ p["wx"] + p["bx"]).reshape(b, lx, 3 * h)
            hid = rows.new_zeros((b, h))
            states = []
            for t in range(lx):
                gx_rz, nx = gx[:, t].split([2 * h, h], dim=-1)
                gh_rz, nh = (hid @ p["wh"] + p["bh"]).split([2 * h, h], dim=-1)
                # The reset and update gates in one sigmoid.
                r, z = torch.sigmoid(gx_rz + gh_rz).split(h, dim=-1)
                n = torch.tanh(nx + r * nh)
                new = (1.0 - z) * n + z * hid
                # Pad positions carry the state through unchanged.
                hid = torch.where(ok[:, t], new, hid)
                states.append(hid)
            x = drop(torch.stack(states, dim=1))  # [B, Lx, H]
        return x @ dense["proj"]
