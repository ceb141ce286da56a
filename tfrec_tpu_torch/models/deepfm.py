"""DeepFM (Guo et al. 2017): FM's linear and second-order terms plus a deep
tower over the same field embeddings.

The counterpart of ``tfrec_tpu/models/deepfm.py``. The sparse path is FM's
(field and linear tables, one gather launch on a card); the tower is a
plain ReLU MLP over the concatenated fields and dense features.
"""

from __future__ import annotations

import torch

from tfrec_tpu_torch.models.base import DataSpec
from tfrec_tpu_torch.models.ctr_base import CTRBase, fm_second_order
from tfrec_tpu_torch.models.layers import apply_mlp, init_mlp


class DeepFM(CTRBase):
    use_linear_tables = True

    def __init__(self, data_spec: DataSpec, embed_dim: int, mlp_dims, dropout: float = 0.0):
        super().__init__(data_spec, embed_dim)
        self.mlp_dims = tuple(mlp_dims)
        self.dropout = dropout

    def init_dense(self, generator: torch.Generator, device: torch.device | str):
        in_dim = sum(self.field_dims) + self.data_spec.num_dense
        d = {"w0": torch.zeros((), device=device),
             "mlp": init_mlp(generator, in_dim, (*self.mlp_dims, 1), device)}
        if self.data_spec.num_dense > 0:
            d["w_dense"] = torch.zeros((self.data_spec.num_dense,), device=device)
        return d

    def forward(self, dense, gathered, batch, *, generator=None) -> torch.Tensor:
        """Logits [B]; the tower's dropout runs only with a ``generator``."""
        fields = self.field_list(gathered, batch)
        logit = (dense["w0"] + self.linear_sum(gathered, batch)
                 + fm_second_order(torch.stack(fields, dim=1)))
        if self.data_spec.num_dense > 0:
            logit = logit + batch["dense"] @ dense["w_dense"]
            fields = fields + [batch["dense"]]
        deep = apply_mlp(dense["mlp"], torch.cat(fields, dim=-1), dropout=self.dropout,
                         generator=generator)[:, 0]
        return logit + deep
