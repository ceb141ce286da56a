"""Wide & Deep (Cheng et al. 2016): a linear "wide" part over the raw
categorical ids and the dense features, summed with a deep MLP over the
field embeddings.

The counterpart of ``tfrec_tpu/models/widedeep.py``. The tower reads the
concatenated fields, so fields may have mixed widths (``field_dims``).
"""

from __future__ import annotations

import torch

from tfrec_tpu_torch.models.base import DataSpec
from tfrec_tpu_torch.models.ctr_base import CTRBase
from tfrec_tpu_torch.models.layers import apply_mlp, init_mlp


class WideDeep(CTRBase):
    use_linear_tables = True
    supports_mixed_dims = True  # the deep tower works on the concatenation

    def __init__(self, data_spec: DataSpec, embed_dim: int, mlp_dims, dropout: float = 0.0,
                 field_dims=None):
        super().__init__(data_spec, embed_dim, field_dims)
        self.mlp_dims = tuple(mlp_dims)
        self.dropout = dropout

    def init_dense(self, generator: torch.Generator, device: torch.device | str):
        in_dim = sum(self.field_dims) + self.data_spec.num_dense
        d = {"b": torch.zeros((), device=device),
             "mlp": init_mlp(generator, in_dim, (*self.mlp_dims, 1), device)}
        if self.data_spec.num_dense > 0:
            d["w_dense"] = torch.zeros((self.data_spec.num_dense,), device=device)
        return d

    def forward(self, dense, gathered, batch, *, generator=None) -> torch.Tensor:
        """Logits [B]; the tower's dropout runs only with a ``generator``."""
        wide = dense["b"] + self.linear_sum(gathered, batch)
        if self.data_spec.num_dense > 0:
            wide = wide + batch["dense"] @ dense["w_dense"]
        deep = apply_mlp(dense["mlp"], self.flat_input(gathered, batch), dropout=self.dropout,
                         generator=generator)[:, 0]
        return wide + deep
