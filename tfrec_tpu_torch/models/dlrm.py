"""DLRM (Naumov et al. 2019): a bottom MLP over the dense features, the
pairwise dot products of {bottom output, field embeddings}, and a top MLP
over [bottom ; products].

The counterpart of ``tfrec_tpu/models/dlrm.py``. The products are one
batched matmul [B, F', D] x [B, D, F'] (the reference's einsum, outside any
Pallas kernel), and the strict lower triangle is taken in
``np.tril_indices(F', k=-1)``'s row-major order, which
``torch.tril_indices(F', F', -1)`` gives too: the top MLP's first weight
reads the pairs in the reference's order.
"""

from __future__ import annotations

import torch

from tfrec_tpu_torch.models.base import DataSpec
from tfrec_tpu_torch.models.ctr_base import CTRBase
from tfrec_tpu_torch.models.layers import apply_mlp, init_mlp


class DLRM(CTRBase):
    def __init__(self, data_spec: DataSpec, embed_dim: int, bottom_dims=(64,), top_dims=(256, 128),
                 dropout: float = 0.0):
        super().__init__(data_spec, embed_dim)
        self.bottom_dims = tuple(bottom_dims)
        self.top_dims = tuple(top_dims)
        self.dropout = dropout
        self.has_bottom = data_spec.num_dense > 0

    def _num_vectors(self) -> int:
        return self.num_fields + (1 if self.has_bottom else 0)

    def init_dense(self, generator: torch.Generator, device: torch.device | str):
        nv = self._num_vectors()
        top_in = nv * (nv - 1) // 2 + (self.embed_dim if self.has_bottom else 0)
        d = {"top": init_mlp(generator, top_in, (*self.top_dims, 1), device)}
        if self.has_bottom:
            # The bottom MLP projects the dense features into the embedding space.
            d["bottom"] = init_mlp(generator, self.data_spec.num_dense,
                                   (*self.bottom_dims, self.embed_dim), device)
        return d

    def forward(self, dense, gathered, batch, *, generator=None) -> torch.Tensor:
        """Logits [B]; the top MLP's dropout runs only with a ``generator``."""
        z = self.field_stack(gathered, batch)  # [B, F, D]
        bottom = None
        if self.has_bottom:
            bottom = apply_mlp(dense["bottom"], batch["dense"])  # [B, D]
            z = torch.cat([bottom[:, None, :], z], dim=1)  # [B, F', D]
        inter = torch.bmm(z, z.transpose(1, 2))  # [B, F', F']
        nv = z.shape[1]
        rows, cols = torch.tril_indices(nv, nv, -1, device=z.device)
        pairs = inter[:, rows, cols]  # [B, F'(F'-1)/2]
        top_in = torch.cat([bottom, pairs], dim=-1) if bottom is not None else pairs
        return apply_mlp(dense["top"], top_in, dropout=self.dropout, generator=generator)[:, 0]
