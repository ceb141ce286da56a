"""DLRM (Naumov et al. 2019): a bottom MLP over the dense features, an
interaction of {bottom output, field embeddings}, and a top MLP over it.

The counterpart of ``tfrec_tpu/models/dlrm.py``, whose interaction is the
default here, ``interaction="dot"``: the pairwise dot products of the F' =
F + 1 vectors (the reference's einsum, outside any Pallas kernel), their
strict lower triangle in ``np.tril_indices(F', k=-1)``'s row-major order (the
top MLP's first weight reads the pairs in the reference's order), and the
top MLP over [bottom ; products]. ``kernels/interaction_cuda.dot_interaction``
computes [bottom ; products] from the bottom output and the field embeddings
where they lie (``interaction.cu`` on a card, one launch each way).

``interaction="dcn"`` is the port's alone: MLPerf Training's DLRM-DCNv2
(torchrec's ``DLRM_DCN``: ``DenseArch``, ``InteractionDCNArch`` over a
``LowRankCrossNet``, ``OverArch``; Wang et al. 2020). The bottom MLP has a
ReLU after every layer, as torchrec's ``MLP`` does; x0 = [bottom ; the F
field embeddings] (d0 = F' * D); the low-rank cross stack x_{l+1} = x0 *
(U_l (V_l^T x_l) + b_l) + x_l of ``num_cross_layers`` layers of rank
``cross_rank`` runs through ``kernels/cross.cross_stack`` (``cross_v2.cu`` on a
card), with U and V drawn as ``models/dcn.DCN`` draws them; the top MLP (the
over-arch) reads the cross output x_L alone. MLPerf sums its bags: build it
with ``combiner="sum"``.
"""

from __future__ import annotations

import torch

from tfrec_tpu_torch.kernels.cross import cross_stack
from tfrec_tpu_torch.kernels.interaction_cuda import dot_interaction
from tfrec_tpu_torch.models.base import DataSpec
from tfrec_tpu_torch.models.ctr_base import CTRBase
from tfrec_tpu_torch.models.layers import apply_mlp, init_mlp

INTERACTIONS = ("dot", "dcn")


class DLRM(CTRBase):
    def __init__(self, data_spec: DataSpec, embed_dim: int, bottom_dims=(64,), top_dims=(256, 128),
                 dropout: float = 0.0, *, interaction: str = "dot", num_cross_layers: int = 3,
                 cross_rank: int = 512, combiner: str = "mean"):
        super().__init__(data_spec, embed_dim, combiner=combiner)
        if interaction not in INTERACTIONS:
            raise ValueError(f"unknown DLRM interaction {interaction!r}; options: {INTERACTIONS}")
        if interaction == "dcn" and (num_cross_layers < 1 or cross_rank < 1):
            raise ValueError("the DCN interaction needs at least one cross layer of rank >= 1")
        self.bottom_dims = tuple(bottom_dims)
        self.top_dims = tuple(top_dims)
        self.dropout = dropout
        self.interaction = interaction
        self.num_cross_layers = num_cross_layers
        self.cross_rank = cross_rank
        self.has_bottom = data_spec.num_dense > 0

    def _num_vectors(self) -> int:
        return self.num_fields + (1 if self.has_bottom else 0)

    @property
    def input_dim(self) -> int:
        """The DCN interaction's d0: every vector side by side."""
        return self._num_vectors() * self.embed_dim

    def init_dense(self, generator: torch.Generator, device: torch.device | str):
        nv = self._num_vectors()
        if self.interaction == "dcn":
            top_in = self.input_dim
        else:
            top_in = nv * (nv - 1) // 2 + (self.embed_dim if self.has_bottom else 0)
        d = {"top": init_mlp(generator, top_in, (*self.top_dims, 1), device)}
        if self.has_bottom:
            # The bottom MLP projects the dense features into the embedding space.
            d["bottom"] = init_mlp(generator, self.data_spec.num_dense,
                                   (*self.bottom_dims, self.embed_dim), device)
        if self.interaction == "dcn":
            d0, nl, r = self.input_dim, self.num_cross_layers, self.cross_rank

            def normal(*shape):
                return torch.randn(shape, generator=generator, device=device) / d0**0.5

            d["cross"] = {"b": torch.zeros((nl, d0), device=device), "u": normal(nl, d0, r),
                          "v": normal(nl, d0, r)}
        return d

    def forward(self, dense, gathered, batch, *, generator=None) -> torch.Tensor:
        """Logits [B]; the top MLP's dropout runs only with a ``generator``."""
        if self.interaction == "dcn":
            return self._forward_dcn(dense, gathered, batch, generator)
        fields = self.field_list(gathered, batch)  # F of [B, D]
        bottom = apply_mlp(dense["bottom"], batch["dense"]) if self.has_bottom else None  # [B, D]
        top_in = dot_interaction(bottom, fields)  # [B, D + F'(F'-1)/2]
        return apply_mlp(dense["top"], top_in, dropout=self.dropout, generator=generator)[:, 0]

    def _forward_dcn(self, dense, gathered, batch, generator) -> torch.Tensor:
        parts = self.field_list(gathered, batch)  # F of [B, D]
        if self.has_bottom:
            parts = [apply_mlp(dense["bottom"], batch["dense"], final_linear=False), *parts]
        x0 = torch.cat(parts, dim=-1)  # [B, d0]
        x = cross_stack(x0, dense["cross"])
        return apply_mlp(dense["top"], x, dropout=self.dropout, generator=generator)[:, 0]
