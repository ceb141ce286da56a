"""Deep & Cross Network (DCN v1 and v2) — the flagship CTR model.

The counterpart of ``tfrec_tpu/models/dcn.py``: explicit feature crosses
x_{l+1} = x0*f(x_l) + b + x_l beside a ReLU MLP, both over the concatenated
field embeddings and dense features, then a linear head. v1 uses rank-one
cross weights; v2 a full (cross_rank=0) or low-rank matrix. The cross stack
runs through ``kernels/cross.py``, which launches the CUDA kernels for v1
and v2 low-rank on a CUDA tensor (forward, and backward when training);
v2 full-rank, the MLP and the head are plain matmuls, differentiated by
autograd.
"""

from __future__ import annotations

import torch

from tfrec_tpu_torch.kernels.cross import cross_stack
from tfrec_tpu_torch.models.base import DataSpec
from tfrec_tpu_torch.models.ctr_base import CTRBase
from tfrec_tpu_torch.models.layers import apply_mlp, glorot, init_mlp


class DCN(CTRBase):
    supports_mixed_dims = True  # cross/deep towers work on the concat

    def __init__(
        self,
        data_spec: DataSpec,
        embed_dim: int,
        num_cross_layers: int,
        mlp_dims,
        *,
        v2: bool = False,
        cross_rank: int = 0,
        dropout: float = 0.0,
        field_dims=None,
    ):
        super().__init__(data_spec, embed_dim, field_dims)
        self.num_cross_layers = num_cross_layers
        self.mlp_dims = tuple(mlp_dims)
        self.v2 = v2
        self.cross_rank = cross_rank
        self.dropout = dropout

    @property
    def input_dim(self) -> int:
        return sum(self.field_dims) + self.data_spec.num_dense

    def init_dense(self, generator: torch.Generator, device: torch.device | str):
        d0, nl = self.input_dim, self.num_cross_layers

        def normal(*shape):
            return torch.randn(shape, generator=generator, device=device) / d0**0.5

        cross = {"b": torch.zeros((nl, d0), device=device)}
        if not self.v2:
            cross["w"] = normal(nl, d0)
        elif self.cross_rank > 0:
            cross["u"] = normal(nl, d0, self.cross_rank)
            cross["v"] = normal(nl, d0, self.cross_rank)
        else:
            cross["w"] = normal(nl, d0, d0)
        head_in = d0 + (self.mlp_dims[-1] if self.mlp_dims else 0)
        return {
            "cross": cross,
            "mlp": init_mlp(generator, d0, self.mlp_dims, device) if self.mlp_dims else [],
            "w_out": glorot(generator, (head_in, 1), device),
            "b_out": torch.zeros((), device=device),
        }

    def forward(self, dense, gathered, batch, *, generator=None) -> torch.Tensor:
        """Logits [B]. The deep tower's dropout runs only when a training
        step passes a ``generator``; serving passes none."""
        x0 = self.flat_input(gathered, batch)
        return self.head(dense, x0, cross_stack(x0, dense["cross"]), generator=generator)

    def head(self, dense, x0, x_cross, *, generator=None) -> torch.Tensor:
        """The deep tower over x0, concatenated with the cross output, then
        the linear head: everything of ``forward`` after the cross stack."""
        if self.mlp_dims:
            deep = apply_mlp(dense["mlp"], x0, final_linear=False,
                             dropout=self.dropout, generator=generator)
            fused = torch.cat([x_cross, deep], dim=-1)
        else:
            fused = x_cross
        return (fused @ dense["w_out"])[:, 0] + dense["b_out"]
