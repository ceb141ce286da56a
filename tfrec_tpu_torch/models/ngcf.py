"""NGCF (Wang et al. 2019): the counterpart of ``tfrec_tpu/models/ngcf.py``,
LightGCN with a transform and a nonlinearity a layer::

    agg     = A_hat e          (LightGCN's sorted sums, ``ops/graph``)
    e^(k+1) = LeakyReLU_0.2((e + agg) W1_k + b1_k + (agg * e) W2_k + b2_k)

and a node is the concatenation of its layers 0..K. The bi-interaction
message sum_j coef (e_j * e_u) is agg * e_u, since e_u is the same for
every edge of u. Message dropout (``dropout``) drops each layer's output
in training, from the step's generator.
"""

from __future__ import annotations

from typing import Tuple

import torch

from tfrec_tpu_torch.models.base import DataSpec
from tfrec_tpu_torch.models.lightgcn import LightGCN
from tfrec_tpu_torch.models.multvae import glorot
from tfrec_tpu_torch.ops.graph import aggregate


class NGCF(LightGCN):
    def __init__(self, data_spec: DataSpec, embed_dim: int = 64, num_layers: int = 3,
                 dropout: float = 0.1):
        super().__init__(data_spec, embed_dim, num_layers=num_layers)
        self.dropout = dropout

    def init_dense(self, generator: torch.Generator, device: torch.device | str):
        dense = super().init_dense(generator, device)
        d = self.embed_dim
        for k in range(self.num_layers):
            dense[f"w1_{k}"] = glorot(generator, d, d, device)
            dense[f"w2_{k}"] = glorot(generator, d, d, device)
            dense[f"b1_{k}"] = torch.zeros(d, device=device)
            dense[f"b2_{k}"] = torch.zeros(d, device=device)
        return dense

    def _drop(self, x: torch.Tensor, generator) -> torch.Tensor:
        if generator is None or self.dropout <= 0.0:
            return x
        keep = 1.0 - self.dropout
        mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
        return x * mask.to(x.dtype) / keep

    def propagate(self, dense, *, generator=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """(users [U, (K+1) D], items [V, (K+1) D])."""
        u_edges, i_edges = self.graph(dense["user_emb"].device)
        eu, ei = dense["user_emb"], dense["item_emb"]
        outs_u, outs_i = [eu], [ei]
        for k in range(self.num_layers):
            agg_u, agg_i = aggregate(eu, ei, u_edges, i_edges)
            w1, w2, b1, b2 = (dense[f"{n}_{k}"] for n in ("w1", "w2", "b1", "b2"))

            def layer(x, agg):
                return torch.nn.functional.leaky_relu(
                    (x + agg) @ w1 + b1 + (agg * x) @ w2 + b2, negative_slope=0.2)

            eu = self._drop(layer(eu, agg_u), generator)
            ei = self._drop(layer(ei, agg_i), generator)
            outs_u.append(eu)
            outs_i.append(ei)
        return torch.cat(outs_u, dim=-1), torch.cat(outs_i, dim=-1)
