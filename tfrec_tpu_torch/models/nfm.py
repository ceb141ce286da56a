"""NFM, the Neural Factorization Machine (He & Chua 2017).

The counterpart of ``tfrec_tpu/models/nfm.py``: FM's second-order term kept
as a vector (bi-interaction pooling, the FM identity per dimension) and fed,
concatenated with the dense features, through an MLP, beside FM's linear
terms. The sparse path is FM's (field and linear tables, one gather launch
on a card); the rest is plain PyTorch.
"""

from __future__ import annotations

import torch

from tfrec_tpu_torch.models.base import DataSpec
from tfrec_tpu_torch.models.ctr_base import CTRBase
from tfrec_tpu_torch.models.layers import apply_mlp, init_mlp


def bi_interaction(field_vecs: torch.Tensor) -> torch.Tensor:
    """0.5 * ((sum_f v_f)^2 - sum_f v_f^2) per dimension: [B, F, D] ->
    [B, D], ``fm_second_order`` before its sum over D."""
    total = field_vecs.sum(dim=1)
    sq = (field_vecs * field_vecs).sum(dim=1)
    return 0.5 * (total * total - sq)


class NFM(CTRBase):
    use_linear_tables = True

    def __init__(self, data_spec: DataSpec, embed_dim: int, mlp_dims, dropout: float = 0.0):
        # Bi-interaction needs one width for every field.
        super().__init__(data_spec, embed_dim)
        self.mlp_dims = tuple(mlp_dims)
        self.dropout = dropout

    def init_dense(self, generator: torch.Generator, device: torch.device | str):
        in_dim = self.embed_dim + self.data_spec.num_dense
        d = {"w0": torch.zeros((), device=device),
             "mlp": init_mlp(generator, in_dim, (*self.mlp_dims, 1), device)}
        if self.data_spec.num_dense > 0:
            d["w_dense"] = torch.zeros((self.data_spec.num_dense,), device=device)
        return d

    def forward(self, dense, gathered, batch, *, generator=None) -> torch.Tensor:
        """Logits [B]; the tower's dropout runs only with a ``generator``."""
        logit = dense["w0"] + self.linear_sum(gathered, batch)
        x = bi_interaction(self.field_stack(gathered, batch))
        if self.data_spec.num_dense > 0:
            logit = logit + batch["dense"] @ dense["w_dense"]
            x = torch.cat([x, batch["dense"]], dim=-1)
        return logit + apply_mlp(dense["mlp"], x, dropout=self.dropout, generator=generator)[:, 0]
