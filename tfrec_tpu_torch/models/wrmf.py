"""WRMF, weighted regularized matrix factorization for implicit feedback
(Hu, Koren and Volinsky 2008).

The counterpart of ``tfrec_tpu/models/wrmf.py``. It scores as plain MF
(dot product, no bias: the closed-form solve has none) and trains by
alternating least squares, not by the SGD step: ``make_solver`` gives the
trainer ``train/als.ALSTrainer``, whose epoch is one sweep, and
``solver_loss_name`` is the loss it logs. ``forward`` serves eval and
serving, its rows through the gather kernel.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from tfrec_tpu_torch.models.base import DataSpec, DotRetrieval, RecModel
from tfrec_tpu_torch.ops.embedding import TableSpec, gather_many


class WRMF(RecModel):
    solver_loss_name = "wrmf"

    def __init__(self, data_spec: DataSpec, embed_dim: int, alpha: float = 10.0, reg: float = 0.05):
        super().__init__()
        if data_spec.kind != "interaction":
            raise ValueError(f"WRMF needs an interaction DataSpec, got {data_spec.kind!r}")
        self.data_spec = data_spec
        self.embed_dim = embed_dim
        self.alpha = alpha
        self.reg = reg

    def make_solver(self, dataset, *, batch: int, seed: int, mesh=None, device="cpu"):
        from tfrec_tpu_torch.train.als import ALSTrainer

        return ALSTrainer(dataset, self.embed_dim, alpha=self.alpha, reg=self.reg, batch=batch, seed=seed,
                          mesh=mesh, device=device)

    def table_specs(self) -> Tuple[TableSpec, ...]:
        u, v, d = self.data_spec.num_users, self.data_spec.num_items, self.embed_dim
        return (TableSpec("user_emb", u, d), TableSpec("item_emb", v, d))

    def init_dense(self, generator: torch.Generator, device: torch.device | str):
        return {}

    def lookup_ids(self, batch) -> Dict[str, torch.Tensor]:
        items = self.pair_item_ids(batch) if self.is_pairwise(batch) else batch["item"]
        return {"user_emb": batch["user"], "item_emb": items}

    def forward(self, dense, gathered, batch, *, generator=None) -> torch.Tensor:
        u, i = gathered["user_emb"], gathered["item_emb"]
        if self.is_pairwise(batch) and "neg" in batch:
            bsz = u.shape[0]
            return (u * i[:bsz]).sum(-1) - (u * i[bsz:]).sum(-1)
        return (u * i).sum(dim=-1)

    def dot_decomposition(self) -> DotRetrieval:
        return DotRetrieval("user_emb", "item_emb", None)

    def score_all(self, params, user_ids: torch.Tensor) -> torch.Tensor:
        t = params["tables"]
        (u,) = gather_many([t["user_emb"]], [user_ids])
        return torch.matmul(u, t["item_emb"].T)
