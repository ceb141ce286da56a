"""Pop, the popularity baseline: score(u, i) = b_i.

The counterpart of ``tfrec_tpu/models/pop.py``: the bias-only member of the
MF family, one [V, 1] table (zeros at init) gathered through the kernel.
Trained under any objective it converges to item popularity, the floor a
personalised model must beat. Pairwise batches give s_pos - s_neg [B], the
[B, 1+K] bias matrix or, with in-batch negatives, every row's positive
bias for every user [B, B]; the catalog is the bias row for every user.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from tfrec_tpu_torch.models.base import DataSpec, RecModel
from tfrec_tpu_torch.ops.embedding import TableSpec


class Pop(RecModel):
    def __init__(self, data_spec: DataSpec):
        super().__init__()
        if data_spec.kind != "interaction":
            raise ValueError(f"Pop needs an interaction DataSpec, got {data_spec.kind!r}")
        self.data_spec = data_spec

    def table_specs(self) -> Tuple[TableSpec, ...]:
        return (TableSpec("item_bias", self.data_spec.num_items, 1, initializer="zeros"),)

    def init_dense(self, generator: torch.Generator, device: torch.device | str):
        return {}

    def lookup_ids(self, batch) -> Dict[str, torch.Tensor]:
        items = self.pair_item_ids(batch) if self.is_pairwise(batch) else batch["item"]
        return {"item_bias": items}

    def forward(self, dense, gathered, batch, *, generator=None) -> torch.Tensor:
        b = gathered["item_bias"][:, 0]
        if not self.is_pairwise(batch):
            return b
        bsz = batch["user"].shape[0]
        if "negs" in batch:
            k = batch["negs"].shape[1]
            return torch.cat([b[:bsz, None], b[bsz:].reshape(bsz, k)], dim=1)
        if "neg" not in batch:
            return b[None, :].expand(bsz, bsz)
        return b[:bsz] - b[bsz:]

    def score_all(self, params, user_ids: torch.Tensor) -> torch.Tensor:
        bias = params["tables"]["item_bias"][:, 0]
        return bias[None, :].expand(user_ids.shape[0], bias.shape[0]).contiguous()
