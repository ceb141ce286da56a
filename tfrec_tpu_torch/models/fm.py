"""Factorization machine (FM): pointwise CTR over multi-field categoricals,
the model of config 2.

The counterpart of ``tfrec_tpu/models/fm.py``: logit = w0 + w_dense . x_dense
+ sum_f lin_f[id_f] + 0.5 (||sum_f v_f||^2 - sum_f ||v_f||^2), the
second-order term by the O(F*D) identity (``ctr_base.fm_second_order``).
Training gathers the field and linear tables of a batch (2F tables, one
launch of the gather kernel on a card); everything after the gather is
plain PyTorch, as the reference leaves it to XLA.

In the 2-field (user, item) form FM is also a retrieval model: ``score_all``
reduces to an MF-style product plus the linear terms. With side fields it
raises ``NotImplementedError``, as the reference does.
"""

from __future__ import annotations

import torch

from tfrec_tpu_torch.models.base import DotRetrieval
from tfrec_tpu_torch.models.ctr_base import CTRBase, fm_second_order
from tfrec_tpu_torch.ops.embedding import gather_many


class FM(CTRBase):
    use_linear_tables = True

    def init_dense(self, generator: torch.Generator, device: torch.device | str):
        d = {"w0": torch.zeros((), device=device)}
        if self.data_spec.num_dense > 0:
            d["w_dense"] = torch.zeros((self.data_spec.num_dense,), device=device)
        return d

    def forward(self, dense, gathered, batch, *, generator=None) -> torch.Tensor:
        """Logits [B]; FM has no dropout, so ``generator`` is unused."""
        logit = dense["w0"] + self.linear_sum(gathered, batch)
        if self.data_spec.num_dense > 0:
            logit = logit + batch["dense"] @ dense["w_dense"]
        return logit + fm_second_order(self.field_stack(gathered, batch))

    def _two_field(self) -> bool:
        return self.num_fields == 2 and self.data_spec.num_dense == 0

    def dot_decomposition(self) -> DotRetrieval | None:
        """The 2-field form over per-field tables only (a packed or stacked
        layout has no per-field table to name, as in the reference): its
        scores differ from ``score_all``'s by the per-user constant u_lin +
        w0, which does not change a ranking."""
        if not self._two_field() or self.layout != "field":
            return None
        return DotRetrieval("field_0", "field_1", "lin_1")

    def score_all(self, params, user_ids: torch.Tensor) -> torch.Tensor:
        """[B, V] full-catalog scores of the (user, item) form, whose only
        cross-field term is <v_u, v_i>: the user's rows (embedding and
        linear weight, one gather launch) against the item table, plus the
        linear terms and w0. A packed or stacked model's per-field tables
        are copied out of its layout first."""
        if not self._two_field():
            raise NotImplementedError("score_all requires the 2-field (u,i) form")
        t, d = params["tables"], params["dense"]
        if self.layout != "field":
            t = {k: v.contiguous() for k, v in self.split_fields(t).items()}
        u, u_lin = gather_many([t["field_0"], t["lin_0"]], [user_ids, user_ids])
        scores = torch.matmul(u, t["field_1"].T)
        return scores + u_lin + t["lin_1"][:, 0][None, :] + d["w0"]
