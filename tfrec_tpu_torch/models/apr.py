"""APR, adversarial personalized ranking (He et al. 2018).

The counterpart of ``tfrec_tpu/models/apr.py``: BPR-MF trained on its
clean loss and on the loss at the worst-case L2-bounded perturbation of the
gathered (user, pos, neg) factor rows, found by one fast-gradient step.
The inner maximisation is ``torch.autograd.grad`` of the summed BPR loss
with respect to detached copies of the gathered factor rows, inside the
step's forward; the perturbation ``eps * g / max(|g|, 1e-12)`` a row is
then a constant, as the reference's ``stop_gradient``, so the outer
backward never differentiates the attack. The biases stay clean. Eval and
serving score as plain MF.
"""

from __future__ import annotations

from typing import Dict

import torch

from tfrec_tpu_torch.models.base import DataSpec
from tfrec_tpu_torch.models.mf import MF


class APR(MF):
    def __init__(self, data_spec: DataSpec, embed_dim: int, eps: float = 0.5, adv_lambda: float = 1.0,
                 use_bias: bool = True):
        super().__init__(data_spec, embed_dim, use_bias=use_bias)
        self.eps = eps
        self.adv_lambda = adv_lambda

    def _diff(self, rows: Dict[str, torch.Tensor]) -> torch.Tensor:
        u, i, b = rows["user_emb"], rows["item_emb"], rows.get("item_bias")
        bsz = u.shape[0]
        s_pos = self._score(u, i[:bsz], None if b is None else b[:bsz])
        s_neg = self._score(u, i[bsz:], None if b is None else b[bsz:])
        return s_pos - s_neg

    def forward(self, dense, gathered, batch, *, generator=None):
        """A single-negative pairwise batch: {"diff", "diff_adv",
        "adv_weight"}; any other batch scores as MF."""
        if not self.is_pairwise(batch) or "neg" not in batch:
            return super().forward(dense, gathered, batch, generator=generator)
        diff = self._diff(gathered)
        names = ("user_emb", "item_emb")
        with torch.enable_grad():
            factors = {k: gathered[k].detach().requires_grad_() for k in names}
            inner = torch.logaddexp(-self._diff({**gathered, **factors}), torch.zeros_like(diff)).sum()
            grads = torch.autograd.grad(inner, [factors[k] for k in names])
        adv = dict(gathered)
        for k, g in zip(names, grads):
            norm = torch.sqrt((g * g).sum(dim=-1, keepdim=True))
            adv[k] = gathered[k] + self.eps * g / norm.clamp_min(1e-12)
        return {"diff": diff, "diff_adv": self._diff(adv),
                "adv_weight": torch.tensor(self.adv_lambda, dtype=diff.dtype, device=diff.device)}
