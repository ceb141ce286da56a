"""SBPR, social Bayesian personalized ranking (Zhao et al. 2014).

The counterpart of ``tfrec_tpu/models/sbpr.py``. Items a user's friends
consumed rank between the user's own positives and unobserved items:
x_pos >= x_soc >= x_neg, two BPR terms (``train/losses.sbpr``). The scorer
is MF's, so the model is MF with one more item column: a batch of
``data/samplers.SBPRSampler`` looks up its [pos; soc; neg] items in one
gather of ``item_emb`` (and ``item_bias``) beside the users', one kernel
launch for the tables on a card; a batch without "soc" (eval, serving, a
plain pairwise batch) is MF's.
"""

from __future__ import annotations

from typing import Dict

import torch

from tfrec_tpu_torch.models.mf import MF


class SBPR(MF):
    def lookup_ids(self, batch) -> Dict[str, torch.Tensor]:
        if "soc" not in batch:
            return super().lookup_ids(batch)
        items = torch.cat([batch["pos"], batch["soc"], batch["neg"]])
        ids = {"user_emb": batch["user"], "item_emb": items}
        if self.use_bias:
            ids["item_bias"] = items
        return ids

    def forward(self, dense, gathered, batch, *, generator=None):
        """With "soc": {"pos", "soc", "neg"} scores [B] and the batch's
        "suk" and "has_social" (as "has") for the loss; else MF's."""
        if "soc" not in batch:
            return super().forward(dense, gathered, batch, generator=generator)
        u, iv, b = gathered["user_emb"], gathered["item_emb"], gathered.get("item_bias")
        bsz = u.shape[0]

        def score(k):
            part = slice(k * bsz, (k + 1) * bsz)
            return self._score(u, iv[part], None if b is None else b[part])

        return {"pos": score(0), "soc": score(1), "neg": score(2),
                "suk": batch["suk"], "has": batch["has_social"]}
