"""Classification metrics, computed on the tensors' device.

The counterpart of ``tfrec_tpu/eval/metrics.py``'s ``auc`` and ``logloss``
(the ranking metrics of retrieval come with ROADMAP Queue 1 item 8). Both
take logits [N] and labels [N] (0 or 1) as float32 tensors and return a 0-d
float32 tensor on their device. The sort is ``torch.sort``; no Pallas
kernel of the reference stands behind either.
"""

from __future__ import annotations

import torch

from tfrec_tpu_torch.ops.embedding import run_first_index, run_last_index_plus1


def auc(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mann-Whitney AUC over binary labels, ties given their average rank
    (as sklearn's ``roc_auc_score``), in float32 as the reference; 0.5 when
    a class is absent."""
    n = logits.shape[0]
    sorted_logits, order = torch.sort(logits, stable=True)
    # The span of each tie: O(n) run scans over the sorted logits.
    lo = run_first_index(sorted_logits).to(torch.float32)
    hi = run_last_index_plus1(sorted_logits).to(torch.float32)
    avg_rank_sorted = (lo + hi - 1.0) / 2.0 + 1.0  # 1-based average ranks
    ranks = torch.zeros(n, dtype=torch.float32, device=logits.device)
    ranks[order] = avg_rank_sorted
    pos = labels > 0.5
    n_pos = pos.to(torch.float32).sum()
    n_neg = n - n_pos
    rank_sum_pos = torch.where(pos, ranks, 0.0).sum()
    u = rank_sum_pos - n_pos * (n_pos + 1.0) / 2.0
    both = (n_pos > 0) & (n_neg > 0)
    return torch.where(both, u / torch.clamp(n_pos * n_neg, min=1.0), 0.5)


def logloss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy from logits (numerically stable)."""
    return torch.mean(torch.clamp(logits, min=0.0) - logits * labels
                      + torch.log1p(torch.exp(-logits.abs())))
