"""Ranking and classification metrics, computed on the tensors' device.

The counterpart of ``tfrec_tpu/eval/metrics.py``. No Pallas kernel of the
reference stands behind any of them.

- ``ranking_metrics_from_topk``: precision, recall, MAP, NDCG and MRR at
  each k, from ranked item ids [U, K] int32 (best first) and each user's
  test positives [U, T] int32, padded with a sentinel >= num_items, with
  their counts [U]. Users with no test item are left out of the means.
- ``auc`` and ``logloss``: logits [N] and labels [N] (0 or 1), float32. The
  sort is ``torch.sort``.

Each returns 0-d float32 tensors on the inputs' device.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from tfrec_tpu_torch.ops.embedding import run_first_index, run_last_index_plus1


def _hit_matrix(topk_items: torch.Tensor, test_padded: torch.Tensor,
                test_counts: torch.Tensor) -> torch.Tensor:
    """[U, K] float32: 1 where the ranked item is a test positive."""
    valid = torch.arange(test_padded.shape[1], device=test_padded.device)[None, :] < test_counts[:, None]
    eq = topk_items[:, :, None] == test_padded[:, None, :]  # [U, K, T]
    return (eq & valid[:, None, :]).any(dim=-1).to(torch.float32)


def ranking_metrics_from_topk(
    topk_items: torch.Tensor,
    test_padded: torch.Tensor,
    test_counts: torch.Tensor,
    ks: Sequence[int],
) -> Dict[str, torch.Tensor]:
    """Precision, recall, MAP, NDCG and MRR at each k of ``ks``: binary
    relevance, the ideal DCG over min(k, |test|) positives."""
    hits = _hit_matrix(topk_items, test_padded, test_counts)  # [U, K]
    device = hits.device
    counts = test_counts.to(torch.float32)
    has_test = counts > 0
    denom_users = torch.clamp_min(has_test.to(torch.float32).sum(), 1.0)
    ranks = torch.arange(1, hits.shape[1] + 1, dtype=torch.float32, device=device)
    log2_discount = 1.0 / torch.log2(ranks + 1.0)
    cum_hits = torch.cumsum(hits, dim=1)  # hits within the top r
    zero = torch.zeros((), device=device)

    out: Dict[str, torch.Tensor] = {}
    for k in ks:
        h = hits[:, :k]
        hits_at_k = cum_hits[:, k - 1]
        recall = torch.where(has_test, hits_at_k / torch.clamp_min(counts, 1.0), zero)
        precision = torch.where(has_test, hits_at_k / k, zero)
        # MAP@k: the precision at each hit, over min(k, |test|).
        prec_at_r = cum_hits[:, :k] / ranks[:k][None, :]
        ideal_len = torch.clamp_max(counts, float(k))
        ap = (prec_at_r * h).sum(dim=1) / torch.clamp_min(ideal_len, 1.0)
        dcg = (h * log2_discount[:k][None, :]).sum(dim=1)
        # idcg(u) = sum over r < ideal_len of 1/log2(r + 2), from a cumsum.
        idcg_table = torch.cat([torch.zeros(1, device=device), torch.cumsum(log2_discount[:k], 0)])
        idcg = idcg_table[torch.clamp_max(ideal_len, k).to(torch.int64)]
        ndcg = torch.where(has_test, dcg / torch.clamp_min(idcg, 1e-12), zero)
        # MRR@k: the reciprocal rank of the first hit.
        first_hit = torch.argmax(h, dim=1).to(torch.float32)
        any_hit = (h > 0).any(dim=1)
        mrr = torch.where(any_hit, 1.0 / (first_hit + 1.0), zero)

        out[f"recall@{k}"] = recall.sum() / denom_users
        out[f"precision@{k}"] = precision.sum() / denom_users
        out[f"map@{k}"] = torch.where(has_test, ap, zero).sum() / denom_users
        out[f"ndcg@{k}"] = ndcg.sum() / denom_users
        out[f"mrr@{k}"] = torch.where(has_test, mrr, zero).sum() / denom_users
    return out


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
