"""Top-k candidate retrieval and full-catalog ranking evaluation.

The counterpart of ``tfrec_tpu/eval/retrieval.py``: score every item for
a batch of users, set the scores of excluded items (each user's train
positives) to ``NEG_INF``, take the top k, and compute the ranking metrics,
all on the device. In the reference the product, the masking scatter and
the top-k are XLA operations, not Pallas kernels; here they are
``torch.matmul`` (in the model's ``score_all``), a masked fill and
``torch.topk``.

Top-k methods: "exact" and "approx" both run ``torch.topk``, which is
exact. The reference's "approx" is ``lax.approx_max_k``, the TPU's partial
reduction with a recall target; on the CPU it lowers to an exact sort
(``tests/test_metrics.py`` pins approx equal to exact there), and the card
has no such operation, so the port computes exactly what the reference
computes on the CPU. ``recall_target`` is accepted and has no effect.

The reference splits rows wider than 262 144 items into column chunks for
its exact top-k, because one sort of a [1024, 1M] matrix crashed its TPU
worker; the split gives the same result as one top-k. ``torch.topk``
selects without a full sort at any width, so the port takes one top-k.

Ties: ``lax.top_k`` puts the lower index first; ``torch.topk`` promises no
order among equal values. Equal scores are rare in trained models; the
masked ``NEG_INF`` entries tie whenever k exceeds a row's unmasked items,
and ``chunked_topk`` maps those to the sentinel id ``num_items``, as the
reference does.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from tfrec_tpu_torch.eval.metrics import ranking_metrics_from_topk

NEG_INF = -1e30
TOPK_METHODS = ("exact", "approx")


def candidate_topk(
    scores: torch.Tensor, k: int, method: str = "exact", recall_target: float = 0.99,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The top ``k`` (values, int32 ids) of each row of ``scores``, best
    first. Both methods are the exact ``torch.topk`` (module docstring)."""
    if method not in TOPK_METHODS:
        raise ValueError(f"unknown topk method {method!r}")
    vals, ids = torch.topk(scores, k, dim=-1)
    return vals, ids.to(torch.int32)


def padded_positives(csr: sp.csr_matrix, pad_to: int | None = None) -> Tuple[np.ndarray, np.ndarray]:
    """Each row's positive items padded to a static width with the sentinel
    ``num_items``: (padded [U, W] int32, counts [U] int32)."""
    num_users, num_items = csr.shape
    lengths = np.diff(csr.indptr).astype(np.int32)
    width = int(pad_to if pad_to is not None else max(1, lengths.max(initial=1)))
    padded = np.full((num_users, width), num_items, dtype=np.int32)
    for u in range(num_users):
        row = csr.indices[csr.indptr[u] : csr.indptr[u + 1]][:width]
        padded[u, : len(row)] = row
    return padded, np.minimum(lengths, width)


def _fill_columns(scores: torch.Tensor, cols: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """``scores[b, cols[b, j]] = NEG_INF`` where ``keep[b, j]``, in place.

    A scatter of the kept columns into a boolean mask one column wider
    than ``scores``: the other slots write their sentinel column, which is
    cut off, so no index out of range reaches a scatter (on the CPU it
    raises; on the card it fails a device-side assert) and nothing
    synchronises with the host. Every write to a mask element writes True,
    so repeated columns do not race."""
    width = scores.shape[1]
    mask = torch.zeros((scores.shape[0], width + 1), dtype=torch.bool, device=scores.device)
    mask.scatter_(1, torch.where(keep, cols, width).to(torch.int64), True)
    return scores.masked_fill_(mask[:, :width], NEG_INF)


def mask_items(scores: torch.Tensor, exclude_padded: torch.Tensor,
               exclude_counts: torch.Tensor) -> torch.Tensor:
    """Set the scores of each row's excluded items (its first
    ``exclude_counts`` entries of ``exclude_padded``, e.g. train positives)
    to ``NEG_INF``, in place; returns ``scores``.

    As the reference's scatter in ``mode="drop"``: the sentinel (>=
    num_items) and the slots past a row's count change nothing, and an id
    in [-V, 0) counts from the end."""
    v = scores.shape[1]
    valid = torch.arange(exclude_padded.shape[1], device=scores.device)[None, :] < exclude_counts[:, None]
    cols = torch.where(exclude_padded < 0, exclude_padded + v, exclude_padded)
    return _fill_columns(scores, cols, valid & (cols >= 0) & (cols < v))


def topk_scores(
    scores: torch.Tensor,
    k: int,
    exclude_padded: torch.Tensor | None = None,
    exclude_counts: torch.Tensor | None = None,
    method: str = "exact",
    recall_target: float = 0.99,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k (values, item ids) over a dense [B, V] score matrix, the
    excluded items masked first (in place)."""
    if exclude_padded is not None:
        scores = mask_items(scores, exclude_padded, exclude_counts)
    return candidate_topk(scores, k, method, recall_target)


def chunked_topk(
    score_chunk_fn: Callable[[torch.Tensor, int], torch.Tensor],
    user_ids: torch.Tensor,
    num_items: int,
    k: int,
    chunk_size: int,
    exclude_padded: torch.Tensor | None = None,
    exclude_counts: torch.Tensor | None = None,
    method: str = "exact",
    recall_target: float = 0.99,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """A running top-k merge over item chunks, which never builds [B, V].

    ``score_chunk_fn(user_ids, start) -> [B, chunk_size]`` scores items
    [start, start + chunk_size); columns past ``num_items`` score NEG_INF.
    The merge of the best k so far with a chunk's best is exact. Ids whose
    value is NEG_INF (masked or past the catalog) come back as the
    sentinel ``num_items``. Returns (values [B, k] f32, ids [B, k] int32).
    """
    batch = user_ids.shape[0]
    device = user_ids.device
    best_vals = torch.full((batch, k), NEG_INF, dtype=torch.float32, device=device)
    best_ids = torch.full((batch, k), num_items, dtype=torch.int32, device=device)
    arange = torch.arange(chunk_size, dtype=torch.int32, device=device)
    if exclude_padded is not None:
        valid = torch.arange(exclude_padded.shape[1], device=device)[None, :] < exclude_counts[:, None]
    for start in range(0, num_items, chunk_size):
        scores = score_chunk_fn(user_ids, start)
        ids = start + arange[None, :]
        scores = torch.where(ids < num_items, scores, NEG_INF)
        if exclude_padded is not None:
            local = exclude_padded - start
            _fill_columns(scores, local, valid & (local >= 0) & (local < chunk_size))
        c_vals, c_idx = candidate_topk(scores, min(k, chunk_size), method, recall_target)
        c_ids = start + c_idx
        c_ids = torch.where(c_vals <= NEG_INF * 0.5, num_items, c_ids)
        vals, idx = torch.topk(torch.cat([best_vals, c_vals], dim=1), k, dim=1)
        best_vals, best_ids = vals, torch.gather(torch.cat([best_ids, c_ids], dim=1), 1, idx)
    return best_vals, best_ids


class RetrievalEvaluator:
    """Full-catalog ranking evaluation over the users with test items.

    The padded train and test positives are built once and kept on the
    device. A batch of users is scored (``score_all_fn(params, users)``),
    its train items masked, its top max(ks) taken and its metrics summed;
    the final batch is padded with user 0 at no test items, which counts
    for nothing."""

    def __init__(
        self,
        score_all_fn: Callable[..., torch.Tensor],
        dataset,
        ks: Sequence[int],
        user_batch: int = 256,
        topk_method: str = "exact",
        device: torch.device | str = "cuda",
    ):
        self.score_all_fn = score_all_fn
        self.ks = tuple(ks)
        self.user_batch = user_batch
        self.topk_method = topk_method
        self.device = torch.device(device)
        train_padded, train_counts = padded_positives(dataset.train_csr)
        test_padded, test_counts = padded_positives(dataset.test_csr)
        self.users_with_test = np.flatnonzero(test_counts > 0).astype(np.int32)

        def on_device(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(a).to(self.device)

        self.train_padded, self.train_counts = on_device(train_padded), on_device(train_counts)
        self.test_padded, self.test_counts = on_device(test_padded), on_device(test_counts)

    def _eval_batch(self, params, users: torch.Tensor, n_real: int):
        """The batch's metric sums (each metric's mean times its users with
        test items) and that number of users, as 0-d tensors."""
        max_k = max(self.ks)
        ulong = users.long()
        tst_c = self.test_counts[ulong].clone()
        tst_c[n_real:] = 0  # the padding users
        scores = self.score_all_fn(params, users)
        _, topk_items = topk_scores(scores, max_k, self.train_padded[ulong], self.train_counts[ulong],
                                    method=self.topk_method)
        metrics = ranking_metrics_from_topk(topk_items, self.test_padded[ulong], tst_c, self.ks)
        n_users = (tst_c > 0).to(torch.float32).sum()
        return {k: v * n_users for k, v in metrics.items()}, n_users

    @torch.no_grad()
    def __call__(self, params) -> Dict[str, float]:
        sums: Dict[str, float] = {}
        total_users = 0.0
        for start in range(0, len(self.users_with_test), self.user_batch):
            batch_users = self.users_with_test[start : start + self.user_batch]
            n_real = len(batch_users)
            if n_real < self.user_batch:
                batch_users = np.concatenate(
                    [batch_users, np.zeros(self.user_batch - n_real, dtype=np.int32)])
            metrics, n_users = self._eval_batch(
                params, torch.from_numpy(batch_users).to(self.device), n_real)
            total_users += float(n_users)
            for key, val in metrics.items():
                sums[key] = sums.get(key, 0.0) + float(val)
        # Keys in sorted order, as the reference's jitted dict comes back.
        return {k: sums[k] / max(total_users, 1.0) for k in sorted(sums)}


def evaluate_retrieval(
    score_all_fn: Callable[..., torch.Tensor],
    params,
    dataset,
    ks: Sequence[int],
    user_batch: int = 256,
    device: torch.device | str = "cuda",
) -> Dict[str, float]:
    """One ``RetrievalEvaluator`` call."""
    return RetrievalEvaluator(score_all_fn, dataset, ks, user_batch, device=device)(params)
