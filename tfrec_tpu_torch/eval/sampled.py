"""Sampled-candidate ranking evaluation (the NCF leave-one-out protocol).

The counterpart of ``tfrec_tpu/eval/sampled.py``: each held-out positive is
ranked against N sampled negatives instead of the full catalog, the
protocol NeuMF-style papers report HR@k and NDCG@k under. It works with
every model through the pointwise forward (each user repeated over its 1+N
candidates), so MLP and NeuMF never build [B, V] scores.

``build_candidates`` is the reference's host numpy, copied as it is, so its
candidates are the reference's array for array under the same seed. A
model with ``score_user_items`` (the sequential family) takes the
reference's per-user path instead: each user's history is encoded once and
dotted with its 1+N candidates.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from tfrec_tpu_torch.ops.embedding import gather_many


def build_candidates(
    dataset, num_candidates: int, seed: int, max_users: int | None = None
) -> Dict[str, np.ndarray]:
    """Per test interaction: [positive, N sampled negatives].

    Negatives exclude the user's train AND test items (rejection resample).
    Returns {"user": [T], "candidates": [T, 1+N]} for T test cases.
    """
    rng = np.random.default_rng(seed)
    test = dataset.test
    n = len(test) if max_users is None else min(len(test), max_users)
    users = test.users[:n]
    pos = test.items[:n]
    num_items = dataset.num_items

    train_csr = dataset.train_csr
    test_csr = dataset.test_csr

    def user_exclusions(u):
        tr = train_csr.indices[train_csr.indptr[u] : train_csr.indptr[u + 1]]
        te = test_csr.indices[test_csr.indptr[u] : test_csr.indptr[u + 1]]
        return set(tr.tolist()) | set(te.tolist())

    excl_cache: Dict[int, set] = {}
    negs = np.empty((n, num_candidates), dtype=np.int32)
    for i, u in enumerate(users):
        excl = excl_cache.get(int(u))
        if excl is None:
            excl = user_exclusions(int(u))
            excl_cache[int(u)] = excl
        draw = rng.integers(0, num_items, num_candidates * 2)
        picked = [d for d in draw if d not in excl][:num_candidates]
        for _ in range(8):  # bounded rejection rounds
            if len(picked) >= num_candidates:
                break
            extra = rng.integers(0, num_items, num_candidates)
            picked.extend(d for d in extra if d not in excl)
        picked = picked[:num_candidates]
        if len(picked) < num_candidates:
            # A user who has interacted with (almost) the whole catalog:
            # fill with unrestricted draws so evaluation terminates; the
            # metric is pessimistic for this user, never wrong for others.
            fill = rng.integers(0, num_items, num_candidates - len(picked))
            picked.extend(int(d) for d in fill)
        negs[i] = picked
    candidates = np.concatenate([pos[:, None], negs], axis=1).astype(np.int32)
    return {"user": users.astype(np.int32), "candidates": candidates}


class SampledEvaluator:
    """HR@k and NDCG@k over fixed sampled candidates.

    The candidates are drawn once and kept on the device. A batch of
    ``user_batch`` test cases is scored through the model's
    ``score_user_items`` where it has one, else its pointwise forward, the
    rows gathered through ``ops.embedding.gather_many`` (one
    launch of the gather kernel a batch on a card, ids clipped as the
    reference's ``jnp.take(mode="clip")``); the last batch is padded with
    user 0 and its padding cut before the metrics. A case's rank is the
    number of its negatives that score strictly higher than its positive
    (ties go to the positive)."""

    def __init__(
        self,
        model,
        dataset,
        ks: Sequence[int],
        num_candidates: int = 100,
        seed: int = 0,
        user_batch: int = 512,
        # Cap on evaluated test interactions; "eval_cases" reports the
        # coverage so a capped run is never mistaken for the full protocol.
        max_users: int | None = 20_000,
        device: torch.device | str = "cuda",
    ):
        self.model = model
        self.ks = tuple(ks)
        self.user_batch = user_batch
        self.device = torch.device(device)
        data = build_candidates(dataset, num_candidates, seed, max_users)
        self.users = data["user"]
        self.candidates = data["candidates"]
        self._users = torch.from_numpy(self.users).to(self.device)
        self._candidates = torch.from_numpy(self.candidates).to(self.device)

    def _rank_batch(self, params, users: torch.Tensor, cands: torch.Tensor) -> torch.Tensor:
        """Ranks [B] of the positives (column 0) of ``cands`` [B, 1+N]."""
        b, width = cands.shape
        if hasattr(self.model, "score_user_items"):
            scores = self.model.score_user_items(params, users, cands)
            return (scores[:, 1:] > scores[:, :1]).sum(dim=1)
        flat_users = users.repeat_interleave(width)
        batch = {"user": flat_users, "item": cands.reshape(-1),
                 "label": torch.zeros(flat_users.shape[0], dtype=torch.float32, device=users.device)}
        ids = self.model.lookup_ids(batch)
        tables = params["tables"]
        gathered = dict(zip(ids, gather_many([tables[k] for k in ids], list(ids.values()))))
        scores = self.model(params["dense"], gathered, batch).reshape(b, width)
        return (scores[:, 1:] > scores[:, :1]).sum(dim=1)

    @torch.no_grad()
    def ranks(self, params) -> np.ndarray:
        """Every case's rank [T] int64, batch by batch."""
        ub = self.user_batch
        out = []
        for start in range(0, len(self.users), ub):
            users = self._users[start : start + ub]
            cands = self._candidates[start : start + ub]
            take = users.shape[0]
            if take < ub:  # pad to the fixed batch shape
                users = torch.cat([users, users.new_zeros(ub - take)])
                cands = torch.cat([cands, cands.new_zeros((ub - take, cands.shape[1]))])
            out.append(self._rank_batch(params, users, cands)[:take])
        return torch.cat(out).cpu().numpy()

    def __call__(self, params) -> Dict[str, float]:
        rank = self.ranks(params).astype(np.float64)
        out: Dict[str, float] = {"eval_cases": float(len(rank))}
        for k in self.ks:
            hit = rank < k
            out[f"hr@{k}"] = float(hit.mean())
            out[f"ndcg_sampled@{k}"] = float(np.where(hit, 1.0 / np.log2(rank + 2.0), 0.0).mean())
        return out
