"""Seeded synthetic data: the port's numpy copies of
``tfrec_tpu.data.synthetic``'s ``synthetic_implicit``, ``synthetic_ctr`` and
``_zipf_ids``.

The port imports nothing of the JAX package, so it keeps its own copies; a
test holds each equal to its original for the same seed.

- ``synthetic_implicit``: implicit feedback drawn from a low-rank
  preference model with a popularity skew, the stand-in for MovieLens in
  config 1, on which MF + BPR reaches a recall@k well above random.
- ``synthetic_ctr``: Criteo-shaped CTR examples. Ids are Zipf(1.2)-skewed,
  as categorical features are, so the duplicate-id combine sees realistic
  duplication, and the label depends on second-order interactions of the
  fields, so a CTR model's loss falls as it trains.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from tfrec_tpu_torch.data.dataset import Interactions


def synthetic_implicit(
    num_users: int,
    num_items: int,
    interactions_per_user: int,
    latent_rank: int = 8,
    seed: int = 0,
    temperature: float = 0.5,
) -> Interactions:
    """Each user draws ``interactions_per_user`` distinct items from
    softmax(U_u . V^T / temperature) plus a popularity term. Timestamps are
    the draw order, so leave-one-out splitting is well defined."""
    rng = np.random.default_rng(seed)
    scale = 1.0 / np.sqrt(latent_rank)
    user_factors = rng.normal(0, scale, (num_users, latent_rank))
    item_factors = rng.normal(0, scale, (num_items, latent_rank))
    item_pop = rng.normal(0, 0.5, num_items)

    users, items, times = [], [], []
    k = min(interactions_per_user, num_items)
    for u in range(num_users):
        logits = user_factors[u] @ item_factors.T + item_pop
        logits = logits / temperature
        logits -= logits.max()
        p = np.exp(logits)
        p /= p.sum()
        chosen = rng.choice(num_items, size=k, replace=False, p=p)
        users.append(np.full(k, u, dtype=np.int32))
        items.append(chosen.astype(np.int32))
        times.append(np.arange(k, dtype=np.float64))
    return Interactions(
        users=np.concatenate(users),
        items=np.concatenate(items),
        ratings=np.ones(num_users * k, dtype=np.float32),
        times=np.concatenate(times),
        num_users=num_users,
        num_items=num_items,
    )


def synthetic_ctr(
    num_examples: int,
    num_dense: int = 13,
    vocab_sizes: Sequence[int] = (1000, 1000, 500, 500, 100, 100),
    seed: int = 0,
    embed_rank: int = 4,
    field_widths: Sequence[int] | None = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Generate (dense [N, D] f32, cat [N, sum(W)] i32, label [N] f32).

    Label model: logistic of (linear dense terms + pairwise dot-products of
    per-field latent vectors) plus noise. Width-W multi-hot fields carry
    1..W valid ids padded with the sentinel ``vocab``; their latent is the
    mean over valid ids (matching the model-side mean combiner).
    """
    rng = np.random.default_rng(seed)
    num_fields = len(vocab_sizes)
    widths = tuple(field_widths) if field_widths else (1,) * num_fields
    if len(widths) != num_fields:
        raise ValueError(f"{len(widths)} field widths for {num_fields} fields")
    dense = rng.normal(0, 1, (num_examples, num_dense)).astype(np.float32)

    field_latents = [
        rng.normal(0, 1.0 / np.sqrt(embed_rank), (v, embed_rank)) for v in vocab_sizes
    ]
    cat_cols = []
    field_vec_list = []
    for f, (v, w) in enumerate(zip(vocab_sizes, widths)):
        if w == 1:
            ids = _zipf_ids(rng, v, num_examples).astype(np.int32)[:, None]
            vec = field_latents[f][ids[:, 0]]
        else:
            ids = np.stack(
                [_zipf_ids(rng, v, num_examples) for _ in range(w)], axis=1
            ).astype(np.int32)
            counts = rng.integers(1, w + 1, num_examples)
            mask = np.arange(w)[None, :] < counts[:, None]
            ids = np.where(mask, ids, v).astype(np.int32)
            vecs_w = np.where(
                mask[:, :, None], field_latents[f][np.minimum(ids, v - 1)], 0.0
            )
            vec = vecs_w.sum(1) / np.maximum(mask.sum(1), 1)[:, None]
        cat_cols.append(ids)
        field_vec_list.append(vec)
    cat = np.concatenate(cat_cols, axis=1)

    dense_w = rng.normal(0, 0.3, num_dense)
    logit = dense @ dense_w
    vecs = np.stack(field_vec_list, axis=1)  # [N, F, R]
    total = vecs.sum(axis=1)
    sum_sq = (total**2).sum(axis=1)
    sq_sum = (vecs**2).sum(axis=(1, 2))
    logit += 0.5 * (sum_sq - sq_sum)  # FM second-order term
    logit += rng.normal(0, 0.5, num_examples)
    logit -= np.median(logit)  # ~balanced classes
    label = (rng.random(num_examples) < 1.0 / (1.0 + np.exp(-logit))).astype(np.float32)
    return dense, cat, label


def _zipf_ids(rng: np.random.Generator, vocab: int, n: int, a: float = 1.2) -> np.ndarray:
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    p = ranks**-a
    p /= p.sum()
    return rng.choice(vocab, size=n, p=p)
