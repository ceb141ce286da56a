"""Mini-batch generators of the port: copies of ``tfrec_tpu.data.samplers``'
``PairwiseSampler``, ``PointwiseSampler`` (with the negative sampling under
them: ``_TrainPairIndex``, ``popularity_cdf``, ``_draw_items``,
``_sample_negatives``), ``CTRBatcher``, the history models'
``build_history`` and ``UserHistorySampler``, the sequential models'
``build_sequences`` and ``SequenceSampler``, and SBPR's ``SBPRSampler``.

The port imports nothing of the JAX package, so it keeps its own copies.
Every sampler draws from ``np.random.default_rng((seed, epoch))`` exactly
as its original does, so a test holds the batches of the two equal, array
for array. Batches have static shapes; the remainder is dropped. Negatives
are drawn in vectorised numpy: membership in the train pairs is one
``searchsorted`` a rejection round against a sorted key array.
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np

from tfrec_tpu_torch.data.dataset import Dataset


class _TrainPairIndex:
    """Sorted u * num_items + i keys for O(log N) membership tests."""

    def __init__(self, dataset: Dataset):
        self.num_items = dataset.num_items
        keys = (dataset.train.users.astype(np.int64) * dataset.num_items
                + dataset.train.items.astype(np.int64))
        self.keys = np.sort(keys)

    def contains(self, users: np.ndarray, items: np.ndarray) -> np.ndarray:
        q = users.astype(np.int64) * self.num_items + items.astype(np.int64)
        idx = np.searchsorted(self.keys, q)
        idx = np.minimum(idx, len(self.keys) - 1)
        return self.keys[idx] == q


def popularity_cdf(dataset: Dataset, beta: float = 0.75) -> np.ndarray:
    """Inverse-CDF table for popularity-biased negatives: item i drawn with
    probability proportional to train_count(i)^beta (beta=0 is uniform,
    since 0^0 == 1 in numpy). Items absent from the train split are never
    drawn for beta > 0."""
    counts = np.bincount(dataset.train.items, minlength=dataset.num_items).astype(np.float64)
    w = np.power(counts, beta)
    total = w.sum()
    if total <= 0:  # an empty train split: uniform
        w = np.ones_like(w)
        total = w.sum()
    return np.cumsum(w / total)


def _draw_items(rng: np.random.Generator, n: int, num_items: int,
                cdf: np.ndarray | None) -> np.ndarray:
    if cdf is None:
        return rng.integers(0, num_items, size=n, dtype=np.int64)
    return np.minimum(np.searchsorted(cdf, rng.random(n), side="right"),
                      num_items - 1).astype(np.int64)


def _sample_negatives(
    rng: np.random.Generator,
    index: _TrainPairIndex,
    users: np.ndarray,
    num_items: int,
    max_rounds: int = 64,
    cdf: np.ndarray | None = None,
) -> np.ndarray:
    """One negative a row, redrawing train positives for up to
    ``max_rounds`` rounds; ``cdf`` makes the proposal popularity^beta. A
    user who has every item keeps the last draw."""
    negs = _draw_items(rng, len(users), num_items, cdf)
    bad = index.contains(users, negs)
    rounds = 0
    while bad.any() and rounds < max_rounds:
        negs[bad] = _draw_items(rng, int(bad.sum()), num_items, cdf)
        bad = index.contains(users, negs)
        rounds += 1
    return negs.astype(np.int32)


def _fixed_batches(batch_size: int,
                   columns: Dict[str, np.ndarray]) -> Iterator[Dict[str, np.ndarray]]:
    """Consecutive batches of ``batch_size`` rows of the columns; the
    remainder is dropped."""
    n = len(next(iter(columns.values())))
    for start in range(0, n - batch_size + 1, batch_size):
        yield {k: v[start : start + batch_size] for k, v in columns.items()}


def build_history(dataset: Dataset, max_len: int, seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Each user's train items, unordered, for the history models: ([U, H]
    int32 item ids padded with the sentinel ``num_items``, [U] int32
    lengths, at most H). A user with more than H items keeps H of them drawn
    without replacement from ``default_rng((seed, 0x415))``, in user order,
    as the reference draws them (its sources need not carry times)."""
    rng = np.random.default_rng((seed, 0x415))
    u_sorted = np.argsort(dataset.train.users, kind="stable")
    users = dataset.train.users[u_sorted]
    items = dataset.train.items[u_sorted]
    nu = dataset.num_users
    if len(items) == 0:
        return np.full((nu, max_len), dataset.num_items, np.int32), np.zeros(nu, np.int32)
    starts = np.searchsorted(users, np.arange(nu))
    counts = np.searchsorted(users, np.arange(nu) + 1) - starts
    lens = np.minimum(counts, max_len).astype(np.int32)
    cols = np.arange(max_len)[None, :]
    valid = cols < lens[:, None]
    flat_idx = np.minimum(starts[:, None] + cols, len(items) - 1)
    hist = np.where(valid, items[flat_idx], dataset.num_items).astype(np.int32)
    for u in np.flatnonzero(counts > max_len):  # the few users past H
        hist[u] = rng.choice(items[starts[u] : starts[u] + counts[u]], size=max_len, replace=False)
    return hist, lens


class UserHistorySampler:
    """{user, hist [B, H], hist_len} batches, a row for every user with a
    train item, shuffled every epoch from ``default_rng((seed, epoch))``:
    the autoencoders' input, whose history is also the reconstruction
    target."""

    def __init__(self, dataset: Dataset, batch_size: int, max_len: int, seed: int = 0):
        self.batch_size = batch_size
        self.seed = seed
        self.hist, self.lens = build_history(dataset, max_len, seed)
        self.active = np.flatnonzero(self.lens > 0).astype(np.int32)

    def num_batches(self) -> int:
        return len(self.active) // self.batch_size

    def epoch(self, epoch: int) -> Iterator[Dict[str, np.ndarray]]:
        rng = np.random.default_rng((self.seed, epoch))
        users = self.active[rng.permutation(len(self.active))]
        for start in range(0, len(users) - self.batch_size + 1, self.batch_size):
            u = users[start : start + self.batch_size]
            yield {"user": u, "hist": self.hist[u], "hist_len": self.lens[u]}


class PairwiseSampler:
    """(user, pos, neg) batches for pairwise losses (BPR, hinge), with fresh
    negatives and a fresh shuffle every epoch from (seed, epoch).

    ``multi_neg=True`` gives {"user", "pos", "negs" [B, num_negatives]}
    (sampled softmax); ``no_negatives=True`` gives {"user", "pos"} (in-batch
    losses, and negatives drawn on the device); the default gives one
    (pos, neg) row a negative. ``with_history=H`` adds each row's user's
    train history, "hist" [B, H] sentinel-padded and "hist_len" [B]
    (``build_history`` from ``seed``), for the item-similarity models.
    """

    def __init__(
        self,
        dataset: Dataset,
        batch_size: int,
        num_negatives: int = 1,
        seed: int = 0,
        multi_neg: bool = False,
        no_negatives: bool = False,
        with_history: int = 0,
        neg_cdf: "np.ndarray | None" = None,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_negatives = num_negatives
        self.seed = seed
        self.multi_neg = multi_neg
        self.no_negatives = no_negatives
        self.neg_cdf = neg_cdf
        self.index = _TrainPairIndex(dataset)
        self.hist = self.lens = None
        if with_history:
            self.hist, self.lens = build_history(dataset, with_history, seed)

    def _batches(self, columns: Dict[str, np.ndarray]) -> Iterator[Dict[str, np.ndarray]]:
        """``_fixed_batches`` of the columns, each with its users' histories
        where the sampler carries them."""
        for batch in _fixed_batches(self.batch_size, columns):
            if self.hist is not None:
                u = batch["user"]
                batch = {**batch, "hist": self.hist[u], "hist_len": self.lens[u]}
            yield batch

    def num_batches(self) -> int:
        n = len(self.dataset.train)
        if not (self.multi_neg or self.no_negatives):
            n *= self.num_negatives
        return n // self.batch_size

    def epoch(self, epoch: int) -> Iterator[Dict[str, np.ndarray]]:
        rng = np.random.default_rng((self.seed, epoch))
        train = self.dataset.train
        if self.no_negatives:
            perm = rng.permutation(len(train))
            yield from self._batches({"user": train.users[perm], "pos": train.items[perm]})
            return
        if self.multi_neg:
            users, pos = train.users, train.items
            flat_users = np.repeat(users, self.num_negatives)
            negs = _sample_negatives(rng, self.index, flat_users, self.dataset.num_items,
                                     cdf=self.neg_cdf).reshape(-1, self.num_negatives)
            perm = rng.permutation(len(users))
            yield from self._batches({"user": users[perm], "pos": pos[perm], "negs": negs[perm]})
            return
        users = np.repeat(train.users, self.num_negatives)
        pos = np.repeat(train.items, self.num_negatives)
        negs = _sample_negatives(rng, self.index, users, self.dataset.num_items, cdf=self.neg_cdf)
        perm = rng.permutation(len(users))
        yield from self._batches({"user": users[perm], "pos": pos[perm], "neg": negs[perm]})


class PointwiseSampler:
    """(user, item, label) batches: every positive plus ``num_negatives``
    sampled negatives a positive, labels 1 and 0 (pointwise logloss on
    implicit data)."""

    def __init__(
        self,
        dataset: Dataset,
        batch_size: int,
        num_negatives: int = 4,
        seed: int = 0,
        neg_cdf: "np.ndarray | None" = None,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_negatives = num_negatives
        self.seed = seed
        self.neg_cdf = neg_cdf
        self.index = _TrainPairIndex(dataset)

    def num_batches(self) -> int:
        return len(self.dataset.train) * (1 + self.num_negatives) // self.batch_size

    def epoch(self, epoch: int) -> Iterator[Dict[str, np.ndarray]]:
        rng = np.random.default_rng((self.seed, epoch))
        train = self.dataset.train
        neg_users = np.repeat(train.users, self.num_negatives)
        neg_items = _sample_negatives(rng, self.index, neg_users, self.dataset.num_items,
                                      cdf=self.neg_cdf)
        users = np.concatenate([train.users, neg_users])
        items = np.concatenate([train.items, neg_items])
        labels = np.concatenate([np.ones(len(train), np.float32),
                                 np.zeros(len(neg_users), np.float32)])
        perm = rng.permutation(len(users))
        yield from _fixed_batches(self.batch_size, {"user": users[perm], "item": items[perm],
                                                    "label": labels[perm]})


class CTRBatcher:
    """Shuffled fixed-shape batches over in-memory CTR arrays
    (dense [N,D], cat [N,F], label [N])."""

    def __init__(
        self,
        dense: np.ndarray,
        cat: np.ndarray,
        label: np.ndarray,
        batch_size: int,
        seed: int = 0,
    ):
        if not len(dense) == len(cat) == len(label):
            raise ValueError(f"dense, cat and label differ in length: {len(dense)}, "
                             f"{len(cat)}, {len(label)}")
        self.dense, self.cat, self.label = dense, cat, label
        self.batch_size = batch_size
        self.seed = seed

    def num_batches(self) -> int:
        return len(self.label) // self.batch_size

    def epoch(self, epoch: int) -> Iterator[Dict[str, np.ndarray]]:
        rng = np.random.default_rng((self.seed, epoch))
        perm = rng.permutation(len(self.label))
        for start in range(0, len(perm) - self.batch_size + 1, self.batch_size):
            idx = perm[start : start + self.batch_size]
            yield {
                "dense": self.dense[idx],
                "cat": self.cat[idx],
                "label": self.label[idx],
            }


def build_sequences(dataset: Dataset, max_len: int, seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Each user's time-ordered train sequence, for the sequential models:
    ([U, L] int32 item ids, oldest first, the tail padded with the sentinel
    ``num_items``; [U] int32 lengths). A user with more than L interactions
    keeps the most recent L. Equal times (or none, times == 0) are ordered
    by a jitter drawn from ``default_rng((seed, 0x5E9))``, as the
    leave-one-out split orders them."""
    rng = np.random.default_rng((seed, 0x5E9))
    tr = dataset.train
    nu = dataset.num_users
    if len(tr.items) == 0:
        return np.full((nu, max_len), dataset.num_items, np.int32), np.zeros(nu, np.int32)
    jitter = rng.random(len(tr.items))
    order = np.lexsort((jitter, tr.times, tr.users))
    users = tr.users[order]
    items = tr.items[order]
    starts = np.searchsorted(users, np.arange(nu))
    ends = np.searchsorted(users, np.arange(nu) + 1)
    counts = ends - starts
    lens = np.minimum(counts, max_len).astype(np.int32)
    # The most recent L: the window [end - len, end) of each user's run.
    cols = np.arange(max_len)[None, :]
    valid = cols < lens[:, None]
    first = ends[:, None] - lens[:, None]
    flat_idx = np.minimum(np.maximum(first + cols, 0), len(items) - 1)
    seq = np.where(valid, items[flat_idx], dataset.num_items).astype(np.int32)
    return seq, lens


class SequenceSampler:
    """{user, seq [B, L], seq_len, seq_negs [B, L-1]} batches for next-item
    training: the time-ordered sequences of the users with at least 2 train
    interactions, shuffled every epoch, with a fresh uniform negative a
    predicted position every epoch (no exclusion of positives, the
    large-catalog approximation), all from ``default_rng((seed, epoch,
    0x5E9))``.

    ``seed`` drives the shuffle and the negatives (a rank's own on N ranks);
    ``order_seed`` the tie-breaking of the time order, which must be the
    run's seed so that every rank, and the eval's attached sequences, agree
    on each user's sequence."""

    def __init__(self, dataset: Dataset, batch_size: int, max_len: int, seed: int = 0,
                 order_seed: int | None = None):
        self.batch_size = batch_size
        self.seed = seed
        self.num_items = dataset.num_items
        self.seq, self.lens = build_sequences(dataset, max_len, seed if order_seed is None else order_seed)
        self.active = np.flatnonzero(self.lens >= 2).astype(np.int32)

    def num_batches(self) -> int:
        return len(self.active) // self.batch_size

    def epoch(self, epoch: int) -> Iterator[Dict[str, np.ndarray]]:
        rng = np.random.default_rng((self.seed, epoch, 0x5E9))
        users = self.active[rng.permutation(len(self.active))]
        l = self.seq.shape[1]
        for start in range(0, len(users) - self.batch_size + 1, self.batch_size):
            u = users[start : start + self.batch_size]
            negs = rng.integers(0, self.num_items, (len(u), l - 1)).astype(np.int32)
            yield {"user": u, "seq": self.seq[u], "seq_len": self.lens[u], "seq_negs": negs}


class SBPRSampler:
    """{user, pos, soc, neg, suk, has_social} batches for social BPR: for
    each train (u, pos), one social item (consumed by at least one of u's
    friends, not by u) with ``suk``, the number of friends who consumed it,
    and one negative outside both u's train items and the social set. Users
    without social candidates train plain BPR triples (has_social = 0; soc
    and suk are dummies the loss masks).

    The candidates are padded [U, S] arrays built once from social @ train;
    a user with more than ``max_social`` keeps a seeded subsample of S,
    while the negatives still exclude the whole set (a truncated one would
    let them collide with the user's social feedback). Membership is one
    ``searchsorted`` against sorted keys, as ``_TrainPairIndex``'s."""

    def __init__(self, dataset: Dataset, batch_size: int, seed: int = 0, max_social: int = 512):
        if dataset.social is None:
            raise ValueError(
                "SBPR needs a social graph: set data.social_degree > 0 "
                "(synthetic taste-overlap friends) or data.social_path"
            )
        self.batch_size = batch_size
        self.seed = seed
        self.users = dataset.train.users
        self.items = dataset.train.items
        self.num_items = dataset.num_items
        self.index = _TrainPairIndex(dataset)
        rng = np.random.default_rng((seed, 0x5B92))

        own = (dataset.train_csr > 0).astype(np.float32)
        cnt = (dataset.social.astype(np.float32) @ own).tocsr()  # friend counts
        cnt = (cnt - cnt.multiply(own > 0)).tocsr()  # drop the user's own train items
        cnt.eliminate_zeros()
        coo = cnt.tocoo()
        self._soc_keys = np.sort(coo.row.astype(np.int64) * self.num_items + coo.col)

        nu, s = dataset.num_users, max_social
        starts, counts = cnt.indptr[:-1], np.diff(cnt.indptr)
        self.sp_lens = np.minimum(counts, s).astype(np.int32)
        cols = np.arange(s)[None, :]
        valid = cols < self.sp_lens[:, None]
        flat = np.minimum(starts[:, None] + cols, max(cnt.nnz - 1, 0))
        if cnt.nnz == 0:
            self.sp_items = np.full((nu, s), self.num_items, np.int32)
            self.sp_counts = np.zeros((nu, s), np.float32)
        else:
            self.sp_items = np.where(valid, cnt.indices[flat], self.num_items).astype(np.int32)
            self.sp_counts = np.where(valid, cnt.data[flat], 0.0).astype(np.float32)
        for u in np.flatnonzero(counts > s):
            pick = rng.choice(counts[u], size=s, replace=False)
            self.sp_items[u] = cnt.indices[starts[u] + pick]
            self.sp_counts[u] = cnt.data[starts[u] + pick]

    def _in_social(self, users: np.ndarray, items: np.ndarray) -> np.ndarray:
        if len(self._soc_keys) == 0:
            return np.zeros(len(users), bool)
        q = users.astype(np.int64) * self.num_items + items.astype(np.int64)
        idx = np.minimum(np.searchsorted(self._soc_keys, q), len(self._soc_keys) - 1)
        return self._soc_keys[idx] == q

    def num_batches(self) -> int:
        return len(self.users) // self.batch_size

    def epoch(self, epoch: int) -> Iterator[Dict[str, np.ndarray]]:
        rng = np.random.default_rng((self.seed, epoch, 0x5B92))
        order = rng.permutation(len(self.users))
        bs = self.batch_size
        for start in range(0, len(order) - bs + 1, bs):
            idx = order[start : start + bs]
            u = self.users[idx]
            pos = self.items[idx]
            lens = self.sp_lens[u]
            has = lens > 0
            j = rng.integers(0, np.maximum(lens, 1))
            soc = np.where(has, self.sp_items[u, j], 0).astype(np.int32)
            suk = np.where(has, self.sp_counts[u, j], 0.0).astype(np.float32)
            negs = rng.integers(0, self.num_items, size=bs, dtype=np.int64)
            bad = self.index.contains(u, negs) | self._in_social(u, negs)
            for _ in range(64):
                if not bad.any():
                    break
                negs[bad] = rng.integers(0, self.num_items, size=int(bad.sum()), dtype=np.int64)
                bad = self.index.contains(u, negs) | self._in_social(u, negs)
            yield {
                "user": u.astype(np.int32),
                "pos": pos.astype(np.int32),
                "soc": soc,
                "neg": negs.astype(np.int32),
                "suk": suk,
                "has_social": has.astype(np.float32),
            }
