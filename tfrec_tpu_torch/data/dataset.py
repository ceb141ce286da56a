"""Interaction datasets: id densifying, splitting, CSR matrices.

A numpy and scipy copy of ``tfrec_tpu/data/dataset.py``: a flat (user,
item, rating, time) log with dense ids, split per user by ratio or leave
one out, with user x item CSR matrices of the train and test parts. The
port imports nothing of the JAX package, so it keeps its own copy; a test
holds the two equal array for array.

``build_dataset`` reads MovieLens' rating files (``source="movielens"``,
``data/movielens.py``; split by ratio, leave one out, or "given" train and
test files densified together, ``split_given``) or generates
``synthetic_implicit`` data. SBPR's user-user trust graph rides on the
dataset as ``Dataset.social``: read from a "u v" edge file over dense user
ids (``data.social_path``, ``load_social_edges``) or synthesized from the
train split's taste overlap (``data.social_degree``,
``build_social_overlap``), a symmetric boolean ``scipy.sparse`` CSR with a
zero diagonal, as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import scipy.sparse as sp

from tfrec_tpu_torch.configs import DataConfig


@dataclasses.dataclass
class Interactions:
    """A flat (user, item, rating, time) log with densified ids."""

    users: np.ndarray  # int32 [N]
    items: np.ndarray  # int32 [N]
    ratings: np.ndarray  # float32 [N]
    times: np.ndarray  # float64 [N] (0 when absent)
    num_users: int
    num_items: int

    def __len__(self) -> int:
        return len(self.users)


@dataclasses.dataclass
class Dataset:
    """Train/test split over an interaction log. ``train_csr``/``test_csr``
    are user x item CSR matrices of ratings (1.0 for implicit data): the
    evaluator ranks each user's test positives against the full catalog
    with the train items masked."""

    train: Interactions
    test: Interactions
    num_users: int
    num_items: int
    # The user-user trust graph of SBPR: boolean CSR [U, U], symmetric, zero
    # diagonal; None when the config names no graph.
    social: sp.csr_matrix | None = None

    @property
    def train_csr(self) -> sp.csr_matrix:
        if not hasattr(self, "_train_csr"):
            self._train_csr = _to_csr(self.train, self.num_users, self.num_items)
        return self._train_csr

    @property
    def test_csr(self) -> sp.csr_matrix:
        if not hasattr(self, "_test_csr"):
            self._test_csr = _to_csr(self.test, self.num_users, self.num_items)
        return self._test_csr

    def train_items_padded(self, pad_to: int | None = None) -> Tuple[np.ndarray, np.ndarray]:
        """Per-user train-item lists padded to a static width
        (``eval.retrieval.padded_positives``)."""
        from tfrec_tpu_torch.eval.retrieval import padded_positives

        return padded_positives(self.train_csr, pad_to=pad_to)


def _to_csr(inter: Interactions, num_users: int, num_items: int) -> sp.csr_matrix:
    vals = np.where(inter.ratings == 0, 1.0, inter.ratings).astype(np.float32)
    m = sp.csr_matrix((vals, (inter.users, inter.items)), shape=(num_users, num_items))
    m.sum_duplicates()
    return m


def densify_ids(
    raw_users: np.ndarray, raw_items: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, int, int]:
    """Map arbitrary raw ids to contiguous [0, n) int32 ids (sorted by raw id
    for determinism)."""
    uniq_u, users = np.unique(raw_users, return_inverse=True)
    uniq_i, items = np.unique(raw_items, return_inverse=True)
    return users.astype(np.int32), items.astype(np.int32), len(uniq_u), len(uniq_i)


def filter_min_interactions(inter: Interactions, min_count: int) -> Interactions:
    """Drop users with fewer than ``min_count`` interactions, then re-densify."""
    if min_count <= 1:
        return inter
    counts = np.bincount(inter.users, minlength=inter.num_users)
    keep = counts[inter.users] >= min_count
    users, items, nu, ni = densify_ids(inter.users[keep], inter.items[keep])
    return Interactions(users=users, items=items, ratings=inter.ratings[keep],
                        times=inter.times[keep], num_users=nu, num_items=ni)


def split_ratio(inter: Interactions, test_fraction: float, seed: int) -> Dataset:
    """Random per-user holdout: each user keeps >= 1 train interaction."""
    rng = np.random.default_rng(seed)
    n = len(inter)
    order = rng.permutation(n)
    # Each user's interactions in a random order; the first test_fraction of
    # them go to test, but never a user's last train interaction.
    is_test = np.zeros(n, dtype=bool)
    user_sorted = np.argsort(inter.users[order], kind="stable")
    shuffled = order[user_sorted]
    users_in_order = inter.users[shuffled]
    boundaries = np.flatnonzero(np.diff(users_in_order)) + 1
    for grp in np.split(shuffled, boundaries):
        k = int(np.floor(len(grp) * test_fraction))
        k = min(k, len(grp) - 1)
        if k > 0:
            is_test[grp[:k]] = True
    return _make_split(inter, is_test)


def split_leave_one_out(inter: Interactions, seed: int) -> Dataset:
    """Hold out each user's most recent interaction (ties and missing
    timestamps broken by a seeded shuffle); users with a single interaction
    keep it in train."""
    rng = np.random.default_rng(seed)
    n = len(inter)
    jitter = rng.random(n)
    order = np.lexsort((jitter, inter.times, inter.users))
    users_sorted = inter.users[order]
    is_last = np.ones(n, dtype=bool)
    is_last[:-1] = users_sorted[1:] != users_sorted[:-1]
    counts = np.bincount(inter.users, minlength=inter.num_users)
    is_test = np.zeros(n, dtype=bool)
    last_idx = order[is_last]
    keepable = counts[inter.users[last_idx]] > 1
    is_test[last_idx[keepable]] = True
    return _make_split(inter, is_test)


def _make_split(inter: Interactions, is_test: np.ndarray) -> Dataset:
    def take(mask: np.ndarray) -> Interactions:
        return Interactions(users=inter.users[mask], items=inter.items[mask],
                            ratings=inter.ratings[mask], times=inter.times[mask],
                            num_users=inter.num_users, num_items=inter.num_items)

    return Dataset(train=take(~is_test), test=take(is_test),
                   num_users=inter.num_users, num_items=inter.num_items)


def split_given(train_raw, test_raw) -> Dataset:
    """Pre-split ("given") train and test files: ids are densified over the
    union, so both sides share one id space; test pairs unseen in train
    stay."""
    all_u = np.concatenate([train_raw[0], test_raw[0]])
    all_i = np.concatenate([train_raw[1], test_raw[1]])
    users, items, nu, ni = densify_ids(all_u, all_i)
    n_train = len(train_raw[0])

    def mk(sl, raw):
        return Interactions(users=users[sl], items=items[sl], ratings=raw[2].astype(np.float32),
                            times=raw[3].astype(np.float64), num_users=nu, num_items=ni)

    return Dataset(train=mk(slice(0, n_train), train_raw), test=mk(slice(n_train, None), test_raw),
                   num_users=nu, num_items=ni)


def load_social_edges(path: str, num_users: int) -> sp.csr_matrix:
    """Whitespace "u v" edge lines over dense user ids -> the symmetric
    boolean CSR [U, U] with a zero diagonal. Ids out of range are a config
    error, reported with their count (dropping trust edges quietly would
    bias the sampler)."""
    raw = np.loadtxt(path, dtype=np.int64, ndmin=2)
    if raw.shape[1] < 2:
        raise ValueError(f"social file {path!r} needs 'u v' columns")
    u, v = raw[:, 0], raw[:, 1]
    bad = (u < 0) | (u >= num_users) | (v < 0) | (v >= num_users)
    if bad.any():
        raise ValueError(
            f"social file {path!r}: {int(bad.sum())}/{len(u)} edges "
            f"reference user ids outside [0, {num_users})"
        )
    m = sp.csr_matrix((np.ones(len(u), np.bool_), (u.astype(np.int32), v.astype(np.int32))),
                      shape=(num_users, num_users))
    return _symmetric(m)


def _symmetric(m: sp.csr_matrix) -> sp.csr_matrix:
    m = (m + m.T).astype(np.bool_).tocsr()
    m.setdiag(False)
    m.eliminate_zeros()
    return m


def build_social_overlap(ds: Dataset, degree: int, seed: int = 0) -> sp.csr_matrix:
    """A trust graph with taste signal: each user's ``degree`` friends are
    the users sharing the most train items (co-interaction counts, ties
    broken by a jitter from ``default_rng((seed, 0x50C1A1))``, below one
    count), symmetrized. Built from the train split only; the [U, U]
    co-count matrix is dense, meant for the stand-in's scales."""
    rng = np.random.default_rng((seed, 0x50C1A1))
    b = (ds.train_csr > 0).astype(np.float32)
    co = (b @ b.T).toarray()
    np.fill_diagonal(co, -1.0)
    co += rng.random(co.shape) * 0.5
    k = min(degree, ds.num_users - 1)
    friends = np.argpartition(-co, k - 1, axis=1)[:, :k]
    rows = np.repeat(np.arange(ds.num_users), k)
    m = sp.csr_matrix((np.ones(rows.size, np.bool_), (rows, friends.reshape(-1))),
                      shape=(ds.num_users, ds.num_users))
    return _symmetric(m)


def build_dataset(cfg: DataConfig) -> Dataset:
    """Config-driven entry: load or generate the interactions, split them,
    then attach the trust graph the config names."""
    if cfg.source == "movielens":
        from tfrec_tpu_torch.data.movielens import load_uirt, load_uirt_raw

        if cfg.splitter == "given":
            if not cfg.test_path:
                raise ValueError("splitter='given' requires data.test_path")
            return _attach_social(split_given(load_uirt_raw(cfg.path), load_uirt_raw(cfg.test_path)), cfg)
        inter = load_uirt(cfg.path)
    elif cfg.source == "synthetic_implicit":
        from tfrec_tpu_torch.data.synthetic import synthetic_implicit

        inter = synthetic_implicit(
            num_users=cfg.num_users,
            num_items=cfg.num_items,
            interactions_per_user=cfg.interactions_per_user,
            latent_rank=cfg.latent_rank,
            seed=cfg.seed,
        )
    else:
        raise ValueError(f"unknown interaction source {cfg.source!r}")
    if cfg.binarize_threshold > 0:
        keep = inter.ratings >= cfg.binarize_threshold
        users, items, nu, ni = densify_ids(inter.users[keep], inter.items[keep])
        inter = Interactions(users=users, items=items, ratings=np.ones(keep.sum(), np.float32),
                             times=inter.times[keep], num_users=nu, num_items=ni)
    inter = filter_min_interactions(inter, cfg.min_interactions)
    if cfg.splitter == "ratio":
        ds = split_ratio(inter, cfg.test_fraction, cfg.seed)
    elif cfg.splitter == "leave_one_out":
        ds = split_leave_one_out(inter, cfg.seed)
    else:
        raise ValueError(f"unknown splitter {cfg.splitter!r}")
    return _attach_social(ds, cfg)


def _attach_social(ds: Dataset, cfg: DataConfig) -> Dataset:
    if cfg.social_path:
        if cfg.min_interactions > 1 or cfg.binarize_threshold > 0:
            # Both re-densify the user ids after filtering, so the edge
            # file's ids would point at other users, past the range check.
            raise ValueError(
                "data.social_path cannot be combined with min_interactions > 1 or "
                "binarize_threshold > 0: those re-densify user ids, scrambling the edge file's "
                "id space. Pre-filter the ratings and re-export the edges, or use social_degree "
                "synthesis."
            )
        ds.social = load_social_edges(cfg.social_path, ds.num_users)
    elif cfg.social_degree > 0:
        ds.social = build_social_overlap(ds, cfg.social_degree, cfg.seed)
    return ds
