"""Criteo click-log TSV loader (label \\t 13 ints \\t 26 hex categoricals):
the counterpart of ``tfrec_tpu/data/criteo.py``.

Categorical tokens hash into per-field vocabularies (FNV-1a over
``f"{field}:{token}"``, the DLRM treatment); dense ints get log1p. Files
stream in chunks, so a 1TB-scale file never has to fit in memory.

Two parsers read the same lines: the threaded C++ parser of
``csrc/criteo_native.cpp`` (``data/criteo_native.py``), and this module's
Python loop, which runs where the native one cannot be built (any
exception at its build falls back, as in the reference). Their ids and
labels are the same bit for bit; their dense values are 1 ulp apart on
some entries (the C library's float32 ``log1pf`` against float64 ``log1p``
rounded to float32), as the reference's two parsers are. Training streams
through the native parser where it builds (``best_batch_iter``), and
``CriteoStreamBatcher.parser`` names the one its last epoch read with;
``load_criteo`` materializes through the Python loop, as the reference's
does, so its arrays are the reference's bit for bit on any host.
"""

from __future__ import annotations

import functools
from typing import Iterator, Sequence, Tuple

import numpy as np

NUM_DENSE = 13
NUM_CATEGORICAL = 26
_FNV_OFFSET = 14695981039346656037
_FNV_PRIME = 1099511628211
_MASK64 = (1 << 64) - 1


def _native_or_none():
    """The native module, its library built, or None where it cannot be."""
    try:
        from tfrec_tpu_torch.data import criteo_native

        criteo_native.load()
        return criteo_native
    except Exception:
        return None


def best_batch_iter(
    path: str,
    batch_size: int,
    vocab_sizes: Sequence[int] | int = 100_000,
    max_examples: int | None = None,
) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """The native (threaded C++) parser where a toolchain builds it, the
    Python parser otherwise: the same ids and labels, dense values within
    1 ulp."""
    return _best_parser(path, batch_size, vocab_sizes, max_examples)[1]


def _best_parser(path, batch_size, vocab_sizes, max_examples):
    """(the parser's name, "native" or "python"; its batch iterator)."""
    native = _native_or_none()
    if native is not None:
        return "native", native.iter_criteo_batches_native(path, batch_size, vocab_sizes,
                                                           max_examples)
    return "python", iter_criteo_batches(path, batch_size, vocab_sizes, max_examples)


@functools.lru_cache(maxsize=1 << 18)
def _hash_token(token: str, vocab: int, field: int) -> int:
    """FNV-1a over ``f"{field}:{token}"``, mod ``vocab``: identical tokens in
    different fields do not collide systematically. The reference's
    arithmetic in Python ints (the same 64-bit wraparound); memoized, since
    a log's tokens repeat."""
    h = _FNV_OFFSET
    for b in f"{field}:{token}".encode():
        h = ((h ^ b) * _FNV_PRIME) & _MASK64
    return h % vocab


def iter_criteo_batches(
    path: str,
    batch_size: int,
    vocab_sizes: Sequence[int] | int = 100_000,
    max_examples: int | None = None,
    drop_remainder: bool = True,
) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Yield (dense [B, 13] f32, cat [B, 26] i32, label [B] f32) batches,
    skipping lines without 40 fields. The final partial batch is dropped
    (static shapes), or with ``drop_remainder=False`` yielded trimmed.
    A batch's dense ints are read as float64 and take log1p together, the
    reference's float64 log1p of each rounded to float32."""
    if isinstance(vocab_sizes, int):
        vocab_sizes = [vocab_sizes] * NUM_CATEGORICAL
    if len(vocab_sizes) != NUM_CATEGORICAL:
        raise ValueError(f"criteo needs {NUM_CATEGORICAL} vocab sizes, got {len(vocab_sizes)}")
    raw = np.zeros((batch_size, NUM_DENSE), dtype=np.float64)
    cat = np.zeros((batch_size, NUM_CATEGORICAL), dtype=np.int32)
    label = np.zeros(batch_size, dtype=np.float32)
    fields = list(enumerate(vocab_sizes))

    def batch(n: int):
        dense = np.log1p(np.where(raw[:n] < 0.0, 0.0, raw[:n])).astype(np.float32)  # max(x, 0.0)
        return dense, cat[:n].copy(), label[:n].copy()

    fill = 0
    seen = 0
    with open(path, "r") as f:
        for line in f:
            if max_examples is not None and seen >= max_examples:
                break
            parts = line.rstrip("\n").split("\t")
            if len(parts) != 1 + NUM_DENSE + NUM_CATEGORICAL:
                continue
            seen += 1
            label[fill] = float(parts[0])
            raw[fill] = [float(v) if v else 0.0 for v in parts[1 : 1 + NUM_DENSE]]
            cat[fill] = [_hash_token(tok, vocab, c) if tok else 0
                         for (c, vocab), tok in zip(fields, parts[1 + NUM_DENSE :])]
            fill += 1
            if fill == batch_size:
                yield batch(fill)
                fill = 0
    if fill and not drop_remainder:
        yield batch(fill)


class CriteoStreamBatcher:
    """Epochs streamed over a Criteo TSV too large to materialize. The
    first ``eval_examples`` lines are the held-out eval slice (materialized
    once); training streams the rest in file order each epoch (no global
    shuffle: Criteo's logs are time-shuffled at day granularity). A batch
    that straddles the eval boundary starts at the first train line.

    With ``num_shards=N, shard_index=p`` the train stream is striped round
    robin: batch i belongs to shard i mod N, and only whole stripes of N
    batches are taken, so every shard yields the same number of disjoint
    batches. ``batch_size`` is then the per-shard batch. The epoch(i)
    protocol is ``CTRBatcher``'s.
    """

    def __init__(
        self,
        path: str,
        batch_size: int,
        vocab_sizes: Sequence[int] | int = 100_000,
        eval_examples: int = 100_000,
        max_examples: int | None = None,
        num_shards: int = 1,
        shard_index: int = 0,
    ):
        if not 0 <= shard_index < num_shards:
            raise ValueError(f"shard_index {shard_index} is not in [0, {num_shards})")
        self.path = path
        self.batch_size = batch_size
        self.vocab_sizes = vocab_sizes
        self.eval_examples = eval_examples
        self.max_examples = max_examples
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.parser = None  # "native" or "python", once an epoch has started
        self._eval = None

    def eval_arrays(self):
        if self._eval is None:
            self._eval = load_criteo(self.path, self.vocab_sizes, max_examples=self.eval_examples)
        return self._eval

    def num_batches(self) -> int:
        """Batches of the train region over all shards, or -1 when unknown
        without a full pass (no ``max_examples``)."""
        if self.max_examples is None:
            return -1
        return (self.max_examples - self.eval_examples) // self.batch_size

    def epoch(self, epoch: int):
        if self.num_shards == 1:
            yield from self._epoch_all(epoch)
            return
        mine = None
        pos = 0
        for batch in self._epoch_all(epoch):
            if pos == self.shard_index:
                mine = batch
            pos += 1
            if pos == self.num_shards:
                yield mine
                mine, pos = None, 0

    def _epoch_all(self, epoch: int):
        skipped = 0
        pend = None  # the part of a batch past the eval boundary
        self.parser, batches = _best_parser(
            self.path, self.batch_size, self.vocab_sizes, self.max_examples)
        for dense, cat, label in batches:
            if skipped < self.eval_examples:
                take = min(self.eval_examples - skipped, len(label))
                skipped += take
                if take == len(label):
                    continue
                pend = (dense[take:], cat[take:], label[take:])
                continue
            if pend is not None:
                d = np.concatenate([pend[0], dense])
                ca = np.concatenate([pend[1], cat])
                la = np.concatenate([pend[2], label])
                yield {"dense": d[: self.batch_size], "cat": ca[: self.batch_size],
                       "label": la[: self.batch_size]}
                pend = (d[self.batch_size:], ca[self.batch_size:], la[self.batch_size:])
                if len(pend[2]) == 0:
                    pend = None
                continue
            yield {"dense": dense, "cat": cat, "label": label}


def load_criteo(
    path: str,
    vocab_sizes: Sequence[int] | int = 100_000,
    max_examples: int | None = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A bounded Criteo subset materialized in memory, the last partial
    batch included, read by the Python parser as in the reference."""
    chunks = list(iter_criteo_batches(path, 8192, vocab_sizes, max_examples, drop_remainder=False))
    if not chunks:
        raise ValueError(f"no complete batches read from {path}")
    dense = np.concatenate([c[0] for c in chunks])
    cat = np.concatenate([c[1] for c in chunks])
    label = np.concatenate([c[2] for c in chunks])
    return dense, cat, label
