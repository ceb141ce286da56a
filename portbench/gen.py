"""Inputs made from ``--seed``: table rows, dense weights and traffic.

Table rows come from a counter-based hash keyed by (seed, table, row,
column), so that the reference regenerates exactly the rows a check
touches, bit for bit and on any device, without a second copy of the
tables. Everything else comes from ``torch.Generator`` streams seeded by
(seed, purpose).
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

MASK64 = (1 << 64) - 1
GOLDEN = 0x9E3779B97F4A7C15
MIX1 = 0xBF58476D1CE4E5B9
MIX2 = 0x94D049BB133111EB
DENSE_STREAM = 4  # ``generator`` purpose of the dense weights
FILL_ROWS = 1 << 21  # rows a table is filled in at a time (2 GiB of int64 counters at d = 128)


def _signed(x: int) -> int:
    """A 64-bit pattern as the int64 that holds it."""
    x &= MASK64
    return x - (1 << 64) if x >> 63 else x


def _mix_py(x: int) -> int:
    """splitmix64's finalizer on Python ints."""
    x &= MASK64
    x = ((x ^ (x >> 30)) * MIX1) & MASK64
    x = ((x ^ (x >> 27)) * MIX2) & MASK64
    return x ^ (x >> 31)


def _shr(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns (torch's ``>>`` keeps the sign)."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def _mix_(x: torch.Tensor) -> torch.Tensor:
    """splitmix64's finalizer in place on int64 tensors (products wrap)."""
    x ^= _shr(x, 30)
    x *= _signed(MIX1)
    x ^= _shr(x, 27)
    x *= _signed(MIX2)
    x ^= _shr(x, 31)
    return x


def stream_seed(seed: int, *purpose: int) -> int:
    """A 63-bit generator seed for one use of ``seed``."""
    x = _mix_py(seed)
    for p in purpose:
        x = _mix_py(x ^ (p * GOLDEN))
    return x >> 1


def generator(seed: int, purpose: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream_seed(seed, purpose))


def table_scale(dim: int) -> float:
    """Half-width of the uniform rows: unit variance over sqrt(dim), the
    port's own table init scale."""
    return math.sqrt(3.0) / math.sqrt(dim)


def _rows_from_counters(x: torch.Tensor, key: int, dim: int) -> torch.Tensor:
    """Uniform f32 rows in (-a, a) from int64 counters, consumed in place."""
    x *= _signed(GOLDEN)
    x += _signed(key)
    _mix_(x)
    u = _shr(x, 40).to(torch.float32)  # 24 random bits, exact in f32
    a = table_scale(dim)
    return u.mul_(2.0 * a / (1 << 24)).add_(a / (1 << 24) - a)


def _key(seed: int, table: int) -> int:
    return _mix_py(stream_seed(seed, 1) + (table + 1) * GOLDEN)


def table_rows(seed: int, table: int, rows: torch.Tensor, dim: int) -> torch.Tensor:
    """Rows ``rows`` (int64 [n]) of table ``table``: [n, dim] f32 on rows' device."""
    cols = torch.arange(dim, dtype=torch.int64, device=rows.device)
    x = rows.to(torch.int64)[:, None] * dim + cols[None, :]
    return _rows_from_counters(x, _key(seed, table), dim)


def fill_table(seed: int, table: int, out: torch.Tensor) -> torch.Tensor:
    """Every row of table ``table`` into ``out`` [V, dim], a block of rows
    at a time: the same values ``table_rows`` gives."""
    vocab, dim = out.shape
    for r0 in range(0, vocab, FILL_ROWS):
        r1 = min(vocab, r0 + FILL_ROWS)
        rows = torch.arange(r0, r1, dtype=torch.int64, device=out.device)
        out[r0:r1] = table_rows(seed, table, rows, dim)
    return out


def make_tables(seed: int, vocabs: List[int], dim: int, device) -> Dict[str, torch.Tensor]:
    """The tables ``field_0`` ... as the port names them, filled on ``device``."""
    out = {}
    for t, v in enumerate(vocabs):
        out[f"field_{t}"] = fill_table(seed, t, torch.empty((v, dim), dtype=torch.float32, device=device))
    return out


# ---- traffic ----

class ZipfSampler:
    """Zipf ranks, P(rank k) proportional to (k + 1)^-s on [0, V), by the
    inverse of the exact discrete CDF (one cumsum up to the largest V), then
    scattered over the rows by a seeded bijection k -> (m k + c) mod V, as
    hashed ids land."""

    def __init__(self, exponent: float, max_vocab: int, device):
        k = torch.arange(1, max_vocab + 1, dtype=torch.float64, device=device)
        self.cdf = torch.cumsum(k.pow_(-exponent), 0)

    def ranks(self, u: torch.Tensor, vocab: int) -> torch.Tensor:
        cdf = self.cdf[:vocab]
        r = torch.searchsorted(cdf, u.to(torch.float64) * cdf[-1], right=True)
        return r.clamp_(max=vocab - 1)


def scatter_ranks(ranks: torch.Tensor, seed: int, table: int, vocab: int) -> torch.Tensor:
    """Ranks to rows by (m k + c) mod V with m coprime to V."""
    h = _mix_py(stream_seed(seed, 2, table))
    m = (h & 0x7FFFFFFF) | 1
    while math.gcd(m, vocab) != 1:
        m += 2
    c = (h >> 32) % vocab
    return (ranks * (m % vocab) + c) % vocab


def ctr_pool(seed: int, traffic: dict, vocabs: List[int], num_dense: int, count: int,
             rows: int, device) -> Dict[str, torch.Tensor]:
    """``count`` batches of ``rows`` CTR examples: {"cat": [count, rows, F]
    int32, "dense": [count, rows, num_dense] f32, "label": [count, rows] f32}."""
    g = generator(seed, 3, device)
    ids = traffic["ids"]
    n = count * rows
    zipf = ZipfSampler(traffic["zipf_exponent"], max(vocabs), device) if ids == "zipf" else None
    cols = []
    for t, v in enumerate(vocabs):
        if ids == "zipf":
            u = torch.rand(n, generator=g, dtype=torch.float64, device=device)
            col = scatter_ranks(zipf.ranks(u, v), seed, t, v)
        elif ids == "uniform":
            col = torch.randint(0, v, (n,), generator=g, device=device)
        else:
            raise ValueError(f"unknown id distribution {ids!r}")
        cols.append(col.to(torch.int32))
    cat = torch.stack(cols, dim=1).reshape(count, rows, len(vocabs))
    # Log-scaled counts, as Criteo's dense features are fed: log(1 + n).
    u = torch.rand((count, rows, num_dense), generator=g, device=device)
    dense = torch.log1p(torch.floor(-torch.log1p(-u) * traffic["dense_mean"]))
    label = (torch.rand((count, rows), generator=g, device=device) < traffic["label_rate"]).float()
    return {"cat": cat.contiguous(), "dense": dense.contiguous(), "label": label}
