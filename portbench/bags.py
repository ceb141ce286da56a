"""Inputs of the multi-hot, row-sharded cells, made from ``--seed`` on the
card of each rank, on top of ``gen.py``'s streams:

- a table's block: the rows that one rank owns, filled by ``gen.table_rows``
  over its logical rows (the rows past the vocab, the shard's padding,
  zero), so no card ever builds a whole table and the blocks of all ranks
  together are ``gen.make_tables``' table;
- a batch: rank r's rows of global batch k, from a generator of its own
  ``(seed, BATCH_STREAM, r, k)``, so any rank (and the reference) can make
  any rank's batch again. Each field draws its full bag, ``widths[f]`` ids
  an example, none padded: Zipf ranks over the table (or uniform ids), the
  ranks scattered over the rows by ``gen.scatter_ranks``' bijection; the
  columns of ``cat`` are field after field, a field's bag side by side, as
  the port reads multi-hot fields.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from portbench import gen

BATCH_STREAM = 5  # ``gen.stream_seed`` purpose of the multi-hot batches


def fill_block(seed: int, table: int, vocab: int, first: int, out: torch.Tensor) -> torch.Tensor:
    """Rows [first, first + len(out)) of table ``table`` into ``out`` [rows,
    dim], a block of rows at a time; rows at or past ``vocab`` zero."""
    rows, dim = out.shape
    real = max(0, min(rows, vocab - first))
    out[real:].zero_()
    for r0 in range(0, real, gen.FILL_ROWS):
        r1 = min(real, r0 + gen.FILL_ROWS)
        ids = torch.arange(first + r0, first + r1, dtype=torch.int64, device=out.device)
        out[r0:r1] = gen.table_rows(seed, table, ids, dim)
    return out


def sampler(traffic: dict, vocabs: Sequence[int], device):
    """The Zipf sampler a traffic mix draws from (None for uniform ids)."""
    return gen.ZipfSampler(traffic["zipf_exponent"], max(vocabs), device) if traffic["ids"] == "zipf" else None


def batch(seed: int, traffic: dict, vocabs: Sequence[int], widths: Sequence[int], num_dense: int,
          rows: int, rank: int, k: int, zipf, device) -> Dict[str, torch.Tensor]:
    """Rank ``rank``'s ``rows`` examples of global batch ``k``: {"cat": [rows,
    sum W] int32, "dense": [rows, num_dense] f32, "label": [rows] f32}."""
    g = torch.Generator(device=device).manual_seed(gen.stream_seed(seed, BATCH_STREAM, rank, k))
    cols = []
    for t, (v, w) in enumerate(zip(vocabs, widths)):
        n = rows * w
        if traffic["ids"] == "zipf":
            u = torch.rand(n, generator=g, dtype=torch.float64, device=device)
            ids = gen.scatter_ranks(zipf.ranks(u, v), seed, t, v)
        elif traffic["ids"] == "uniform":
            ids = torch.randint(0, v, (n,), generator=g, device=device)
        else:
            raise ValueError(f"unknown id distribution {traffic['ids']!r}")
        cols.append(ids.to(torch.int32).view(rows, w))
    # Log-scaled counts, as Criteo's dense features are fed: log(1 + n).
    u = torch.rand((rows, num_dense), generator=g, device=device)
    dense = torch.log1p(torch.floor(-torch.log1p(-u) * traffic["dense_mean"]))
    label = (torch.rand(rows, generator=g, device=device) < traffic["label_rate"]).float()
    return {"cat": torch.cat(cols, dim=1).contiguous(), "dense": dense, "label": label}


def pool(seed: int, traffic: dict, vocabs: Sequence[int], widths: Sequence[int], num_dense: int,
         count: int, rows: int, rank: int, zipf, device) -> List[Dict[str, torch.Tensor]]:
    """Rank ``rank``'s rows of global batches 0 .. count - 1."""
    return [batch(seed, traffic, vocabs, widths, num_dense, rows, rank, k, zipf, device) for k in range(count)]


def global_batch(seed: int, traffic: dict, vocabs: Sequence[int], widths: Sequence[int], num_dense: int,
                 rows: int, world: int, k: int, zipf, device) -> Dict[str, torch.Tensor]:
    """Global batch ``k``: every rank's rows, rank 0's first."""
    parts = [batch(seed, traffic, vocabs, widths, num_dense, rows, r, k, zipf, device) for r in range(world)]
    return {key: torch.cat([p[key] for p in parts]) for key in parts[0]}
