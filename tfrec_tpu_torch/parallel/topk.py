"""Top-k retrieval over a row-sharded item table: the counterpart of
``tfrec_tpu/parallel/topk.py``.

Each data index holds a block of ``rps`` rows of the (padded) item table.
On each rank, ``sharded_topk_dot`` scores the replicated query vectors
against its block (``torch.matmul``, f32 with TF32 off: a plain product,
outside any Pallas kernel in the reference too), adds the bias, masks the
padded rows and its share of each user's exclusions, and takes its top
``k_local = min(k, rps)``; one ``all_gather`` over ``data`` brings every
block's candidates (values and ids side by side), and the merge's top k
over them is the result, replicated. Slots left with no real candidate (a
small catalog, heavy exclusions) carry the sentinel ``num_items``.

Top-k: "exact" and "approx" are both ``torch.topk``, per block and in the
merge. The reference's "approx" is ``lax.approx_max_k``, the TPU's partial
reduction (``tfrec_tpu/eval/retrieval.py``), which the card has no
counterpart of and which lowers to an exact sort on the CPU; the port
computes exactly what the reference computes there. Ties: ``torch.topk``
promises no order among equal values, so only untied ids are the
reference's.
"""

from __future__ import annotations

from typing import Tuple

import torch

from tfrec_tpu_torch.eval.retrieval import NEG_INF, _fill_columns, candidate_topk
from tfrec_tpu_torch.parallel.mesh import Mesh


def sharded_topk_dot(
    mesh: Mesh,
    user_vecs: torch.Tensor,
    item_block: torch.Tensor,
    k: int,
    num_items: int,
    item_bias: torch.Tensor | None = None,
    exclude_padded: torch.Tensor | None = None,
    exclude_counts: torch.Tensor | None = None,
    axis: str = "data",
    method: str = "exact",
    recall_target: float = 0.99,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k (values [B, k] f32, global item ids [B, k] int32) of
    ``user_vecs`` [B, D] (the same on every rank) against the item table
    whose rows [i * rps, (i + 1) * rps) rank i of ``axis`` holds as
    ``item_block`` [rps, D] (``item_bias`` [rps], its block of the bias);
    ``exclude_padded`` [B, W] global ids, the first ``exclude_counts`` [B]
    of each row excluded. A collective: every rank of ``axis`` calls it."""
    if exclude_padded is not None and exclude_counts is None:
        raise ValueError("exclude_padded requires exclude_counts")
    rps = item_block.shape[0]
    base = mesh.index(axis) * rps
    k_local = min(k, rps)
    scores = torch.matmul(user_vecs, item_block.T)  # [B, rps]
    if item_bias is not None:
        scores = scores + item_bias[None, :]
    ids = base + torch.arange(rps, dtype=torch.int32, device=scores.device)
    scores = torch.where(ids[None, :] < num_items, scores, NEG_INF)
    if exclude_padded is not None:
        valid = (torch.arange(exclude_padded.shape[1], device=scores.device)[None, :]
                 < exclude_counts[:, None])
        local = exclude_padded.long() - base
        _fill_columns(scores, local, valid & (local >= 0) & (local < rps))
    vals, idx = candidate_topk(scores, k_local, method, recall_target)
    gids = (base + idx).to(torch.int32)
    # Values and ids in one gather: the ids ride as their f32 bit patterns.
    both = mesh.all_gather(torch.cat([vals, gids.view(torch.float32)], dim=1), axis, dim=1)
    n = mesh.shape[axis]
    both = both.view(both.shape[0], n, 2, k_local)
    all_vals = both[:, :, 0].reshape(both.shape[0], -1)
    all_ids = both[:, :, 1].reshape(both.shape[0], -1).contiguous().view(torch.int32)
    mvals, midx = torch.topk(all_vals, k, dim=1)
    mids = torch.gather(all_ids, 1, midx)
    mids = torch.where(mvals <= NEG_INF * 0.5, num_items, mids)
    return mvals, mids
