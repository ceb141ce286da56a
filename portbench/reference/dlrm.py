"""DLRM (Naumov et al., arXiv:1906.00091) in plain float32 PyTorch.

bottom = MLP(dense) (13-512-256-128, no ReLU after its last layer, as the
port builds it: the published reference applies one); the 27 vectors
[bottom ; one embedding a field] dotted pairwise; the strict lower triangle
of the [27, 27] products, row by row; top MLP over [bottom ; pairs]
(479-1024-1024-512-256-1) to one logit.
"""

from __future__ import annotations

import torch

from portbench.reference.common import mlp


def logits(dense: dict, emb: torch.Tensor, dense_x: torch.Tensor, mm) -> torch.Tensor:
    """dense: {"bottom", "top"} lists of (w [in, out], b); emb [B, F, D] one
    row a field; dense_x [B, 13] -> logits [B]."""
    bottom = mlp(dense["bottom"], dense_x, mm, final_linear=True)
    z = torch.cat([bottom[:, None, :], emb], dim=1)
    products = mm(z, z.transpose(1, 2))
    nv = z.shape[1]
    rows, cols = torch.tril_indices(nv, nv, -1, device=z.device)
    pairs = products[:, rows, cols]
    return mlp(dense["top"], torch.cat([bottom, pairs], dim=1), mm, final_linear=True)[:, 0]
