"""MLPerf's DLRM-DCNv2 (torchrec's ``DLRM_DCN``; Wang et al., arXiv:2008.13535;
Naumov et al., arXiv:1906.00091) in plain float32 PyTorch.

bottom = MLP(dense) (13-512-256-128, a ReLU after every layer); x0 =
[bottom ; the 26 summed bags, in field order] (d0 = 3456); the low-rank
cross x_{l+1} = x0 * ((x_l V_l) U_l^T + b_l) + x_l over 3 layers of rank
512; the over-arch on x_L (3456-1024-1024-512-256-1, a ReLU after every
layer but the last) to one logit. The bags' pooling is
``reference/train_bags.py``'s.
"""

from __future__ import annotations

import torch

from portbench.reference.common import mlp


def logits(dense: dict, emb: torch.Tensor, dense_x: torch.Tensor, mm) -> torch.Tensor:
    """dense: {"top", "bottom"} lists of (w [in, out], b), {"cross": {"b",
    "u", "v"}}; emb [B, F, D] one pooled bag a field; dense_x [B, 13] ->
    logits [B]."""
    bottom = mlp(dense["bottom"], dense_x, mm, final_linear=False)
    x0 = torch.cat([bottom, emb.reshape(emb.shape[0], -1)], dim=1)
    cross = dense["cross"]
    x = x0
    for l in range(cross["b"].shape[0]):
        x = x0 * (mm(mm(x, cross["v"][l]), cross["u"][l].transpose(0, 1)) + cross["b"][l]) + x
    return mlp(dense["top"], x, mm, final_linear=True)[:, 0]
