"""Low-rank DCN-v2 (Wang et al., arXiv:2008.13535) in plain float32 PyTorch,
in the port's parallel structure.

x0 = [one embedding a field, in field order ; the 13 raw dense features];
the cross stack x_{l+1} = x0 * ((x_l V_l) U_l^T + b_l) + x_l over 3 layers of
rank 512; beside it the deep tower, ReLU after every layer
(3341-1024-1024-512-256); the head [x_L ; deep] @ w_out + b_out.
"""

from __future__ import annotations

import torch

from portbench.reference.common import mlp


def logits(dense: dict, emb: torch.Tensor, dense_x: torch.Tensor, mm) -> torch.Tensor:
    x0 = torch.cat([emb.reshape(emb.shape[0], -1), dense_x], dim=1)
    cross = dense["cross"]
    x = x0
    for l in range(cross["b"].shape[0]):
        x = x0 * (mm(mm(x, cross["v"][l]), cross["u"][l].transpose(0, 1)) + cross["b"][l]) + x
    deep = mlp(dense["mlp"], x0, mm, final_linear=False)
    return mm(torch.cat([x, deep], dim=1), dense["w_out"])[:, 0] + dense["b_out"]
