"""Caser, convolutional sequence embedding (Tang & Wang 2018), on the
sequential protocol of ``models/seq_base.py``: each position's features see
exactly its trailing window, so one sequence carries L-1 training examples.

The counterpart of ``tfrec_tpu/models/caser.py``. Horizontal filters of
heights ``caser_heights`` are causal convolutions over time with the
embedding as input channels: the reference's ``lax.conv_general_dilated``
with padding (h-1, 0) is the cross-correlation ``F.conv1d(pad(x, (h-1,
0)), w.permute(2, 1, 0))``, computed here as its h shifted matmuls, one a
tap, so that it runs on cuBLAS in f32 like every other product of the port
(cuDNN would choose its algorithm, and TF32, at run time). The weights keep
the reference's [h, d, F] layout. The vertical filters are the reference's
[n_v, Lx, Lx] lower-banded matrices built from ``v_w``; the user embedding
joins at the prediction layer.
"""

from __future__ import annotations

from typing import Tuple

import torch

from tfrec_tpu_torch.models.base import DataSpec
from tfrec_tpu_torch.models.seq_base import SequentialRecModel, glorot, make_dropout


def causal_conv(rows: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """rows [B, Lx, D], w [h, D, F] -> [B, Lx, F]: out[t] = sum_k rows[t -
    h + 1 + k] @ w[k], the rows before position 0 zero."""
    h, lx = w.shape[0], rows.shape[1]
    padded = torch.nn.functional.pad(rows, (0, 0, h - 1, 0))
    out = padded[:, :lx] @ w[0]
    for k in range(1, h):
        out = out + padded[:, k : k + lx] @ w[k]
    return out


class Caser(SequentialRecModel):
    uses_user = True

    def __init__(self, data_spec: DataSpec, embed_dim: int, h_filters: int = 16,
                 heights: Tuple[int, ...] = (2, 3, 4), v_filters: int = 4, dropout: float = 0.2,
                 max_history: int = 50):
        super().__init__(data_spec, embed_dim, max_history)
        self.user_dim = embed_dim
        self.h_filters = h_filters
        self.heights = tuple(heights)
        self.v_filters = v_filters
        self.dropout = dropout

    def init_dense(self, generator: torch.Generator, device: torch.device | str):
        d = self.embed_dim
        params = {
            "v_w": torch.randn((self.v_filters, self.max_history), generator=generator,
                               device=device) * 0.02,
            "fc1": glorot(generator, len(self.heights) * self.h_filters + self.v_filters * d, d, device),
            "fc1_b": torch.zeros((d,), device=device),
            "fc2": glorot(generator, 2 * d, d, device),
            "fc2_b": torch.zeros((d,), device=device),
        }
        for h in self.heights:
            params[f"h{h}"] = {"w": glorot(generator, h * d, self.h_filters, device).reshape(
                                   h, d, self.h_filters),
                               "b": torch.zeros((self.h_filters,), device=device)}
        return params

    def _encode(self, dense, rows, seq, user_rows, *, generator, gathered=None):
        b, lx, d = rows.shape
        drop = make_dropout(generator, self.dropout)
        # Horizontal: causal convolutions over time, D input channels.
        feats = [torch.relu(causal_conv(rows, dense[f"h{h}"]["w"]) + dense[f"h{h}"]["b"])
                 for h in self.heights]  # each [B, Lx, F]
        # Vertical: a banded weighted sum over the trailing window, as an
        # [Lx, Lx] matrix a filter.
        w = dense["v_w"]  # [n_v, Lmax]
        pos = torch.arange(lx, device=rows.device)
        delta = pos[:, None] - pos[None, :]
        in_band = (delta >= 0) & (delta < w.shape[1])
        band = torch.where(in_band[None], w[:, delta.clamp(0, w.shape[1] - 1)], 0.0)  # [n_v, Lx, Lx]
        feats.append(torch.einsum("vts,bsd->btvd", band, rows).reshape(b, lx, -1))
        z = torch.cat(feats, dim=-1)
        z = torch.relu(z.reshape(b * lx, -1) @ dense["fc1"] + dense["fc1_b"])
        z = drop(z.reshape(b, lx, d))
        # The prediction layer: the user embedding joins every position.
        zu = torch.cat([z, user_rows[:, None, :].expand(b, lx, d)], dim=-1)
        return zu @ dense["fc2"] + dense["fc2_b"]
