"""NAIS: neural attentive item similarity, the counterpart of
``tfrec_tpu/models/nais.py`` (FISM with a target-aware attention pool)::

    score(u, i) = b_i + sum_{j in R_u \\ {i}} a_ij <p_j, q_i>
    f_ij = h^T relu(W^T (p_j * q_i) + c),  clipped to [-12, 12]
    a_ij = exp(f_ij) / (sum_j exp(f_ij))^beta

FISM's tables and batches, and a dense attention MLP (W [D, A], c [A],
h [A]) under the dense optimizer. Padding and the scored item are masked
out of the pool; the clip keeps exp finite without a max-shift (which
would change the ranks under beta < 1).

``score_all`` attends to every (history item, catalog item) pair, O(B H V
A D): W is applied to each history row once (``tw`` [B, H, A, D]), and the
catalog goes in chunks whose [B * H, A, C] pre-activation stays within
``SCORE_CHUNK_FLOATS`` (C = 256 at an eval batch of 256 users, H = 64, A =
16: 268 MB in f32). The reference's chunks are 512 items; a chunk's scores
do not depend on its size.
"""

from __future__ import annotations

import torch

from tfrec_tpu_torch.models.base import DataSpec
from tfrec_tpu_torch.models.fism import FISM, _single_negative
from tfrec_tpu_torch.ops.embedding import gather_many

_F_CLIP = 12.0
SCORE_CHUNK_FLOATS = 1 << 26


class NAIS(FISM):
    def __init__(self, data_spec: DataSpec, embed_dim: int, attention_dim: int = 16,
                 beta: float = 0.5, max_history: int = 50):
        super().__init__(data_spec, embed_dim, max_history=max_history)
        self.attention_dim = attention_dim
        self.beta = beta

    def init_dense(self, generator: torch.Generator, device: torch.device | str):
        """Glorot-uniform W [D, A], c zeros, h uniform in +-1/sqrt(A)."""
        d, a = self.embed_dim, self.attention_dim
        lim = (6.0 / (d + a)) ** 0.5

        def uniform(shape, bound):
            u = torch.rand(shape, generator=generator, device=device)
            return u.mul_(2 * bound).sub_(bound)

        return {"att_w": uniform((d, a), lim), "att_c": torch.zeros(a, device=device),
                "att_h": uniform((a,), 1.0 / a**0.5)}

    def _pool(self, w: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
        """sum_h w * e / max(sum_h w, 1e-8)^beta over axis 1."""
        return (w * e).sum(dim=1) / w.sum(dim=1).clamp_min(1e-8) ** self.beta

    def _attend(self, dense, rows, valid, q, items, hist) -> torch.Tensor:
        """The attention-pooled similarity [B] (no bias) of each history
        (rows [B, H, D] masked, valid [B, H]) to its target (q [B, D],
        items [B])."""
        e = torch.einsum("bhd,bd->bh", rows, q)
        x = rows * q[:, None, :]
        f = torch.relu(torch.matmul(x, dense["att_w"]) + dense["att_c"]) @ dense["att_h"]
        f = f.clamp(-_F_CLIP, _F_CLIP)
        keep = valid & (hist != items[:, None])
        return self._pool(torch.where(keep, f.exp(), 0.0), e)

    def forward(self, dense, gathered, batch, *, generator=None) -> torch.Tensor:
        """Pairwise {"pos", "neg"}: s_pos - s_neg [B]; pointwise: [B]."""
        hist = self.batch_history(batch)
        b, h = hist.shape
        valid = self._valid(hist)
        rows = torch.where(valid[:, :, None], gathered["item_p"].reshape(b, h, -1), 0.0)
        q, bias = gathered["item_q"], gathered["item_bias"]
        if self.is_pairwise(batch):
            _single_negative(self, batch)
            s_pos = self._attend(dense, rows, valid, q[:b], batch["pos"], hist)
            s_neg = self._attend(dense, rows, valid, q[b:], batch["neg"], hist)
            return (s_pos + bias[:b, 0]) - (s_neg + bias[b:, 0])
        return self._attend(dense, rows, valid, q, batch["item"], hist) + bias[:, 0]

    def score_all(self, params, user_ids: torch.Tensor) -> torch.Tensor:
        """[B, V]: every catalog item attended against each history, in
        chunks of the catalog."""
        t, dense = params["tables"], params["dense"]
        v, a = self.data_spec.num_items, self.attention_dim
        hist = self._history(user_ids.device)[0][user_ids.long()]
        b, h = hist.shape
        valid = self._valid(hist)
        (p_rows,) = gather_many([t["item_p"]], [hist.reshape(-1)])
        rows = torch.where(valid[:, :, None], p_rows.reshape(b, h, -1), 0.0)
        # (p * q) @ W = contract(tw, q) with tw[b, h, a, d] = p[b, h, d] W[d, a].
        tw = (rows[:, :, None, :] * dense["att_w"].T[None, None]).reshape(b * h, a, -1)
        chunk = max(1, min(v, SCORE_CHUNK_FLOATS // max(b * h * a, 1)))
        item_ids = torch.arange(v, device=hist.device, dtype=hist.dtype)
        out = []
        for lo in range(0, v, chunk):
            q_c = t["item_q"][lo : lo + chunk]
            e = torch.matmul(rows, q_c.T)  # [B, H, C]
            pre = torch.matmul(tw, q_c.T) + dense["att_c"][:, None]  # [B * H, A, C]
            f = torch.matmul(dense["att_h"], torch.relu(pre)).reshape(b, h, -1)
            f = f.clamp(-_F_CLIP, _F_CLIP)
            keep = valid[:, :, None] & (hist[:, :, None] != item_ids[None, None, lo : lo + chunk])
            out.append(self._pool(torch.where(keep, f.exp(), 0.0), e) + t["item_bias"][lo : lo + chunk, 0])
        return torch.cat(out, dim=1)
