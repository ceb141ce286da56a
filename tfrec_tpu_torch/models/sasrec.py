"""SASRec, self-attentive sequential recommendation (Kang & McAuley 2018).

The counterpart of ``tfrec_tpu/models/sasrec.py``: positions 0..L-2 attend
causally over their prefix and each predicts position t+1 (the protocol of
``models/seq_base.py``). Attention is plain einsum attention with the
reference's additive mask: -1e9 on the logits of future and padded keys,
then a softmax. A user whose every key is padding gets a finite, uniform
row there, where a boolean mask (``scaled_dot_product_attention``) would
give NaN. Padded query rows are zeroed after each block.
"""

from __future__ import annotations

import torch

from tfrec_tpu_torch.models.base import DataSpec
from tfrec_tpu_torch.models.seq_base import SequentialRecModel, glorot, make_dropout


def _layer_norm(x, scale, bias, eps: float = 1e-6):
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


class SASRec(SequentialRecModel):
    def __init__(self, data_spec: DataSpec, embed_dim: int, num_blocks: int = 2, num_heads: int = 1,
                 dropout: float = 0.2, max_history: int = 50):
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of num_heads {num_heads}")
        super().__init__(data_spec, embed_dim, max_history)
        self.num_blocks = num_blocks
        self.num_heads = num_heads
        self.dropout = dropout

    def init_dense(self, generator: torch.Generator, device: torch.device | str):
        d, l = self.embed_dim, self.max_history

        def zeros(*shape):
            return torch.zeros(shape, device=device)

        def ones(*shape):
            return torch.ones(shape, device=device)

        params = {"pos_emb": torch.randn((l, d), generator=generator, device=device) * 0.02,
                  "ln_f_scale": ones(d), "ln_f_bias": zeros(d)}
        for b in range(self.num_blocks):
            params[f"b{b}"] = {
                "wq": glorot(generator, d, d, device), "wk": glorot(generator, d, d, device),
                "wv": glorot(generator, d, d, device), "wo": glorot(generator, d, d, device),
                "ln1_scale": ones(d), "ln1_bias": zeros(d),
                "ln2_scale": ones(d), "ln2_bias": zeros(d),
                "ffn1": glorot(generator, d, d, device), "ffn1_b": zeros(d),
                "ffn2": zeros(d, d), "ffn2_b": zeros(d),
            }
        return params

    def _encode(self, dense, rows, seq, user_rows, *, generator, gathered=None):
        """Causal attention; padded positions are masked as keys."""
        v = self.data_spec.num_items
        b, lx, d = rows.shape
        h = self.num_heads
        x = rows * float(d) ** 0.5 + dense["pos_emb"][:lx][None, :, :]
        key_ok = seq < v  # [B, Lx]
        causal = torch.ones((lx, lx), dtype=torch.bool, device=rows.device).tril()
        mask = causal[None, :, :] & key_ok[:, None, :]  # [B, Lq, Lk]
        drop = make_dropout(generator, self.dropout)
        x = drop(x)
        for blk in range(self.num_blocks):
            p = dense[f"b{blk}"]
            q = _layer_norm(x, p["ln1_scale"], p["ln1_bias"])
            qh = (q @ p["wq"]).reshape(b, lx, h, d // h)
            kh = (x @ p["wk"]).reshape(b, lx, h, d // h)
            vh = (x @ p["wv"]).reshape(b, lx, h, d // h)
            logits = torch.einsum("bqhe,bkhe->bhqk", qh, kh) / float(d // h) ** 0.5
            logits = torch.where(mask[:, None, :, :], logits, -1e9)
            att = drop(torch.softmax(logits, dim=-1))
            ctx = torch.einsum("bhqk,bkhe->bqhe", att, vh).reshape(b, lx, d)
            x = x + ctx @ p["wo"]
            y = _layer_norm(x, p["ln2_scale"], p["ln2_bias"])
            y = drop(torch.relu(y @ p["ffn1"] + p["ffn1_b"]))
            x = x + y @ p["ffn2"] + p["ffn2_b"]
            # Padded query rows contribute nothing downstream (their keys
            # are already masked).
            x = torch.where(key_ok[:, :, None], x, 0.0)
        return _layer_norm(x, dense["ln_f_scale"], dense["ln_f_bias"])
