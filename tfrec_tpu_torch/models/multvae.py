"""Mult-VAE and Mult-DAE: the counterpart of ``tfrec_tpu/models/multvae.py``
(Liang et al. 2018; ``variational=False`` is Mult-DAE).

The encoder's first layer over a user's multi-hot history is an embedding
bag: table ``enc1`` [V, H1] gathered at the batch's B * H history ids (one
launch of the gather kernel on a card), summed over the valid ids and
scaled by 1 / sqrt(n). Training drops history members (input dropout, the
kept ones rescaled by 1 / (1 - p)). Then tanh, the [H1, 2Z] layer to mu and
logvar (clipped to [-10, 10]), z = mu + eps * exp(logvar / 2) in training
and mu in scoring, and the decoder tanh(z W1 + b1) W_out + b_out, whose
[H1, V] product is one ``torch.matmul`` (the reference leaves it to XLA).
Mult-DAE's bottleneck is tanh of a [H1, Z] layer with no KL.

``forward`` gives {"logits" [B, V], "kl" [B]} with kl times beta, the
``multvae`` loss's input; for a batch with "item" (a served (user, item)
request) it gives the logits at those items. ``score_all`` reconstructs
from the attached history with no dropout and z = mu.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from tfrec_tpu_torch.models.base import DataSpec
from tfrec_tpu_torch.models.history_base import HistoryRecModel
from tfrec_tpu_torch.ops.embedding import TableSpec, gather_many


def glorot(generator, fan_in: int, fan_out: int, device) -> torch.Tensor:
    lim = (6.0 / (fan_in + fan_out)) ** 0.5
    u = torch.rand((fan_in, fan_out), generator=generator, device=device)
    return u.mul_(2 * lim).sub_(lim)


def corrupt(valid: torch.Tensor, rate: float, generator) -> torch.Tensor:
    """The history mask [B, H] as floats, each member kept with probability
    1 - rate and rescaled by 1 / (1 - rate) in training (``generator``
    given), as it is otherwise."""
    valid = valid.to(torch.float32)
    if generator is None or rate <= 0.0:
        return valid
    keep = (torch.rand(valid.shape, generator=generator, device=valid.device) < 1.0 - rate)
    return valid * keep.to(valid.dtype) / (1.0 - rate)


class MultVAE(HistoryRecModel):
    def __init__(self, data_spec: DataSpec, hidden_dim: int = 256, latent_dim: int = 64,
                 beta: float = 0.2, dropout: float = 0.5, max_history: int = 50,
                 variational: bool = True):
        super().__init__()
        if data_spec.kind != "interaction":
            raise ValueError(f"{type(self).__name__} needs an interaction DataSpec, got {data_spec.kind!r}")
        self.data_spec = data_spec
        self.hidden_dim = hidden_dim
        self.latent_dim = latent_dim
        self.beta = beta
        self.dropout = dropout
        self.max_history = max_history
        self.variational = variational

    def draws_noise(self) -> bool:
        return self.variational or self.dropout > 0.0

    def noise(self, mu: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        """The reparameterisation's eps, standard normal like ``mu`` (a
        comparison across devices or with the reference sets it to 0)."""
        return torch.randn(mu.shape, generator=generator, device=mu.device)

    def table_specs(self) -> Tuple[TableSpec, ...]:
        return (TableSpec("enc1", self.data_spec.num_items, self.hidden_dim),)

    def init_dense(self, generator: torch.Generator, device: torch.device | str):
        v, h, z = self.data_spec.num_items, self.hidden_dim, self.latent_dim
        z_out = 2 * z if self.variational else z
        zeros = lambda n: torch.zeros(n, device=device)  # noqa: E731
        return {"b_enc1": zeros(h), "w_enc2": glorot(generator, h, z_out, device), "b_enc2": zeros(z_out),
                "w_dec1": glorot(generator, z, h, device), "b_dec1": zeros(h),
                "w_out": glorot(generator, h, v, device), "b_out": zeros(v)}

    def lookup_ids(self, batch) -> Dict[str, torch.Tensor]:
        return {"enc1": self.batch_history(batch).reshape(-1)}

    def _encode_decode(self, dense, bag_rows, hist, *, generator):
        """bag_rows [B * H, H1] of ``hist`` [B, H] -> (logits [B, V], kl [B])."""
        b, h = hist.shape
        rows = bag_rows.reshape(b, h, -1)
        valid = corrupt(self._valid(hist), self.dropout, generator)
        n = valid.sum(dim=1).clamp_min(1.0)
        x = torch.einsum("bh,bhd->bd", valid, rows) / n.sqrt()[:, None]
        stats = torch.tanh(x + dense["b_enc1"]) @ dense["w_enc2"] + dense["b_enc2"]
        if self.variational:
            mu, logvar = stats.chunk(2, dim=-1)
            logvar = logvar.clamp(-10.0, 10.0)
            z = mu
            if generator is not None:
                z = mu + self.noise(mu, generator) * torch.exp(0.5 * logvar)
            kl = -0.5 * (1.0 + logvar - mu**2 - logvar.exp()).sum(dim=-1)
        else:
            z = torch.tanh(stats)
            kl = torch.zeros(b, dtype=stats.dtype, device=stats.device)
        h3 = torch.tanh(z @ dense["w_dec1"] + dense["b_dec1"])
        return torch.matmul(h3, dense["w_out"]) + dense["b_out"], kl

    def forward(self, dense, gathered, batch, *, generator=None):
        logits, kl = self._encode_decode(dense, gathered["enc1"], self.batch_history(batch),
                                         generator=generator)
        if "item" in batch:
            return logits.gather(1, batch["item"].long()[:, None].clamp(0, logits.shape[1] - 1))[:, 0]
        return {"logits": logits, "kl": self.beta * kl}

    def score_all(self, params, user_ids: torch.Tensor) -> torch.Tensor:
        hist = self._history(user_ids.device)[0][user_ids.long()]
        (rows,) = gather_many([params["tables"]["enc1"]], [hist.reshape(-1)])
        return self._encode_decode(params["dense"], rows, hist, generator=None)[0]
