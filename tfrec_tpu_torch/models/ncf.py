"""Neural collaborative filtering: GMF, MLP and NeuMF, the models of config 3.

The counterpart of ``tfrec_tpu/models/ncf.py``. GMF scores a pair by a
learned weighting of the elementwise product h . (p_u * q_i) + b; MLP by a
tower over [p_u ; q_i]; NeuMF fuses both towers over separate embeddings
through one linear head. They train pointwise (logloss over sampled
negatives) or pairwise (BPR, sampled softmax; GMF also in-batch).

Rows come through the gather kernel (one launch for every table a call on
a card); the towers are plain PyTorch. Full-catalog scoring walks the items
in chunks of ``eval_chunk``, so the [B * chunk, D] pair rows of one chunk
are the most it holds at once (the reference's ``lax.scan``); the last
chunk's ids clamp to V-1 and the result is cut to V. GMF scores the
catalog as one product of h-scaled user rows against the item table.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from tfrec_tpu_torch.models.base import DataSpec, DotRetrieval, RecModel
from tfrec_tpu_torch.models.layers import apply_mlp, glorot, init_mlp
from tfrec_tpu_torch.ops.embedding import TableSpec, gather_many


class _NCFBase(RecModel):
    """Pairwise and pointwise plumbing and chunked full-catalog scoring."""

    eval_chunk: int = 1024

    def __init__(self, data_spec: DataSpec):
        super().__init__()
        if data_spec.kind != "interaction":
            raise ValueError(f"{type(self).__name__} needs an interaction DataSpec, got {data_spec.kind!r}")
        self.data_spec = data_spec

    def lookup_ids(self, batch) -> Dict[str, torch.Tensor]:
        """User tables take the users; item tables the items ([pos; negs]
        for a pairwise batch)."""
        items = self.pair_item_ids(batch) if self.is_pairwise(batch) else batch["item"]
        return {spec.name: batch["user"] if spec.name.startswith("user") else items
                for spec in self.table_specs()}

    def _pair_logit(self, dense, u_g: Dict, i_g: Dict, generator=None) -> torch.Tensor:
        raise NotImplementedError

    def in_batch_scores(self, dense, u_g: Dict, i_g: Dict) -> torch.Tensor:
        raise NotImplementedError(
            f"{type(self).__name__} does not support in_batch_softmax "
            "(dot-product scorers only: mf, gmf)"
        )

    def forward(self, dense, gathered, batch, *, generator=None) -> torch.Tensor:
        """Pointwise: [B] logits. Pairwise with "neg": s_pos - s_neg [B];
        with "negs" [B, K]: the [B, 1+K] score matrix, column 0 the
        positive; with "pos" alone: the [B, B] in-batch scores. Dropout runs
        only when a training step passes a ``generator``."""
        u_g = {k: v for k, v in gathered.items() if k.startswith("user")}
        i_g = {k: v for k, v in gathered.items() if k.startswith("item")}
        if not self.is_pairwise(batch):
            return self._pair_logit(dense, u_g, i_g, generator)
        if "neg" not in batch and "negs" not in batch:
            return self.in_batch_scores(dense, u_g, i_g)
        bsz = batch["user"].shape[0]
        if "negs" in batch:
            k = batch["negs"].shape[1]
            # Items are [pos (B); negs (B*K, user-major)].
            u_rep = {key: torch.cat([v, v.repeat_interleave(k, dim=0)]) for key, v in u_g.items()}
            s = self._pair_logit(dense, u_rep, i_g, generator)
            return torch.cat([s[:bsz, None], s[bsz:].reshape(bsz, k)], dim=1)
        pos = {key: v[:bsz] for key, v in i_g.items()}
        neg = {key: v[bsz:] for key, v in i_g.items()}
        return self._pair_logit(dense, u_g, pos, generator) - self._pair_logit(dense, u_g, neg, generator)

    def _gather_users_items(self, tables, user_ids, item_ids):
        """(user rows, item rows) by table name, in one gather launch."""
        names = [spec.name for spec in self.table_specs()]
        ids = [user_ids if n.startswith("user") else item_ids for n in names]
        rows = dict(zip(names, gather_many([tables[n] for n in names], ids)))
        return ({n: r for n, r in rows.items() if n.startswith("user")},
                {n: r for n, r in rows.items() if n.startswith("item")})

    def _cross_scores(self, dense, u_g, i_g) -> torch.Tensor:
        """[B, C]: every user's rows against every item's, as B*C pairs."""
        bsz = next(iter(u_g.values())).shape[0]
        csz = next(iter(i_g.values())).shape[0]
        u_rep = {k: v.repeat_interleave(csz, dim=0) for k, v in u_g.items()}  # [B*C, D]
        i_rep = {k: v.repeat(bsz, 1) for k, v in i_g.items()}  # [B*C, D]
        return self._pair_logit(dense, u_rep, i_rep).reshape(bsz, csz)

    def score_items(self, params, user_ids, item_ids) -> torch.Tensor:
        """[B, C]: every user in the batch scored against a shared item chunk."""
        u_g, i_g = self._gather_users_items(params["tables"], user_ids, item_ids)
        return self._cross_scores(params["dense"], u_g, i_g)

    def score_all(self, params, user_ids: torch.Tensor) -> torch.Tensor:
        """[B, V] scores, chunk by chunk over the items (the chunks' rows are
        gathered together with the users', in one launch)."""
        v = self.data_spec.num_items
        chunk = min(self.eval_chunk, v)
        num_chunks = -(-v // chunk)
        ids = torch.arange(num_chunks * chunk, dtype=torch.int32, device=user_ids.device).clamp_(max=v - 1)
        u_g, i_all = self._gather_users_items(params["tables"], user_ids, ids)
        parts = [
            self._cross_scores(params["dense"], u_g,
                               {k: r[c * chunk : (c + 1) * chunk] for k, r in i_all.items()})
            for c in range(num_chunks)
        ]
        return torch.cat(parts, dim=1)[:, :v]


class GMF(_NCFBase):
    """Generalized MF: logit = h . (p_u * q_i) + b."""

    def __init__(self, data_spec: DataSpec, embed_dim: int):
        super().__init__(data_spec)
        self.embed_dim = embed_dim

    def table_specs(self) -> Tuple[TableSpec, ...]:
        u, v, d = self.data_spec.num_users, self.data_spec.num_items, self.embed_dim
        return (TableSpec("user_emb", u, d), TableSpec("item_emb", v, d))

    def init_dense(self, generator: torch.Generator, device: torch.device | str):
        return {"h": torch.ones((self.embed_dim,), device=device) / self.embed_dim,
                "b": torch.zeros((), device=device)}

    def _pair_logit(self, dense, u_g, i_g, generator=None) -> torch.Tensor:
        return (u_g["user_emb"] * i_g["item_emb"]) @ dense["h"] + dense["b"]

    def in_batch_scores(self, dense, u_g, i_g) -> torch.Tensor:
        # h . (u * v) = (u * h) . v: [B, B] in one product.
        u = u_g["user_emb"] * dense["h"][None, :]
        return torch.matmul(u, i_g["item_emb"].T) + dense["b"]

    def score_all(self, params, user_ids: torch.Tensor) -> torch.Tensor:
        """[B, V]: the h-scaled user rows (one gather launch) against the
        item table in one product."""
        t, d = params["tables"], params["dense"]
        (u,) = gather_many([t["user_emb"]], [user_ids])
        return torch.matmul(u * d["h"][None, :], t["item_emb"].T) + d["b"]

    def dot_decomposition(self) -> DotRetrieval:
        # The scalar b, the same for every item, does not change a ranking.
        return DotRetrieval("user_emb", "item_emb", None,
                            transform=lambda dense, u: u * dense["h"][None, :])


class MLP(_NCFBase):
    """NCF-MLP: logit = MLP([p_u ; q_i])."""

    def __init__(self, data_spec: DataSpec, embed_dim: int, mlp_dims, dropout: float = 0.0):
        super().__init__(data_spec)
        self.embed_dim = embed_dim
        self.mlp_dims = tuple(mlp_dims)
        self.dropout = dropout

    def table_specs(self) -> Tuple[TableSpec, ...]:
        u, v, d = self.data_spec.num_users, self.data_spec.num_items, self.embed_dim
        return (TableSpec("user_emb", u, d), TableSpec("item_emb", v, d))

    def init_dense(self, generator: torch.Generator, device: torch.device | str):
        # The hidden layers and a linear head of width 1.
        return {"mlp": init_mlp(generator, 2 * self.embed_dim, (*self.mlp_dims, 1), device)}

    def _pair_logit(self, dense, u_g, i_g, generator=None) -> torch.Tensor:
        z = torch.cat([u_g["user_emb"], i_g["item_emb"]], dim=-1)
        return apply_mlp(dense["mlp"], z, dropout=self.dropout, generator=generator)[:, 0]


class NeuMF(_NCFBase):
    """NeuMF: a GMF tower and an MLP tower over separate embeddings, fused
    by one linear head."""

    def __init__(self, data_spec: DataSpec, gmf_dim: int, mlp_embed_dim: int, mlp_dims,
                 dropout: float = 0.0):
        super().__init__(data_spec)
        self.gmf_dim = gmf_dim
        self.mlp_embed_dim = mlp_embed_dim
        self.mlp_dims = tuple(mlp_dims)
        self.dropout = dropout

    def table_specs(self) -> Tuple[TableSpec, ...]:
        u, v = self.data_spec.num_users, self.data_spec.num_items
        return (
            TableSpec("user_gmf", u, self.gmf_dim),
            TableSpec("item_gmf", v, self.gmf_dim),
            TableSpec("user_mlp", u, self.mlp_embed_dim),
            TableSpec("item_mlp", v, self.mlp_embed_dim),
        )

    def warm_start_aliases(self) -> Dict[str, str]:
        """The paper's pretraining: both towers start from a trained
        factorization's user_emb and item_emb (a GMF or MF run), through
        ``train.init_from``; a tower whose dim differs is skipped."""
        return {"user_gmf": "user_emb", "item_gmf": "item_emb",
                "user_mlp": "user_emb", "item_mlp": "item_emb"}

    def init_dense(self, generator: torch.Generator, device: torch.device | str):
        head_in = self.gmf_dim + self.mlp_dims[-1]
        return {
            "mlp": init_mlp(generator, 2 * self.mlp_embed_dim, self.mlp_dims, device),
            "w_out": glorot(generator, (head_in, 1), device),
            "b_out": torch.zeros((), device=device),
        }

    def _pair_logit(self, dense, u_g, i_g, generator=None) -> torch.Tensor:
        gmf_vec = u_g["user_gmf"] * i_g["item_gmf"]
        z = torch.cat([u_g["user_mlp"], i_g["item_mlp"]], dim=-1)
        # Every tower layer is hidden, ReLU on the last too, as in NCF.
        mlp_vec = apply_mlp(dense["mlp"], z, final_linear=False, dropout=self.dropout,
                            generator=generator)
        fused = torch.cat([gmf_vec, mlp_vec], dim=-1)
        return (fused @ dense["w_out"])[:, 0] + dense["b_out"]
