"""The sequential recommenders' common part: the counterpart of
``tfrec_tpu/models/seq_base.py``.

Every member trains on one protocol (``SequenceSampler`` batches: a
time-ordered ``seq`` [B, L] and a sampled negative a predicted position,
``seq_negs`` [B, L-1]; the ``sasrec`` loss, a per-position next-item BCE)
and differs only in its causal encoder from item rows [B, Lx, D] to hidden
states [B, Lx, D]: SASRec (self-attention), GRU4Rec (a gated recurrence),
Caser (causal convolutions) and FPMC (user plus last-item transition).

One item table serves the input rows, the positive targets (the input rows
shifted by one) and the negatives: one gather launch and one sparse update
a step. Shapes are static; a tail of sentinels (``num_items``) pads each
sequence, and the loss mask, never a shape, drops those positions. The
eval encodes each user's whole ordered train sequence, which the trainer
attaches (``attach_history``, from ``data.samplers.build_sequences``), and
dots the last valid hidden state with the item table; its rows are
gathered through ``ops.embedding.gather_many`` (clip semantics, the kernel
on a card), where the reference takes them with ``jnp.take(mode="clip")``.

Dropout draws from an explicit ``torch.Generator``, one draw after another,
where the reference folds a key into its rng; its numbers differ from
JAX's for any seed.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from tfrec_tpu_torch.models.base import DataSpec
from tfrec_tpu_torch.models.history_base import HistoryRecModel
from tfrec_tpu_torch.ops.embedding import TableSpec, gather_many


def glorot(generator: torch.Generator, fan_in: int, fan_out: int,
           device: torch.device | str) -> torch.Tensor:
    """Glorot-uniform [fan_in, fan_out]: U(-lim, lim), lim = sqrt(6 / (fan_in
    + fan_out)), as the reference's sequential models draw it."""
    lim = (6.0 / (fan_in + fan_out)) ** 0.5
    return torch.empty((fan_in, fan_out), device=device).uniform_(-lim, lim, generator=generator)


def make_dropout(generator: torch.Generator | None, rate: float) -> Callable:
    """Inverted dropout ``drop(t)``; the identity without a generator (eval)
    or at rate 0. Each call draws from ``generator`` after the last, where
    the reference folds a site key into its rng."""

    def drop(t: torch.Tensor) -> torch.Tensor:
        if generator is None or rate <= 0.0:
            return t
        keep = torch.rand(t.shape, generator=generator, device=t.device) < 1.0 - rate
        return torch.where(keep, t / (1.0 - rate), 0.0)

    return drop


class SequentialRecModel(HistoryRecModel):
    """Next-item models over time-ordered sequences.

    Subclasses set ``uses_user`` and ``user_dim`` if they carry a user
    table and implement ``_encode(dense, rows, seq, user_rows, *,
    generator, gathered=None) -> [B, Lx, D]`` as a causal map: position t
    depends on positions <= t only."""

    # The trainer attaches time-ordered sequences (build_sequences), not
    # unordered history sets.
    ordered_history = True
    uses_user = False
    user_dim = 0

    def __init__(self, data_spec: DataSpec, embed_dim: int, max_history: int):
        super().__init__()
        if data_spec.kind != "interaction":
            raise ValueError(f"{type(self).__name__} needs an interaction DataSpec, got {data_spec.kind!r}")
        self.data_spec = data_spec
        self.embed_dim = embed_dim
        self.max_history = max_history

    # ---- protocol ----

    def table_specs(self) -> Tuple[TableSpec, ...]:
        specs = (TableSpec("item_emb", self.data_spec.num_items, self.embed_dim),)
        if self.uses_user:
            specs += (TableSpec("user_emb", self.data_spec.num_users, self.user_dim),)
        return specs

    def lookup_ids(self, batch) -> Dict[str, torch.Tensor]:
        """Training: the sequence's ids then its negatives' into
        ``item_emb``; pointwise (user, item) scoring: the user's attached
        sequence then the items. The user table takes the users."""
        if "seq" not in batch:
            ids = torch.cat([self._pointwise_seq(batch).reshape(-1), batch["item"]])
        else:
            ids = batch["seq"].reshape(-1)
            if "seq_negs" in batch:
                ids = torch.cat([ids, batch["seq_negs"].reshape(-1)])
        out = {"item_emb": ids}
        if self.uses_user:
            out["user_emb"] = batch["user"]
        return out

    def _pointwise_seq(self, batch) -> torch.Tensor:
        # The rows carried in the batch (serving passes them,
        # ``pointwise_batch_extras``), else the attached sequences.
        if "hist_seq" in batch:
            return batch["hist_seq"]
        return self._history(batch["user"].device)[0][batch["user"].long()]

    def _pointwise_lens(self, batch) -> torch.Tensor:
        if "hist_len" in batch:
            return batch["hist_len"]
        return self._history(batch["user"].device)[1][batch["user"].long()]

    def pointwise_batch_extras(self, user_ids: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The users' attached sequences and lengths as batch entries, for
        pointwise scoring (``serve.Recommender.predict``)."""
        hist, lens = self._history(user_ids.device)
        users = user_ids.long()
        return {"hist_seq": hist[users], "hist_len": lens[users]}

    # ---- encoder (subclass) ----

    def _encode(self, dense, rows, seq, user_rows, *, generator, gathered=None):
        """rows [B, Lx, D] of ``seq`` [B, Lx] (sentinel rows zeroed);
        user_rows [B, user_dim] or None; ``gathered`` the whole lookup for
        encoders with tables of their own (None where the caller gathered
        only these rows) -> hidden [B, Lx, D], causal in time."""
        raise NotImplementedError

    @staticmethod
    def _at_last(hidden: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
        """Each row's entry at its last valid position: [B, L, D] -> [B, D]
        (or [B, L] -> [B])."""
        idx = (lens.long() - 1).clamp_min(0)
        return hidden[torch.arange(hidden.shape[0], device=hidden.device), idx]

    def forward(self, dense, gathered, batch, *, generator=None):
        """Training batches -> {"pos", "neg", "mask"} [B, L-1]: the hidden
        state at each position against the next item's row and the
        position's negative's, and where both positions are real. Pointwise
        batches -> scores [B] of the items against each user's last hidden
        state (no dropout)."""
        v = self.data_spec.num_items
        user_rows = gathered.get("user_emb") if self.uses_user else None
        rows_all = gathered["item_emb"]
        if "seq" not in batch:
            seq = self._pointwise_seq(batch)
            b, l = seq.shape
            seq_rows = torch.where((seq < v)[:, :, None], rows_all[: b * l].reshape(b, l, -1), 0.0)
            hidden = self._encode(dense, seq_rows, seq, user_rows, generator=None, gathered=gathered)
            last = self._at_last(hidden, self._pointwise_lens(batch))
            return (last * rows_all[b * l :]).sum(dim=-1)
        seq = batch["seq"]  # [B, L]
        b, l = seq.shape
        valid = seq < v
        seq_rows = torch.where(valid[:, :, None], rows_all[: b * l].reshape(b, l, -1), 0.0)
        neg_rows = rows_all[b * l :].reshape(b, l - 1, -1)
        hidden = self._encode(dense, seq_rows[:, :-1], seq[:, :-1], user_rows, generator=generator,
                              gathered=gathered)  # [B, L-1, D]
        pos = (hidden * seq_rows[:, 1:]).sum(dim=-1)
        neg = (hidden * neg_rows).sum(dim=-1)
        return {"pos": pos, "neg": neg, "mask": valid[:, :-1] & valid[:, 1:]}

    def _last_hidden(self, params, user_ids: torch.Tensor) -> torch.Tensor:
        """[B, D]: the last valid hidden state of each user's attached
        sequence, the query of every eval path. One gather launch takes the
        sequence's item rows (and the users' rows)."""
        hist, hist_len = self._history(user_ids.device)
        users = user_ids.long()
        seq, lens = hist[users], hist_len[users]
        t = params["tables"]
        tables, ids = [t["item_emb"]], [seq.reshape(-1)]
        if self.uses_user:
            tables.append(t["user_emb"])
            ids.append(user_ids)
        got = gather_many(tables, ids)
        rows = torch.where((seq < self.data_spec.num_items)[:, :, None],
                           got[0].reshape(*seq.shape, -1), 0.0)
        user_rows = got[1] if self.uses_user else None
        hidden = self._encode(params["dense"], rows, seq, user_rows, generator=None)
        return self._at_last(hidden, lens)

    def score_all(self, params, user_ids: torch.Tensor) -> torch.Tensor:
        """[B, num_items] scores of the full catalog."""
        return self._last_hidden(params, user_ids) @ params["tables"]["item_emb"].T

    def score_user_items(self, params, user_ids: torch.Tensor, item_ids: torch.Tensor) -> torch.Tensor:
        """[B, W] scores of a candidate list a user: each user's history is
        encoded once and dotted with its W candidates' rows (ids clipped)."""
        last = self._last_hidden(params, user_ids)
        rows = gather_many([params["tables"]["item_emb"]], [item_ids.reshape(-1)])[0]
        return torch.einsum("bd,bwd->bw", last, rows.reshape(*item_ids.shape, -1))
