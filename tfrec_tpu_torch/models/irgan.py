"""IRGAN, generative adversarial retrieval (Wang et al. 2017).

The counterpart of ``tfrec_tpu/models/irgan.py``. Two MF scorers play a
minimax game over implicit feedback: the generator G (``user_g``,
``item_g``, ``bias_g``) learns which items a user would pick, by REINFORCE,
to fool the discriminator D (``user_d``, ``item_d``, ``bias_d``), which
learns to tell the true positives from G's picks. One step trains both: G
reaches the loss only through log p_G of a discrete pick and D only
through its scores, with the reward detached, so the simultaneous step has
each player's own gradient (``train/losses.irgan``).

A training batch is a multi-negative pairwise batch, "negs" [B, K] the
generator's pool: the six tables' rows come in one gather (one kernel
launch on a card), [pos; negs] for the item tables. G's categorical over
the pool is a tempered log-softmax; the pick is a Gumbel-max, the Gumbel
noise drawn from the step's generator (``gumbel``), or passed in as
``forward(..., gumbel=)`` (a comparison with the reference passes its
``jax.random.gumbel`` draw); without either the pick is greedy. The reward
of a pick is softplus(D's score), detached.

Eval and serving score with the generator alone, which warm starts from an
MF checkpoint (``warm_start_aliases``) and is exposed to the sharded top-k
as a dot product.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from tfrec_tpu_torch.models.base import DataSpec, DotRetrieval, RecModel
from tfrec_tpu_torch.ops.embedding import TableSpec, gather_many


class IRGAN(RecModel):
    def __init__(self, data_spec: DataSpec, embed_dim: int, temperature: float = 1.0, use_bias: bool = True):
        super().__init__()
        if data_spec.kind != "interaction":
            raise ValueError(f"IRGAN needs an interaction DataSpec, got {data_spec.kind!r}")
        self.data_spec = data_spec
        self.embed_dim = embed_dim
        self.temperature = temperature
        self.use_bias = use_bias

    def table_specs(self) -> Tuple[TableSpec, ...]:
        u, v, d = self.data_spec.num_users, self.data_spec.num_items, self.embed_dim
        specs = [TableSpec("user_g", u, d), TableSpec("item_g", v, d),
                 TableSpec("user_d", u, d), TableSpec("item_d", v, d)]
        if self.use_bias:
            specs += [TableSpec("bias_g", v, 1, initializer="zeros"),
                      TableSpec("bias_d", v, 1, initializer="zeros")]
        return tuple(specs)

    def init_dense(self, generator: torch.Generator, device: torch.device | str):
        return {}

    def draws_noise(self) -> bool:
        return True  # the Gumbel-max pick

    def gumbel(self, shape, generator: torch.Generator, device) -> torch.Tensor:
        """Standard Gumbel noise -log(-log(u)), u uniform in [tiny, 1)."""
        u = torch.rand(shape, generator=generator, device=device).clamp_min(torch.finfo(torch.float32).tiny)
        return -torch.log(-torch.log(u))

    def step_noise(self, batch, generator, ranks: int, index: int):
        """The global batch's Gumbel draw [B * ranks, K], shard ``index``'s
        rows (a pool of K = 1 where the batch has one neg)."""
        if generator is None or not self.is_pairwise(batch):
            return None
        b = batch["user"].shape[0]
        k = batch["negs"].shape[1] if "negs" in batch else 1
        noise = self.gumbel((b * ranks, k), generator, batch["user"].device)
        return {"gumbel": noise[index * b:(index + 1) * b]}

    def lookup_ids(self, batch) -> Dict[str, torch.Tensor]:
        if not self.is_pairwise(batch):
            # Eval and serving read the generator's tables only.
            ids = {"user_g": batch["user"], "item_g": batch["item"]}
            if self.use_bias:
                ids["bias_g"] = batch["item"]
            return ids
        items = self.pair_item_ids(batch)
        ids = {"user_g": batch["user"], "item_g": items, "user_d": batch["user"], "item_d": items}
        if self.use_bias:
            ids["bias_g"] = items
            ids["bias_d"] = items
        return ids

    @staticmethod
    def _pair_scores(u, i, b, bsz: int, k: int) -> torch.Tensor:
        """[B, 1+K] scores from the user rows and the [pos; negs] item rows."""
        u_rep = torch.cat([u, u.repeat_interleave(k, dim=0)])
        s = (u_rep * i).sum(dim=-1)
        if b is not None:
            s = s + b[:, 0]
        return torch.cat([s[:bsz, None], s[bsz:].reshape(bsz, k)], dim=1)

    def forward(self, dense, gathered, batch, *, generator=None, gumbel=None):
        """Pointwise: the generator's scores [B]. A pairwise batch:
        {"d_pos", "d_sel", "logp", "reward", "sample"} [B]."""
        if not self.is_pairwise(batch):
            s = (gathered["user_g"] * gathered["item_g"]).sum(dim=-1)
            return s + gathered["bias_g"][:, 0] if self.use_bias else s
        if "negs" in batch:
            k = batch["negs"].shape[1]
        elif "neg" in batch:
            k = 1  # a pool of one: G's log-prob is 0 and only D trains
        else:
            raise ValueError(
                "IRGAN trains on explicit negative pools; in-batch-negative batches are not "
                "supported (set train.loss='irgan' and train.num_negatives >= 8)")
        bsz = batch["user"].shape[0]
        s_g = self._pair_scores(gathered["user_g"], gathered["item_g"], gathered.get("bias_g"), bsz, k)
        s_d = self._pair_scores(gathered["user_d"], gathered["item_d"], gathered.get("bias_d"), bsz, k)
        logits_g = s_g[:, 1:] / self.temperature
        if gumbel is None:
            gumbel = (self.gumbel(logits_g.shape, generator, logits_g.device) if generator is not None
                      else torch.zeros_like(logits_g))
        j = torch.argmax(logits_g.detach() + gumbel, dim=-1)
        logp = torch.gather(torch.log_softmax(logits_g, dim=-1), 1, j[:, None])[:, 0]
        d_sel = torch.gather(s_d[:, 1:], 1, j[:, None])[:, 0]
        reward = torch.logaddexp(d_sel, torch.zeros_like(d_sel)).detach()
        return {"d_pos": s_d[:, 0], "d_sel": d_sel, "logp": logp, "reward": reward, "sample": j}

    def warm_start_aliases(self) -> Dict[str, str]:
        """The paper's protocol: both players start from BPR-MF."""
        return {"user_g": "user_emb", "item_g": "item_emb", "user_d": "user_emb", "item_d": "item_emb",
                "bias_g": "item_bias", "bias_d": "item_bias"}

    def dot_decomposition(self) -> DotRetrieval:
        return DotRetrieval("user_g", "item_g", "bias_g" if self.use_bias else None)

    def score_all(self, params, user_ids: torch.Tensor) -> torch.Tensor:
        """[B, V]: the generator's user rows (one gather launch) against its
        item table, the bias added in place."""
        t = params["tables"]
        (u,) = gather_many([t["user_g"]], [user_ids])
        scores = torch.matmul(u, t["item_g"].T)
        if self.use_bias:
            scores.add_(t["bias_g"][:, 0][None, :])
        return scores
