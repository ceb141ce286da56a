"""Model protocol: tables + dense params + a forward over gathered rows.

The counterpart of ``tfrec_tpu/models/base.py``. A model is an
``nn.Module`` that describes one architecture; as in the JAX package its
parameters are not registered on it but passed in explicitly, as a tree
``{"tables": {name: [V, D]}, "dense": <model tree>}`` of tensors, so that a
seeded init and parameters converted from JAX (``convert.params_from_jax``)
are interchangeable:

- ``table_specs()``                 — which embedding tables exist.
- ``init_dense(generator, device)`` — dense-tower params as a tree.
- ``lookup_ids(batch)``             — {table: flat int32 ids} for a batch.
- ``forward(dense, gathered, batch)`` — logits from gathered rows: [B]
  for pointwise, CTR and single-negative pairwise batches (s_pos - s_neg),
  [B, 1+K] for K negatives a row, [B, B] for in-batch negatives.
- retrieval models add ``score_all(params, user_ids)`` -> [B, num_items]
  for full-catalog top-k, and ``dot_decomposition()``.
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Callable, Dict, Sequence, Tuple

import torch
from torch import nn

from tfrec_tpu_torch.ops.embedding import TableSpec, init_tables


@dataclasses.dataclass(frozen=True)
class DataSpec:
    """Shape description of the data a model is built for."""

    kind: str  # "interaction" (user/item) | "ctr" (dense + categorical fields)
    num_users: int = 0
    num_items: int = 0
    field_vocabs: Tuple[int, ...] = ()
    num_dense: int = 0
    # Multi-hot bag width per field (1 = single-hot). A width-W field
    # occupies W columns of batch["cat"], padded with the sentinel value
    # ``vocab`` (one past the end); embeddings are mean-combined over the
    # valid ids.
    field_widths: Tuple[int, ...] = ()

    @staticmethod
    def interaction(num_users: int, num_items: int) -> "DataSpec":
        return DataSpec(kind="interaction", num_users=num_users, num_items=num_items)

    @staticmethod
    def ctr(
        field_vocabs: Sequence[int],
        num_dense: int,
        field_widths: Sequence[int] | None = None,
    ) -> "DataSpec":
        vocabs = tuple(field_vocabs)
        widths = tuple(field_widths) if field_widths else (1,) * len(vocabs)
        if len(widths) != len(vocabs):
            raise ValueError(f"{len(widths)} field widths for {len(vocabs)} fields")
        return DataSpec(
            kind="ctr", field_vocabs=vocabs, num_dense=num_dense,
            field_widths=widths,
        )


def copy_once(cache: Dict[str, object], device, make: Callable):
    """``make(device)``, made once a device and kept in ``cache``; made
    outside ``torch.inference_mode``, so training may use a copy that
    serving made."""
    key = str(device)
    if key not in cache:
        with torch.inference_mode(False):
            cache[key] = make(device)
    return cache[key]


@dataclasses.dataclass(frozen=True)
class DotRetrieval:
    """Dot-product decomposition of a retrieval scorer: ``score_all(params,
    u)`` equals ``user_vecs(dense, tables[user_table][u]) @
    tables[item_table].T (+ tables[bias_table][:, 0])``. ``transform``
    (optional) maps gathered user rows to query vectors with the dense
    params; identity if None."""

    user_table: str
    item_table: str
    bias_table: str | None = None
    transform: Callable | None = None

    def user_vecs(self, dense, user_rows: torch.Tensor) -> torch.Tensor:
        return user_rows if self.transform is None else self.transform(dense, user_rows)


class RecModel(nn.Module, abc.ABC):
    """Base class; subclasses describe one architecture and hold no params."""

    data_spec: DataSpec

    @abc.abstractmethod
    def table_specs(self) -> Tuple[TableSpec, ...]:
        ...

    @abc.abstractmethod
    def init_dense(self, generator: torch.Generator, device: torch.device | str):
        ...

    @abc.abstractmethod
    def lookup_ids(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        ...

    @abc.abstractmethod
    def forward(self, dense, gathered: Dict[str, torch.Tensor], batch) -> torch.Tensor:
        """Logits [B] from the dense params and the gathered rows."""
        ...

    def init(self, generator: torch.Generator, device: torch.device | str):
        """Full params tree ``{"tables": ..., "dense": ...}``, drawn from
        ``generator`` (which must live on ``device``): tables first."""
        return {
            "tables": init_tables(generator, self.table_specs(), device),
            "dense": self.init_dense(generator, device),
        }

    def draws_noise(self) -> bool:
        """Whether the training forward draws from the step's generator
        (dropout; Mult-VAE's reparameterisation too)."""
        return getattr(self, "dropout", 0.0) > 0.0

    def step_noise(self, batch, generator: torch.Generator | None, ranks: int, index: int):
        """Forward keywords of noise that a sharded step draws for the
        global batch of ``ranks`` equal data shards from the step's
        generator, shard ``index``'s rows of it; None where the forward draws
        its own noise (or none)."""
        return None

    def warm_start_aliases(self) -> Dict[str, str]:
        """Target table -> source table for warm starts across models
        (``train.init_from``); unmapped tables match by name."""
        return {}

    # ---- the retrieval surface (interaction models override) ----

    def score_all(self, params, user_ids: torch.Tensor) -> torch.Tensor:
        """[B, num_items] scores of the full catalog for a user batch."""
        raise NotImplementedError(f"{type(self).__name__} is not a retrieval model")

    def dot_decomposition(self) -> DotRetrieval | None:
        """Non-None when ``score_all`` is a plain dot product against one item
        table."""
        return None

    # ---- helpers of pairwise-capable models ----

    @staticmethod
    def is_pairwise(batch) -> bool:
        return "pos" in batch

    @staticmethod
    def pair_item_ids(batch) -> torch.Tensor:
        """The item ids of a pairwise batch, [pos; negs...], B * (1+K) long:
        "neg" [B] for one negative a row, "negs" [B, K] (user-major) for K,
        only "pos" for in-batch negatives."""
        if "negs" in batch:
            return torch.cat([batch["pos"], batch["negs"].reshape(-1)])
        if "neg" in batch:
            return torch.cat([batch["pos"], batch["neg"]])
        return batch["pos"]
