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
- ``forward(dense, gathered, batch)`` — logits [B] from gathered rows.
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Dict, Sequence, Tuple

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
