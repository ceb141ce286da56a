"""Embedding-table primitives: specs, seeded init and the row gather.

The counterpart of ``tfrec_tpu/ops/embedding.py`` for serving. The
sentinel row id ``vocab`` (one past the end) marks bag padding; ``gather``
clamps it, and negative ids, to a real row as ``jnp.take(mode="clip")``
does, and callers mask those rows. The duplicate-id combine and the sparse
update come with the training slice.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import torch

from tfrec_tpu_torch.kernels.gather_cuda import gather_rows


@dataclasses.dataclass(frozen=True)
class TableSpec:
    """One logical embedding table."""

    name: str
    vocab: int
    dim: int
    # Initializer: "normal" (std = init_scale or 1/sqrt(dim)) | "zeros".
    initializer: str = "normal"
    init_scale: float | None = None

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.vocab, self.dim)


def init_table(
    generator: torch.Generator, spec: TableSpec, device: torch.device | str,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """One table drawn from ``generator``, which must live on ``device``."""
    if spec.initializer == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    scale = spec.init_scale if spec.init_scale is not None else 1.0 / (spec.dim**0.5)
    t = torch.randn(spec.shape, generator=generator, dtype=torch.float32, device=device)
    return t.mul_(scale).to(dtype)


def init_tables(
    generator: torch.Generator, specs: Sequence[TableSpec],
    device: torch.device | str, dtype: torch.dtype = torch.float32,
) -> Dict[str, torch.Tensor]:
    """Tables drawn one after another from one generator. The numbers differ
    from the JAX package's for the same seed; load JAX params through
    ``convert.params_from_jax`` where the two must agree."""
    return {s.name: init_table(generator, s, device, dtype) for s in specs}


def gather(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Row gather ``table[clip(ids, 0, V-1)]``: table [V, D] f32, ids [N]
    int32 -> [N, D]. Launches the CUDA kernel for CUDA tensors."""
    return gather_rows(table, ids)
