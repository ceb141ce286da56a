"""Weights and shapes that every CTR family of the benchmark draws alike."""

from __future__ import annotations

import torch


def data_spec(cfg: dict):
    from tfrec_tpu_torch.models.base import DataSpec

    return DataSpec.ctr(cfg["num_embeddings_per_feature"], cfg["dense_in_features"])


def normal(g: torch.Generator, shape, std: float, device) -> torch.Tensor:
    return torch.randn(shape, generator=g, device=device).mul_(std)


def glorot_mlp(g: torch.Generator, in_dim: int, widths, device):
    """[(w [in, out] glorot-normal, b [out] N(0, 0.01))] a layer."""
    dims = [in_dim, *widths]
    return [(normal(g, (a, b), (2.0 / (a + b)) ** 0.5, device), normal(g, (b,), 0.01, device))
            for a, b in zip(dims[:-1], dims[1:])]
