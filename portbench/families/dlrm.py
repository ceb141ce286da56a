"""DLRM as the port builds it: ``tfrec_tpu_torch.models.dlrm.DLRM`` with the
configuration's own bottom and top MLPs (``models.build_model`` fixes the
bottom MLP at (64,), so the class is built directly)."""

from __future__ import annotations

import torch

from portbench import roofline
from portbench.families.common import data_spec, glorot_mlp


def build(cfg: dict):
    from tfrec_tpu_torch.models.dlrm import DLRM

    bottom, top, d = cfg["bottom_mlp"], cfg["top_mlp"], cfg["embedding_dim"]
    if bottom[-1] != d or top[-1] != 1:
        raise ValueError("the bottom MLP ends at the embedding dim and the top MLP at one logit")
    return DLRM(data_spec(cfg), d, bottom_dims=tuple(bottom[:-1]), top_dims=tuple(top[:-1]))


def vectors(cfg: dict) -> int:
    """The interaction's vectors: the bottom MLP's output and one a field."""
    return len(cfg["num_embeddings_per_feature"]) + 1


def top_in(cfg: dict) -> int:
    nv = vectors(cfg)
    return nv * (nv - 1) // 2 + cfg["embedding_dim"]


def dense_init(cfg: dict, g: torch.Generator, device) -> dict:
    """The dense params in the port's tree: {"top", "bottom"}, each a list of
    (w [in, out], b [out])."""
    return {"top": glorot_mlp(g, top_in(cfg), cfg["top_mlp"], device),
            "bottom": glorot_mlp(g, cfg["dense_in_features"], cfg["bottom_mlp"], device)}


def forward_flops(cfg: dict, rows: int) -> int:
    """Bottom MLP, the [27, 128] x [128, 27] products of every example, the
    top MLP."""
    nv, d = vectors(cfg), cfg["embedding_dim"]
    return (roofline.mlp_flops(rows, [cfg["dense_in_features"], *cfg["bottom_mlp"]])
            + 2 * rows * nv * nv * d
            + roofline.mlp_flops(rows, [top_in(cfg), *cfg["top_mlp"]]))


def cross_shape(cfg: dict):
    """No cross stack."""
    return None
