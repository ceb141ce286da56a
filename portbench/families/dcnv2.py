"""Low-rank DCN-v2 as the port builds it: ``models.build_model("dcnv2")``,
the parallel structure: the cross stack and the deep tower both over x0 =
[field embeddings ; raw dense features], then one linear head."""

from __future__ import annotations

import torch

from portbench import roofline
from portbench.families.common import data_spec, glorot_mlp, normal


def build(cfg: dict):
    from tfrec_tpu_torch.configs import ModelConfig
    from tfrec_tpu_torch.models import build_model

    mc = ModelConfig(name="dcnv2", embed_dim=cfg["embedding_dim"], num_cross_layers=cfg["dcn_num_layers"],
                     cross_rank=cfg["dcn_low_rank_dim"], mlp_dims=tuple(cfg["deep_mlp"]))
    model = build_model(mc, data_spec(cfg))
    if (model.input_dim, model.cross_rank, model.num_cross_layers, model.mlp_dims) != (
            input_dim(cfg), cfg["dcn_low_rank_dim"], cfg["dcn_num_layers"], tuple(cfg["deep_mlp"])):
        raise ValueError("build_model did not build the configured DCN-v2")
    return model


def input_dim(cfg: dict) -> int:
    return len(cfg["num_embeddings_per_feature"]) * cfg["embedding_dim"] + cfg["dense_in_features"]


def dense_init(cfg: dict, g: torch.Generator, device) -> dict:
    """The dense params in the port's tree: {"cross": {"b", "u", "v"}, "mlp",
    "w_out", "b_out"}; U and V N(0, 1/d0), as the port draws them."""
    d0, nl, r = input_dim(cfg), cfg["dcn_num_layers"], cfg["dcn_low_rank_dim"]
    cross = {"b": normal(g, (nl, d0), 0.01, device),
             "u": normal(g, (nl, d0, r), d0 ** -0.5, device),
             "v": normal(g, (nl, d0, r), d0 ** -0.5, device)}
    mlp = glorot_mlp(g, d0, cfg["deep_mlp"], device)
    head_in = d0 + cfg["deep_mlp"][-1]
    (w_out, b_out), = glorot_mlp(g, head_in, [1], device)
    return {"cross": cross, "mlp": mlp, "w_out": w_out, "b_out": b_out[0].clone()}


def cross_shape(cfg: dict):
    """(d0, rank, layers) of the low-rank cross stack."""
    return input_dim(cfg), cfg["dcn_low_rank_dim"], cfg["dcn_num_layers"]


def forward_flops(cfg: dict, rows: int) -> int:
    """The cross stack's products, the deep tower, the head."""
    d0, r, nl = cross_shape(cfg)
    return (roofline.cross_v2_flops(rows, d0, r, nl, train=False)
            + roofline.mlp_flops(rows, [d0, *cfg["deep_mlp"]])
            + 2 * rows * (d0 + cfg["deep_mlp"][-1]))
