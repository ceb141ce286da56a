"""MLPerf's DLRM-DCNv2 as the port builds it: ``models.dlrm.DLRM`` with the
DCN interaction (``interaction="dcn"``) and summed bags, the configuration's
own bottom MLP, cross and over-arch. ``build`` raises where the model built
is not the configured one."""

from __future__ import annotations

import torch

from portbench import roofline
from portbench.families.common import glorot_mlp, normal


def data_spec(cfg: dict):
    from tfrec_tpu_torch.models.base import DataSpec

    return DataSpec.ctr(cfg["num_embeddings_per_feature"], cfg["dense_in_features"],
                        cfg["multi_hot_sizes"])


def build(cfg: dict):
    from tfrec_tpu_torch.models.dlrm import DLRM

    bottom, over, d = cfg["bottom_mlp"], cfg["over_arch"], cfg["embedding_dim"]
    if bottom[-1] != d or over[-1] != 1:
        raise ValueError("the bottom MLP ends at the embedding dim and the over-arch at one logit")
    model = DLRM(data_spec(cfg), d, bottom_dims=tuple(bottom[:-1]), top_dims=tuple(over[:-1]),
                 interaction=cfg["interaction"], num_cross_layers=cfg["dcn_num_layers"],
                 cross_rank=cfg["dcn_low_rank_dim"], combiner=cfg["bag_combiner"])
    built = (model.interaction, model.input_dim, model.cross_rank, model.num_cross_layers,
             model.bottom_dims + (d,), model.top_dims + (1,), model.combiner, model.widths)
    want = ("dcn", input_dim(cfg), cfg["dcn_low_rank_dim"], cfg["dcn_num_layers"], tuple(bottom),
            tuple(over), cfg["bag_combiner"], tuple(cfg["multi_hot_sizes"]))
    if built != want:
        raise ValueError(f"the port built {built}, not the configured DLRM-DCNv2 {want}")
    return model


def input_dim(cfg: dict) -> int:
    """d0: the bottom MLP's output and one pooled embedding a field."""
    return (len(cfg["num_embeddings_per_feature"]) + 1) * cfg["embedding_dim"]


def dense_init(cfg: dict, g: torch.Generator, device) -> dict:
    """The dense params in the port's tree: {"top", "bottom"}, each a list of
    (w [in, out], b [out]), and {"cross": {"b", "u", "v"}}; U and V N(0,
    1/d0), as the port draws them."""
    d0, nl, r = input_dim(cfg), cfg["dcn_num_layers"], cfg["dcn_low_rank_dim"]
    top = glorot_mlp(g, d0, cfg["over_arch"], device)
    bottom = glorot_mlp(g, cfg["dense_in_features"], cfg["bottom_mlp"], device)
    cross = {"b": normal(g, (nl, d0), 0.01, device),
             "u": normal(g, (nl, d0, r), d0 ** -0.5, device),
             "v": normal(g, (nl, d0, r), d0 ** -0.5, device)}
    return {"top": top, "bottom": bottom, "cross": cross}


def cross_shape(cfg: dict):
    """(d0, rank, layers) of the low-rank cross stack."""
    return input_dim(cfg), cfg["dcn_low_rank_dim"], cfg["dcn_num_layers"]


def forward_flops(cfg: dict, rows: int) -> int:
    """The bottom MLP, the cross stack's products, the over-arch."""
    d0, r, nl = cross_shape(cfg)
    return (roofline.mlp_flops(rows, [cfg["dense_in_features"], *cfg["bottom_mlp"]])
            + roofline.cross_v2_flops(rows, d0, r, nl, train=False)
            + roofline.mlp_flops(rows, [d0, *cfg["over_arch"]]))
