"""Model registry of the port: ``dcn`` and ``dcnv2`` so far."""

from __future__ import annotations

from tfrec_tpu_torch.configs import ModelConfig
from tfrec_tpu_torch.models.base import DataSpec, RecModel
from tfrec_tpu_torch.models.dcn import DCN

__all__ = ["DataSpec", "RecModel", "DCN", "build_model"]


def build_model(cfg: ModelConfig, data_spec: DataSpec) -> RecModel:
    """The model ``cfg`` names, over per-field tables.

    ``lane_pack=None`` (AUTO, the default) builds per-field tables here: the
    reference's packing answers the TPU's 128-lane rows and is decided again
    on the GPU. An explicit ``lane_pack=True`` or ``stack_tables=True`` is
    refused until those layouts are ported (ROADMAP Queue 1).
    """
    if cfg.stack_tables or cfg.lane_pack:
        which = "stack_tables" if cfg.stack_tables else "lane_pack"
        raise NotImplementedError(
            f"model.{which}=True: the port builds per-field tables only "
            "(ROADMAP Queue 1, lane-packed and stacked layouts); "
            "convert.params_from_jax reads JAX params of either layout"
        )
    name = cfg.name.lower()
    if name in ("dcn", "dcnv2"):
        if name == "dcn" and cfg.cross_rank > 0:
            raise ValueError(
                "model.cross_rank applies to DCN-v2's low-rank crosses; "
                "name='dcn' (v1, rank-one) would silently ignore it — use "
                "model.name='dcnv2'"
            )
        return DCN(
            data_spec,
            cfg.embed_dim,
            cfg.num_cross_layers,
            cfg.mlp_dims,
            v2=(name == "dcnv2"),
            cross_rank=cfg.cross_rank,
            dropout=cfg.dropout,
            field_dims=cfg.field_dims or None,
        )
    raise ValueError(
        f"unknown or not yet ported model {cfg.name!r}; tfrec_tpu_torch "
        "builds: dcn, dcnv2"
    )
