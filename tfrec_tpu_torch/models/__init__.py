"""Model registry of the port, every model the reference builds: ``mf``,
``pop``, ``fm``, ``gmf``, ``mlp``, ``neumf``, ``convncf``, the CTR models
(``dcn``, ``dcnv2``, ``deepfm``, ``nfm``, ``widedeep``, ``dlrm``), the
sequential models (``sasrec``, ``gru4rec``, ``caser``, ``fpmc``), the history
models (``fism``, ``nais``, ``multvae``, ``multdae``, ``cdae``), the graph
models (``lightgcn``, ``ngcf``), the social and adversarial ones (``sbpr``,
``apr``, ``irgan``) and the closed-form ones (``wrmf``, ``ease``)."""

from __future__ import annotations

from tfrec_tpu_torch.configs import ModelConfig
from tfrec_tpu_torch.models.apr import APR
from tfrec_tpu_torch.models.base import DataSpec, RecModel
from tfrec_tpu_torch.models.caser import Caser
from tfrec_tpu_torch.models.cdae import CDAE
from tfrec_tpu_torch.models.convncf import ConvNCF
from tfrec_tpu_torch.models.ctr_base import CTRBase
from tfrec_tpu_torch.models.dcn import DCN
from tfrec_tpu_torch.models.deepfm import DeepFM
from tfrec_tpu_torch.models.dlrm import DLRM
from tfrec_tpu_torch.models.ease import EASE
from tfrec_tpu_torch.models.fism import FISM
from tfrec_tpu_torch.models.fm import FM
from tfrec_tpu_torch.models.fpmc import FPMC
from tfrec_tpu_torch.models.gru4rec import GRU4Rec
from tfrec_tpu_torch.models.irgan import IRGAN
from tfrec_tpu_torch.models.lightgcn import LightGCN
from tfrec_tpu_torch.models.mf import MF
from tfrec_tpu_torch.models.multvae import MultVAE
from tfrec_tpu_torch.models.nais import NAIS
from tfrec_tpu_torch.models.ncf import GMF, MLP, NeuMF
from tfrec_tpu_torch.models.nfm import NFM
from tfrec_tpu_torch.models.ngcf import NGCF
from tfrec_tpu_torch.models.pop import Pop
from tfrec_tpu_torch.models.sasrec import SASRec
from tfrec_tpu_torch.models.sbpr import SBPR
from tfrec_tpu_torch.models.widedeep import WideDeep
from tfrec_tpu_torch.models.wrmf import WRMF

__all__ = ["DataSpec", "RecModel", "APR", "Caser", "CDAE", "ConvNCF", "DCN", "DeepFM", "DLRM", "EASE", "FISM",
           "FM", "FPMC", "GMF", "GRU4Rec", "IRGAN", "LightGCN", "MF", "MLP", "MultVAE", "NAIS", "NeuMF", "NFM",
           "NGCF", "Pop", "SASRec", "SBPR", "WideDeep", "WRMF", "build_model"]
BUILT = ("mf, pop, fm, gmf, mlp, neumf, convncf, dcn, dcnv2, deepfm, nfm, widedeep, dlrm, sasrec, gru4rec, "
         "caser, fpmc, fism, nais, multvae, multdae, cdae, lightgcn, ngcf, sbpr, apr, irgan, wrmf, ease")

# The reference's models that the port does not build yet, by the ROADMAP
# Queue 1 item that ports them: none.
NOT_PORTED: dict = {}


def build_model(cfg: ModelConfig, data_spec: DataSpec) -> RecModel:
    """The model ``cfg`` names, in the table layout it asks for.

    ``lane_pack=True`` and ``stack_tables=True`` build a CTR model's
    lane-packed or stacked tables (``models/ctr_base.py``), with the
    reference's checks. ``lane_pack=None`` (AUTO, the default) builds
    per-field tables here: the reference packs under AUTO for the TPU's
    128-lane rows (its ``lane_pack_applies``, not ported), while on the card
    a pack makes every gathered row 128 floats wide where a field needs d
    (PERF.md, the three layouts measured on the H100).
    """
    model = _build(cfg, data_spec)
    if cfg.stack_tables or cfg.lane_pack:
        which = "stack_tables" if cfg.stack_tables else "lane_pack"
        if not isinstance(model, CTRBase):
            raise ValueError(f"model.{which} applies to CTR models, not {cfg.name!r}")
        if cfg.stack_tables and cfg.lane_pack:
            raise ValueError("stack_tables and lane_pack are mutually exclusive")
        return model.enable_stacked_tables() if cfg.stack_tables else model.enable_lane_packing()
    return model


def _build(cfg: ModelConfig, data_spec: DataSpec) -> RecModel:
    name = cfg.name.lower()
    if name == "mf":
        return MF(data_spec, cfg.embed_dim)
    if name == "pop":
        return Pop(data_spec)
    if name == "sbpr":
        return SBPR(data_spec, cfg.embed_dim)
    if name == "apr":
        return APR(data_spec, cfg.embed_dim, eps=cfg.apr_eps, adv_lambda=cfg.apr_lambda)
    if name == "irgan":
        return IRGAN(data_spec, cfg.embed_dim, temperature=cfg.irgan_temperature)
    if name == "wrmf":
        return WRMF(data_spec, cfg.embed_dim, alpha=cfg.wrmf_alpha, reg=cfg.wrmf_reg)
    if name == "ease":
        return EASE(data_spec, reg=cfg.ease_reg)
    if name == "convncf":
        return ConvNCF(data_spec, cfg.embed_dim, channels=cfg.convncf_channels, dropout=cfg.dropout)
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
    if name == "fm":
        return FM(data_spec, cfg.embed_dim, field_dims=cfg.field_dims or None)
    if name == "gmf":
        return GMF(data_spec, cfg.gmf_dim or cfg.embed_dim)
    if name == "mlp":
        return MLP(data_spec, cfg.mlp_embed_dim or cfg.embed_dim, cfg.mlp_dims, dropout=cfg.dropout)
    if name == "neumf":
        return NeuMF(data_spec, cfg.gmf_dim, cfg.mlp_embed_dim, cfg.mlp_dims, dropout=cfg.dropout)
    if name == "deepfm":
        return DeepFM(data_spec, cfg.embed_dim, cfg.mlp_dims, dropout=cfg.dropout)
    if name == "nfm":
        return NFM(data_spec, cfg.embed_dim, cfg.mlp_dims, dropout=cfg.dropout)
    if name == "widedeep":
        return WideDeep(data_spec, cfg.embed_dim, cfg.mlp_dims, dropout=cfg.dropout,
                        field_dims=cfg.field_dims or None)
    if name == "dlrm":
        return DLRM(data_spec, cfg.embed_dim, top_dims=cfg.mlp_dims, dropout=cfg.dropout)
    if name == "fpmc":
        return FPMC(data_spec, cfg.embed_dim, max_history=cfg.max_history)
    if name == "sasrec":
        return SASRec(data_spec, cfg.embed_dim, num_blocks=cfg.sasrec_blocks, num_heads=cfg.sasrec_heads,
                      dropout=cfg.dropout, max_history=cfg.max_history)
    if name == "gru4rec":
        return GRU4Rec(data_spec, cfg.embed_dim, hidden_dim=cfg.gru_hidden, num_layers=cfg.gru_layers,
                       dropout=cfg.dropout, max_history=cfg.max_history)
    if name == "caser":
        return Caser(data_spec, cfg.embed_dim, h_filters=cfg.caser_h_filters, heights=cfg.caser_heights,
                     v_filters=cfg.caser_v_filters, dropout=cfg.dropout, max_history=cfg.max_history)
    if name == "fism":
        return FISM(data_spec, cfg.embed_dim, alpha=cfg.fism_alpha, max_history=cfg.max_history)
    if name == "nais":
        return NAIS(data_spec, cfg.embed_dim, attention_dim=cfg.nais_attention_dim, beta=cfg.nais_beta,
                    max_history=cfg.max_history)
    if name in ("multvae", "multdae"):
        return MultVAE(data_spec, hidden_dim=cfg.vae_hidden, latent_dim=cfg.vae_latent, beta=cfg.vae_beta,
                       dropout=cfg.dropout, max_history=cfg.max_history, variational=(name == "multvae"))
    if name == "cdae":
        return CDAE(data_spec, hidden_dim=cfg.vae_hidden, dropout=cfg.dropout, max_history=cfg.max_history)
    if name == "lightgcn":
        return LightGCN(data_spec, cfg.embed_dim, num_layers=cfg.lightgcn_layers)
    if name == "ngcf":
        return NGCF(data_spec, cfg.embed_dim, num_layers=cfg.lightgcn_layers, dropout=cfg.dropout)
    raise ValueError(f"unknown model {cfg.name!r}; tfrec_tpu_torch builds: {BUILT}")
