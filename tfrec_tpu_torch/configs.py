"""Typed configuration: a copy of ``tfrec_tpu.configs``' dataclasses.

The port keeps its own copy so that it imports nothing of the JAX package.
Field names, types and defaults are the reference's (a test holds them
equal), and so are the dotted-path overrides of ``with_overrides``.
Several knobs (lane packing, table stacking, mesh layout, ``kernels``) were
tuned for the TPU; the port reads them but decides each again on the GPU.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Sequence


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Where the examples come from and how they are split."""

    # "movielens" | "criteo" | "synthetic_implicit" | "synthetic_ctr".
    source: str = "synthetic_implicit"
    path: str | None = None
    # "ratio" | "leave_one_out" | "given" (train at `path`, test at `test_path`).
    splitter: str = "ratio"
    test_path: str | None = None
    test_fraction: float = 0.2
    min_interactions: int = 1
    # Implicit-feedback threshold: ratings >= this count as positives.
    binarize_threshold: float = 0.0
    seed: int = 0
    # Synthetic-generator knobs (ignored for on-disk sources).
    num_users: int = 512
    num_items: int = 1024
    interactions_per_user: int = 32
    latent_rank: int = 8
    # CTR-generator knobs.
    num_examples: int = 100_000
    num_dense_features: int = 13
    categorical_vocab_sizes: Sequence[int] = (1000, 1000, 500, 500, 100, 100)
    # Multi-hot bag width per field (empty = all single-hot); a width-W
    # field occupies W sentinel-padded columns of the cat matrix.
    categorical_field_widths: Sequence[int] = ()
    # Criteo: stream the TSV; the first eval_examples lines are held out.
    streaming: bool = False
    eval_examples: int = 100_000
    # Side features for interaction data used by CTR models.
    user_features_path: str | None = None
    item_features_path: str | None = None
    synthetic_side_features: bool = False
    # Social graph (SBPR family): an edge file, or synthesized friends.
    social_path: str | None = None
    social_degree: int = 0


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Which model and its hyperparameters."""

    name: str = "mf"
    embed_dim: int = 64
    # Per-field embedding dims for CTR models (empty = embed_dim for all).
    field_dims: Sequence[int] = ()
    # Dense-tower widths (MLP/NeuMF deep tower, DCN deep tower).
    mlp_dims: Sequence[int] = (256, 128, 64)
    # DCN: number of cross layers.
    num_cross_layers: int = 3
    # DCNv2: low-rank dimension for cross layers (0 = full rank).
    cross_rank: int = 0
    # NeuMF: separate GMF/MLP embedding dims.
    gmf_dim: int = 32
    mlp_embed_dim: int = 32
    dropout: float = 0.0
    l2_reg: float = 0.0
    # CTR: one [sum(V_f), D] table for all fields.
    stack_tables: bool = False
    # CTR: pack 128/d fields side by side in one table. None = AUTO: the
    # port builds per-field tables then, or a resumed checkpoint's layout.
    lane_pack: bool | None = None
    # History-conditioned models.
    max_history: int = 50
    fism_alpha: float = 0.5
    vae_hidden: int = 256
    vae_latent: int = 64
    vae_beta: float = 0.2
    nais_attention_dim: int = 16
    nais_beta: float = 0.5
    sasrec_blocks: int = 2
    sasrec_heads: int = 1
    lightgcn_layers: int = 3
    convncf_channels: int = 32
    apr_eps: float = 0.5
    apr_lambda: float = 1.0
    irgan_temperature: float = 1.0
    wrmf_alpha: float = 10.0
    wrmf_reg: float = 0.05
    ease_reg: float = 100.0
    gru_hidden: int = 0
    gru_layers: int = 1
    caser_h_filters: int = 16
    caser_heights: tuple[int, ...] = (2, 3, 4)
    caser_v_filters: int = 4


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    """Optimizer for dense params and the sparse rowwise path for tables."""

    dense_optimizer: str = "adam"  # adam | adagrad | sgd
    sparse_optimizer: str = "rowwise_adagrad"  # rowwise_adagrad | rowwise_adam | sgd
    learning_rate: float = 1e-2
    sparse_learning_rate: float | None = None  # default: learning_rate
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    eps: float = 1e-8
    adagrad_init: float = 0.0
    weight_decay: float = 0.0
    # "constant" | "cosine" | "linear", after warmup_steps of linear warmup.
    lr_schedule: str = "constant"
    warmup_steps: int = 0
    decay_steps: int = 0
    end_lr_factor: float = 0.1


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device mesh layout: data x table axes."""

    data_axis_size: int = -1  # -1: infer; 0: single-device path
    table_axis_size: int = 1
    table_sharding: str = "row"  # row | col | gspmd | replicated
    a2a_capacity_factor: float = 2.0
    a2a_dtype: str = "bfloat16"
    fused_tables: bool = False
    route_reuse: bool = True
    recv_combine: str = "sort"
    row_permute: bool = False
    dense_sharding: str = "replicated"


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training-loop shape."""

    batch_size: int = 1024  # global batch
    epochs: int = 10
    steps_per_epoch: int = -1  # -1: full pass
    steps_per_dispatch: int = 1
    host_dedup: bool = False
    eval_every_epochs: int = 1
    num_negatives: int = 1
    neg_sampling: str = "uniform"
    neg_sampling_beta: float = 0.75
    device_negatives: bool = False
    loss: str = "bpr"
    seed: int = 42
    eval_topk: Sequence[int] = (10, 20, 50)
    eval_user_batch: int = 256
    eval_protocol: str = "full"
    eval_num_candidates: int = 100
    eval_ctr_max_rows: int = 200_000
    log_every_steps: int = 100
    checkpoint_dir: str | None = None
    checkpoint_every_epochs: int = 0
    resume: bool = False
    early_stop_patience: int = 0
    early_stop_metric: str = "auto"
    early_stop_min_delta: float = 0.0
    init_from: str | None = None
    # The reference's kernel backend ("pallas" | "xla"). The port launches
    # its CUDA kernels for every CUDA tensor and reads this field nowhere.
    kernels: str = "xla"
    matmul_precision: str = "default"
    profile_steps: tuple[int, int] | None = None


@dataclasses.dataclass(frozen=True)
class Config:
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    optim: OptimConfig = dataclasses.field(default_factory=OptimConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    run_name: str = "run"

    def replace(self, **kw: Any) -> "Config":
        return dataclasses.replace(self, **kw)


def _apply_overrides_dc(dc: Any, dotted: str, value: Any) -> Any:
    parts = dotted.split(".", 1)
    if len(parts) == 1:
        field_types = {f.name: f.type for f in dataclasses.fields(dc)}
        if parts[0] not in field_types:
            raise KeyError(f"unknown config field {parts[0]!r} on {type(dc).__name__}")
        ftype = field_types[parts[0]]
        ftype_str = ftype if isinstance(ftype, str) else str(ftype)
        if isinstance(value, str) and "bool" in ftype_str:
            # "false" is truthy: a string on a bool (or bool | None) field is
            # always a caller's mistake. The CLI turns true/false into bools.
            raise ValueError(
                f"config field {parts[0]!r} on {type(dc).__name__} is {ftype_str}; got string "
                f"{value!r} (use true/false)")
        return dataclasses.replace(dc, **{parts[0]: value})
    child = getattr(dc, parts[0])
    return dataclasses.replace(dc, **{parts[0]: _apply_overrides_dc(child, parts[1], value)})


def with_overrides(cfg: Config, overrides: Mapping[str, Any]) -> Config:
    """``cfg`` with dotted-path overrides applied, e.g.
    ``{"train.batch_size": 512}``; a top-level name (``run_name``) replaces
    that field."""
    for key, value in overrides.items():
        parts = key.split(".")
        if len(parts) == 1:
            cfg = dataclasses.replace(cfg, **{parts[0]: value})
            continue
        section_name, field_name = parts[0], ".".join(parts[1:])
        section = getattr(cfg, section_name)
        cfg = dataclasses.replace(
            cfg, **{section_name: _apply_overrides_dc(section, field_name, value)})
    return cfg
