"""Milestone configs ported so far: ``dcn_criteo`` (config 4).

A copy of ``tfrec_tpu.zoo_configs.dcn_criteo``; a test holds the two equal.
"""

from __future__ import annotations

from tfrec_tpu_torch.configs import (
    Config,
    DataConfig,
    MeshConfig,
    ModelConfig,
    OptimConfig,
    TrainConfig,
)


def dcn_criteo(path: str | None = None, max_examples: int = 2_000_000) -> Config:
    """Config 4: DCN (cross + deep) on a Criteo subset. With a ``path`` the
    data is Criteo's shape (26 fields of 100k rows, 13 dense features);
    without one, the seeded synthetic stand-in (8 fields of 10k rows)."""
    return Config(
        run_name="dcn_criteo",
        data=DataConfig(
            source="criteo" if path else "synthetic_ctr",
            path=path,
            num_examples=max_examples,
            num_dense_features=13,
            categorical_vocab_sizes=(100_000,) * 26 if path else (10_000,) * 8,
            test_fraction=0.05,
        ),
        model=ModelConfig(
            name="dcn", embed_dim=32, num_cross_layers=3, mlp_dims=(512, 256, 128)
        ),
        optim=OptimConfig(
            learning_rate=0.001, dense_optimizer="adam",
            sparse_optimizer="rowwise_adagrad",
            sparse_learning_rate=0.02,
        ),
        train=TrainConfig(batch_size=8192, epochs=2, loss="logloss",
                          eval_every_epochs=1, steps_per_dispatch=8),
        mesh=MeshConfig(table_sharding="row"),
    )
