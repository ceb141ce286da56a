"""Milestone configs ported so far: ``mf_bpr_ml100k`` (config 1) and
``dcn_criteo`` (config 4).

Copies of ``tfrec_tpu.zoo_configs``' constructors; a test holds each equal
to its original.
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


def mf_bpr_ml100k(path: str | None = None) -> Config:
    """Config 1: MF + BPR on MovieLens-100K, one user and one item table,
    dot-product scorer. With a ``path`` the data is MovieLens' files (not
    ported yet); without one, the seeded ``synthetic_implicit`` stand-in at
    ML-100K's shape (943 users, 1682 items, 64 interactions a user)."""
    return Config(
        run_name="mf_bpr_ml100k",
        data=DataConfig(
            source="movielens" if path else "synthetic_implicit",
            path=path,
            splitter="ratio",
            test_fraction=0.2,
            binarize_threshold=1.0 if path else 0.0,
            num_users=943, num_items=1682, interactions_per_user=64,
        ),
        # The reference tuned these on the stand-in: l2 0.03 is
        # load-bearing (without it MF overfits below the popularity
        # baseline, recall@20 0.116).
        model=ModelConfig(name="mf", embed_dim=64, l2_reg=0.03),
        optim=OptimConfig(
            learning_rate=0.1, dense_optimizer="adagrad",
            sparse_optimizer="rowwise_adagrad",
        ),
        train=TrainConfig(
            batch_size=2048, epochs=60, loss="bpr", eval_every_epochs=10,
            eval_topk=(10, 20, 50),
        ),
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
