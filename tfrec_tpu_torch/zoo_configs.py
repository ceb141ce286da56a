"""Every zoo config of the reference: ``mf_bpr_ml100k`` (config 1),
``fm_ctr_ml1m`` (config 2), ``neumf_ml20m`` (config 3), ``dcn_criteo``
(config 4) and ``dcn_multihost`` (config 5, row-sharded tables on N
ranks), the sequential zoo: ``sasrec_ml1m``, ``gru4rec_ml1m`` and
``caser_ml1m``, the history zoo: ``fism_ml100k``, ``nais_ml100k``,
``multvae_ml100k`` and ``cdae_ml100k``, the social and adversarial zoo:
``sbpr_ml100k``, ``apr_ml100k`` and ``irgan_ml100k``, and the closed-form
zoo: ``wrmf_ml100k`` and ``ease_ml100k``.

Copies of ``tfrec_tpu.zoo_configs``' constructors; a test holds each equal
to its original.
"""

from __future__ import annotations

import dataclasses

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


def fm_ctr_ml1m(path: str | None = None) -> Config:
    """Config 2: FM pointwise CTR on MovieLens-1M over multi-field
    categoricals (user, item, and gender, age, occupation and genre side
    fields). With a ``path`` the data is MovieLens' files and
    ``data.user_features_path`` / ``item_features_path`` name users.dat and
    movies.dat; without one, the seeded
    ``synthetic_implicit`` stand-in at ML-1M's shape (6040 users, 3706
    items, 64 interactions a user) with synthetic side fields."""
    return Config(
        run_name="fm_ctr_ml1m",
        data=DataConfig(
            source="movielens" if path else "synthetic_implicit",
            path=path,
            splitter="ratio",
            test_fraction=0.2,
            num_users=6040, num_items=3706, interactions_per_user=64,
            synthetic_side_features=path is None,
        ),
        model=ModelConfig(name="fm", embed_dim=64),
        optim=OptimConfig(
            learning_rate=0.02, dense_optimizer="adagrad",
            sparse_optimizer="rowwise_adagrad",
        ),
        train=TrainConfig(
            batch_size=4096, epochs=20, loss="logloss", num_negatives=4,
            eval_every_epochs=5, eval_topk=(10, 20),
        ),
    )


def neumf_ml20m(path: str | None = None) -> Config:
    """Config 3: NeuMF (GMF + MLP towers over separate embeddings) with
    sampled negatives, evaluated by the NCF protocol: each held-out item
    ranked against 100 sampled negatives. Without a ``path``, the seeded
    ``synthetic_implicit`` stand-in (8192 users, 4096 items, 32
    interactions a user, one held out each)."""
    return Config(
        run_name="neumf_ml20m",
        data=DataConfig(
            source="movielens" if path else "synthetic_implicit",
            path=path,
            splitter="leave_one_out",
            num_users=8192, num_items=4096, interactions_per_user=32,
        ),
        model=ModelConfig(
            name="neumf", gmf_dim=32, mlp_embed_dim=32, mlp_dims=(64, 32, 16)
        ),
        optim=OptimConfig(
            learning_rate=0.001, dense_optimizer="adam",
            sparse_optimizer="rowwise_adam",
        ),
        train=TrainConfig(
            batch_size=8192, epochs=20, loss="logloss", num_negatives=4,
            eval_every_epochs=5, eval_topk=(10, 20),
            eval_protocol="sampled", eval_num_candidates=100,
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


def dcn_multihost(path: str | None = None) -> Config:
    """Config 5: config 4's DCN with row-sharded tables exchanged all to all
    on N ranks (``mesh.table_sharding="row"``, the bf16 wire, capacity
    factor 2, route reuse; per-field tables). On one rank it is config 4 on
    one device, as in the reference."""
    cfg = dcn_criteo(path)
    return cfg.replace(
        run_name="dcn_multihost",
        mesh=MeshConfig(table_sharding="row", a2a_capacity_factor=2.0),
    )


def _sequential_ml1m(run_name: str, path: str | None, model: ModelConfig) -> Config:
    """The sequential zoo's protocol at ML-1M's shape: leave one out,
    time-ordered sequences, per-position BCE, Adam and rowwise Adam, batch
    128, 60 epochs, the full-catalog eval every 20 at ks (10, 20). Without
    a ``path``, the seeded ``synthetic_implicit`` stand-in (6040 users,
    3706 items, 96 interactions a user)."""
    return Config(
        run_name=run_name,
        data=DataConfig(
            source="movielens" if path else "synthetic_implicit",
            path=path,
            splitter="leave_one_out",
            binarize_threshold=1.0 if path else 0.0,
            num_users=6040, num_items=3706, interactions_per_user=96,
        ),
        model=model,
        optim=OptimConfig(learning_rate=0.001, dense_optimizer="adam",
                          sparse_optimizer="rowwise_adam"),
        train=TrainConfig(batch_size=128, epochs=60, loss="sasrec", eval_every_epochs=20,
                          eval_topk=(10, 20)),
    )


def sasrec_ml1m(path: str | None = None) -> Config:
    """SASRec next-item prediction on ML-1M's shape (the paper's protocol):
    2 blocks, 1 head, d=64, 200 positions, dropout 0.2."""
    return _sequential_ml1m("sasrec_ml1m", path, ModelConfig(
        name="sasrec", embed_dim=64, max_history=200, sasrec_blocks=2, sasrec_heads=1, dropout=0.2))


def gru4rec_ml1m(path: str | None = None) -> Config:
    """GRU4Rec on sasrec_ml1m's protocol and shape: one GRU layer of 128
    over d=64, 200 positions, dropout 0.1."""
    return _sequential_ml1m("gru4rec_ml1m", path, ModelConfig(
        name="gru4rec", embed_dim=64, max_history=200, gru_hidden=128, gru_layers=1, dropout=0.1))


def caser_ml1m(path: str | None = None) -> Config:
    """Caser (causal convolution windows and the user embedding) on
    sasrec_ml1m's protocol and shape, over 64 positions: 16 horizontal
    filters of heights 2, 3 and 4, 4 vertical ones, dropout 0.3."""
    return _sequential_ml1m("caser_ml1m", path, ModelConfig(
        name="caser", embed_dim=64, max_history=64, caser_h_filters=16, caser_heights=(2, 3, 4),
        caser_v_filters=4, dropout=0.3))


def fism_ml100k(path: str | None = None) -> Config:
    """FISM item-based retrieval on ML-100K's protocol and shape (pairwise
    BPR over history-conditioned scores, 64 history items a user)."""
    return Config(
        run_name="fism_ml100k",
        data=DataConfig(
            source="movielens" if path else "synthetic_implicit",
            path=path,
            splitter="ratio",
            test_fraction=0.2,
            binarize_threshold=1.0 if path else 0.0,
            num_users=943, num_items=1682, interactions_per_user=64,
        ),
        model=ModelConfig(name="fism", embed_dim=64, l2_reg=0.01, max_history=64, fism_alpha=0.5),
        optim=OptimConfig(learning_rate=0.05, dense_optimizer="adagrad", sparse_optimizer="rowwise_adagrad"),
        train=TrainConfig(batch_size=1024, epochs=40, loss="bpr", eval_every_epochs=10,
                          eval_topk=(10, 20, 50)),
    )


def multvae_ml100k(path: str | None = None) -> Config:
    """Mult-VAE^PR on ML-100K's protocol and shape (a batch of users' whole
    histories, up to 128 items, under the ELBO)."""
    return Config(
        run_name="multvae_ml100k",
        data=DataConfig(
            source="movielens" if path else "synthetic_implicit",
            path=path,
            splitter="ratio",
            test_fraction=0.2,
            binarize_threshold=1.0 if path else 0.0,
            num_users=943, num_items=1682, interactions_per_user=64,
        ),
        model=ModelConfig(name="multvae", vae_hidden=256, vae_latent=64, vae_beta=0.2, dropout=0.5,
                          max_history=128),
        optim=OptimConfig(learning_rate=0.001, dense_optimizer="adam"),
        train=TrainConfig(batch_size=128, epochs=80, loss="multvae", eval_every_epochs=20,
                          eval_topk=(10, 20, 50)),
    )


def nais_ml100k(path: str | None = None) -> Config:
    """NAIS on fism_ml100k's protocol and shape (FISM with a target-aware
    attention pool over the history)."""
    return fism_ml100k(path).replace(
        run_name="nais_ml100k",
        model=ModelConfig(name="nais", embed_dim=64, l2_reg=0.01, max_history=64, nais_attention_dim=16,
                          nais_beta=0.5),
        optim=OptimConfig(learning_rate=0.02, dense_optimizer="adagrad", sparse_optimizer="rowwise_adagrad"),
    )


def cdae_ml100k(path: str | None = None) -> Config:
    """CDAE on multvae_ml100k's protocol and shape (the full-catalog BCE)."""
    cfg = multvae_ml100k(path)
    return cfg.replace(
        run_name="cdae_ml100k",
        model=ModelConfig(name="cdae", vae_hidden=256, dropout=0.2, max_history=128),
        train=dataclasses.replace(cfg.train, loss="cdae"),
    )


def sbpr_ml100k(path: str | None = None) -> Config:
    """SBPR on the ML-100K shape. MovieLens has no trust file, so the graph
    is ``data.social_path``'s ("u v" lines of dense user ids) where one is
    given, else the taste-overlap synthesis (``social_degree`` friends a
    user)."""
    return Config(
        run_name="sbpr_ml100k",
        data=DataConfig(
            source="movielens" if path else "synthetic_implicit",
            path=path,
            splitter="ratio", test_fraction=0.2,
            binarize_threshold=1.0 if path else 0.0,
            num_users=943, num_items=1682, interactions_per_user=64,
            social_degree=10,
        ),
        model=ModelConfig(name="sbpr", embed_dim=64),
        optim=OptimConfig(learning_rate=0.05, sparse_optimizer="rowwise_adagrad"),
        train=TrainConfig(batch_size=1024, epochs=40, loss="sbpr", eval_every_epochs=10,
                          eval_topk=(10, 20, 50)),
    )


def apr_ml100k(path: str | None = None) -> Config:
    """APR on the ML-100K shape, the minimax objective from scratch (the
    paper pretrains BPR-MF: warm start from an mf_bpr_ml100k checkpoint
    with ``train.init_from`` for the two-phase recipe)."""
    return Config(
        run_name="apr_ml100k",
        data=DataConfig(
            source="movielens" if path else "synthetic_implicit",
            path=path,
            splitter="ratio", test_fraction=0.2,
            binarize_threshold=1.0 if path else 0.0,
            num_users=943, num_items=1682, interactions_per_user=64,
        ),
        model=ModelConfig(name="apr", embed_dim=64, apr_eps=0.5, apr_lambda=1.0),
        optim=OptimConfig(learning_rate=0.05, sparse_optimizer="rowwise_adagrad"),
        train=TrainConfig(batch_size=1024, epochs=40, loss="apr", eval_every_epochs=10,
                          eval_topk=(10, 20, 50)),
    )


def irgan_ml100k(path: str | None = None) -> Config:
    """IRGAN on the ML-100K shape: the generator picks from a pool of 16
    uniform items a positive (``train.num_negatives``); the eval scores with
    the generator."""
    return Config(
        run_name="irgan_ml100k",
        data=DataConfig(
            source="movielens" if path else "synthetic_implicit",
            path=path,
            splitter="ratio", test_fraction=0.2,
            binarize_threshold=1.0 if path else 0.0,
            num_users=943, num_items=1682, interactions_per_user=64,
        ),
        model=ModelConfig(name="irgan", embed_dim=64, irgan_temperature=0.5),
        optim=OptimConfig(learning_rate=0.05, sparse_optimizer="rowwise_adagrad"),
        train=TrainConfig(batch_size=1024, epochs=40, loss="irgan", num_negatives=16,
                          eval_every_epochs=10, eval_topk=(10, 20, 50)),
    )


def wrmf_ml100k(path: str | None = None) -> Config:
    """WRMF (implicit ALS) on the ML-100K shape: an epoch is one full sweep
    (15 suffice); the logged loss is the exact weighted objective, which
    falls at every sweep."""
    return Config(
        run_name="wrmf_ml100k",
        data=DataConfig(
            source="movielens" if path else "synthetic_implicit",
            path=path,
            splitter="ratio", test_fraction=0.2,
            binarize_threshold=1.0 if path else 0.0,
            num_users=943, num_items=1682, interactions_per_user=64,
        ),
        model=ModelConfig(name="wrmf", embed_dim=64, wrmf_alpha=10.0, wrmf_reg=0.05),
        train=TrainConfig(batch_size=1024, epochs=15, loss="wrmf", eval_every_epochs=5,
                          eval_topk=(10, 20, 50)),
    )


def ease_ml100k(path: str | None = None) -> Config:
    """EASE on the ML-100K shape: one epoch is the whole run, a single
    [V, V] ridge solve."""
    return Config(
        run_name="ease_ml100k",
        data=DataConfig(
            source="movielens" if path else "synthetic_implicit",
            path=path,
            splitter="ratio", test_fraction=0.2,
            binarize_threshold=1.0 if path else 0.0,
            num_users=943, num_items=1682, interactions_per_user=64,
        ),
        model=ModelConfig(name="ease", ease_reg=100.0),
        train=TrainConfig(batch_size=1024, epochs=1, loss="ease", eval_every_epochs=1,
                          eval_topk=(10, 20, 50)),
    )


# The zoo configs the port builds, by name (the CLI's --config).
ZOO = {
    "mf_bpr_ml100k": mf_bpr_ml100k,
    "fm_ctr_ml1m": fm_ctr_ml1m,
    "neumf_ml20m": neumf_ml20m,
    "dcn_criteo": dcn_criteo,
    "dcn_multihost": dcn_multihost,
    "sasrec_ml1m": sasrec_ml1m,
    "gru4rec_ml1m": gru4rec_ml1m,
    "caser_ml1m": caser_ml1m,
    "fism_ml100k": fism_ml100k,
    "nais_ml100k": nais_ml100k,
    "multvae_ml100k": multvae_ml100k,
    "cdae_ml100k": cdae_ml100k,
    "sbpr_ml100k": sbpr_ml100k,
    "apr_ml100k": apr_ml100k,
    "irgan_ml100k": irgan_ml100k,
    "wrmf_ml100k": wrmf_ml100k,
    "ease_ml100k": ease_ml100k,
}
# The reference's zoo configs the port does not build yet, by the ROADMAP
# Queue 1 item that ports them: none.
NOT_PORTED: dict = {}
