"""The port's trainer on data files against the JAX trainer, on the CPU.

Files written from a numpy seed go through the JAX ``Trainer`` and the
port's ``Trainer(device="cpu")`` from the JAX trainer's initial state
(``convert.train_state_from_jax``): a Criteo TSV, materialized
(``load_criteo``, 1 or 26 vocab sizes) and streamed past its eval slice
(``CriteoStreamBatcher``), with DCN; MovieLens-1M's ``ratings.dat``,
``users.dat`` and ``movies.dat`` with FM over the side fields. The
histories must match with tests/test_torch_trainer.py's tolerances.

The JAX package reads the files with its Python parsers here (its native
libraries are not built, so no test races the JAX tests on ``build/``);
the port materializes Criteo with its Python parser too, as the reference
does, and streams the train batches through its native parser, whose
dense values may lie 1 ulp from the Python parser's
(tests/test_torch_loaders.py).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import tfrec_tpu.configs as jax_configs
import tfrec_tpu.data.criteo_native as jax_criteo_native
import tfrec_tpu.data.uirt_native as jax_uirt_native
from tfrec_tpu.train.trainer import Trainer as JaxTrainer
from tfrec_tpu_torch import configs
from tfrec_tpu_torch.convert import train_state_from_jax
from tfrec_tpu_torch.train.trainer import Trainer, _criteo_vocabs
from test_torch_loaders import write_criteo

torch.set_num_threads(1)

# As tests/test_torch_trainer.py: a few epochs of two implementations of the
# same arithmetic; AUC over the held-out rows.
TRAIN_RTOL = 1e-4
TRAIN_AUC_ATOL = 1e-4


@pytest.fixture(autouse=True)
def jax_python_parsers(monkeypatch):
    def unavailable(*_args, **_kw):
        raise jax_uirt_native.NativeUnavailable("not built in this test")

    monkeypatch.setattr(jax_criteo_native, "load", unavailable)
    monkeypatch.setattr(jax_uirt_native, "parse_buffer", unavailable)


def _same_history(got, want):
    assert len(got) == len(want), (got, want)
    for g, w in zip(got, want):
        g, w = dict(g), dict(w)
        g.pop("examples_per_s")
        w.pop("examples_per_s")
        assert g.keys() == w.keys(), (g, w)
        for k in g:
            if k in ("loss", "logloss"):
                np.testing.assert_allclose(g[k], w[k], rtol=TRAIN_RTOL, err_msg=k)
            elif k == "auc":
                np.testing.assert_allclose(g[k], w[k], rtol=0, atol=TRAIN_AUC_ATOL, err_msg=k)
            else:
                assert g[k] == w[k], (k, g, w)


def _trainers(cfg_of):
    jt = JaxTrainer(cfg_of(jax_configs), quiet=True)
    pt = Trainer(cfg_of(configs), quiet=True, device="cpu")
    pt.state = train_state_from_jax(jax.tree_util.tree_map(np.asarray, jt.state), pt.model)
    return jt, pt


@pytest.mark.parametrize("streaming,vocabs", [(False, (40,)), (False, tuple(range(30, 56))),
                                              (True, (40,))])
def test_criteo_trainer_matches_jax(tmp_path, streaming, vocabs):
    path = write_criteo(tmp_path / "criteo.tsv", 1500, malformed_every=89)

    def cfg(mod):
        return mod.Config(
            run_name="criteo",
            data=mod.DataConfig(source="criteo", path=path, streaming=streaming,
                                eval_examples=300, num_examples=1400,
                                categorical_vocab_sizes=vocabs, test_fraction=0.2),
            model=mod.ModelConfig(name="dcn", embed_dim=4, num_cross_layers=2, mlp_dims=(16,),
                                  lane_pack=False),
            optim=mod.OptimConfig(learning_rate=0.01, sparse_learning_rate=0.05),
            train=mod.TrainConfig(batch_size=128, epochs=2, loss="logloss", eval_every_epochs=1,
                                  steps_per_dispatch=2, log_every_steps=0),
            mesh=mod.MeshConfig(data_axis_size=0))

    jt, pt = _trainers(cfg)
    assert pt.data_spec.field_vocabs == _criteo_vocabs(vocabs)
    assert pt.data_spec.num_dense == 13
    assert len(pt.ctr_arrays["test"][2]) == len(jt.ctr_arrays["test"][2])
    got, want = pt.train(), jt.train()
    _same_history(got, want)
    assert (pt.stream is not None) == streaming and pt.global_step == jt.global_step > 0
    if streaming:
        assert pt.sampler is pt.stream and pt.stream.parser == "native"
        assert len(pt.ctr_arrays["test"][2]) == 300


def test_criteo_vocab_sizes_must_be_1_or_26(tmp_path):
    path = write_criteo(tmp_path / "criteo.tsv", 50)
    cfg = configs.Config(data=configs.DataConfig(source="criteo", path=path,
                                                 categorical_vocab_sizes=(10, 20)),
                         model=configs.ModelConfig(name="dcn"))
    with pytest.raises(ValueError, match="1 or 26"):
        Trainer(cfg, quiet=True, device="cpu")


def _write_ml1m(d, seed=0, users=60, items=90, n=2400):
    """ML-1M's three files in its ``::`` format; ids 1-based, a few users and
    movies missing from the side files."""
    rng = np.random.default_rng(seed)
    ratings = d / "ratings.dat"
    ratings.write_text("".join(f"{u}::{i}::{r}::{t}\n" for u, i, r, t in zip(
        rng.integers(1, users + 1, n), rng.integers(1, items + 1, n), rng.integers(1, 6, n),
        rng.integers(9 * 10**8, 10**9, n))), encoding="latin-1")
    (d / "users.dat").write_text("".join(
        f"{u}::{'MF'[u % 2]}::{[1, 18, 25, 35, 45, 50, 56][u % 7]}::{u % 21}::{10000 + u}\n"
        for u in range(1, users - 2)), encoding="latin-1")
    genres = ["Action", "Comedy", "Drama", "Horror"]
    (d / "movies.dat").write_text("".join(
        f"{m}::Movie {m} (2000)::{genres[m % 4]}|{genres[(m + 1) % 4]}\n"
        for m in range(1, items - 3)), encoding="latin-1")
    return str(ratings), str(d / "users.dat"), str(d / "movies.dat")


def test_fm_over_ml1m_files_matches_jax(tmp_path):
    ratings, users, movies = _write_ml1m(tmp_path)

    def cfg(mod):
        return mod.Config(
            run_name="fm_files",
            data=mod.DataConfig(source="movielens", path=ratings, splitter="ratio",
                                user_features_path=users, item_features_path=movies),
            model=mod.ModelConfig(name="fm", embed_dim=8, lane_pack=False),
            optim=mod.OptimConfig(learning_rate=0.05, dense_optimizer="adagrad"),
            train=mod.TrainConfig(batch_size=256, epochs=2, loss="logloss", num_negatives=2,
                                  eval_every_epochs=2, eval_topk=(10,), log_every_steps=0),
            mesh=mod.MeshConfig(data_axis_size=0))

    jt, pt = _trainers(cfg)
    np.testing.assert_array_equal(pt.user_side, jt.user_side)
    np.testing.assert_array_equal(pt.item_side, jt.item_side)
    assert pt.data_spec.field_vocabs == tuple(jt.data_spec.field_vocabs)
    assert len(pt.data_spec.field_vocabs) == 6  # user, item, gender, age, occupation, genre
    _same_history(pt.train(), jt.train())


def test_side_feature_files_alone_and_before_synthetic_fields(tmp_path):
    ratings, users, _ = _write_ml1m(tmp_path)
    data = configs.DataConfig(source="movielens", path=ratings, user_features_path=users,
                              synthetic_side_features=True)
    cfg = configs.Config(data=data, model=configs.ModelConfig(name="fm", embed_dim=4),
                         train=configs.TrainConfig(loss="logloss"))
    pt = Trainer(cfg, quiet=True, device="cpu")
    assert pt.item_side is None and pt.user_side.shape[1] == 3  # the file wins
    jt = JaxTrainer(jax_configs.Config(
        data=jax_configs.DataConfig(**dataclasses.asdict(data)),
        model=jax_configs.ModelConfig(name="fm", embed_dim=4, lane_pack=False),
        train=jax_configs.TrainConfig(loss="logloss"),
        mesh=jax_configs.MeshConfig(data_axis_size=0)), quiet=True)
    np.testing.assert_array_equal(pt.user_side, jt.user_side)
