"""The port's Trainer on interaction data (config 1's path) against the JAX
Trainer, on the CPU.

``tests/test_train.py``'s shape: ``synthetic_implicit`` with 128 users,
256 items and 16 interactions a user, MF at d=16, batch 256, 8 epochs, the
eval at epoch 8 with ks (20,). The port's ``Trainer(device="cpu")`` (the
kernels' plain versions) starts from the JAX trainer's initial state
(``convert.train_state_from_jax``); the history and the JSONL metric
stream must match under each sampler path (bpr with two steps a dispatch,
logloss with the AUC over sampled negatives, sampled softmax, in-batch
softmax, hinge over popularity negatives) and with early stopping on
recall@20. Device negatives (another RNG stream than JAX's) are held to
learning; the refusals name their ROADMAP items. The card runs config 1
itself in ``chip_smoke.py``.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

import tfrec_tpu.configs as jax_configs
from tfrec_tpu.train.trainer import Trainer as JaxTrainer
from tfrec_tpu_torch import configs, zoo_configs
from tfrec_tpu_torch.convert import train_state_from_jax
from tfrec_tpu_torch.data.samplers import PairwiseSampler, PointwiseSampler
from tfrec_tpu_torch.serve import Recommender
from tfrec_tpu_torch.train.trainer import Trainer, run

torch.set_num_threads(1)

# 8 epochs of 6-7 steps of two implementations of the same arithmetic (sums
# in another order, through the rowwise Adagrad's normalised updates), as
# tests/test_torch_trainer.py holds its trainers.
TRAIN_RTOL = 1e-4
# recall@20 and ndcg@20 over ~128 users: an exchanged rank would move them
# by ~1e-3, which this would catch; rounding moves them by ~1e-8.
METRIC_ATOL = 1e-6
AUC_ATOL = 1e-4


def _config(mod, loss="bpr", **train):
    kw = dict(batch_size=256, epochs=8, eval_every_epochs=8, eval_topk=(20,), loss=loss,
              log_every_steps=10)
    kw.update(train)
    return mod.Config(
        run_name=f"mf_{loss}",
        data=mod.DataConfig(source="synthetic_implicit", num_users=128, num_items=256,
                            interactions_per_user=16, seed=0),
        model=mod.ModelConfig(name="mf", embed_dim=16, l2_reg=0.03),
        optim=mod.OptimConfig(learning_rate=0.05, sparse_optimizer="rowwise_adagrad"),
        train=mod.TrainConfig(**kw),
        # The single-device path: tests/conftest.py gives JAX 8 virtual CPU
        # devices, where the default would take the mesh path.
        mesh=mod.MeshConfig(data_axis_size=0),
    )


def _records(path):
    out = []
    for line in path.read_text().splitlines():
        rec = json.loads(line)
        rec.pop("wall_s")
        out.append(rec)
    return out


def _same_stream(got, want):
    """Records equal key for key; losses within TRAIN_RTOL, the ranking
    metrics within METRIC_ATOL, AUC within AUC_ATOL; examples_per_s (a host
    clock) left out."""
    assert len(got) == len(want), (got, want)
    for g, w in zip(got, want):
        g, w = dict(g), dict(w)
        g.pop("examples_per_s", None)
        w.pop("examples_per_s", None)
        assert g.keys() == w.keys(), (g, w)
        for k in g:
            if k == "loss":
                np.testing.assert_allclose(g[k], w[k], rtol=TRAIN_RTOL, err_msg=k)
            elif "@" in k or k in ("best", "last"):
                np.testing.assert_allclose(g[k], w[k], rtol=0, atol=METRIC_ATOL, err_msg=k)
            elif k == "auc":
                np.testing.assert_allclose(g[k], w[k], rtol=0, atol=AUC_ATOL, err_msg=k)
            else:
                assert g[k] == w[k], (k, g, w)


def _pair(tmp_path, loss, **train):
    jt = JaxTrainer(_config(jax_configs, loss, checkpoint_dir=str(tmp_path / "jax"), **train), quiet=True)
    pt = Trainer(_config(configs, loss, checkpoint_dir=str(tmp_path / "port"), **train), quiet=True,
                 device="cpu")
    pt.state = train_state_from_jax(jax.tree_util.tree_map(np.asarray, jt.state), pt.model)
    return jt, pt


def _streams(tmp_path, name):
    out = []
    for where in ("port", "jax"):
        records = _records(tmp_path / where / f"{name}.metrics.jsonl")
        assert records[0]["config"]["train"]["checkpoint_dir"] == str(tmp_path / where)
        records[0]["config"]["train"]["checkpoint_dir"] = None  # the two runs' own directories
        out.append(records)
    return out


PATHS = {
    # name: (loss, train overrides)
    "bpr, 2 steps a dispatch": ("bpr", {"steps_per_dispatch": 2}),
    "logloss": ("logloss", {}),
    "sampled_softmax": ("sampled_softmax", {"num_negatives": 4}),
    "in_batch_softmax": ("in_batch_softmax", {}),
    "hinge, popularity negatives": ("hinge", {"neg_sampling": "popularity"}),
}


@pytest.mark.parametrize("case", sorted(PATHS))
def test_trainer_matches_jax(tmp_path, case):
    """Each sampler path: bpr (PairwiseSampler, two steps a dispatch),
    logloss (PointwiseSampler; its eval adds the AUC over sampled
    negatives), sampled softmax (4 negatives a row), in-batch softmax (no
    negatives) and hinge over popularity negatives: the history and the
    whole metric stream, from the JAX trainer's initial state."""
    loss, train = PATHS[case]
    jt, pt = _pair(tmp_path, loss, **train)
    sampler = pt.sampler
    assert type(sampler) is (PointwiseSampler if loss == "logloss" else PairwiseSampler)
    assert type(sampler).__name__ == type(jt.sampler).__name__
    for attr in ("multi_neg", "no_negatives", "num_negatives"):
        assert getattr(sampler, attr, None) == getattr(jt.sampler, attr, None), attr
    assert (sampler.neg_cdf is not None) == ("neg_sampling" in train)
    want, got = jt.train(), pt.train()
    jt.logger.close()
    pt.logger.close()
    assert pt.global_step == jt.global_step > 40
    assert [r["epoch"] for r in got] == list(range(8))
    keys = {f"{m}@20" for m in ("recall", "precision", "map", "ndcg", "mrr")}
    assert keys <= set(got[-1]) and ("auc" in got[-1]) == (loss == "logloss")
    _same_stream(got, want)
    if loss == "bpr":
        assert got[-1]["recall@20"] > 0.18  # tests/test_train.py's gate; random is ~0.078
    stream, jax_stream = _streams(tmp_path, f"mf_{loss}")
    _same_stream(stream, jax_stream)
    assert sum("step" in r for r in stream) >= 4


def test_trainer_early_stops_on_recall_like_jax(tmp_path):
    """Eval every 2 epochs; "auto" monitors recall@20 (the largest k of the
    recall family), and no gain of 1.0 stops the run after one stalled
    eval, at the same epoch as JAX's."""
    train = dict(eval_every_epochs=2, early_stop_patience=1, early_stop_min_delta=1.0,
                 eval_topk=(5, 20))
    jt, pt = _pair(tmp_path, "bpr", **train)
    want, got = jt.train(), pt.train()
    jt.logger.close()
    pt.logger.close()
    assert [r["epoch"] for r in got] == [0, 1, 2, 3]
    _same_stream(got, want)
    stream, jax_stream = _streams(tmp_path, "mf_bpr")
    _same_stream(stream, jax_stream)
    assert stream[-1]["event"] == "early_stopped" and stream[-1]["metric"] == "recall@20"
    assert pt._early_stop_monitor({"recall@5": 0.1, "recall@20": 0.2, "loss": 1.0}) == (
        jt._early_stop_monitor({"recall@5": 0.1, "recall@20": 0.2, "loss": 1.0}))


def test_trainer_draws_negatives_on_the_device_and_serves():
    """hinge with ``train.device_negatives``: the sampler gives (user, pos)
    rows and the step draws the negatives (its draws differ from JAX's, so
    the run is held to learning, not to JAX); then ``Recommender`` serves
    the trained model from the trainer."""
    pt = Trainer(_config(configs, "hinge", device_negatives=True), quiet=True, device="cpu")
    assert pt.sampler.no_negatives and pt.builder.device_negatives
    assert pt.builder.num_items == pt.dataset.num_items == 256
    batch = next(pt.sampler.epoch(0))
    assert set(batch) == {"user", "pos"}
    hist = pt.train()
    assert np.isfinite(hist[-1]["loss"]) and hist[-1]["recall@20"] > 0.15
    rec = Recommender.from_trainer(pt)
    ids, scores = rec.recommend(np.arange(8), 20)
    assert ids.shape == scores.shape == (8, 20) and (np.diff(scores, axis=1) <= 0).all()
    train = pt.dataset.train_csr
    for r in range(8):
        assert not set(ids[r].tolist()) & set(train.indices[train.indptr[r] : train.indptr[r + 1]].tolist())


def test_config1_stand_in_and_its_small_run():
    """``mf_bpr_ml100k()`` builds the stand-in at ML-100K's shape; two
    epochs of it at 160 users train and evaluate at ks (10, 20, 50)."""
    cfg = zoo_configs.mf_bpr_ml100k()
    small = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, num_users=160),
        train=dataclasses.replace(cfg.train, epochs=2, eval_every_epochs=2))
    trainer, hist = run(small, quiet=True, device="cpu")
    assert trainer.dataset.num_users == 160 and trainer.dataset.num_items == 1682
    assert len(trainer.dataset.train) + len(trainer.dataset.test) == 160 * 64
    assert {"recall@10", "recall@20", "ndcg@50"} <= set(hist[-1])
    assert all(np.isfinite(v) for v in hist[-1].values())


@pytest.mark.parametrize("overrides,error,match", [
    ({"model": {"name": "ease"}, "train": {"neg_sampling": "popularity"}}, ValueError,
     "no effect on closed-form"),
    ({"model": {"name": "sbpr"}}, ValueError, "SBPR needs a social graph"),
    ({"train": {"loss": "sbpr"}}, ValueError, "SBPR needs a social graph"),
    ({"data": {"social_degree": 4}, "model": {"name": "sbpr"}, "train": {"neg_sampling": "popularity"}},
     ValueError, "not the 'sbpr' data path"),
    ({"train": {"device_negatives": True, "neg_sampling": "popularity"}}, ValueError,
     "device_negatives"),
    ({"train": {"loss": "in_batch_softmax", "neg_sampling": "popularity"}}, ValueError, "in-batch"),
    ({"train": {"neg_sampling": "nope"}}, ValueError, "unknown train.neg_sampling"),
    ({"data": {"source": "synthetic_ctr"}}, ValueError, "needs interaction data"),
])
def test_trainer_refuses_what_is_not_ported_by_naming_its_item(overrides, error, match):
    """The refusals of the interaction path; where the reference refuses
    too (a ValueError), the port's message is the reference's."""
    cfg = _config(configs)
    for section, kw in overrides.items():
        cfg = cfg.replace(**{section: dataclasses.replace(getattr(cfg, section), **kw)})
    with pytest.raises(error, match=match) as ours:
        Trainer(cfg, quiet=True, device="cpu")
    if error is ValueError and "source" not in overrides.get("data", {}):
        jcfg = _config(jax_configs)
        for section, kw in overrides.items():
            jcfg = jcfg.replace(**{section: dataclasses.replace(getattr(jcfg, section), **kw)})
        with pytest.raises(ValueError) as ref:
            JaxTrainer(jcfg, quiet=True)
        assert str(ours.value) == str(ref.value)
