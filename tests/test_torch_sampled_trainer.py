"""The port's sampled-candidate eval, the trainer's CTR-over-interaction
path and the serving of configs 2 and 3 against the JAX package, on the
CPU.

- ``build_candidates``, array for array, and ``SampledEvaluator``'s
  metrics at fixed params (padding of the last batch included);
- the port's ``Trainer(device="cpu")`` against the JAX ``Trainer`` from
  its initial state (``convert.train_state_from_jax``), on
  ``synthetic_implicit`` at 128 users x 256 items, 16 interactions a user:
  FM with synthetic side fields (multi-field batches, two steps a
  dispatch; its eval AUC only, as the reference's), FM in the 2-field form
  (full-catalog metrics and AUC; bpr coerced to logloss), NeuMF under
  rowwise Adam with the sampled eval, and GMF under bpr with the sampled
  eval. The history and the JSONL stream must match with
  tests/test_torch_retrieval_trainer.py's tolerances. JAX's FM sets
  ``model.lane_pack=False`` here, as the port's does (its default packs
  config 2's tables; tests/test_torch_layouts.py holds the packed layout);
- ``Recommender.predict`` / ``score_catalog`` / ``recommend`` of NeuMF and
  GMF, and ``predict_ctr`` of FM with side fields, against the JAX
  ``Recommender`` at the same params; JAX's default (lane-packed) FM
  params and state carried into the port's packed FM, its params served
  per field and packed, and its eval at those params;
- configs 2 and 3 at a small size: the refusals of ROADMAP Queue 1 item 9
  are gone; those still owed name their items.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tfrec_tpu.configs as jax_configs
from tfrec_tpu.eval.sampled import SampledEvaluator as JaxSampledEvaluator
from tfrec_tpu.eval.sampled import build_candidates as jax_build_candidates
from tfrec_tpu.serve import Recommender as JaxRecommender
from tfrec_tpu.train.trainer import Trainer as JaxTrainer
from tfrec_tpu_torch import configs, zoo_configs
from tfrec_tpu_torch.convert import params_from_jax, train_state_from_jax
from tfrec_tpu_torch.eval.sampled import SampledEvaluator, build_candidates
from tfrec_tpu_torch.models import build_model
from tfrec_tpu_torch.serve import Recommender
from tfrec_tpu_torch.train.trainer import Trainer, run

torch.set_num_threads(1)

# As tests/test_torch_retrieval_trainer.py: losses over a few epochs of two
# implementations of the same arithmetic; ranking metrics over ~128 cases,
# where one exchanged rank moves them by ~1e-2 and rounding by ~1e-8; AUC.
TRAIN_RTOL = 1e-4
METRIC_ATOL = 1e-6
AUC_ATOL = 1e-4
# Scores of one forward (d <= 16 products, a small tower) in another order.
FWD_RTOL, FWD_ATOL = 1e-5, 1e-6

MODELS = {
    "fm": dict(name="fm", embed_dim=16, lane_pack=False),
    "neumf": dict(name="neumf", gmf_dim=8, mlp_embed_dim=8, mlp_dims=(16, 8)),
    "gmf": dict(name="gmf", gmf_dim=16),
}


def _config(mod, model="neumf", loss="logloss", side=False, splitter="ratio", optim=None, **train):
    kw = dict(batch_size=256, epochs=4, eval_every_epochs=4, eval_topk=(10, 20), loss=loss,
              log_every_steps=10, num_negatives=2, eval_num_candidates=50, eval_user_batch=48)
    kw.update(train)
    return mod.Config(
        run_name=f"{model}_{loss}",
        data=mod.DataConfig(source="synthetic_implicit", num_users=128, num_items=256,
                            interactions_per_user=16, seed=0, splitter=splitter,
                            synthetic_side_features=side),
        model=mod.ModelConfig(**MODELS[model]),
        optim=mod.OptimConfig(**(optim or dict(learning_rate=0.05, sparse_optimizer="rowwise_adagrad"))),
        train=mod.TrainConfig(**kw),
        # The single-device path: tests/conftest.py gives JAX 8 virtual CPU
        # devices, where the default would take the mesh path.
        mesh=mod.MeshConfig(data_axis_size=0),
    )


ADAM = dict(learning_rate=0.002, dense_optimizer="adam", sparse_optimizer="rowwise_adam")
PATHS = {
    # name: _config keywords
    "fm, side fields, 2 steps a dispatch": dict(model="fm", side=True, steps_per_dispatch=2),
    "fm, 2 fields, bpr coerced": dict(model="fm", loss="bpr"),
    "neumf, rowwise adam, sampled eval": dict(model="neumf", optim=ADAM, splitter="leave_one_out",
                                              eval_protocol="sampled"),
    "gmf, bpr, sampled eval": dict(model="gmf", loss="bpr", eval_protocol="sampled"),
}


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
            elif "@" in k:
                np.testing.assert_allclose(g[k], w[k], rtol=0, atol=METRIC_ATOL, err_msg=k)
            elif k == "auc":
                np.testing.assert_allclose(g[k], w[k], rtol=0, atol=AUC_ATOL, err_msg=k)
            else:
                assert g[k] == w[k], (k, g, w)


@pytest.mark.parametrize("case", sorted(PATHS))
def test_trainer_matches_jax(tmp_path, case):
    kw = PATHS[case]
    jt = JaxTrainer(_config(jax_configs, checkpoint_dir=str(tmp_path / "jax"), **kw), quiet=True)
    pt = Trainer(_config(configs, checkpoint_dir=str(tmp_path / "port"), **kw), quiet=True, device="cpu")
    pt.state = train_state_from_jax(jax.tree_util.tree_map(np.asarray, jt.state), pt.model)
    assert pt.is_ctr_model == jt.is_ctr_model == (kw["model"] == "fm")
    assert pt.data_spec.field_vocabs == jt.data_spec.field_vocabs
    if kw.get("side"):
        assert pt.data_spec.field_vocabs == (128, 256, 2, 7, 21, 18)
        np.testing.assert_array_equal(pt.user_side, jt.user_side)
        np.testing.assert_array_equal(pt.item_side, jt.item_side)
        host = pt._host_batch(next(pt.sampler.epoch(0)))
        assert host["cat"].shape == (256, 6) and host["dense"].shape == (256, 0)
    want, got = jt.train(), pt.train()
    jt.logger.close()
    pt.logger.close()
    assert pt.global_step == jt.global_step > 10
    final = got[-1]
    if kw.get("eval_protocol") == "sampled":
        assert {"eval_cases", "hr@10", "ndcg_sampled@20"} <= set(final)
    assert ("recall@20" in final) == (case == "fm, 2 fields, bpr coerced")
    assert ("auc" in final) == (kw["model"] != "gmf")
    _same_stream(got, want)
    records = []
    for where in ("port", "jax"):
        recs = _records(tmp_path / where / f"{kw['model']}_{kw.get('loss', 'logloss')}.metrics.jsonl")
        recs[0]["config"]["train"]["checkpoint_dir"] = None  # the two runs' own directories
        records.append(recs)
    _same_stream(*records)
    if kw.get("loss") == "bpr" and kw["model"] == "fm":
        assert records[0][1] == {"event": "loss_coerced", "from": "bpr", "to": "logloss",
                                 "reason": "CTR models train pointwise"}


def _dataset_pair(splitter="leave_one_out"):
    pt = Trainer(_config(configs, splitter=splitter), quiet=True, device="cpu")
    jt = JaxTrainer(_config(jax_configs, splitter=splitter), quiet=True)
    return pt, jt


@pytest.mark.parametrize("splitter,max_users", [("leave_one_out", None), ("ratio", None), ("ratio", 77)])
def test_build_candidates_matches_jax(splitter, max_users):
    pt, jt = _dataset_pair(splitter)
    got = build_candidates(pt.dataset, 50, seed=13, max_users=max_users)
    want = jax_build_candidates(jt.dataset, 50, seed=13, max_users=max_users)
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].dtype == want[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    n = len(pt.dataset.test) if max_users is None else max_users
    assert got["candidates"].shape == (n, 51)


def _noisy_params(jt):
    rng = np.random.default_rng(7)
    params = jax.tree.map(np.asarray, jt.params)
    params["dense"] = jax.tree.map(
        lambda a: (a + 0.1 * rng.normal(size=a.shape)).astype(np.float32), params["dense"])
    return params


@pytest.mark.parametrize("user_batch", [48, 128])
def test_sampled_evaluator_matches_jax(user_batch):
    """At the JAX init (dense leaves noised); 128 cases, in batches of 48
    (the last one padded) and of 128."""
    pt, jt = _dataset_pair()
    np_params = _noisy_params(jt)
    want = JaxSampledEvaluator(jt.model, jt.dataset, ks=(5, 10), num_candidates=30, seed=4,
                               user_batch=user_batch)(jax.tree.map(jnp.asarray, np_params))
    ev = SampledEvaluator(pt.model, pt.dataset, ks=(5, 10), num_candidates=30, seed=4,
                          user_batch=user_batch, device="cpu")
    got = ev(params_from_jax(np_params, pt.model))
    assert list(got) == list(want) and got["eval_cases"] == 128.0
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=METRIC_ATOL, err_msg=k)
    assert 0.0 < got["hr@10"] < 1.0


# ---- serving ----

def test_recommender_serves_ncf_like_jax():
    """NeuMF and GMF: predict (ids out of range clamp), score_catalog over
    item chunks, recommend with and without the train items."""
    for name in ("neumf", "gmf"):
        pt = Trainer(_config(configs, model=name), quiet=True, device="cpu")
        jt = JaxTrainer(_config(jax_configs, model=name), quiet=True)
        np_params = _noisy_params(jt)
        jt.model.eval_chunk = pt.model.eval_chunk = 100  # 3 chunks, the last clamped
        jrec = JaxRecommender(jt.model, jax.tree.map(jnp.asarray, np_params), dataset=jt.dataset,
                              topk_method="exact")
        rec = Recommender(pt.model, params_from_jax(np_params, pt.model), dataset=pt.dataset, device="cpu")
        rng = np.random.default_rng(3)
        users, items = rng.integers(0, 128, 40).astype(np.int32), rng.integers(0, 256, 40).astype(np.int32)
        users[:2], items[2:4] = [-3, 130], [-1, 256]  # clamp, as mode="clip"
        np.testing.assert_allclose(rec.predict(users, items), jrec.predict(users, items),
                                   rtol=FWD_RTOL, atol=FWD_ATOL, err_msg=name)
        some = np.array([0, 3, 3, 64, 127], np.int32)
        np.testing.assert_allclose(rec.score_catalog(some), jrec.score_catalog(some),
                                   rtol=FWD_RTOL, atol=FWD_ATOL, err_msg=name)
        for exclude in (True, False):
            got_ids, got_vals = rec.recommend(some, 10, exclude_train=exclude)
            want_ids, want_vals = jrec.recommend(some, 10, exclude_train=exclude)
            np.testing.assert_allclose(got_vals, want_vals, rtol=FWD_RTOL, atol=FWD_ATOL, err_msg=name)
            gaps = np.abs(np.diff(want_vals, axis=1)) > 1e-4
            clear = np.ones(want_vals.shape, bool)
            clear[:, 1:] &= gaps
            clear[:, :-1] &= gaps
            assert clear.mean() > 0.5
            np.testing.assert_array_equal(got_ids[clear], want_ids[clear], err_msg=name)


def _fm_side_pair(lane_pack):
    pt = Trainer(_config(configs, model="fm", side=True), quiet=True, device="cpu")
    cfg = _config(jax_configs, model="fm", side=True)
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, lane_pack=lane_pack))
    jt = JaxTrainer(cfg, quiet=True)
    np_params = _noisy_params(jt)
    lin = [k for k in np_params["tables"] if k.startswith("lin")]
    rng = np.random.default_rng(8)
    for k in lin:
        np_params["tables"][k] = (0.3 * rng.normal(size=np_params["tables"][k].shape)).astype(np.float32)
    return pt, jt, np_params


@pytest.mark.parametrize("lane_pack", [False, None])
def test_fm_with_side_fields_serves_and_evaluates_like_jax(lane_pack):
    """``predict_ctr`` on 6-field batches, and the trainer's eval (AUC over
    sampled negatives; no full-catalog metrics), at JAX's params in the
    per-field layout and in JAX's default, lane-packed, one (at d=16 the six
    fields share one ``pack_0`` of 128 // 16 = 8 slots, and their linear
    tables one ``linpack_0``); the packed train state, [V, G] optimizer
    state included, carries into the port's packed FM as it is, and that
    model serves as the per-field one does."""
    pt, jt, np_params = _fm_side_pair(lane_pack)
    packed = any(k.startswith("pack_") for k in np_params["tables"])
    assert packed == (lane_pack is None)
    packed_model = None
    if packed:
        packed_model = build_model(dataclasses.replace(pt.config.model, lane_pack=True), pt.data_spec)
        jstate = jax.tree_util.tree_map(np.asarray, jt.state)
        state = train_state_from_jax(jstate, packed_model)
        assert set(state["tables"]) == {"pack_0", "linpack_0"}
        for name, table in jstate["tables"].items():
            np.testing.assert_array_equal(state["tables"][name].numpy(), table)
            for k, leaf in jstate["sparse_opt"][name].items():
                assert state["sparse_opt"][name][k].shape == leaf.shape and leaf.ndim == 2
                np.testing.assert_array_equal(state["sparse_opt"][name][k].numpy(), leaf)
    params = params_from_jax(np_params, pt.model)
    rng = np.random.default_rng(9)
    users, items = rng.integers(0, 128, 64), rng.integers(0, 256, 64)
    host = pt._host_batch({"user": users.astype(np.int32), "item": items.astype(np.int32),
                           "label": np.zeros(64, np.float32)})
    jrec = JaxRecommender(jt.model, jax.tree.map(jnp.asarray, np_params))
    rec = Recommender(pt.model, params, device="cpu")
    got, want = rec.predict_ctr(host["dense"], host["cat"]), jrec.predict_ctr(host["dense"], host["cat"])
    assert got.shape == (64,)
    np.testing.assert_allclose(got, want, rtol=FWD_RTOL, atol=FWD_ATOL)
    if packed_model is not None:
        rec_packed = Recommender(packed_model, params_from_jax(np_params, packed_model), device="cpu")
        np.testing.assert_array_equal(rec_packed.predict_ctr(host["dense"], host["cat"]), got)
    with pytest.raises(NotImplementedError, match="2-field"):
        rec.score_catalog([0, 1])
    jt.state = {**jt.state, "tables": jax.tree.map(jnp.asarray, np_params["tables"]),
                "dense": jax.tree.map(jnp.asarray, np_params["dense"])}
    pt.state = {**pt.state, "tables": params["tables"], "dense": params["dense"]}
    got, want = pt.evaluate(), jt.evaluate()
    assert set(got) == set(want) == {"auc"}
    np.testing.assert_allclose(got["auc"], want["auc"], rtol=0, atol=AUC_ATOL)


# ---- configs 2 and 3, and the refusals ----

def test_configs_2_and_3_train_and_evaluate_at_a_small_size():
    """``fm_ctr_ml1m()`` and ``neumf_ml20m()`` run (ROADMAP Queue 1 item 9's
    refusals are gone) at 200 users and 1 epoch."""
    fm = zoo_configs.fm_ctr_ml1m()
    fm = fm.replace(data=dataclasses.replace(fm.data, num_users=200),
                    train=dataclasses.replace(fm.train, epochs=1, batch_size=1024))
    trainer, hist = run(fm, quiet=True, device="cpu")
    assert trainer.data_spec.field_vocabs == (200, 3706, 2, 7, 21, 18)
    assert set(hist[-1]) == {"epoch", "loss", "examples_per_s", "auc"}
    neumf = zoo_configs.neumf_ml20m()
    neumf = neumf.replace(data=dataclasses.replace(neumf.data, num_users=200, num_items=500),
                          train=dataclasses.replace(neumf.train, epochs=1, batch_size=1024))
    trainer, hist = run(neumf, quiet=True, device="cpu")
    assert trainer.builder.sparse_opt.name == "rowwise_adam"
    assert {"eval_cases", "hr@10", "ndcg_sampled@10", "hr@20", "auc"} <= set(hist[-1])
    assert hist[-1]["eval_cases"] == 200.0
    assert all(np.isfinite(v) for v in hist[-1].values())
