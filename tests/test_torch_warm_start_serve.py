"""Warm starts and serving from disk, between the port and the JAX
package, on the CPU (checkpoints in the JAX package's layout; their format,
resume and cross-topology restore are tests/test_torch_checkpoint.py's).

- ``init_from``: NeuMF from a GMF checkpoint the port or JAX saved (the
  model's ``warm_start_aliases``), a source with more rows cut and said so,
  the refusal when nothing matches, and resume winning, against
  tests/test_warm_start.py;
- ``Recommender.from_checkpoint`` against JAX's (tests/test_serve.py), its
  two refusals, the one ``run_config`` record of the run's stream, answers
  equal to ``from_trainer``'s, and a JAX model in the lane-packed layout
  served from disk.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import tfrec_tpu.configs as jax_configs
from tfrec_tpu.serve import Recommender as JaxRecommender
from tfrec_tpu.train.trainer import Trainer as JaxTrainer
from tfrec_tpu_torch import configs
from tfrec_tpu_torch.serve import Recommender
from tfrec_tpu_torch.train.trainer import Trainer, run
from tfrec_tpu_torch.utils import checkpoint as ckpt
from test_torch_checkpoint import _config

torch.set_num_threads(1)

# recommend's and predict's scores of one product of d <= 16 in another order.
SCORE_RTOL, SCORE_ATOL = 1e-5, 1e-6


def _gmf_source(tmp_path, mod, dim=8):
    cfg = _config(mod, "neumf", str(tmp_path / f"gmf_{mod.__name__}"), epochs=1)
    cfg = cfg.replace(model=mod.ModelConfig(name="gmf", gmf_dim=dim), run_name="gmf")
    if mod is configs:
        run(cfg, quiet=True, device="cpu")
    else:
        JaxTrainer(cfg, quiet=True).train()
    return cfg.train.checkpoint_dir


def test_neumf_warm_starts_from_gmf_as_in_jax(tmp_path):
    """NeuMF's towers seed from GMF's user_emb and item_emb (its aliases);
    the port warm starts from its own GMF checkpoint and from JAX's."""
    for src_mod in (configs, jax_configs):
        src = _gmf_source(tmp_path, src_mod)
        tables = ckpt.load_table_arrays(src)
        cfg = _config(configs, "neumf", epochs=1, init_from=src)
        seen = []
        pt = Trainer(cfg, quiet=True, device="cpu")
        for name, alias in (("user_gmf", "user_emb"), ("item_gmf", "item_emb"),
                            ("user_mlp", "user_emb"), ("item_mlp", "item_emb")):
            np.testing.assert_array_equal(pt.state["tables"][name].numpy(), tables[alias])
        jt = JaxTrainer(_config(jax_configs, "neumf", epochs=1, init_from=src), quiet=True)
        for name, t in pt.state["tables"].items():
            np.testing.assert_array_equal(t.numpy(), np.asarray(jt.state["tables"][name]))
        pt.logger.log = seen.append
        pt._warm_start(src)
        assert seen[0]["event"] == "warm_start" and seen[0]["skipped"] == []
        assert seen[0]["copied"] == ["item_gmf", "item_mlp", "user_gmf", "user_mlp"]
        assert np.isfinite(pt.train()[-1]["loss"])


def test_warm_start_skips_truncates_and_refuses_as_jax(tmp_path):
    src = _gmf_source(tmp_path, configs, dim=8)
    # A GMF of another dim copies nothing: refused, as in the reference.
    for mod, trainer in ((configs, lambda c: Trainer(c, quiet=True, device="cpu")),
                         (jax_configs, lambda c: JaxTrainer(c, quiet=True))):
        cfg = _config(mod, "neumf", epochs=1, init_from=src)
        cfg = cfg.replace(model=mod.ModelConfig(name="gmf", gmf_dim=4))
        with pytest.raises(ValueError, match="copied no tables"):
            trainer(cfg)
    # A source with more rows than the target: the first rows, said so.
    cfg = _config(configs, "neumf", epochs=1, init_from=src)
    cfg = cfg.replace(model=configs.ModelConfig(name="gmf", gmf_dim=8),
                      data=dataclasses.replace(cfg.data, num_users=48))
    seen = []
    pt = Trainer(cfg, quiet=True, device="cpu")
    pt.logger.log = seen.append
    pt._warm_start(src)
    users = pt.state["tables"]["user_emb"].shape[0]
    assert ["user_emb", f"first {users} of 96 source rows"] in seen[0]["copied"]
    np.testing.assert_array_equal(pt.state["tables"]["user_emb"].numpy(),
                                  ckpt.load_table_arrays(src)["user_emb"][:users])


def test_resume_wins_over_init_from(tmp_path):
    src = _gmf_source(tmp_path, configs)
    own = str(tmp_path / "own")
    cfg = _config(configs, "neumf", own, epochs=1).replace(
        model=configs.ModelConfig(name="gmf", gmf_dim=8))
    t1, _ = run(cfg, quiet=True, device="cpu")
    resumed = Trainer(dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, resume=True, init_from=src)), quiet=True, device="cpu")
    assert resumed.start_epoch == 1
    assert torch.equal(resumed.state["tables"]["user_emb"], t1.state["tables"]["user_emb"])
    stream = [json.loads(x) for x in open(os.path.join(own, f"{cfg.run_name}.metrics.jsonl"))]
    assert stream[-1]["event"] == "warm_start_skipped"


def test_from_checkpoint_matches_jax_and_refuses_as_jax(tmp_path):
    d = str(tmp_path / "ck")
    jt = JaxTrainer(_config(jax_configs, "mf", d, epochs=2), quiet=True)
    jt.train()
    want = JaxRecommender.from_checkpoint(_config(jax_configs, "mf", d))
    cold = Recommender.from_checkpoint(_config(configs, "mf", d), device="cpu")
    users = np.asarray([0, 5, 9, 40], np.int32)
    ids, scores = cold.recommend(users, k=5)
    want_ids, want_scores = want.recommend(users, k=5)
    np.testing.assert_array_equal(ids, np.asarray(want_ids))
    np.testing.assert_allclose(scores, np.asarray(want_scores), rtol=SCORE_RTOL, atol=SCORE_ATOL)
    np.testing.assert_allclose(cold.predict(users, users + 1),
                               np.asarray(want.predict(users, users + 1)),
                               rtol=SCORE_RTOL, atol=SCORE_ATOL)
    with pytest.raises(ValueError, match="no checkpoint found"):
        Recommender.from_checkpoint(_config(configs, "mf", d), str(tmp_path / "empty"),
                                    device="cpu")
    with pytest.raises(ValueError, match="needs a checkpoint_dir"):
        Recommender.from_checkpoint(_config(configs, "mf"), device="cpu")


def test_from_checkpoint_equals_from_trainer_and_keeps_one_run_config(tmp_path):
    d = str(tmp_path / "ck")
    cfg = _config(configs, "dcn", d, epochs=1)
    trainer, _ = run(cfg, quiet=True, device="cpu")
    live = Recommender.from_trainer(trainer)
    cold = Recommender.from_checkpoint(cfg, device="cpu")
    dense, cat, _ = trainer.ctr_arrays["test"]
    np.testing.assert_array_equal(cold.predict_ctr(dense, cat), live.predict_ctr(dense, cat))
    stream = [json.loads(x) for x in open(os.path.join(d, f"{cfg.run_name}.metrics.jsonl"))]
    assert sum(r.get("event") == "run_config" for r in stream) == 1


@pytest.mark.parametrize("layout", ["lane_pack", "stack_tables"])
def test_from_checkpoint_serves_a_packed_or_stacked_jax_model(tmp_path, layout):
    """JAX's FM in its lane-packed (``pack_k``/``linpack_k``) or stacked
    (``fields``/``lin``) table layout: the port serves its checkpoint's
    params, and resumes its state in that layout (a packed one under
    ``lane_pack=None``, which takes the checkpoint's layout), its [V, G]
    or [sum V] optimizer state as saved."""
    d = str(tmp_path / "ck")
    jcfg = _config(jax_configs, "fm", d, epochs=1)
    jcfg = jcfg.replace(model=dataclasses.replace(jcfg.model, lane_pack=layout == "lane_pack",
                                                  stack_tables=layout == "stack_tables"))
    jt = JaxTrainer(jcfg, quiet=True)
    jt.train()
    keys = json.load(open(os.path.join(d, "step_0000000001", "tree.json")))["keys"]
    assert ("tables/pack_0" in keys) == (layout == "lane_pack")
    assert ("tables/fields" in keys) == (layout == "stack_tables")
    want = JaxRecommender.from_checkpoint(jcfg)
    cold = Recommender.from_checkpoint(_config(configs, "fm", d, epochs=1), device="cpu")
    users = np.arange(0, 96, 7, dtype=np.int32)
    cat = np.stack([users, users * 3 % 160], axis=1).astype(np.int32)
    dense = np.zeros((len(users), 0), np.float32)
    np.testing.assert_allclose(cold.predict_ctr(dense, cat), np.asarray(want.predict_ctr(dense, cat)),
                               rtol=SCORE_RTOL, atol=SCORE_ATOL)
    np.testing.assert_allclose(cold.score_catalog(users), np.asarray(want.score_catalog(users)),
                               rtol=SCORE_RTOL, atol=SCORE_ATOL)
    pcfg = _config(configs, "fm", d, epochs=1, resume=True)
    pcfg = pcfg.replace(model=dataclasses.replace(pcfg.model, lane_pack=None if layout == "lane_pack" else False,
                                                  stack_tables=layout == "stack_tables"))
    pt = Trainer(pcfg, quiet=True, device="cpu")
    assert pt.start_epoch == 1 and getattr(pt.model, layout)
    for name, table in jt.state["tables"].items():
        np.testing.assert_array_equal(pt.state["tables"][name].numpy(), np.asarray(table), err_msg=name)
        for k, leaf in jt.state["sparse_opt"][name].items():
            np.testing.assert_array_equal(pt.state["sparse_opt"][name][k].numpy(), np.asarray(leaf))
