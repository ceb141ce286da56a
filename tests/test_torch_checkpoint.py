"""Checkpoints in the JAX package's on-disk layout, between the port and
the JAX package, on the CPU.

- ``convert.flat_from_state`` writes the keys, dtypes and shapes JAX saves
  for each dense optimizer (Adam, Adagrad, SGD, with and without weight
  decay) and sparse optimizer; a checkpoint the port saves loads in JAX's
  ``restore_checkpoint`` leaf for leaf, and one JAX saves in the port;
- ``save_checkpoint``'s round trip, overwrite of a step, stale ``.tmp``
  and ``keep``; ``latest_step``, ``load_table_arrays``,
  ``checkpoint_table_layout`` and ``checkpoint_row_permute`` against
  JAX's on the same directories;
- JAX trainers (MF, DCN, FM, NeuMF) save, the port resumes and its
  ``evaluate()`` gives JAX's metrics; a checkpoint JAX saved over its
  8-device CPU mesh (padded tables, tests/conftest.py) restores in the
  one-device port;
- resume against JAX's resume (an interrupted run ends as the whole one).

Warm starts and serving from disk are tests/test_torch_warm_start_serve.py's.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

import tfrec_tpu.configs as jax_configs
import tfrec_tpu.utils.checkpoint as jax_ckpt
from tfrec_tpu.models import DataSpec as JaxDataSpec
from tfrec_tpu.models import build_model as jax_build_model
from tfrec_tpu.train.step import TrainStepBuilder as JaxTrainStepBuilder
from tfrec_tpu.train.trainer import Trainer as JaxTrainer
from tfrec_tpu_torch import configs, convert
from tfrec_tpu_torch.models import DataSpec, build_model
from tfrec_tpu_torch.train.step import tree_leaves
from tfrec_tpu_torch.train.trainer import Trainer, run
from tfrec_tpu_torch.utils import checkpoint as ckpt

torch.set_num_threads(1)

# The trainer tests' tolerances (tests/test_torch_trainer.py and
# tests/test_torch_sampled_trainer.py): the same arithmetic in another order
# over a forward at restored params; AUC over held-out rows; ranking metrics
# over ~100 users, where rounding moves them by ~1e-8.
EVAL_RTOL = 1e-4
AUC_ATOL = 1e-4
METRIC_ATOL = 1e-6
# Losses of a run resumed in the port from JAX's checkpoint, against JAX's
# whole run: one epoch of steps in another order.
TRAIN_RTOL = 1e-4


def _jax_state(model_kw, spec_args, optim_kw, loss="logloss", ctr=True):
    spec = (JaxDataSpec.ctr(*spec_args, num_dense=3) if ctr
            else JaxDataSpec.interaction(*spec_args))
    model = jax_build_model(jax_configs.ModelConfig(**model_kw), spec)
    builder = JaxTrainStepBuilder(model, loss, jax_configs.OptimConfig(**optim_kw))
    state = builder.init_state(jax.random.PRNGKey(0))
    # A state with non-trivial optimizer leaves: every float leaf drawn.
    rng = np.random.default_rng(1)
    state = jax.tree.map(
        lambda x: (rng.normal(size=np.shape(x)).astype(np.float32)
                   if np.asarray(x).dtype == np.float32 else np.asarray(x) + 3), state)
    port_spec = DataSpec.ctr(*spec_args, num_dense=3) if ctr else DataSpec.interaction(*spec_args)
    port_model = build_model(configs.ModelConfig(**model_kw), port_spec)
    return state, port_model


OPTIMIZERS = [(dense, wd) for dense in ("adam", "adagrad", "sgd") for wd in (0.0, 0.1)]


@pytest.mark.parametrize("dense,wd", OPTIMIZERS)
def test_flat_keys_match_jax_for_each_dense_optimizer(tmp_path, dense, wd):
    """A small DCN's state under each dense optimizer: the port's keys,
    dtypes, shapes and values are JAX's; each package loads the other's
    checkpoint leaf for leaf."""
    model_kw = dict(name="dcn", embed_dim=4, mlp_dims=(8, 4), num_cross_layers=2, lane_pack=False)
    optim_kw = dict(dense_optimizer=dense, weight_decay=wd, lr_schedule="cosine", decay_steps=10)
    state, model = _jax_state(model_kw, ((5, 6),), optim_kw)
    want = {k: np.asarray(v) for k, v in jax_ckpt._flatten(state).items()}
    port_state = convert.train_state_from_jax(state, model)
    got = convert.flat_from_state(port_state, dense, wd)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype and got[key].shape == want[key].shape, key
        if key.endswith(".count") or key == "step":
            assert got[key].dtype == np.int32 and got[key].shape == ()
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    # The port saves, JAX restores every leaf equal.
    ckpt.save_checkpoint(str(tmp_path / "port"), 7, got)
    restored = jax_ckpt.restore_checkpoint(str(tmp_path / "port"), state)
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(restored)[0],
                            jax.tree_util.tree_leaves(state)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=str(path))
    # JAX saves, the port restores the same state.
    jax_ckpt.save_checkpoint(str(tmp_path / "jax"), 7, state)
    with open(tmp_path / "jax" / "step_0000000007" / "tree.json") as f:
        assert json.load(f)["keys"] == sorted(got)
    back = convert.train_state_from_flat(ckpt.restore_checkpoint(str(tmp_path / "jax")), model,
                                         port_state)
    assert back["step"] == port_state["step"] and back["dense_opt"]["count"] == \
        port_state["dense_opt"]["count"]
    for a, b in zip(tree_leaves(back), tree_leaves(port_state)):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))


@pytest.mark.parametrize("sparse", ["rowwise_adagrad", "rowwise_adam", "sgd"])
def test_flat_keys_match_jax_for_each_sparse_optimizer(tmp_path, sparse):
    state, model = _jax_state(dict(name="mf", embed_dim=4), (5, 6),
                              dict(sparse_optimizer=sparse, dense_optimizer="adagrad"),
                              loss="bpr", ctr=False)
    want = {k: np.asarray(v) for k, v in jax_ckpt._flatten(state).items()}
    port_state = convert.train_state_from_jax(state, model)
    got = convert.flat_from_state(port_state, "adagrad")
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    jax_ckpt.save_checkpoint(str(tmp_path), 1, state)
    back = convert.train_state_from_flat(ckpt.restore_checkpoint(str(tmp_path)), model, port_state)
    for a, b in zip(tree_leaves(back), tree_leaves(port_state)):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))


def _tiny_flat(seed=0):
    rng = np.random.default_rng(seed)
    return {"step": np.asarray(seed, np.int32), "tables/field_0": rng.normal(size=(5, 3)),
            "dense/mlp/0/0": rng.normal(size=(3, 2)).astype(np.float32),
            "dense_opt/1/.count": np.asarray(4, np.int32)}


def test_save_restore_round_trip_overwrite_stale_tmp_and_keep(tmp_path):
    d = str(tmp_path / "ck")
    assert ckpt.latest_step(d) is None and jax_ckpt.latest_step(d) is None
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        ckpt.restore_checkpoint(d)
    flat = _tiny_flat()
    out = ckpt.save_checkpoint(d, 1, flat)
    assert out == jax_ckpt.save_checkpoint(str(tmp_path / "jax"), 1, flat).replace("jax", "ck")
    assert sorted(os.listdir(out)) == sorted(os.listdir(tmp_path / "jax" / "step_0000000001"))
    got = ckpt.restore_checkpoint(d)
    assert got.keys() == flat.keys()
    for k in flat:
        assert got[k].dtype == np.asarray(flat[k]).dtype
        np.testing.assert_array_equal(got[k], flat[k])
    # The same step again overwrites it; a stale .tmp of a crashed save goes.
    os.makedirs(os.path.join(d, "step_0000000002.tmp"))
    open(os.path.join(d, "step_0000000002.tmp", "stale.p3.npy"), "w").close()
    ckpt.save_checkpoint(d, 2, _tiny_flat(1))
    ckpt.save_checkpoint(d, 2, _tiny_flat(2))
    assert not os.path.exists(os.path.join(d, "step_0000000002", "stale.p3.npy"))
    assert int(ckpt.restore_checkpoint(d)["step"]) == 2
    assert int(ckpt.restore_checkpoint(d, step=1)["step"]) == 0
    # keep: the newest three stay.
    for step in (3, 4, 5):
        ckpt.save_checkpoint(d, step, _tiny_flat(step))
    assert sorted(os.listdir(d)) == [f"step_{s:010d}" for s in (3, 4, 5)]
    assert ckpt.latest_step(d) == jax_ckpt.latest_step(d) == 5
    ckpt.save_checkpoint(d, 6, _tiny_flat(6), keep=0)
    assert len(os.listdir(d)) == 4
    # A template restores its keys only; a missing leaf is named.
    got = ckpt.restore_checkpoint(d, {"tables/field_0": (5, 3)})
    assert list(got) == ["tables/field_0"]
    with pytest.raises(FileNotFoundError, match="tables/nope"):
        ckpt.restore_checkpoint(d, {"tables/nope": (1,)})


def test_layout_readers_match_jax(tmp_path):
    d = str(tmp_path)
    assert ckpt.checkpoint_table_layout(d) is jax_ckpt.checkpoint_table_layout(d) is None
    ckpt.save_checkpoint(d, 1, _tiny_flat(), meta={"row_permute": False})
    assert ckpt.checkpoint_table_layout(d) is jax_ckpt.checkpoint_table_layout(d) is False
    assert ckpt.checkpoint_row_permute(d) is jax_ckpt.checkpoint_row_permute(d) is False
    packed = {"tables/pack_0": np.zeros((4, 128), np.float32), "step": np.asarray(1, np.int32)}
    ckpt.save_checkpoint(d, 2, packed, meta={"row_permute": True})
    assert ckpt.checkpoint_table_layout(d) is jax_ckpt.checkpoint_table_layout(d) is True
    assert ckpt.checkpoint_row_permute(d) is jax_ckpt.checkpoint_row_permute(d) is True
    with pytest.raises(ValueError, match="row_permute"):
        ckpt.restore_checkpoint(d)
    for got, want in ((ckpt.load_table_arrays(d, 1), jax_ckpt.load_table_arrays(d, 1)),
                      (ckpt.load_table_arrays(d), jax_ckpt.load_table_arrays(d))):
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


def test_multi_process_blocks_reassemble_as_jax(tmp_path):
    """A checkpoint two processes saved, a table's rows split between them
    (process 0 holding two spans), restores as JAX restores it, with its
    pad rows dropped to the template; the warm-start loader reads it too."""
    src = tmp_path / "step_0000000003"
    src.mkdir()
    table = np.arange(30, dtype=np.float32).reshape(10, 3)
    padded = np.concatenate([table, np.zeros((2, 3), np.float32)])
    np.save(src / "tables__field_0.p0.npy", np.concatenate([padded[0:4], padded[8:12]]))
    np.save(src / "tables__field_0.p1.npy", padded[4:8])
    for p in (0, 1):
        np.save(src / f"step.p{p}.npy", np.asarray(3, np.int32))
    spans = {0: [[0, 4], [8, 12]], 1: [[4, 8]]}
    for p, sp in spans.items():
        with open(src / f"blocks.p{p}.json", "w") as f:
            json.dump({"tables/field_0": {"axis": 0, "spans": sp, "global_shape": [12, 3]}}, f)
    with open(src / "tree.json", "w") as f:
        json.dump({"step": 3, "keys": ["step", "tables/field_0"], "process_count": 2,
                   "device_count": 2}, f)
    template = {"step": np.zeros((), np.int32), "tables/field_0": np.zeros((10, 3), np.float32)}
    got = ckpt.restore_checkpoint(str(tmp_path), {k: v.shape for k, v in template.items()})
    want = jax_ckpt.restore_checkpoint(str(tmp_path), template)
    for k in template:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    np.testing.assert_array_equal(got["tables/field_0"], table)
    np.testing.assert_array_equal(ckpt.restore_checkpoint(str(tmp_path))["tables/field_0"], padded)
    np.testing.assert_array_equal(ckpt.load_table_arrays(str(tmp_path))["field_0"],
                                  jax_ckpt.load_table_arrays(str(tmp_path))["field_0"])
    os.remove(src / "tables__field_0.p1.npy")
    with pytest.raises(ValueError, match="incomplete checkpoint"):
        ckpt.restore_checkpoint(str(tmp_path))


def test_fit_axis0_absorbs_zero_pad_rows_only():
    a = np.arange(6, dtype=np.float32).reshape(3, 2)
    padded = np.concatenate([a, np.zeros((5, 2), np.float32)])
    np.testing.assert_array_equal(ckpt._fit_axis0(padded, (3, 2)), a)
    np.testing.assert_array_equal(ckpt._fit_axis0(a, (8, 2)), padded)
    with pytest.raises(ValueError, match="NON-ZERO"):
        ckpt._fit_axis0(a, (2, 2))
    with pytest.raises(ValueError, match="does not match"):
        ckpt._fit_axis0(a, (3, 3))


# ---- trainers ----

def _data(mod, kind):
    if kind == "ctr":
        return mod.DataConfig(source="synthetic_ctr", num_examples=3000, num_dense_features=3,
                              categorical_vocab_sizes=(60, 40, 30), test_fraction=0.2, seed=5)
    return mod.DataConfig(source="synthetic_implicit", num_users=96, num_items=160,
                          interactions_per_user=10, seed=3, splitter="ratio")


MODELS = {  # name: (data kind, model, loss, optimizer, train extras)
    "mf": ("implicit", dict(name="mf", embed_dim=16), "bpr",
           dict(learning_rate=0.05, dense_optimizer="adagrad"), dict(eval_topk=(10, 20))),
    # MF has no dense params: its dense optimizer state holds only counts.
    "mf_adam": ("implicit", dict(name="mf", embed_dim=16), "bpr",
                dict(learning_rate=0.05, dense_optimizer="adam"), dict(eval_topk=(10,))),
    "dcn": ("ctr", dict(name="dcn", embed_dim=8, num_cross_layers=2, mlp_dims=(16, 8),
                        lane_pack=False), "logloss",
            dict(learning_rate=0.01, sparse_learning_rate=0.05), {}),
    "fm": ("implicit", dict(name="fm", embed_dim=8, lane_pack=False), "logloss",
           dict(learning_rate=0.05, dense_optimizer="adagrad"), dict(eval_topk=(10,))),
    "neumf": ("implicit", dict(name="neumf", gmf_dim=8, mlp_embed_dim=8, mlp_dims=(16, 8)),
              "logloss", dict(learning_rate=0.01, sparse_optimizer="rowwise_adam"),
              dict(eval_protocol="sampled", eval_num_candidates=40, eval_topk=(10,))),
}


def _config(mod, name, ckpt_dir=None, epochs=2, mesh=0, **train):
    kind, model, loss, optim, extra = MODELS[name]
    kw = dict(batch_size=128, epochs=epochs, eval_every_epochs=epochs, loss=loss, seed=1,
              log_every_steps=0, checkpoint_dir=ckpt_dir,
              checkpoint_every_epochs=1 if ckpt_dir else 0, eval_user_batch=32)
    kw.update(extra)
    kw.update(train)
    return mod.Config(run_name=f"ck_{name}", data=_data(mod, kind),
                      model=mod.ModelConfig(**model), optim=mod.OptimConfig(**optim),
                      train=mod.TrainConfig(**kw),
                      # mesh=0: the single-device path of JAX's 8 virtual CPU
                      # devices (tests/conftest.py); -1: the mesh path.
                      mesh=mod.MeshConfig(data_axis_size=mesh))


def _same_metrics(got, want):
    assert got.keys() == want.keys(), (got, want)
    for k in want:
        if k == "auc":
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=AUC_ATOL, err_msg=k)
        elif k in ("logloss",):
            np.testing.assert_allclose(got[k], want[k], rtol=EVAL_RTOL, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=METRIC_ATOL, err_msg=k)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_jax_trainer_checkpoint_resumes_in_the_port_with_its_metrics(tmp_path, name):
    d = str(tmp_path / "ck")
    jt = JaxTrainer(_config(jax_configs, name, d), quiet=True)
    jt.train()
    want = jt.evaluate()
    pt = Trainer(_config(configs, name, d, resume=True), quiet=True, device="cpu")
    assert pt.start_epoch == 2 and pt.state["step"] == int(jt.state["step"])
    for k, t in pt.state["tables"].items():
        np.testing.assert_array_equal(t.numpy(), np.asarray(jt.state["tables"][k]), err_msg=k)
    _same_metrics(pt.evaluate(), want)
    assert pt.train() == []  # nothing left to train


def test_jax_mesh_checkpoint_restores_in_the_port(tmp_path):
    """JAX over its 8 virtual CPU devices pads each table to a multiple of
    the device count's rows; the port restores the unpadded tables."""
    d = str(tmp_path / "ck")
    jt = JaxTrainer(_config(jax_configs, "dcn", d, epochs=1, mesh=-1, batch_size=128), quiet=True)
    assert jt.mesh is not None
    jt.train()
    with open(os.path.join(d, "step_0000000001", "tree.json")) as f:
        tree = json.load(f)
    assert tree["device_count"] == 8
    saved = np.load(os.path.join(d, "step_0000000001", "tables__field_0.p0.npy"))
    assert saved.shape[0] > 60  # padded rows on disk
    pt = Trainer(_config(configs, "dcn", d, epochs=1, resume=True), quiet=True, device="cpu")
    assert pt.start_epoch == 1
    params = jax.tree.map(np.asarray, jt.params)
    for k, t in pt.state["tables"].items():
        np.testing.assert_array_equal(t.numpy(), params["tables"][k], err_msg=k)
    got = convert.flat_from_state(pt.state, "adam")
    for key, want in jax_ckpt._flatten({"dense": params["dense"]}).items():
        np.testing.assert_array_equal(got[key], want, err_msg=key)
    for k, s in pt.state["sparse_opt"].items():
        np.testing.assert_array_equal(s["acc"].numpy(), np.asarray(jt.state["sparse_opt"][k]["acc"])[
            : s["acc"].shape[0]])


def test_resume_refuses_another_models_or_optimizers_checkpoint(tmp_path):
    d = str(tmp_path / "ck")
    run(_config(configs, "dcn", d, epochs=1), quiet=True, device="cpu")
    other_opt = _config(configs, "dcn", d, epochs=2, resume=True)
    other_opt = other_opt.replace(optim=dataclasses.replace(other_opt.optim, dense_optimizer="sgd",
                                                            weight_decay=0.1))
    with pytest.raises(ValueError, match="dense_opt/1/1/.count"):
        Trainer(other_opt, quiet=True, device="cpu")
    other_model = _config(configs, "dcn", d, epochs=2, resume=True)
    other_model = other_model.replace(model=dataclasses.replace(other_model.model, mlp_dims=(16,)))
    with pytest.raises(ValueError, match="dense/w_out' has shape"):
        Trainer(other_model, quiet=True, device="cpu")


def _copy_first_checkpoint(src, dst):
    import shutil

    shutil.copytree(os.path.join(src, "step_0000000001"), os.path.join(dst, "step_0000000001"))


@pytest.mark.parametrize("name", ["dcn", "neumf", "mf", "mf_adam"])
def test_resume_ends_as_the_whole_run_in_both_packages(tmp_path, name):
    """Interrupted after epoch 1 and resumed, a run ends with the state of
    the whole run: in JAX (the reference's answer), and in the port bit for
    bit. The port resumed from JAX's epoch-1 checkpoint follows JAX's run.
    MF, under Adagrad and Adam, has an empty dense tree, so its checkpoint
    holds no dense optimizer leaf but the counts."""
    whole, half = str(tmp_path / "whole"), str(tmp_path / "half")
    jt = JaxTrainer(_config(jax_configs, name, whole), quiet=True)
    jax_hist = jt.train()
    os.makedirs(half)
    _copy_first_checkpoint(whole, half)
    jr = JaxTrainer(_config(jax_configs, name, half, resume=True), quiet=True)
    assert jr.start_epoch == 1
    jr.train()
    for a, b in zip(jax.tree_util.tree_leaves(jr.state), jax.tree_util.tree_leaves(jt.state)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # The port from JAX's checkpoint: JAX's last epoch within the tolerance.
    from_jax = str(tmp_path / "from_jax")
    os.makedirs(from_jax)
    _copy_first_checkpoint(whole, from_jax)
    pj = Trainer(_config(configs, name, from_jax, resume=True), quiet=True, device="cpu")
    assert pj.state["dense_opt"].keys() == pj.builder.init_state(torch.Generator())["dense_opt"].keys()
    got = pj.train()
    assert [r["epoch"] for r in got] == [1]
    np.testing.assert_allclose(got[0]["loss"], jax_hist[1]["loss"], rtol=TRAIN_RTOL)
    # The port's own run, whole and resumed.
    pwhole, phalf = str(tmp_path / "pwhole"), str(tmp_path / "phalf")
    pt, _ = run(_config(configs, name, pwhole), quiet=True, device="cpu")
    os.makedirs(phalf)
    _copy_first_checkpoint(pwhole, phalf)
    pr = Trainer(_config(configs, name, phalf, resume=True), quiet=True, device="cpu")
    stream = [json.loads(x) for x in open(os.path.join(phalf, f"ck_{name}.metrics.jsonl"))]
    assert stream[1] == {"event": "resumed", "epoch": 1, "wall_s": stream[1]["wall_s"]}
    pr.train()
    assert pr.state["step"] == pt.state["step"] and pr.state["dense_opt"]["count"] == \
        pt.state["dense_opt"]["count"]
    for a, b in zip(tree_leaves(pr.state), tree_leaves(pt.state)):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
