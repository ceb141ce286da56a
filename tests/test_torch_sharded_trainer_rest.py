"""Config 5's trainer on 2 ranks with lane-packed tables over the
lane-sliced wire and FSDP dense params, and IRGAN on the mesh path, over
gloo (tests/torch_dist_worker.py job ``trainer``), against the JAX package
on the same checkpoints.

One spawn runs four trainers in turn: ``dcn_multihost`` (cut to a tiny
size) with ``model.lane_pack=True`` and ``mesh.dense_sharding="fsdp"`` and
a checkpoint an epoch; its resume from the epoch-1 checkpoint under
replicated dense params, which must end bit for bit as the whole run; a
resume from JAX's packed mesh checkpoint (2 of the 8 virtual CPU devices),
which must restore JAX's state exactly; and ``irgan_ml100k`` cut small.
The packed 2-rank checkpoint is then read by JAX's loader and resumes here
at world 1, each leaf as saved.
"""

import shutil

import jax
import numpy as np
import pytest

from tfrec_tpu import zoo_configs as jax_zoo
from tfrec_tpu.configs import with_overrides as jax_with_overrides
from tfrec_tpu.train.trainer import Trainer as JaxTrainer
from tfrec_tpu.utils import checkpoint as jax_ckpt
from tfrec_tpu_torch import zoo_configs
from tfrec_tpu_torch.configs import with_overrides
from tfrec_tpu_torch.train.trainer import Trainer
from tfrec_tpu_torch.utils import checkpoint
from torch_dist_worker import _np, run_ranks

VOCAB, FIELDS = 50, 4
TINY = {"data.num_examples": 3000, "data.categorical_vocab_sizes": (VOCAB,) * FIELDS,
        "model.embed_dim": 4, "model.mlp_dims": (16,), "model.lane_pack": True,
        "train.batch_size": 256, "train.steps_per_dispatch": 2, "train.checkpoint_every_epochs": 1,
        "train.log_every_steps": 0}
IRGAN = {"data.num_users": 60, "data.num_items": 80, "data.interactions_per_user": 8,
         "model.embed_dim": 8, "train.batch_size": 64, "train.epochs": 2, "train.num_negatives": 4,
         "train.eval_topk": (5,), "train.init_from": None, "train.log_every_steps": 0}


def _config(with_overrides_fn, zoo_fn, ckpt, **kw):
    return with_overrides_fn(zoo_fn(), {**TINY, "train.checkpoint_dir": str(ckpt), **kw})


def _port(ckpt, **kw):
    return _config(with_overrides, zoo_configs.dcn_multihost, ckpt, **kw)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("sharded_trainer_rest")
    jt = JaxTrainer(_config(jax_with_overrides, jax_zoo.ZOO["dcn_multihost"], root / "jax", **{
        "train.epochs": 1, "mesh.data_axis_size": 2}), quiet=True)
    assert jt.mesh is not None and jt.model.lane_pack
    jt.train()
    fsdp = {"mesh.dense_sharding": "fsdp"}
    spec = {"runs": [
        ("whole", _port(root / "whole", **fsdp), None),
        ("resumed", _port(root / "resumed", **{"train.resume": True}),
         (str(root / "whole" / "step_0000000001"), str(root / "resumed" / "step_0000000001"))),
        ("from_jax", _port(root / "from_jax", **{"train.resume": True}, **fsdp),
         (str(root / "jax" / "step_0000000001"), str(root / "from_jax" / "step_0000000001"))),
        ("irgan", with_overrides(zoo_configs.irgan_ml100k(), IRGAN), None),
    ]}
    got = run_ranks("trainer", 2, spec, root / "work", timeout=240)
    return root, jt, got


def _assert_states_equal(got, want):
    for key in ("tables", "sparse_opt", "dense", "dense_opt"):
        for (path, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(got[key])[0],
                                     jax.tree_util.tree_flatten_with_path(want[key])[0]):
            np.testing.assert_array_equal(a, b, err_msg=f"{key}{path}")
    assert got["step"] == want["step"]


def test_packed_fsdp_run_trains_and_saves_logical_leaves(runs):
    root, _, got = runs
    whole = got["whole"]
    assert [r["epoch"] for r in whole["history"]] == [0, 1]
    for rec in whole["history"]:
        assert np.isfinite([rec["loss"], rec["auc"], rec["logloss"]]).all()
    assert set(whole["state"]["tables"]) == {"pack_0"}
    # Trainer.params gathers FSDP's blocks: the whole dense leaves.
    for a, b in zip(jax.tree.leaves(whole["dense_params"]), jax.tree.leaves(whole["state"]["dense"])):
        np.testing.assert_array_equal(a, b)
    assert len(jax.tree.leaves(whole["dense_params"])) > 2
    assert whole["state"]["sparse_opt"]["pack_0"]["acc"].shape == (VOCAB, FIELDS)
    # JAX's loader reassembles the blocks: the port's logical packed table.
    tables = jax_ckpt.load_table_arrays(str(root / "whole"))
    np.testing.assert_array_equal(tables["pack_0"][:VOCAB], whole["state"]["tables"]["pack_0"])
    assert checkpoint.read_tree(str(root / "whole"))["process_count"] == 2


def test_resume_under_replicated_dense_ends_as_the_fsdp_run(runs):
    _, _, got = runs
    resumed, whole = got["resumed"], got["whole"]
    assert resumed["start_epoch"] == 1
    drop = {"examples_per_s"}
    assert ({k: v for k, v in resumed["history"][0].items() if k not in drop}
            == {k: v for k, v in whole["history"][1].items() if k not in drop})
    _assert_states_equal(resumed["state"], whole["state"])


def test_a_jax_packed_mesh_checkpoint_resumes_on_two_port_ranks_under_fsdp(runs):
    _, jt, got = runs
    from_jax = got["from_jax"]
    assert from_jax["start_epoch"] == 1
    state = jax.device_get(jt.state)
    restored = from_jax["restored"]
    for name, t in restored["tables"].items():
        np.testing.assert_array_equal(t, np.asarray(state["tables"][name])[:VOCAB], err_msg=name)
        np.testing.assert_array_equal(restored["sparse_opt"][name]["acc"],
                                      np.asarray(state["sparse_opt"][name]["acc"])[:VOCAB], err_msg=name)
    want = jax.tree.leaves(jax.tree.map(np.asarray, state["dense"]))
    for a, b in zip(jax.tree.leaves(restored["dense"]), want):
        np.testing.assert_array_equal(a, b)
    assert np.isfinite(from_jax["history"][0]["auc"])


def test_the_packed_fsdp_checkpoint_resumes_at_world_one(runs, tmp_path):
    root, _, got = runs
    ckpt = tmp_path / "one"
    shutil.copytree(root / "whole", ckpt)
    pt = Trainer(_port(ckpt, **{"train.resume": True, "train.epochs": 3}), quiet=True, device="cpu")
    assert pt.mesh is None and pt.model.lane_pack and pt.start_epoch == 2
    _assert_states_equal(_np(pt.state), got["whole"]["state"])


def test_irgan_trains_on_two_ranks(runs):
    _, _, got = runs
    history = got["irgan"]["history"]
    assert [r["epoch"] for r in history] == [0, 1]
    assert all(np.isfinite(r["loss"]) for r in history) and "recall@5" in history[-1]
