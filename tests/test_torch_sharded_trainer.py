"""Config 5's trainer on N ranks: ``trainer.run(dcn_multihost())`` (cut to a
tiny size) on 2 ranks over gloo (tests/torch_dist_worker.py), with a
checkpoint an epoch, against the JAX package on the same checkpoints.

One spawn runs seven trainers in turn: the whole run; a resume from its
epoch-1 checkpoint, which must end bit for bit as the whole run; a resume
from a JAX mesh checkpoint (2 of the 8 virtual CPU devices,
tests/conftest.py), which must restore JAX's state exactly; the whole run
under ``mesh.row_permute`` with a resume from its epoch-1 checkpoint, both
bit for bit the unpermuted run (a change of layout only); a warm start
from the whole run's tables (``train.init_from``); and a run whose
capacity drops ids, which must say so; the single-device path
(``mesh.data_axis_size=0``) is refused on the 2 ranks. The 2-rank
checkpoint is then read by JAX's ``load_table_arrays`` equal to the port's
logical tables and resumes in this process at world 1 (the single-device
path), each leaf as saved; the permuted one is refused there.
"""

import json
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
        "model.embed_dim": 4, "model.mlp_dims": (16,), "train.batch_size": 256,
        "train.steps_per_dispatch": 2, "train.checkpoint_every_epochs": 1, "train.log_every_steps": 0}


def _config(with_overrides_fn, zoo_fn, ckpt, **kw):
    return with_overrides_fn(zoo_fn(), {**TINY, "train.checkpoint_dir": str(ckpt), **kw})


def _port(ckpt, **kw):
    return _config(with_overrides, zoo_configs.dcn_multihost, ckpt, **kw)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("sharded_trainer")
    # JAX's mesh path on 2 of its 8 devices, one epoch, its checkpoint.
    jt = JaxTrainer(_config(jax_with_overrides, jax_zoo.ZOO["dcn_multihost"], root / "jax", **{
        "train.epochs": 1, "mesh.data_axis_size": 2}), quiet=True)
    assert jt.mesh is not None and jt.mesh.shape["data"] == 2
    jt.train()
    spec = {"runs": [
        ("whole", _port(root / "whole"), None),
        ("resumed", _port(root / "resumed", **{"train.resume": True}),
         (str(root / "whole" / "step_0000000001"), str(root / "resumed" / "step_0000000001"))),
        ("from_jax", _port(root / "from_jax", **{"train.resume": True}),
         (str(root / "jax" / "step_0000000001"), str(root / "from_jax" / "step_0000000001"))),
        ("permuted", _port(root / "permuted", **{"mesh.row_permute": True}), None),
        ("permuted_resumed", _port(root / "permuted_resumed", **{"mesh.row_permute": True,
                                                                  "train.resume": True}),
         (str(root / "permuted" / "step_0000000001"), str(root / "permuted_resumed" / "step_0000000001"))),
        ("warm", _port(root / "warm", **{"train.init_from": str(root / "whole"), "train.epochs": 1}), None),
        ("dropping", _port(root / "dropping", **{"mesh.a2a_capacity_factor": 0.1, "train.epochs": 1}), None),
    ], "refused": [("single_path", _port(root / "single_path", **{"mesh.data_axis_size": 0}))]}
    got = run_ranks("trainer", 2, spec, root / "work", timeout=240)
    return root, jt, got


def _assert_states_equal(got, want):
    for key in ("tables", "sparse_opt", "dense", "dense_opt"):
        for (path, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(got[key])[0],
                                     jax.tree_util.tree_flatten_with_path(want[key])[0]):
            np.testing.assert_array_equal(a, b, err_msg=f"{key}{path}")
    assert got["step"] == want["step"]


def test_two_ranks_train_and_checkpoint_in_the_reference_layout(runs):
    root, _, got = runs
    whole = got["whole"]
    assert [r["epoch"] for r in whole["history"]] == [0, 1]
    for rec in whole["history"]:
        assert np.isfinite([rec["loss"], rec["auc"], rec["logloss"]]).all() and "eval_lookup_overflow" not in rec
    tree = checkpoint.read_tree(str(root / "whole"))
    assert (tree["process_count"], tree["device_count"], tree["row_permute"]) == (2, 2, False)
    # JAX's loader reassembles the ranks' blocks: the port's logical tables.
    tables = jax_ckpt.load_table_arrays(str(root / "whole"))
    assert set(tables) == set(whole["state"]["tables"]) and len(tables) == FIELDS
    for name, t in whole["state"]["tables"].items():
        np.testing.assert_array_equal(tables[name][:VOCAB], t)
        assert not tables[name][VOCAB:].any()  # the pad rows


def test_a_resume_at_world_two_ends_as_the_whole_run(runs):
    _, _, got = runs
    resumed, whole = got["resumed"], got["whole"]
    assert resumed["start_epoch"] == 1 and [r["epoch"] for r in resumed["history"]] == [1]
    drop = {"examples_per_s"}
    assert ({k: v for k, v in resumed["history"][0].items() if k not in drop}
            == {k: v for k, v in whole["history"][1].items() if k not in drop})
    _assert_states_equal(resumed["state"], whole["state"])


def test_the_checkpoint_of_two_ranks_resumes_at_world_one(runs, tmp_path):
    root, _, got = runs
    ckpt = tmp_path / "one"
    shutil.copytree(root / "whole", ckpt)
    pt = Trainer(_port(ckpt, **{"train.resume": True, "train.epochs": 3}), quiet=True, device="cpu")
    assert pt.mesh is None and pt.start_epoch == 2
    _assert_states_equal(_np(pt.state), got["whole"]["state"])
    history = pt.train()
    assert [r["epoch"] for r in history] == [2] and np.isfinite(history[0]["auc"])


def test_a_jax_mesh_checkpoint_resumes_on_two_port_ranks(runs):
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
    assert restored["step"] == int(state["step"])
    assert [r["epoch"] for r in from_jax["history"]] == [1] and np.isfinite(from_jax["history"][0]["auc"])


def test_row_permute_trains_and_resumes_as_the_plain_layout(runs, tmp_path):
    root, _, got = runs
    drop = {"examples_per_s"}
    tree = checkpoint.read_tree(str(root / "permuted"))
    assert tree["row_permute"] is True and tree["row_permute_shards"] == 2
    assert got["permuted_resumed"]["start_epoch"] == 1
    for name in ("permuted", "permuted_resumed"):
        want = got["whole"]["history"][-len(got[name]["history"]):]
        assert ([{k: v for k, v in r.items() if k not in drop} for r in got[name]["history"]]
                == [{k: v for k, v in r.items() if k not in drop} for r in want]), name
        _assert_states_equal(got[name]["state"], got["whole"]["state"])
    # One device cannot read the permuted rows: refused, by the flag or the layout.
    ckpt = tmp_path / "permuted"
    shutil.copytree(root / "permuted", ckpt)
    with pytest.raises(ValueError, match="row_permute requires the sharded"):
        Trainer(_port(ckpt, **{"train.resume": True, "mesh.row_permute": True}), quiet=True,
                device="cpu")
    with pytest.raises(ValueError, match="row_permute=True but this run has mesh.row_permute=False"):
        Trainer(_port(ckpt, **{"train.resume": True}), quiet=True, device="cpu")


def test_a_warm_start_on_two_ranks_takes_the_tables(runs):
    _, _, got = runs
    warm = got["warm"]
    assert warm["start_epoch"] == 0
    for name, t in got["whole"]["state"]["tables"].items():
        np.testing.assert_array_equal(warm["restored"]["tables"][name], t, err_msg=name)
    assert warm["restored"]["step"] == 0  # the tables only, not the optimizer


def test_ids_over_capacity_are_dropped_loudly(runs):
    """Activations of dropped ids read 0 and their gradients are not sent:
    counted in the eval record and, for training, in the stream."""
    root, _, got = runs
    rec = got["dropping"]["history"][-1]
    assert rec["eval_lookup_overflow"] > 0 and np.isfinite(rec["auc"])
    stream = [json.loads(line) for line in
              (root / "dropping" / "dcn_multihost.metrics.jsonl").read_text().splitlines()]
    events = [e for e in stream if e.get("event") == "lookup_overflow"]
    assert len(events) == 1 and events[0]["dropped_ids"] > 0 and 0 < events[0]["drop_rate"] < 1


def test_the_single_device_path_is_refused_on_two_ranks(runs):
    """``mesh.data_axis_size=0`` on 2 ranks would make each rank a lone
    lead writing the stream and checkpoints into one directory: every rank
    refuses it, and nothing is written."""
    root, _, got = runs
    assert "mesh.data_axis_size=0 (the single-device path) on 2 ranks" in got["single_path"]
    assert not (root / "single_path").exists()
