"""Retrieval on a mesh: the port's sharded top-k, row gather and
``ShardedRetrievalEvaluator`` against the JAX package's and the
single-device results, and the trainer, ``Trainer.params`` and serving on
2 ranks, on the CPU.

Two spawns (tests/torch_dist_worker.py): 2 gloo ranks run the parts on a
(2, 1) mesh and then six trainers in turn; 4 ranks run them on (4, 1) and
(2, 2) meshes. ``sharded_topk_dot`` is held against JAX's on a mesh of as
many of its 8 virtual CPU devices (tests/conftest.py), with a bias,
exclusions and a catalog smaller than k (tests/test_parallel.py:211-266 and
:429): ids equal (the scores are untied), values within 1e-5 relative.
``ShardedRetrievalEvaluator`` of MF and GMF under row and col sharding
equals JAX's on the same state and the single-device
``RetrievalEvaluator``'s. The trainers: MF/BPR with the full-catalog eval
under row and col sharding, a resume of the col run's epoch-1 checkpoint
as row, a JAX col checkpoint resumed on the ranks, GMF with the
full-catalog eval, NeuMF with the sampled eval and FM (side fields) with
the interaction AUC; each run's last eval
equals a single-device ``Trainer``'s evaluation of its last checkpoint (the
col checkpoint resumes at world 1 as the ranks' logical state, and in
the JAX package), and
``Trainer.params`` and ``Recommender.from_trainer(...).recommend`` on the
mesh equal the unsharded state's and its single-device ``recommend``.
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from tfrec_tpu import zoo_configs as jax_zoo
from tfrec_tpu.configs import DataConfig as JaxDataConfig
from tfrec_tpu.configs import MeshConfig as JaxMeshConfig
from tfrec_tpu.configs import ModelConfig as JaxModelConfig
from tfrec_tpu.configs import OptimConfig as JaxOptimConfig
from tfrec_tpu.configs import with_overrides as jax_with_overrides
from tfrec_tpu.data.dataset import build_dataset as jax_build_dataset
from tfrec_tpu.models import DataSpec as JaxDataSpec
from tfrec_tpu.models import build_model as jax_build_model
from tfrec_tpu.parallel.eval import ShardedRetrievalEvaluator as JaxShardedEvaluator
from tfrec_tpu.parallel.mesh import make_mesh as jax_make_mesh
from tfrec_tpu.parallel.step import ShardedTrainStepBuilder as JaxShardedBuilder
from tfrec_tpu.parallel.topk import sharded_topk_dot as jax_sharded_topk_dot
from tfrec_tpu.train.step import TrainStepBuilder as JaxTrainStepBuilder
from tfrec_tpu.train.trainer import Trainer as JaxTrainer
from tfrec_tpu_torch import zoo_configs
from tfrec_tpu_torch.configs import DataConfig, ModelConfig, with_overrides
from tfrec_tpu_torch.convert import train_state_from_jax
from tfrec_tpu_torch.data.dataset import build_dataset
from tfrec_tpu_torch.eval.retrieval import RetrievalEvaluator
from tfrec_tpu_torch.models import DataSpec, build_model
from tfrec_tpu_torch.parallel.embedding import pad_vocab
from tfrec_tpu_torch.serve import Recommender
from tfrec_tpu_torch.train.trainer import Trainer
from tfrec_tpu_torch.utils import checkpoint
from torch_dist_worker import _np, run_ranks

torch.set_num_threads(1)

TOPK_V, TOPK_D, TOPK_USERS = 100, 16, 16
TOPK_PAD = pad_vocab(TOPK_V, 8)  # divides by every data axis here
# case: (k, num_items, bias, exclusions)
TOPK_CASES = {"bias": (10, TOPK_V, True, False), "exclusions": (10, TOPK_V, False, True),
              "small_catalog": (10, 6, False, False)}  # k past the catalog
VALUE_RTOL = 1e-5
DATA = dict(source="synthetic_implicit", num_users=60, num_items=90, interactions_per_user=12, seed=3)
EVALS = {"mf": dict(model=dict(name="mf", embed_dim=8)),
         "gmf": dict(model=dict(name="gmf", embed_dim=8))}
KS, USER_BATCH = (5, 10), 16
METRIC_RTOL = 1e-5
SERVE_USERS, SERVE_K = np.arange(0, 60, 3, dtype=np.int32), 7
TINY = {"data.num_users": 64, "data.num_items": 96, "data.interactions_per_user": 16,
        "train.batch_size": 128, "train.eval_user_batch": 32, "train.log_every_steps": 0,
        "train.checkpoint_every_epochs": 1, "mesh.a2a_dtype": "float32"}
MF = {**TINY, "model.embed_dim": 8, "train.epochs": 2, "train.eval_every_epochs": 1,
      "train.eval_topk": (5, 10)}
COL = {"mesh.table_axis_size": 2, "mesh.table_sharding": "col"}


def _rand(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _topk_spec():
    table, bias, users = _rand(1, (TOPK_PAD, TOPK_D)), _rand(2, (TOPK_PAD,)), _rand(3, (TOPK_USERS, TOPK_D))
    dense = users @ table[:TOPK_V].T
    exc_p = np.argsort(-dense, axis=1)[:, :3].astype(np.int32)  # each user's true top 3
    exc_c = np.full((TOPK_USERS,), 3, np.int32)
    ids = np.random.default_rng(4).integers(0, TOPK_V, 40).astype(np.int32)
    return {"table": table, "bias": bias, "users": users, "exc_p": exc_p, "exc_c": exc_c, "ids": ids,
            "cases": TOPK_CASES}


def _jax_eval_model(name):
    ds = jax_build_dataset(JaxDataConfig(**DATA))
    return jax_build_model(JaxModelConfig(**EVALS[name]["model"]),
                           JaxDataSpec.interaction(ds.num_users, ds.num_items)), ds


def _eval_spec():
    out = {}
    for name, ev in EVALS.items():
        model, ds = _jax_eval_model(name)
        jstate = JaxTrainStepBuilder(model, "bpr", JaxOptimConfig()).init_state(jax.random.PRNGKey(1))
        port_model = build_model(ModelConfig(**ev["model"]), DataSpec.interaction(ds.num_users, ds.num_items))
        out[name] = {"model": ev["model"], "data_spec": ("interaction", (ds.num_users, ds.num_items)),
                     "state": _np(train_state_from_jax(jax.tree.map(np.asarray, jstate), port_model)),
                     "modes": ("row", "col"), "ks": KS, "user_batch": USER_BATCH}
    return out


def _cfg(zoo, ckpt, **kw):
    return with_overrides(zoo(), {**TINY, "train.checkpoint_dir": str(ckpt), **kw})


def _jax_col_checkpoint(root):
    """JAX's col mesh (1 x 2 of its devices) on tiny MF, one epoch, its
    checkpoint."""
    cfg = jax_with_overrides(jax_zoo.ZOO["mf_bpr_ml100k"](), {
        **MF, "train.epochs": 1, "train.checkpoint_dir": str(root / "jax_col"),
        "mesh.data_axis_size": 1, **COL})
    jt = JaxTrainer(cfg, quiet=True)
    assert jt.mesh is not None and dict(jt.mesh.shape) == {"data": 1, "table": 2}
    jt.train()
    return jt


def _trainer_spec(root):
    step1 = "step_0000000001"
    return {"runs": [
        ("mf", _cfg(zoo_configs.mf_bpr_ml100k, root / "mf", **MF), None),
        ("mf_col", _cfg(zoo_configs.mf_bpr_ml100k, root / "mf_col", **MF, **COL), None),
        ("mf_col_as_row", _cfg(zoo_configs.mf_bpr_ml100k, root / "mf_col_as_row", **MF,
                               **{"train.resume": True}),
         (str(root / "mf_col" / step1), str(root / "mf_col_as_row" / step1))),
        ("from_jax_col", _cfg(zoo_configs.mf_bpr_ml100k, root / "from_jax_col", **MF, **COL,
                              **{"train.resume": True}),
         (str(root / "jax_col" / step1), str(root / "from_jax_col" / step1))),
        ("neumf", _cfg(zoo_configs.neumf_ml20m, root / "neumf", **{
            "model.gmf_dim": 8, "model.mlp_embed_dim": 8, "model.mlp_dims": (16, 8),
            "train.epochs": 1, "train.eval_num_candidates": 20}), None),
        ("gmf", _cfg(zoo_configs.neumf_ml20m, root / "gmf", **{
            "model.name": "gmf", "model.gmf_dim": 8, "train.epochs": 1, "train.eval_protocol": "full",
            "train.eval_topk": (5, 10)}), None),
        ("fm", _cfg(zoo_configs.fm_ctr_ml1m, root / "fm", **{"model.embed_dim": 8, "train.epochs": 1}),
         None),
    ], "serve": {"mf": (SERVE_USERS, SERVE_K), "mf_col": (SERVE_USERS, SERVE_K)}}


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    """The (2, 1) parts and the trainer runs on 2 ranks."""
    root = tmp_path_factory.mktemp("mesh_retrieval2")
    jt = _jax_col_checkpoint(root)
    spec = {"meshes": (1,), "topk": _topk_spec(), "data": DATA, "evals": _eval_spec(),
            "trainer": _trainer_spec(root)}
    return root, jt, spec, run_ranks("retrieval", 2, spec, root / "work", timeout=240)


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    """The parts on (4, 1) and (2, 2) meshes of 4 ranks."""
    spec = {"meshes": (1, 2), "topk": _topk_spec(), "data": DATA, "evals": _eval_spec()}
    return spec, run_ranks("retrieval", 4, spec, tmp_path_factory.mktemp("mesh_retrieval4"), timeout=200)


@pytest.fixture(params=["two", "four"])
def parts(request):
    """(spec, {"NxT": rank 0's results}) of each spawn."""
    got = request.getfixturevalue(request.param)
    spec, res = (got[2], got[3]) if request.param == "two" else got
    return spec, {k: v for k, v in res.items() if k != "trainer"}


def _put(mesh, x, spec):
    return jax.device_put(jnp.asarray(x), NamedSharding(mesh, spec))


def test_sharded_topk_matches_jax(parts):
    spec, res = parts
    tk = spec["topk"]
    for key, got in res.items():
        n, t = (int(x) for x in key.split("x"))
        mesh = jax_make_mesh(n, t)
        for case, (k, num_items, with_bias, excl) in TOPK_CASES.items():
            kw = {}
            if with_bias:
                kw["item_bias"] = _put(mesh, tk["bias"], P("data"))
            if excl:
                kw.update(exclude_padded=jnp.asarray(tk["exc_p"]), exclude_counts=jnp.asarray(tk["exc_c"]))
            want_v, want_i = jax.jit(lambda u, tb, kw=kw, k=k, ni=num_items: jax_sharded_topk_dot(
                mesh, u, tb, k, ni, **kw))(jnp.asarray(tk["users"]), _put(mesh, tk["table"], P("data", None)))
            vals, ids = got[case]
            np.testing.assert_array_equal(ids, np.asarray(want_i), err_msg=f"{key} {case}")
            np.testing.assert_allclose(vals, np.asarray(want_v), rtol=VALUE_RTOL, err_msg=f"{key} {case}")
            if excl:
                assert not any(set(tk["exc_p"][u]) & set(ids[u]) for u in range(TOPK_USERS))
            if case == "small_catalog":
                assert ids.max() == num_items  # empty slots carry the sentinel
        dense = tk["users"] @ tk["table"][:TOPK_V].T + tk["bias"][:TOPK_V][None, :]
        want = np.argsort(-dense, axis=1)[:, :10]
        np.testing.assert_array_equal(got["bias"][1], want)  # the full sort's
        np.testing.assert_array_equal(got["row_gather"], tk["table"][tk["ids"]])


def test_sharded_retrieval_eval_matches_jax_and_the_single_device_eval(parts):
    spec, res = parts
    port_ds = build_dataset(DataConfig(**DATA))
    seen = 0
    for key, got in res.items():
        n, t = (int(x) for x in key.split("x"))
        mode = "col" if t > 1 else "row"
        for name in EVALS:
            metrics = got[f"eval_{name}_{mode}"]
            model, ds = _jax_eval_model(name)
            jb = JaxShardedBuilder(model, "bpr", JaxOptimConfig(), jax_make_mesh(n, t),
                                   JaxMeshConfig(table_sharding=mode))
            want = JaxShardedEvaluator(jb, model, ds, ks=KS, user_batch=USER_BATCH)(
                jb.init_state(jax.random.PRNGKey(1)))
            assert metrics.keys() == want.keys()
            for k in want:
                np.testing.assert_allclose(metrics[k], want[k], rtol=METRIC_RTOL, err_msg=f"{key} {name} {k}")
            ev = spec["evals"][name]
            port_model = build_model(ModelConfig(**ev["model"]), DataSpec.interaction(*ev["data_spec"][1]))
            params = {"tables": {k: torch.from_numpy(v) for k, v in ev["state"]["tables"].items()},
                      "dense": jax.tree.map(torch.from_numpy, ev["state"]["dense"])}
            single = RetrievalEvaluator(port_model.score_all, port_ds, KS, USER_BATCH, device="cpu")(params)
            for k in single:
                np.testing.assert_allclose(metrics[k], single[k], rtol=METRIC_RTOL, err_msg=f"{key} {name} {k}")
            seen += 1
    assert seen == 2 * len(res)


# ---- the trainer on 2 ranks ----

def _single_device_eval(cfg, **kw):
    """A single-device Trainer's state and evaluation of the run's last
    checkpoint."""
    cfg = with_overrides(cfg, {"train.resume": True, "mesh.table_axis_size": 1,
                               "mesh.table_sharding": "row", **kw})
    trainer = Trainer(cfg, quiet=True, device="cpu")
    assert trainer.mesh is None and trainer.start_epoch == cfg.train.epochs
    return trainer, trainer.evaluate()


def _metrics(rec):
    return {k: v for k, v in rec.items() if k not in ("epoch", "loss", "examples_per_s")}


@pytest.mark.parametrize("name,keys", [
    ("mf", {"recall@10", "ndcg@10", "precision@5", "map@10", "mrr@10"}),
    ("mf_col", {"recall@10", "ndcg@10"}),
    ("neumf", {"hr@10", "ndcg_sampled@10", "auc"}),
    ("gmf", {"recall@10", "ndcg@10"}),
    ("fm", {"auc"}),
])
def test_mesh_trainers_evaluate_as_one_device_does_on_their_checkpoint(two, name, keys):
    """MF's and GMF's full-catalog eval (ShardedRetrievalEvaluator on the
    live row or column blocks; GMF's query transform, under rowwise Adam),
    NeuMF's sampled eval on Trainer.params and FM's
    interaction AUC split over the data axis: each run's last record is a
    single-device Trainer's evaluation of its last checkpoint."""
    root, _, spec, got = two
    run = got["trainer"][name]
    cfg = dict((n, c) for n, c, _ in spec["trainer"]["runs"])[name]
    assert run["mesh"] == ({"data": 1, "table": 2} if name == "mf_col" else {"data": 2, "table": 1})
    history = run["history"]
    assert [r["epoch"] for r in history] == list(range(cfg.train.epochs))
    assert keys <= set(history[-1]) and np.isfinite(list(_metrics(history[-1]).values())).all()
    trainer, single = _single_device_eval(cfg)
    assert _metrics(history[-1]).keys() == single.keys()
    for k, v in single.items():
        np.testing.assert_allclose(history[-1][k], v, rtol=METRIC_RTOL, err_msg=k)
    for k, v in _np(trainer.state["tables"]).items():  # the col checkpoint resumes at world 1
        np.testing.assert_array_equal(v, run["state"]["tables"][k], err_msg=k)


@pytest.mark.parametrize("name", ["mf", "mf_col"])
def test_params_and_recommend_on_a_mesh_are_the_unsharded_states(two, name):
    root, _, spec, got = two
    run = got["trainer"][name]
    for k, v in run["state"]["tables"].items():
        np.testing.assert_array_equal(run["params"]["tables"][k], v, err_msg=k)
    cfg = dict((n, c) for n, c, _ in spec["trainer"]["runs"])[name]
    ds = build_dataset(cfg.data)
    model = build_model(cfg.model, DataSpec.interaction(ds.num_users, ds.num_items))
    params = {"tables": {k: torch.from_numpy(v) for k, v in run["state"]["tables"].items()},
              "dense": {}}
    want_ids, want_vals = Recommender(model, params, dataset=ds, device="cpu").recommend(SERVE_USERS, SERVE_K)
    ids, vals = run["recommend"]
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_allclose(vals, want_vals, rtol=VALUE_RTOL)


def test_a_col_checkpoint_resumes_as_row_on_the_ranks(two):
    root, _, _, got = two
    run = got["trainer"]["mf_col_as_row"]
    assert run["start_epoch"] == 1 and run["mesh"] == {"data": 2, "table": 1}
    assert [r["epoch"] for r in run["history"]] == [1] and np.isfinite(run["history"][0]["recall@10"])
    flat = checkpoint.restore_checkpoint(str(root / "mf_col_as_row"), None, 1)
    tree = checkpoint.read_tree(str(root / "mf_col_as_row"), 1)
    assert tree["process_count"] == 1  # the logical state, written by rank 0
    for k, v in run["restored"]["tables"].items():
        np.testing.assert_array_equal(v, flat[f"tables/{k}"], err_msg=k)
        np.testing.assert_array_equal(run["restored"]["sparse_opt"][k]["acc"], flat[f"sparse_opt/{k}/acc"])


def test_a_jax_col_checkpoint_resumes_on_port_ranks(two):
    _, jt, _, got = two
    run = got["trainer"]["from_jax_col"]
    assert run["start_epoch"] == 1 and run["mesh"] == {"data": 1, "table": 2}
    state = jax.device_get(jt.state)
    for name, t in run["restored"]["tables"].items():
        np.testing.assert_array_equal(t, np.asarray(state["tables"][name]), err_msg=name)
        np.testing.assert_array_equal(run["restored"]["sparse_opt"][name]["acc"],
                                      np.asarray(state["sparse_opt"][name]["acc"]), err_msg=name)
    assert run["restored"]["step"] == int(state["step"])
    assert np.isfinite(run["history"][-1]["recall@10"])


def test_a_table_axis_needs_its_ranks():
    """One process cannot hold a table axis of 2: refused, naming the ranks
    the mesh needs."""
    with pytest.raises(ValueError, match="needs a multiple of as many ranks"):
        Trainer(_cfg(zoo_configs.mf_bpr_ml100k, "", **MF, **COL), quiet=True, device="cpu")


def test_serving_a_sharded_state_takes_its_builder():
    """A mesh or a state alone says nothing of the layout: refused."""
    model = build_model(ModelConfig(name="mf", embed_dim=4), DataSpec.interaction(5, 6))
    with pytest.raises(ValueError, match="takes mesh=, state= and the builder="):
        Recommender(model, None, mesh=object(), state={"tables": {}}, device="cpu")


def test_a_col_checkpoint_of_the_ranks_resumes_in_jax(two, tmp_path):
    """The logical state that rank 0 wrote for the (1, 2) mesh resumes in
    the JAX package on one device, leaf for leaf."""
    root, _, _, got = two
    run = got["trainer"]["mf_col"]
    ckpt = tmp_path / "mf_col"
    shutil.copytree(root / "mf_col", ckpt)
    cfg = jax_with_overrides(jax_zoo.ZOO["mf_bpr_ml100k"](), {
        **MF, "train.epochs": 3, "train.resume": True, "train.checkpoint_dir": str(ckpt),
        "mesh.data_axis_size": 0})
    jt = JaxTrainer(cfg, quiet=True)
    assert jt.mesh is None and jt.start_epoch == 2
    state = jax.device_get(jt.state)
    for name, t in run["state"]["tables"].items():
        np.testing.assert_array_equal(np.asarray(state["tables"][name]), t, err_msg=name)
        np.testing.assert_array_equal(np.asarray(state["sparse_opt"][name]["acc"]),
                                      run["state"]["sparse_opt"][name]["acc"], err_msg=name)
    assert int(state["step"]) == run["state"]["step"]
