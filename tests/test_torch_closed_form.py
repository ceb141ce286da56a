"""The port's closed-form zoo (WRMF by ALS, EASE) against the JAX package,
on the CPU.

- ``padded_lists`` bit for bit; one ALS half-sweep and a whole sweep's
  exact objective from one loaded state; the objective falling over 3
  sweeps and equal to the dense sum it stands for; the sweep with its
  solves split over 2 gloo ranks (``tests/torch_dist_worker.py``) against
  one rank's, and the trainer there (rank 0's stream and checkpoints);
- EASE's solution (an exactly zero diagonal) and objective; its two
  dense-size refusals;
- ``predict`` at the catalog scores' entries, the sampled eval, and the
  trainers' metric streams against JAX's from one state;
- checkpoints across packages: a JAX checkpoint of each resumed and served
  in the port, the port's restored by JAX.
"""

import dataclasses
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tfrec_tpu.configs as jax_configs
from tfrec_tpu.data.dataset import build_dataset as jax_build_dataset
from tfrec_tpu.eval.sampled import SampledEvaluator as JaxSampledEvaluator
from tfrec_tpu.models import DataSpec as JaxDataSpec
from tfrec_tpu.models.ease import EASE as JaxEASE
from tfrec_tpu.models.ease import EASETrainer as JaxEASETrainer
from tfrec_tpu.serve import Recommender as JaxRecommender
from tfrec_tpu.train import als as jax_als
from tfrec_tpu.train.trainer import Trainer as JaxTrainer
from tfrec_tpu.utils import checkpoint as jax_ckpt
from tfrec_tpu_torch import configs
from tfrec_tpu_torch.data.dataset import build_dataset
from tfrec_tpu_torch.eval.sampled import SampledEvaluator
from tfrec_tpu_torch.models import EASE, WRMF, DataSpec, build_model
from tfrec_tpu_torch.models.ease import EASETrainer
from tfrec_tpu_torch.serve import Recommender
from tfrec_tpu_torch.train import als
from tfrec_tpu_torch.train.trainer import Trainer
from torch_dist_worker import run_ranks

torch.set_num_threads(1)

SWEEP_RTOL, SWEEP_ATOL = 1e-4, 1e-6  # batched solves in another order
OBJ_RTOL = 1e-5
SHARD_RTOL = 1e-5
EASE_RTOL, EASE_ATOL = 1e-4, 1e-6
ALPHA, REG, DIM = 10.0, 0.05, 8
DATA = dict(source="synthetic_implicit", num_users=40, num_items=64, interactions_per_user=10, seed=2)


def _datasets(**kw):
    d = dict(DATA, **kw)
    return build_dataset(configs.DataConfig(**d)), jax_build_dataset(jax_configs.DataConfig(**d))


def _state(ds, seed=0):
    rng = np.random.default_rng(seed)
    return {"user_emb": (rng.normal(size=(ds.num_users, DIM)) / np.sqrt(DIM)).astype(np.float32),
            "item_emb": (rng.normal(size=(ds.num_items, DIM)) / np.sqrt(DIM)).astype(np.float32)}


def _tensors(d):
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


# ---- ALS ----

def test_padded_lists_matches_jax():
    """Rows with no entry, repeated entries, and the widest row setting H."""
    rng = np.random.default_rng(3)
    rows = rng.integers(0, 12, 80).astype(np.int32)
    rows[rows == 5] = 6  # row 5 empty
    rows[:9] = 11
    cols = rng.integers(0, 30, 80).astype(np.int32)
    for args in ((rows, cols, 14, 30), (rows[:0], cols[:0], 3, 30)):
        got, want = als.padded_lists(*args), jax_als.padded_lists(*args)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype == np.int32
            np.testing.assert_array_equal(a, b)
    hist, lens = got = als.padded_lists(rows, cols, 14, 30)
    assert lens[5] == 0 and (hist[5] == 30).all() and hist.shape[1] == lens.max()


@pytest.mark.parametrize("batch", [16, 1024])
def test_half_sweep_and_objective_match_jax(batch):
    """The padded batches are JAX's; from one loaded state, the users'
    half-sweep (padding rows solved to 0) and then a whole sweep with its
    exact objective."""
    port_ds, ref_ds = _datasets()
    ours = als.ALSTrainer(port_ds, DIM, ALPHA, REG, batch=batch)
    ref = jax_als.ALSTrainer(ref_ds, DIM, ALPHA, REG, batch=batch)
    for a, b in ((ours.u_hist, ref.u_hist), (ours.i_hist, ref.i_hist)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    state = _state(port_ds)
    ours.load(_tensors(state))
    ref.load({k: jnp.asarray(v) for k, v in state.items()})
    got = ours.sweep(ours.y, ours.u_hist)
    want = np.asarray(ref.sweep(ref.y, ref.u_hist))
    assert got.shape == want.shape == (ours.u_hist.shape[0] * ours.u_hist.shape[1], DIM)
    np.testing.assert_allclose(got.numpy(), want, rtol=SWEEP_RTOL, atol=SWEEP_ATOL)
    assert not got[port_ds.num_users:].any()
    np.testing.assert_allclose(ours.epoch()["loss"], ref.epoch()["loss"], rtol=OBJ_RTOL)
    for a, b in ((ours.x, ref.x), (ours.y, ref.y)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=SWEEP_RTOL, atol=SWEEP_ATOL)


def test_objective_falls_over_three_sweeps_and_is_the_dense_sum():
    port_ds, _ = _datasets()
    ours = als.ALSTrainer(port_ds, DIM, ALPHA, REG, batch=16, seed=3)
    losses = [ours.epoch()["loss"] for _ in range(3)]
    assert losses[0] > losses[1] > losses[2] > 0, losses
    x, y = ours.x.double().numpy(), ours.y.double().numpy()
    p = (port_ds.train_csr > 0).toarray()
    s = x @ y.T
    dense = ((1 + ALPHA * p) * (p - s) ** 2).sum() + REG * ((x * x).sum() + (y * y).sum())
    np.testing.assert_allclose(losses[-1], dense, rtol=OBJ_RTOL)


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """One sweep and the wrmf trainer, their solves split over 2 gloo ranks."""
    work = tmp_path_factory.mktemp("als")
    port_ds, _ = _datasets()
    cfg = _config(configs, "wrmf", str(work / "ckpt"), epochs=3)
    spec = {"data": DATA, "als": dict(embed_dim=DIM, alpha=ALPHA, reg=REG, batch=16),
            "state": _state(port_ds, 5), "trainer": cfg.replace(mesh=dataclasses.replace(cfg.mesh,
                                                                                         data_axis_size=-1))}
    return run_ranks("als", 2, spec, work, timeout=120.0), spec, cfg


def test_sharded_sweep_matches_one_rank(sharded):
    out, spec, _ = sharded
    port_ds, _ = _datasets()
    one = als.ALSTrainer(port_ds, DIM, ALPHA, REG, batch=16)
    one.load(_tensors(spec["state"]))
    loss = one.epoch()["loss"]
    np.testing.assert_allclose(out["x"], one.x.numpy(), rtol=SHARD_RTOL, atol=SWEEP_ATOL)
    np.testing.assert_allclose(out["y"], one.y.numpy(), rtol=SHARD_RTOL, atol=SWEEP_ATOL)
    np.testing.assert_allclose(out["loss"], loss, rtol=SHARD_RTOL)


def test_trainer_on_two_ranks_matches_one(sharded):
    """On 2 ranks the solver takes the data axis and rank 0 writes the
    checkpoints; the history is one rank's."""
    out, _, cfg = sharded
    run = out["trainer"]
    assert run["solver_mesh"] == {"data": 2, "table": 1} and run["steps"] == [1, 2, 3]
    trainer = Trainer(cfg.replace(train=dataclasses.replace(cfg.train, checkpoint_dir=None)), quiet=True,
                      device="cpu")
    history = trainer.train()
    assert len(history) == len(run["history"]) == 3
    for g, w in zip(run["history"], history):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=SHARD_RTOL)
    for name, table in trainer.state["tables"].items():
        np.testing.assert_allclose(run["tables"][name], table.numpy(), rtol=SHARD_RTOL, atol=SWEEP_ATOL)


# ---- EASE ----

def test_ease_solution_matches_jax():
    port_ds, ref_ds = _datasets()
    spec = DataSpec.interaction(port_ds.num_users, port_ds.num_items)
    ours = EASETrainer(port_ds, EASE(spec, reg=30.0), 30.0)
    ref = JaxEASETrainer(ref_ds, JaxEASE(JaxDataSpec.interaction(ref_ds.num_users, ref_ds.num_items), reg=30.0),
                         30.0)
    np.testing.assert_array_equal(ours.x.numpy(), np.asarray(ref.x))
    got, want = ours.epoch()["loss"], ref.epoch()["loss"]
    np.testing.assert_allclose(got, want, rtol=EASE_RTOL)
    bt = ours.tables()["ease_bt"]
    np.testing.assert_allclose(bt.numpy(), np.asarray(ref.tables()["ease_bt"]), rtol=EASE_RTOL, atol=EASE_ATOL)
    assert bt.is_contiguous() and (torch.diagonal(bt) == 0).all() and bt.abs().max() > 1e-3


def test_ease_refuses_dense_sizes_as_jax_does():
    for kw, spec in (({"max_items": 63}, (10, 64)), ({}, (1 << 14, 1 << 15))):
        for cls, ds in ((EASE, DataSpec), (JaxEASE, JaxDataSpec)):
            with pytest.raises(ValueError, match="max_items" if kw else "f32 elements"):
                cls(ds.interaction(*spec), **kw)
    assert EASE.MAX_ITEMS == JaxEASE.MAX_ITEMS and EASE.MAX_ELEMENTS == JaxEASE.MAX_ELEMENTS
    with pytest.raises(ValueError, match="train matrix"):
        EASE(DataSpec.interaction(4, 5)).pointwise_batch_extras(torch.zeros(1, dtype=torch.int32))


# ---- the trainers, serving and checkpoints ----

@pytest.fixture
def no_tensorboard(monkeypatch):
    """JAX's metric stream without its optional TensorBoard writer, whose
    import costs more than these runs."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


def _config(mod, name, ckpt_dir=None, epochs=3, **train):
    model = (dict(name="wrmf", embed_dim=DIM, wrmf_alpha=ALPHA, wrmf_reg=REG) if name == "wrmf"
             else dict(name="ease", ease_reg=30.0))
    kw = dict(batch_size=16, epochs=epochs if name == "wrmf" else 1, eval_every_epochs=1, eval_topk=(5, 10),
              loss=name, checkpoint_dir=ckpt_dir, checkpoint_every_epochs=1 if ckpt_dir else 0)
    kw.update(train)
    return mod.Config(run_name=name, data=mod.DataConfig(**DATA), model=mod.ModelConfig(**model),
                      train=mod.TrainConfig(**kw),
                      mesh=mod.MeshConfig(data_axis_size=0))  # JAX's single device under its 8 CPU devices


def _records(path):
    out = []
    for line in path.read_text().splitlines():
        rec = json.loads(line)
        rec.pop("wall_s")
        rec.pop("examples_per_s", None)
        if rec.get("event") == "run_config":
            rec["config"]["train"]["checkpoint_dir"] = None
        out.append(rec)
    return out


@pytest.mark.parametrize("name", ["wrmf", "ease"])
def test_trainer_matches_jax_and_serves(tmp_path, no_tensorboard, name):
    """From JAX's initial factors: the metric streams (exact objectives,
    full-catalog metrics each epoch) match; ``predict`` (EASE's through
    the gather of ``ease_bt``) gives the catalog scores' entries, and
    ``from_checkpoint`` serves bit for bit as ``from_trainer``."""
    jt = JaxTrainer(_config(jax_configs, name, str(tmp_path / "jax")), quiet=True)
    cfg = _config(configs, name, str(tmp_path / "port"))
    pt = Trainer(cfg, quiet=True, device="cpu")
    assert pt.builder is None and pt.sampler is None and pt.loss_name == name
    pt.solver.load(_tensors(jax.tree.map(np.asarray, jt.solver.tables())))
    hist = pt.train()
    jt.train()
    got, want = _records(tmp_path / "port" / f"{name}.metrics.jsonl"), _records(tmp_path / "jax" / f"{name}.metrics.jsonl")
    assert len(got) == len(want) and [r.get("epoch") for r in got] == [r.get("epoch") for r in want]
    for g, w in zip(got, want):
        assert g.keys() == w.keys(), (g, w)
        for k in g:
            if k == "loss":
                np.testing.assert_allclose(g[k], w[k], rtol=OBJ_RTOL if name == "wrmf" else EASE_RTOL)
            elif "@" in k:
                np.testing.assert_allclose(g[k], w[k], atol=1e-6, err_msg=k)
            else:
                assert g[k] == w[k], k
    if name == "wrmf":
        assert hist[0]["loss"] > hist[1]["loss"] > hist[2]["loss"]
    live, disk = Recommender.from_trainer(pt), Recommender.from_checkpoint(cfg, device="cpu")
    users = np.array([0, 5, 5, 39], np.int32)
    items = np.array([1, 2, 63, 40], np.int32)
    scores = live.score_catalog(users)
    np.testing.assert_allclose(live.predict(users, items), scores[np.arange(4), items], rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(disk.predict(users, items), live.predict(users, items))
    for a, b in zip(disk.recommend(users, 10), live.recommend(users, 10)):
        np.testing.assert_array_equal(a, b)
    jrec = JaxRecommender.from_trainer(jt)
    np.testing.assert_allclose(live.predict(users, items), np.asarray(jrec.predict(users, items)),
                               rtol=EASE_RTOL, atol=1e-5)


@pytest.mark.parametrize("name", ["wrmf", "ease"])
def test_sampled_eval_matches_jax(name):
    """EASE through ``score_user_items`` (its catalog row), WRMF through
    its pointwise forward, at the same tables: JAX's HR and NDCG."""
    port_ds, ref_ds = _datasets()
    spec = (port_ds.num_users, port_ds.num_items)
    if name == "ease":
        model, ref_model = EASE(DataSpec.interaction(*spec), reg=30.0), JaxEASE(JaxDataSpec.interaction(*spec), reg=30.0)
        solver, jsolver = EASETrainer(port_ds, model, 30.0), JaxEASETrainer(ref_ds, ref_model, 30.0)
        jsolver.epoch()
        tables = jax.tree.map(np.asarray, jsolver.tables())
        solver.load(_tensors(tables))
    else:
        model, ref_model = WRMF(DataSpec.interaction(*spec), DIM), None
        tables = _state(port_ds, 7)
        from tfrec_tpu.models.wrmf import WRMF as JaxWRMF
        ref_model = JaxWRMF(JaxDataSpec.interaction(*spec), DIM)
    ours = SampledEvaluator(model, port_ds, ks=(5, 10), num_candidates=20, seed=4, user_batch=16, device="cpu")
    ref = JaxSampledEvaluator(ref_model, ref_ds, ks=(5, 10), num_candidates=20, seed=4, user_batch=16)
    got = ours({"tables": _tensors(tables), "dense": {}})
    want = ref({"tables": {k: jnp.asarray(v) for k, v in tables.items()}, "dense": {}})
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_allclose(got[k], float(want[k]), atol=1e-6, err_msg=k)


@pytest.mark.parametrize("name", ["wrmf", "ease"])
def test_checkpoints_cross_packages(tmp_path, no_tensorboard, name):
    """JAX's checkpoint of epoch 1 serves in the port as JAX serves it, and
    resumes there to end where JAX's 2-epoch run ends (WRMF's second sweep);
    JAX resumes the port's checkpoint, EASE's train matrix with it."""
    jax_dir = str(tmp_path / "jax")
    jt = JaxTrainer(_config(jax_configs, name, jax_dir, epochs=1), quiet=True)
    jt.train()
    disk = Recommender.from_checkpoint(_config(configs, name, jax_dir, epochs=1), device="cpu")
    users, items = np.array([0, 3, 39], np.int32), np.array([5, 6, 63], np.int32)
    np.testing.assert_allclose(disk.predict(users, items), np.asarray(JaxRecommender.from_trainer(jt).predict(
        users, items)), rtol=1e-6, atol=1e-6)
    epochs = 2 if name == "wrmf" else 1
    pt = Trainer(_config(configs, name, jax_dir, epochs=epochs, resume=True), quiet=True, device="cpu",
                 log_metrics=False)
    assert pt.start_epoch == 1
    pt.train()
    whole = JaxTrainer(_config(jax_configs, name, None, epochs=epochs), quiet=True)
    whole.train()
    for k, v in whole.state["tables"].items():
        np.testing.assert_allclose(pt.state["tables"][k].numpy(), np.asarray(v), rtol=SWEEP_RTOL,
                                   atol=SWEEP_ATOL, err_msg=k)
    port_dir = str(tmp_path / "port")
    Trainer(_config(configs, name, port_dir, epochs=epochs), quiet=True, device="cpu").train()
    mine = Trainer(_config(configs, name, port_dir, epochs=epochs, resume=True), quiet=True, device="cpu",
                   log_metrics=False)
    back = JaxTrainer(_config(jax_configs, name, port_dir, epochs=epochs, resume=True), quiet=True,
                      log_metrics=False)
    assert back.start_epoch == mine.start_epoch == epochs
    for k, v in mine.state["tables"].items():
        np.testing.assert_array_equal(np.asarray(back.state["tables"][k]), v.numpy(), err_msg=k)
    if name == "ease":
        np.testing.assert_array_equal(np.asarray(back.model._x), mine.model._x.numpy())


def test_build_model_and_zoo_configs():
    from tfrec_tpu import zoo_configs as jax_zoo
    from tfrec_tpu_torch import zoo_configs as zoo

    spec = DataSpec.interaction(6, 9)
    assert isinstance(build_model(configs.ModelConfig(name="wrmf", embed_dim=4), spec), WRMF)
    ease = build_model(configs.ModelConfig(name="ease", ease_reg=7.0), spec)
    assert isinstance(ease, EASE) and ease.reg == 7.0 and ease.table_specs() == ()
    for name in ("wrmf_ml100k", "ease_ml100k"):
        assert zoo.ZOO[name] is getattr(zoo, name)
        assert dataclasses.asdict(zoo.ZOO[name]()) == dataclasses.asdict(getattr(jax_zoo, name)())
        assert dataclasses.asdict(zoo.ZOO[name]("f")) == dataclasses.asdict(getattr(jax_zoo, name)("f"))
    for kw, match in (({"neg_sampling": "popularity"}, "no effect on closed-form"),):
        cfg = _config(configs, "wrmf", **kw)
        with pytest.raises(ValueError, match=match):
            Trainer(cfg, quiet=True, device="cpu")
    cfg = _config(configs, "ease")
    with pytest.raises(ValueError, match="closed-form solvers keep replicated tables"):
        Trainer(cfg.replace(mesh=dataclasses.replace(cfg.mesh, row_permute=True)), quiet=True, device="cpu")


@pytest.mark.parametrize("name", ["wrmf", "ease"])
def test_convert_carries_the_solved_tables(no_tensorboard, name):
    """A JAX closed-form state (step, solved tables, no optimizer state)
    through ``train_state_from_jax`` and back to JAX's flat keys."""
    from tfrec_tpu.utils.checkpoint import _flatten
    from tfrec_tpu_torch import convert

    jt = JaxTrainer(_config(jax_configs, name, None, epochs=1), quiet=True)
    jt.train()
    pt = Trainer(_config(configs, name, None, epochs=1), quiet=True, device="cpu")
    np_state = jax.tree.map(np.asarray, jt.state)
    state = convert.train_state_from_jax(np_state, pt.model)
    assert sorted(state) == ["dense", "step", "tables"] and state["step"] == 1 and state["dense"] == {}
    assert sorted(state["tables"]) == sorted(np_state["tables"])
    flat = convert.flat_from_state(state, "adam", model=pt.model)
    want = {k: np.asarray(v) for k, v in _flatten(jt.state).items()}
    assert sorted(flat) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(flat[k], want[k], err_msg=k)
