"""The port's graph zoo (LightGCN, NGCF) against the JAX package, on the CPU.

- the edge lists of ``attach_graph`` bit for bit JAX's (repeated
  interactions one edge, degrees clamped at 1);
- the propagation against the dense normalised-adjacency oracle of
  tests/test_lightgcn.py:13-49 (NGCF's layers too) and against JAX's, and
  its gradient (the sorted sums' backward, ``take_rows``') against JAX's;
- the forwards, ``score_all`` and one ``TrainStepBuilder.step`` against
  JAX's at dropout 0; a step with no tables calls no gather and no sparse
  update; NGCF's message dropout;
- the trainer against JAX's, serving from its checkpoint; checkpoints of
  both dense trees in both directions.
"""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tfrec_tpu.configs as jax_configs
import tfrec_tpu.utils.checkpoint as jax_ckpt
from tfrec_tpu.configs import ModelConfig as JaxModelConfig
from tfrec_tpu.configs import OptimConfig as JaxOptimConfig
from tfrec_tpu.models import DataSpec as JaxDataSpec
from tfrec_tpu.models import build_model as jax_build_model
from tfrec_tpu.train import step as jax_step
from tfrec_tpu.train.trainer import Trainer as JaxTrainer
from tfrec_tpu_torch import configs, convert
from tfrec_tpu_torch.configs import ModelConfig, OptimConfig
from tfrec_tpu_torch.models import NGCF, DataSpec, LightGCN, build_model
from tfrec_tpu_torch.ops import graph
from tfrec_tpu_torch.serve import Recommender
from tfrec_tpu_torch.train import step as step_mod
from tfrec_tpu_torch.train.step import TrainStepBuilder, tree_leaves
from tfrec_tpu_torch.train.trainer import Trainer, run
from tfrec_tpu_torch.utils import checkpoint as ckpt

torch.set_num_threads(1)

# The propagation sums in another order than XLA's segment_sum
# (tests/test_lightgcn.py holds JAX's to its oracle at 2e-5 / 1e-6); a step
# adds the dense Adagrad's normalised update.
RTOL, ATOL = 2e-5, 1e-6
STEP_RTOL, STEP_ATOL = 1e-4, 1e-5
TRAIN_RTOL = 1e-4
METRIC_ATOL = 1e-6
NUM_USERS, NUM_ITEMS, D, K = 7, 9, 4, 3
MODELS = {"lightgcn": LightGCN, "ngcf": NGCF}


def _interactions(seed=0, n=30):
    """Pairs with repeats; user 6 and item 8 have no edge."""
    rng = np.random.default_rng(seed)
    users = rng.integers(0, NUM_USERS - 1, n).astype(np.int32)
    items = rng.integers(0, NUM_ITEMS - 1, n).astype(np.int32)
    users[-1], items[-1] = users[0], items[0]
    return users, items


def _models(name, users=None, items=None, **kw):
    ref = jax_build_model(JaxModelConfig(name=name, embed_dim=D, lightgcn_layers=K, **kw),
                          JaxDataSpec.interaction(NUM_USERS, NUM_ITEMS))
    port = build_model(ModelConfig(name=name, embed_dim=D, lightgcn_layers=K, **kw),
                       DataSpec.interaction(NUM_USERS, NUM_ITEMS))
    assert isinstance(port, MODELS[name]) and port.table_specs() == ref.table_specs() == ()
    if users is None:
        users, items = _interactions()
    port.attach_graph(users, items)
    ref.attach_graph(users, items)
    return port, ref


def _pair(name, seed=1, **kw):
    port, ref = _models(name, **kw)
    rng = np.random.default_rng(seed)
    np_params = jax.tree.map(lambda a: (np.asarray(a) + 0.05 * rng.normal(size=a.shape)).astype(np.float32),
                             ref.init(jax.random.PRNGKey(0)))
    return port, ref, np_params, convert.params_from_jax(np_params, port)


def _dense_oracle(dense, users, items):
    """The layers' inputs over A_hat, dense: [(users, items) of layer 0..K]
    for LightGCN, and NGCF's given its weights."""
    a = np.zeros((NUM_USERS + NUM_ITEMS,) * 2, np.float64)
    for u, i in zip(users, items):
        a[u, NUM_USERS + i] = a[NUM_USERS + i, u] = 1.0
    deg = np.maximum(a.sum(1), 1.0)
    a_hat = a / np.sqrt(deg[:, None] * deg[None, :])
    e = np.concatenate([dense["user_emb"], dense["item_emb"]]).astype(np.float64)
    layers = [e]
    for k in range(K):
        agg = a_hat @ e
        if "w1_0" in dense:
            pre = (e + agg) @ dense[f"w1_{k}"] + dense[f"b1_{k}"] + (agg * e) @ dense[f"w2_{k}"] + dense[f"b2_{k}"]
            e = np.where(pre > 0, pre, 0.2 * pre)
        else:
            e = agg
        layers.append(e)
    if "w1_0" in dense:
        out = np.concatenate(layers, axis=1)
    else:
        out = sum(layers) / (K + 1)
    return out[:NUM_USERS], out[NUM_USERS:]


def _same_edges(port, ref):
    """The port's edge lists are the reference's six arrays, bit for bit."""
    spec = port.data_spec
    for side, edges, n in (("u", port.graph("cpu")[0], spec.num_users), ("i", port.graph("cpu")[1], spec.num_items)):
        np.testing.assert_array_equal(np.repeat(np.arange(n), edges.lengths.numpy()),
                                      np.asarray(ref._edges[f"{side}_dst"]))
        np.testing.assert_array_equal(edges.src.numpy(), np.asarray(ref._edges[f"{side}_src"]))
        coef = np.asarray(ref._edges[f"{side}_coef"])
        assert edges.coef.numpy().dtype == coef.dtype
        np.testing.assert_array_equal(edges.coef.numpy(), coef)


def test_attach_graph_matches_jax_bit_for_bit():
    port, ref = _models("lightgcn")
    _same_edges(port, ref)
    u_side, i_side = port.graph("cpu")
    users, items = _interactions()
    assert u_side.lengths.sum() == len(set(zip(users.tolist(), items.tolist()))) < len(users)
    assert u_side.lengths[NUM_USERS - 1] == 0 and i_side.lengths[NUM_ITEMS - 1] == 0


@pytest.mark.parametrize("name", sorted(MODELS))
def test_propagation_matches_the_dense_oracle_and_jax(name):
    port, ref, np_params, params = _pair(name)
    pu, qi = port.propagate(params["dense"])
    want_u, want_i = _dense_oracle(np_params["dense"], *_interactions())
    np.testing.assert_allclose(pu.numpy(), want_u, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(qi.numpy(), want_i, rtol=RTOL, atol=ATOL)
    ju, ji = ref.propagate(jax.tree.map(jnp.asarray, np_params["dense"]))
    np.testing.assert_allclose(pu.numpy(), np.asarray(ju), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(qi.numpy(), np.asarray(ji), rtol=RTOL, atol=ATOL)
    assert qi.shape == (NUM_ITEMS, D * (K + 1) if name == "ngcf" else D)
    again = port.propagate(params["dense"])
    assert torch.equal(again[0], pu) and torch.equal(again[1], qi)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_propagation_gradient_matches_jax(name):
    """The gradient of a weighted sum of the propagated rows a batch takes
    (users repeated), through the sorted sums' backward and ``take_rows``'."""
    port, ref, np_params, params = _pair(name, 2)
    rng = np.random.default_rng(3)
    users = rng.integers(0, NUM_USERS, 12).astype(np.int32)
    items = rng.integers(0, NUM_ITEMS, 12).astype(np.int32)
    width = D * (K + 1) if name == "ngcf" else D
    wu, wi = rng.normal(size=(12, width)).astype(np.float32), rng.normal(size=(12, width)).astype(np.float32)

    def jax_obj(dense):
        pu, qi = ref.propagate(dense)
        return jnp.sum(pu[users] * wu) + jnp.sum(qi[items] * wi)

    want = jax.grad(jax_obj)(jax.tree.map(jnp.asarray, np_params["dense"]))
    dense = {k: v.clone().requires_grad_() for k, v in params["dense"].items()}
    pu, qi = port.propagate(dense)
    obj = (graph.take_rows(pu, torch.from_numpy(users)) * torch.from_numpy(wu)).sum() + \
        (graph.take_rows(qi, torch.from_numpy(items)) * torch.from_numpy(wi)).sum()
    got = dict(zip(dense, torch.autograd.grad(obj, list(dense.values()))))
    for k in dense:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-4, atol=1e-5, err_msg=k)


def test_take_rows_gradient_sums_repeated_ids():
    x = torch.randn(5, 3, dtype=torch.float64, requires_grad=True)
    ids = torch.tensor([4, 1, 4, 0, 4])
    g = torch.randn(5, 3, dtype=torch.float64)
    (got,) = torch.autograd.grad((graph.take_rows(x, ids) * g).sum(), x)
    (want,) = torch.autograd.grad((x[ids] * g).sum(), x)
    torch.testing.assert_close(got, want)
    assert (got[[2, 3]] == 0).all()


@pytest.mark.parametrize("name", sorted(MODELS))
def test_forward_and_score_all_match_jax(name):
    port, ref, np_params, params = _pair(name, 4)
    rng = np.random.default_rng(5)
    b = 8
    batch = {"user": rng.integers(0, NUM_USERS, b).astype(np.int32),
             "pos": rng.integers(0, NUM_ITEMS, b).astype(np.int32),
             "neg": rng.integers(0, NUM_ITEMS, b).astype(np.int32)}
    point = {"user": batch["user"], "item": batch["pos"], "label": np.zeros(b, np.float32)}
    jd = jax.tree.map(jnp.asarray, np_params["dense"])
    for bt in (batch, point):
        want = ref.forward(jd, {}, {k: jnp.asarray(v) for k, v in bt.items()})
        got = port(params["dense"], {}, {k: torch.from_numpy(v) for k, v in bt.items()})
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    users = np.arange(NUM_USERS, dtype=np.int32)
    want = ref.score_all(jax.tree.map(jnp.asarray, np_params), jnp.asarray(users))
    got = port.score_all(params, torch.from_numpy(users))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    served = Recommender(port, params, device="cpu").predict(point["user"], point["item"])
    np.testing.assert_allclose(served, got.numpy()[point["user"], point["item"]], rtol=RTOL, atol=ATOL)
    assert port.dot_decomposition() is None


@pytest.mark.parametrize("name", sorted(MODELS))
def test_one_step_matches_jax_and_launches_no_sparse_work(name, monkeypatch):
    """One step from JAX's state (BPR, dense Adagrad, l2 over the whole
    embeddings as JAX's); the step looks nothing up and updates no table."""
    port, ref, np_params, _ = _pair(name, 6)
    optim = dict(learning_rate=0.1, dense_optimizer="adagrad")
    jb = jax_step.TrainStepBuilder(ref, "bpr", JaxOptimConfig(**optim), l2_reg=0.03, kernels="xla")
    jstate = {**jb.init_state(jax.random.PRNGKey(0)), "dense": jax.tree.map(jnp.asarray, np_params["dense"])}
    builder = TrainStepBuilder(port, "bpr", OptimConfig(**optim), l2_reg=0.03, device="cpu")
    state = convert.train_state_from_jax(jax.tree.map(np.asarray, jstate), port)

    def refuse(*a, **k):
        raise AssertionError("a model with no tables gathered or updated rows")

    monkeypatch.setattr(step_mod, "gather_many", refuse)
    monkeypatch.setattr(builder, "sparse_update_deduped_all", refuse)
    rng = np.random.default_rng(7)
    batch = {"user": rng.integers(0, NUM_USERS, 16).astype(np.int32),
             "pos": rng.integers(0, NUM_ITEMS, 16).astype(np.int32),
             "neg": rng.integers(0, NUM_ITEMS, 16).astype(np.int32)}
    jstate, jm = jax.jit(jb.step)(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    state, m = builder.step(state, tb)
    np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=STEP_RTOL)
    assert state["tables"] == {} and state["sparse_opt"] == {}
    for k, v in jstate["dense"].items():
        np.testing.assert_allclose(state["dense"][k].numpy(), np.asarray(v), rtol=STEP_RTOL, atol=STEP_ATOL,
                                   err_msg=k)
    sos = jstate["dense_opt"][0].sum_of_squares
    for k, v in sos.items():
        np.testing.assert_allclose(state["dense_opt"]["sum_of_squares"][k].numpy(), np.asarray(v),
                                   rtol=STEP_RTOL, atol=STEP_ATOL, err_msg=k)


def test_ngcf_message_dropout_draws_from_the_step_generator():
    port, _, _, params = _pair("ngcf", 8, dropout=0.5)
    assert port.draws_noise()
    plain = port.propagate(params["dense"])
    first = port.propagate(params["dense"], generator=torch.Generator().manual_seed(3))
    again = port.propagate(params["dense"], generator=torch.Generator().manual_seed(3))
    assert torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])
    layer1 = first[0][:, D:]
    assert not torch.equal(layer1, plain[0][:, D:]) and (layer1 == 0).float().mean() > 0.2
    assert torch.equal(first[0][:, :D], plain[0][:, :D])  # layer 0 is the embeddings


@pytest.mark.parametrize("name", sorted(MODELS))
def test_checkpoints_carry_the_dense_tree_both_ways(tmp_path, name):
    port, ref = _models(name)
    params = port.init(torch.Generator().manual_seed(0), "cpu")
    assert params["tables"] == {}
    assert jax.tree.map(lambda t: tuple(t.shape), params["dense"]) == \
        jax.tree.map(lambda a: tuple(a.shape), ref.init(jax.random.PRNGKey(0))["dense"])
    jb = jax_step.TrainStepBuilder(ref, "bpr", JaxOptimConfig(learning_rate=0.01, dense_optimizer="adam"))
    rng = np.random.default_rng(11)
    state = jax.tree.map(lambda x: (rng.normal(size=np.shape(x)).astype(np.float32)
                                    if np.asarray(x).dtype == np.float32 else np.asarray(x) + 3),
                         jb.init_state(jax.random.PRNGKey(0)))
    port_state = convert.train_state_from_jax(state, port)
    got = convert.flat_from_state(port_state, "adam")
    want = {k: np.asarray(v) for k, v in jax_ckpt._flatten(state).items()}
    assert sorted(got) == sorted(want) and "dense/user_emb" in got and not any(k.startswith("tables/") for k in got)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    ckpt.save_checkpoint(str(tmp_path / "port"), 3, got)
    restored = jax_ckpt.restore_checkpoint(str(tmp_path / "port"), state)
    for a, b in zip(jax.tree_util.tree_leaves(restored), jax.tree_util.tree_leaves(state)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    jax_ckpt.save_checkpoint(str(tmp_path / "jax"), 3, state)
    back = convert.train_state_from_flat(ckpt.restore_checkpoint(str(tmp_path / "jax")), port, port_state)
    for a, b in zip(tree_leaves(back), tree_leaves(port_state)):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))


def _config(mod, name, ckpt_dir=None, **model):
    return mod.Config(
        run_name=name,
        data=mod.DataConfig(source="synthetic_implicit", num_users=96, num_items=120,
                            interactions_per_user=14, seed=1),
        model=mod.ModelConfig(name=name, embed_dim=8, lightgcn_layers=2, l2_reg=0.01, **model),
        optim=mod.OptimConfig(learning_rate=0.05, dense_optimizer="adagrad"),
        train=mod.TrainConfig(batch_size=128, epochs=3, eval_every_epochs=3, eval_topk=(5, 10), loss="bpr",
                              checkpoint_dir=ckpt_dir, checkpoint_every_epochs=3 if ckpt_dir else 0),
        mesh=mod.MeshConfig(data_axis_size=0),
    )


@pytest.fixture
def no_tensorboard(monkeypatch):
    """JAX's metric stream without its optional TensorBoard writer, whose
    import (``torch.utils.tensorboard``, and TensorFlow with it) costs more
    than these trainers' runs."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


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


@pytest.mark.parametrize("name", sorted(MODELS))
def test_trainer_matches_jax_and_serves_from_a_checkpoint(tmp_path, no_tensorboard, name):
    """From JAX's initial state at dropout 0: the metric streams match;
    ``from_checkpoint`` re-attaches the graph and serves bit for bit as
    ``from_trainer``."""
    jt = JaxTrainer(_config(jax_configs, name, str(tmp_path / "jax")), quiet=True)
    cfg = _config(configs, name, str(tmp_path / "port"))
    pt = Trainer(cfg, quiet=True, device="cpu")
    _same_edges(pt.model, jt.model)
    pt.state = convert.train_state_from_jax(jax.tree.map(np.asarray, jt.state), pt.model)
    pt.train()
    jt.train()
    got, want = _records(tmp_path / "port" / f"{name}.metrics.jsonl"), \
        _records(tmp_path / "jax" / f"{name}.metrics.jsonl")
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys(), (g, w)
        for k in g:
            if k == "loss":
                np.testing.assert_allclose(g[k], w[k], rtol=TRAIN_RTOL)
            elif "@" in k:
                np.testing.assert_allclose(g[k], w[k], rtol=0, atol=METRIC_ATOL, err_msg=k)
            else:
                assert g[k] == w[k], (k, g, w)
    assert "recall@10" in got[-1]
    live = Recommender.from_trainer(pt)
    disk = Recommender.from_checkpoint(cfg, device="cpu")
    users = np.array([0, 5, 5, 95], np.int32)
    items = np.array([1, 2, 119, 40], np.int32)
    np.testing.assert_array_equal(disk.predict(users, items), live.predict(users, items))
    for a, b in zip(disk.recommend(users, 10), live.recommend(users, 10)):
        np.testing.assert_array_equal(a, b)


def test_ngcf_with_message_dropout_trains_on_the_cpu():
    """``run(config, device="cpu")`` with dropout 0.1: a finite history, a
    falling loss, recall@10 above the random ranking's 10/120."""
    cfg = _config(configs, "ngcf", dropout=0.1)
    cfg = cfg.replace(train=cfg.train.__class__(**{**cfg.train.__dict__, "epochs": 6, "eval_every_epochs": 6}))
    _, history = run(cfg, quiet=True, device="cpu")
    assert all(np.isfinite(v) for r in history for v in r.values())
    assert history[-1]["loss"] < history[0]["loss"] and history[-1]["recall@10"] > 10 / 120


def test_propagate_needs_the_graph():
    port = build_model(ModelConfig(name="lightgcn", embed_dim=D), DataSpec.interaction(NUM_USERS, NUM_ITEMS))
    params = port.init(torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="attach_graph"):
        port.propagate(params["dense"])
