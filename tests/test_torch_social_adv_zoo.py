"""The port's social and adversarial zoo (SBPR and its trust graph, APR,
IRGAN) and Pop and ConvNCF against the JAX package, on the CPU.

At the JAX model's own params (``convert.params_from_jax``, seeded noise on
every leaf), the same seeded inputs go through both:

- the taste-overlap graph and ``load_social_edges`` (with its refusals),
  and ``SBPRSampler``'s batches bit for bit, ``max_social`` truncating too;
- the ``apr``, ``sbpr`` and ``irgan`` losses;
- each model's training forward (APR's perturbed ``diff_adv``; IRGAN's
  with JAX's Gumbel draw passed in, and greedy without one) and its
  pointwise forward;
- 3 ``TrainStepBuilder`` steps of each against JAX's from one state (IRGAN
  takes JAX's Gumbel draw of each step): losses, every table and
  accumulator, dense leaves;
- IRGAN's warm start from an MF checkpoint, and the trainer's
  ``loss_coerced`` events against JAX's metric stream.
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
import tfrec_tpu.utils.checkpoint as jax_ckpt
from tfrec_tpu.configs import ModelConfig as JaxModelConfig
from tfrec_tpu.configs import OptimConfig as JaxOptimConfig
from tfrec_tpu.data.dataset import build_dataset as jax_build_dataset
from tfrec_tpu.data.dataset import load_social_edges as jax_load_social_edges
from tfrec_tpu.data.samplers import SBPRSampler as JaxSBPRSampler
from tfrec_tpu.models import DataSpec as JaxDataSpec
from tfrec_tpu.models import build_model as jax_build_model
from tfrec_tpu.train import losses as jax_losses
from tfrec_tpu.train import step as jax_step
from tfrec_tpu.train.trainer import Trainer as JaxTrainer
from tfrec_tpu_torch import configs, convert
from tfrec_tpu_torch.configs import ModelConfig, OptimConfig
from tfrec_tpu_torch.data.dataset import build_dataset, build_social_overlap, load_social_edges
from tfrec_tpu_torch.data.samplers import SBPRSampler
from tfrec_tpu_torch.models import APR, IRGAN, SBPR, ConvNCF, DataSpec, Pop, build_model
from tfrec_tpu_torch.ops.embedding import gather_many
from tfrec_tpu_torch.train import losses
from tfrec_tpu_torch.train.step import TrainStepBuilder, tree_leaves
from tfrec_tpu_torch.train.trainer import Trainer
from tfrec_tpu_torch.utils import checkpoint as ckpt

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6  # a forward of the same arithmetic in another order
STEP_RTOL, STEP_ATOL = 1e-4, 1e-5  # 3 steps through the normalised updates
LOSS_RTOL = 1e-6
NUM_USERS, NUM_ITEMS, K = 30, 50, 4
MODELS = {
    "sbpr": (SBPR, dict(embed_dim=8)),
    "apr": (APR, dict(embed_dim=8, apr_eps=0.3, apr_lambda=0.7)),
    "irgan": (IRGAN, dict(embed_dim=8, irgan_temperature=0.5)),
    "pop": (Pop, dict(embed_dim=8)),
    "convncf": (ConvNCF, dict(embed_dim=8, convncf_channels=4)),
}
LOSS = {"sbpr": "sbpr", "apr": "apr", "irgan": "irgan", "pop": "bpr", "convncf": "bpr"}


def _models(name):
    cls, kw = MODELS[name]
    ref = jax_build_model(JaxModelConfig(name=name, **kw), JaxDataSpec.interaction(NUM_USERS, NUM_ITEMS))
    port = build_model(ModelConfig(name=name, **kw), DataSpec.interaction(NUM_USERS, NUM_ITEMS))
    assert isinstance(port, cls) and type(port).__name__ == type(ref).__name__
    return port, ref


def _pair(name, seed=1):
    """(port, ref, JAX params as numpy, the port's params): JAX's init with
    seeded noise on every leaf (the zero-initialised biases too)."""
    port, ref = _models(name)
    rng = np.random.default_rng(seed)
    params = jax.tree.map(np.asarray, ref.init(jax.random.PRNGKey(0)))
    params = jax.tree.map(lambda a: (a + 0.3 * rng.normal(size=a.shape)).astype(np.float32), params)
    return port, ref, params, convert.params_from_jax(params, port)


def _gumbel(step_rng, shape):
    """JAX's Gumbel draw of IRGAN's forward at ``step_rng``."""
    return np.array(jax.random.gumbel(jax.random.fold_in(step_rng, 0x1269A7), shape, dtype=jnp.float32))


def _batch(name, seed, b=8):
    rng = np.random.default_rng(seed)
    batch = {"user": rng.integers(0, NUM_USERS, b), "pos": rng.integers(0, NUM_ITEMS, b)}
    if name == "irgan":
        batch["negs"] = rng.integers(0, NUM_ITEMS, (b, K))
    else:
        batch["neg"] = rng.integers(0, NUM_ITEMS, b)
    batch = {k: v.astype(np.int32) for k, v in batch.items()}
    if name == "sbpr":
        batch["soc"] = rng.integers(0, NUM_ITEMS, b).astype(np.int32)
        batch["suk"] = rng.integers(0, 4, b).astype(np.float32)
        batch["has_social"] = (rng.random(b) < 0.6).astype(np.float32)
    return batch


def _forward_pair(port, ref, np_params, params, batch, rng=None, gumbel=None):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jg = {k: jnp.take(jnp.asarray(np_params["tables"][k]), v, axis=0, mode="clip")
          for k, v in ref.lookup_ids(jb).items()}
    want = ref.forward(jax.tree.map(jnp.asarray, np_params["dense"]), jg, jb, rng=rng)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    ids = port.lookup_ids(tb)
    assert list(ids) == list(ref.lookup_ids(jb))
    rows = dict(zip(ids, gather_many([params["tables"][k] for k in ids], list(ids.values()))))
    kw = {} if gumbel is None else {"gumbel": torch.from_numpy(gumbel)}
    return port(params["dense"], rows, tb, **kw), want


def _close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=rtol, atol=atol, err_msg=msg)


# ---- the trust graph and the sampler ----

SOCIAL_DATA = dict(source="synthetic_implicit", num_users=NUM_USERS, num_items=NUM_ITEMS,
                   interactions_per_user=10, seed=3)


def _social_datasets(degree=4):
    kw = dict(SOCIAL_DATA, social_degree=degree)
    return build_dataset(configs.DataConfig(**kw)), jax_build_dataset(jax_configs.DataConfig(**kw))


def _same_csr(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype == np.bool_ and (a != b).nnz == 0
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)


@pytest.mark.parametrize("degree", [1, 4, 60])
def test_social_overlap_graph_matches_jax(degree):
    """Symmetric, no self-loop, each user's friends at least ``degree``
    (all the others past the user count), equal to JAX's for two seeds."""
    port_ds, ref_ds = _social_datasets(degree)
    _same_csr(port_ds.social, ref_ds.social)
    g = port_ds.social
    assert g.diagonal().sum() == 0 and (g != g.T).nnz == 0
    assert np.asarray(g.sum(axis=1)).min() >= min(degree, port_ds.num_users - 1)
    from tfrec_tpu.data.dataset import build_social_overlap as jax_overlap
    _same_csr(build_social_overlap(port_ds, degree, seed=9), jax_overlap(ref_ds, degree, seed=9))


def test_load_social_edges_matches_jax_and_refuses(tmp_path):
    """Repeated, reversed and self edges fold into JAX's graph; a file of
    one column, ids out of range and a re-densifying config are refused
    as JAX refuses them."""
    path = tmp_path / "edges.txt"
    path.write_text("0 1\n1 0\n2 5\n5 5\n3 4\n3 4\n7 2\n")
    _same_csr(load_social_edges(str(path), 8), jax_load_social_edges(str(path), 8))
    cfg = dict(SOCIAL_DATA, social_path=str(path))
    port_ds, ref_ds = build_dataset(configs.DataConfig(**cfg)), jax_build_dataset(jax_configs.DataConfig(**cfg))
    _same_csr(port_ds.social, ref_ds.social)
    assert port_ds.social.shape == (NUM_USERS, NUM_USERS) and port_ds.social[5, 5] == 0
    (tmp_path / "one.txt").write_text("1\n2\n")
    for bad, n, match in ((tmp_path / "one.txt", 8, "'u v' columns"), (path, 5, "3/7 edges")):
        for load in (load_social_edges, jax_load_social_edges):
            with pytest.raises(ValueError, match=match):
                load(str(bad), n)
    for kw in ({"min_interactions": 2}, {"binarize_threshold": 1.0}):
        for mod, build in ((configs, build_dataset), (jax_configs, jax_build_dataset)):
            with pytest.raises(ValueError, match="re-densify"):
                build(mod.DataConfig(**cfg, **kw))


@pytest.mark.parametrize("max_social", [512, 3])
def test_sbpr_sampler_matches_jax(max_social):
    """3 batches of two epochs bit for bit; under ``max_social=3`` the
    candidates are a seeded subsample while the negatives still exclude the
    whole social set (tests/test_social.py:66)."""
    port_ds, ref_ds = _social_datasets()
    ours = SBPRSampler(port_ds, 32, seed=5, max_social=max_social)
    ref = JaxSBPRSampler(ref_ds, 32, seed=5, max_social=max_social)
    for attr in ("sp_lens", "sp_items", "sp_counts", "_soc_keys"):
        np.testing.assert_array_equal(getattr(ours, attr), getattr(ref, attr), err_msg=attr)
    assert ours.num_batches() == ref.num_batches() >= 3
    for epoch in (0, 1):
        for _, a, b in zip(range(3), ours.epoch(epoch), ref.epoch(epoch)):
            assert a.keys() == b.keys() == {"user", "pos", "soc", "neg", "suk", "has_social"}
            for k in a:
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            assert not ours._in_social(a["user"], a["neg"]).any()
            has = a["has_social"] > 0
            assert has.any() and ours._in_social(a["user"][has], a["soc"][has]).all()
    if max_social == 3:
        assert ours.sp_lens.max() == 3 and (ours.sp_lens == 3).sum() > 1
    with pytest.raises(ValueError, match="social graph"):
        SBPRSampler(build_dataset(configs.DataConfig(**SOCIAL_DATA)), 8)


# ---- the losses and the forwards ----

def test_losses_match_jax():
    rng = np.random.default_rng(2)
    b = 9

    def vec(scale=3.0):
        return (rng.normal(size=b) * scale).astype(np.float32)

    cases = {
        "apr": {"diff": vec(), "diff_adv": vec(), "adv_weight": np.float32(0.7)},
        "sbpr": {"pos": vec(), "soc": vec(), "neg": vec(), "suk": rng.integers(0, 5, b).astype(np.float32),
                 "has": (np.arange(b) % 3 > 0).astype(np.float32)},
        "irgan": {"d_pos": vec(), "d_sel": vec(), "logp": -np.abs(vec()), "reward": np.abs(vec())},
    }
    for name, out in cases.items():
        want = float(getattr(jax_losses, name)(jax.tree.map(jnp.asarray, out), {}))
        got = losses.make_loss(name)({k: torch.as_tensor(v) for k, v in out.items()}, {})
        np.testing.assert_allclose(got.item(), want, rtol=LOSS_RTOL, err_msg=name)
    assert losses.MULTI_NEG_LOSSES == jax_losses.MULTI_NEG_LOSSES
    assert losses.PAIRWISE_LOSSES == jax_losses.PAIRWISE_LOSSES


@pytest.mark.parametrize("name", sorted(MODELS))
def test_training_forward_matches_jax(name):
    """SBPR's five columns; APR's clean and perturbed differences; IRGAN's
    outputs under JAX's Gumbel draw; Pop's and ConvNCF's s_pos - s_neg."""
    port, ref, np_params, params = _pair(name)
    batch = _batch(name, 2)
    rng = jax.random.PRNGKey(17) if name == "irgan" else None
    gumbel = _gumbel(rng, (8, K)) if name == "irgan" else None
    got, want = _forward_pair(port, ref, np_params, params, batch, rng=rng, gumbel=gumbel)
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            if k == "sample":
                np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
            else:
                _close(got[k], want[k], msg=k)
    else:
        _close(got, want)
    if name == "apr":
        assert not torch.allclose(got["diff_adv"], got["diff"])
    if name == "irgan":  # the draw changes some picks
        greedy, want_greedy = _forward_pair(port, ref, np_params, params, batch)
        np.testing.assert_array_equal(greedy["sample"].numpy(), np.asarray(want_greedy["sample"]))
        assert (greedy["sample"] != got["sample"]).any()
        _close(greedy["logp"], want_greedy["logp"])


@pytest.mark.parametrize("name", sorted(MODELS))
def test_pointwise_forward_and_multi_negative_forward_match_jax(name):
    """The pointwise scores eval and serving read (IRGAN's generator's)
    and, but for SBPR's and APR's own batches, a [B, 1+K] pool."""
    port, ref, np_params, params = _pair(name, 3)
    rng = np.random.default_rng(4)
    users = rng.integers(0, NUM_USERS, 7).astype(np.int32)
    items = rng.integers(0, NUM_ITEMS, 7).astype(np.int32)
    got, want = _forward_pair(port, ref, np_params, params,
                              {"user": users, "item": items, "label": np.zeros(7, np.float32)})
    _close(got, want)
    if name in ("pop", "convncf", "sbpr"):
        batch = {"user": users, "pos": items, "negs": rng.integers(0, NUM_ITEMS, (7, 3)).astype(np.int32)}
        got, want = _forward_pair(port, ref, np_params, params, batch)
        assert got.shape == (7, 4)
        _close(got, want)


@pytest.mark.parametrize("name", ["irgan", "pop", "convncf"])
def test_score_all_matches_jax(name):
    port, ref, np_params, params = _pair(name, 5)
    users = np.array([0, 3, 3, NUM_USERS - 1], np.int32)
    want = np.asarray(ref.score_all(jax.tree.map(jnp.asarray, np_params), jnp.asarray(users)))
    got = port.score_all(params, torch.from_numpy(users))
    assert got.shape == want.shape == (4, NUM_ITEMS) and got.is_contiguous()
    _close(got, want)


# ---- three steps against JAX's ----

OPTIM = dict(learning_rate=0.05, dense_optimizer="adagrad", sparse_optimizer="rowwise_adagrad")


def _step_batches(name, seed):
    """3 batches of 16: SBPRSampler's over a graph for SBPR, else seeded
    pairs (K=4 negatives a row for IRGAN)."""
    if name != "sbpr":
        return [_batch(name, seed + i, b=16) for i in range(3)]
    port_ds, _ = _social_datasets()
    assert (port_ds.num_users, port_ds.num_items) == (NUM_USERS, NUM_ITEMS)
    return [b for _, b in zip(range(3), SBPRSampler(port_ds, 16, seed=seed).epoch(0))]


@pytest.mark.parametrize("name", sorted(MODELS))
def test_three_steps_match_jax(name, monkeypatch):
    """From JAX's state, with l2 (but for APR, whose reference step reads
    the batch size off its scalar ``adv_weight``): each step's loss, and
    after 3 steps every table row, accumulator and dense leaf."""
    port, ref, np_params, _ = _pair(name, 9)
    l2 = 0.0 if name == "apr" else 0.01
    loss = LOSS[name]
    jb = jax_step.TrainStepBuilder(ref, loss, JaxOptimConfig(**OPTIM), l2_reg=l2, kernels="xla", seed=4)
    jstate = jb.init_state(jax.random.PRNGKey(0))
    jstate = {**jstate, "tables": jax.tree.map(jnp.asarray, np_params["tables"]),
              "dense": jax.tree.map(jnp.asarray, np_params["dense"])}
    builder = TrainStepBuilder(port, loss, OptimConfig(**OPTIM), l2_reg=l2, device="cpu", seed=4)
    assert (builder._generator(0) is not None) == (name == "irgan")
    state = convert.train_state_from_jax(jax.tree.map(np.asarray, jstate), port)
    if name == "irgan":  # JAX's draw at each step: fold_in(PRNGKey(seed), step)
        draws = iter(_gumbel(jax.random.fold_in(jax.random.PRNGKey(4), s), (16, K)) for s in range(3))
        monkeypatch.setattr(port, "gumbel", lambda shape, generator, device: torch.from_numpy(next(draws)))
    jit_step = jax.jit(jb.step)
    for batch in _step_batches(name, 10):
        jstate, jm = jit_step(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, m = builder.step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=STEP_RTOL)
    for tname, table in jstate["tables"].items():
        np.testing.assert_allclose(state["tables"][tname].numpy(), np.asarray(table), rtol=STEP_RTOL,
                                   atol=STEP_ATOL, err_msg=tname)
        for leaf, v in jstate["sparse_opt"][tname].items():
            np.testing.assert_allclose(state["sparse_opt"][tname][leaf].numpy(), np.asarray(v),
                                       rtol=STEP_RTOL, atol=STEP_ATOL, err_msg=f"{tname} {leaf}")
        assert not np.array_equal(np.asarray(table), np_params["tables"][tname]), f"{tname} untouched"
    want = convert.params_from_jax(jax.tree.map(np.asarray, {"tables": jstate["tables"],
                                                             "dense": jstate["dense"]}), port)
    assert len(tree_leaves(state["dense"])) == (2 * 3 + 2 if name == "convncf" else 0)
    for got, w in zip(tree_leaves(state["dense"]), tree_leaves(want["dense"])):
        np.testing.assert_allclose(got.numpy(), w.numpy(), rtol=STEP_RTOL, atol=STEP_ATOL)


def test_convncf_state_carries_the_kernels_in_each_layout(tmp_path):
    """JAX's HWIO kernels become OIHW in the port and go back in its
    checkpoints, the Adam moments with them: each package restores the
    other's checkpoint leaf for leaf."""
    port, ref = _models("convncf")
    assert [tuple(t.shape) for t in tree_leaves(port.init(torch.Generator().manual_seed(0), "cpu")["dense"])
            ] == [(4, 1, 2, 2), (4,), (4, 4, 2, 2), (4,), (4, 4, 2, 2), (4,), (4,), ()]
    jb = jax_step.TrainStepBuilder(ref, "bpr", JaxOptimConfig(learning_rate=0.01, dense_optimizer="adam"))
    rng = np.random.default_rng(11)
    state = jax.tree.map(lambda x: (rng.normal(size=np.shape(x)).astype(np.float32)
                                    if np.asarray(x).dtype == np.float32 else np.asarray(x) + 3),
                         jb.init_state(jax.random.PRNGKey(0)))
    port_state = convert.train_state_from_jax(state, port)
    np.testing.assert_array_equal(port_state["dense"]["k1"].numpy(), state["dense"]["k1"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(port_state["dense_opt"]["mu"]["k0"].numpy(),
                                  convert._optax_state(state["dense_opt"], "mu").mu["k0"].transpose(3, 2, 0, 1))
    got = convert.flat_from_state(port_state, "adam", model=port)
    want = {k: np.asarray(v) for k, v in jax_ckpt._flatten(state).items()}
    assert sorted(got) == sorted(want)
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


# ---- the trainer ----

@pytest.fixture
def no_tensorboard(monkeypatch):
    """JAX's metric stream without its optional TensorBoard writer, whose
    import costs more than these trainers' runs."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


def _config(mod, name, ckpt_dir=None, loss="bpr", **train):
    kw = dict(batch_size=64, epochs=1, eval_every_epochs=0, loss=loss, num_negatives=4,
              checkpoint_dir=ckpt_dir, checkpoint_every_epochs=1 if ckpt_dir else 0)
    kw.update(train)
    data = dict(SOCIAL_DATA, social_degree=4 if name == "sbpr" else 0)
    return mod.Config(
        run_name=name, data=mod.DataConfig(**data),
        model=mod.ModelConfig(name=name, **{k: v for k, v in MODELS.get(name, (None, {"embed_dim": 8}))[1].items()}),
        optim=mod.OptimConfig(learning_rate=0.05, sparse_optimizer="rowwise_adagrad"),
        train=mod.TrainConfig(**kw),
        mesh=mod.MeshConfig(data_axis_size=0),  # JAX's single-device path under its 8 CPU devices
    )


def _events(path, kind):
    out = []
    for line in path.read_text().splitlines():
        rec = json.loads(line)
        if rec.get("event") == kind:
            rec.pop("wall_s")
            out.append(rec)
    return out


@pytest.mark.parametrize("name,loss,to", [
    ("sbpr", "bpr", "sbpr"), ("apr", "hinge", "apr"), ("irgan", "sampled_softmax", "irgan"),
    ("irgan", "irgan", None), ("wrmf", "bpr", "wrmf"), ("ease", "logloss", "ease"),
])
def test_loss_coerced_events_match_jax(tmp_path, no_tensorboard, name, loss, to):
    for mod, trainer in ((configs, lambda c: Trainer(c, quiet=True, device="cpu")),
                         (jax_configs, lambda c: JaxTrainer(c, quiet=True))):
        t = trainer(_config(mod, name, str(tmp_path / mod.__name__), loss=loss))
        assert t.loss_name == (to or loss)
    got = _events(tmp_path / configs.__name__ / f"{name}.metrics.jsonl", "loss_coerced")
    want = _events(tmp_path / jax_configs.__name__ / f"{name}.metrics.jsonl", "loss_coerced")
    assert got == want and [(r["from"], r["to"]) for r in got] == ([(loss, to)] if to else [])


def test_irgan_warm_starts_from_an_mf_checkpoint(tmp_path, no_tensorboard):
    """Both players start from the MF run's tables (the port's checkpoint
    and JAX's), the ``warm_start`` events equal to JAX's."""
    mf = Trainer(_config(configs, "mf", str(tmp_path / "mf")), quiet=True, device="cpu")
    mf.train()
    src = ckpt.load_table_arrays(str(tmp_path / "mf"))
    trainers = {}
    for mod, make in ((configs, lambda c: Trainer(c, quiet=True, device="cpu")),
                      (jax_configs, lambda c: JaxTrainer(c, quiet=True))):
        cfg = _config(mod, "irgan", str(tmp_path / f"irgan_{mod.__name__}"))
        trainers[mod] = make(cfg.replace(train=dataclasses.replace(cfg.train, init_from=str(tmp_path / "mf"))))
    port = trainers[configs]
    for name, source in port.model.warm_start_aliases().items():
        np.testing.assert_array_equal(port.state["tables"][name].numpy(), src[source], err_msg=name)
    got, want = (_events(tmp_path / f"irgan_{m.__name__}" / "irgan.metrics.jsonl", "warm_start")
                 for m in (configs, jax_configs))
    assert got == want and len(got[0]["copied"]) == 6 and got[0]["skipped"] == []


def test_irgan_takes_the_mesh_path_and_pools_are_required(monkeypatch):
    """On 2 ranks IRGAN trains through the sharded step (its noise and
    baseline the global batch's: tests/test_torch_sharded_rest.py holds the
    steps against JAX's); building it runs no collective."""
    from tfrec_tpu_torch.parallel.mesh import Mesh
    from tfrec_tpu_torch.parallel.step import ShardedTrainStepBuilder
    from tfrec_tpu_torch.train import trainer as trainer_mod

    monkeypatch.setattr(trainer_mod, "world_size", lambda: 2)
    monkeypatch.setattr(trainer_mod, "make_mesh", lambda *a: Mesh(
        shape={"data": 2, "table": 1}, rank=0, device=torch.device("cpu"), backend="gloo"))
    cfg = _config(configs, "irgan")
    cfg = cfg.replace(mesh=dataclasses.replace(cfg.mesh, data_axis_size=-1))
    trainer = Trainer(cfg, quiet=True, device="cpu")
    assert isinstance(trainer.builder, ShardedTrainStepBuilder) and trainer.loss_name == "irgan"
    assert trainer.builder.loss_fn.keywords["batch_mean"] == trainer.builder._global_mean
    port, _, _, params = _pair("irgan")
    batch = {"user": torch.zeros(2, dtype=torch.int32), "pos": torch.zeros(2, dtype=torch.int32)}
    with pytest.raises(ValueError, match="explicit negative pools"):
        port({}, {k: params["tables"][k][:2] for k in port.lookup_ids(batch)}, batch)


def test_zoo_configs_match_jax():
    from tfrec_tpu import zoo_configs as jax_zoo
    from tfrec_tpu_torch import zoo_configs as zoo

    for name in ("sbpr_ml100k", "apr_ml100k", "irgan_ml100k"):
        assert zoo.ZOO[name] is getattr(zoo, name)
        assert dataclasses.asdict(zoo.ZOO[name]()) == dataclasses.asdict(getattr(jax_zoo, name)())
        assert dataclasses.asdict(zoo.ZOO[name]("f")) == dataclasses.asdict(getattr(jax_zoo, name)("f"))
    assert zoo.NOT_PORTED == {} and set(zoo.ZOO) == set(jax_zoo.ZOO)
