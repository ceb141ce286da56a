"""The port's sequential zoo (SASRec, GRU4Rec, Caser, FPMC) against the JAX
package, on the CPU.

At the JAX model's own params (``convert.params_from_jax``, seeded noise on
every dense leaf), the same seeded inputs go through both:

- the training forward ({"pos", "neg", "mask"}) over sequences with padded
  tails, a sequence all padding and one of length 1; the pointwise
  forward, ``score_all`` and ``score_user_items`` over attached histories;
- ``build_sequences`` and ``SequenceSampler`` bit for bit (ties in time
  broken by the seeded jitter), the ``sasrec`` loss, and one
  ``TrainStepBuilder.step`` of each against the JAX step at dropout 0;
- the encoders' causality (a change at position t+1 leaves the hidden
  states at positions <= t as they were), ``make_dropout``'s kept fraction
  and scale;
- the trainer against JAX's (the loss coerced to ``sasrec``, the
  full-catalog and the sampled evals), its serving from the trainer and
  from a checkpoint; checkpoints of every model's dense tree in the JAX
  on-disk layout both ways;
- sasrec, gru4rec, caser and nfm on 2 gloo ranks through the generic mesh
  seams (tests/test_parallel.py:478-520's counterpart).
"""

import dataclasses
import json

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
from tfrec_tpu.data.samplers import SequenceSampler as JaxSequenceSampler
from tfrec_tpu.data.samplers import build_sequences as jax_build_sequences
from tfrec_tpu.models import DataSpec as JaxDataSpec
from tfrec_tpu.models import build_model as jax_build_model
from tfrec_tpu.train import losses as jax_losses
from tfrec_tpu.train import step as jax_step
from tfrec_tpu.train.trainer import Trainer as JaxTrainer
from tfrec_tpu_torch import configs, convert
from tfrec_tpu_torch.configs import ModelConfig, OptimConfig
from tfrec_tpu_torch.data.dataset import build_dataset
from tfrec_tpu_torch.data.samplers import SequenceSampler, build_sequences
from tfrec_tpu_torch.models import FPMC, SASRec, Caser, DataSpec, GRU4Rec, build_model
from tfrec_tpu_torch.models.seq_base import make_dropout
from tfrec_tpu_torch.ops.embedding import gather_many
from tfrec_tpu_torch.serve import Recommender
from tfrec_tpu_torch.train import losses
from tfrec_tpu_torch.train.step import TrainStepBuilder, tree_leaves
from tfrec_tpu_torch.train.trainer import Trainer
from tfrec_tpu_torch.utils import checkpoint as ckpt
from torch_dist_worker import run_ranks

torch.set_num_threads(1)

# A forward of the same arithmetic in another order
# (tests/test_torch_fm_ncf.py), and steps of it through the normalised
# updates (tests/test_torch_layouts.py).
RTOL, ATOL = 1e-5, 1e-6
STEP_RTOL, STEP_ATOL = 1e-4, 1e-5
# The trainers' tolerances (tests/test_torch_retrieval_trainer.py): losses
# over a few epochs of steps; ranking metrics over ~60 users, where an
# exchanged rank moves them by ~1e-3 and rounding by ~1e-8.
TRAIN_RTOL = 1e-4
METRIC_ATOL = 1e-6
NUM_USERS, NUM_ITEMS, L = 30, 50, 12
MODELS = {
    "sasrec": (SASRec, dict(max_history=L, sasrec_blocks=2, sasrec_heads=2, dropout=0.0)),
    "gru4rec": (GRU4Rec, dict(max_history=L, gru_hidden=12, gru_layers=2)),
    "caser": (Caser, dict(max_history=L, caser_h_filters=4, caser_heights=(2, 3),
                          caser_v_filters=2, dropout=0.0)),
    "fpmc": (FPMC, dict(max_history=L)),
}


def _models(name):
    cls, kw = MODELS[name]
    ref = jax_build_model(JaxModelConfig(name=name, embed_dim=8, **kw),
                          JaxDataSpec.interaction(NUM_USERS, NUM_ITEMS))
    port = build_model(ModelConfig(name=name, embed_dim=8, **kw), DataSpec.interaction(NUM_USERS, NUM_ITEMS))
    assert isinstance(port, cls) and type(port).__name__ == type(ref).__name__
    return port, ref


def _jax_params(ref, seed):
    rng = np.random.default_rng(seed)
    params = jax.tree.map(np.asarray, ref.init(jax.random.PRNGKey(0)))
    params["dense"] = jax.tree.map(
        lambda a: (a + 0.05 * rng.normal(size=a.shape)).astype(np.float32), params["dense"])
    return params


def _pair(name, seed=1):
    port, ref = _models(name)
    np_params = _jax_params(ref, seed)
    return port, ref, np_params, convert.params_from_jax(np_params, port)


def _seq_batch(seed, b=6):
    """Sequences with padded tails: row 1 all padding, row 2 one item."""
    rng = np.random.default_rng(seed)
    seq = rng.integers(0, NUM_ITEMS, (b, L)).astype(np.int32)
    seq[0, 7:] = NUM_ITEMS
    seq[1, :] = NUM_ITEMS
    seq[2, 1:] = NUM_ITEMS
    return {"user": rng.integers(0, NUM_USERS, b).astype(np.int32), "seq": seq,
            "seq_len": (seq < NUM_ITEMS).sum(1).astype(np.int32),
            "seq_negs": rng.integers(0, NUM_ITEMS, (b, L - 1)).astype(np.int32)}


def _history(seed):
    """Attached histories of L - 1 positions: some users empty, some full."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, L, NUM_USERS).astype(np.int32)
    lens[:2] = [0, L - 1]
    hist = rng.integers(0, NUM_ITEMS, (NUM_USERS, L - 1)).astype(np.int32)
    hist[np.arange(L - 1)[None, :] >= lens[:, None]] = NUM_ITEMS
    return hist, lens


def _forward_pair(port, ref, np_params, params, batch):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jg = {k: jnp.take(jnp.asarray(np_params["tables"][k]), v, axis=0, mode="clip")
          for k, v in ref.lookup_ids(jb).items()}
    want = ref.forward(jax.tree.map(jnp.asarray, np_params["dense"]), jg, jb)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    ids = port.lookup_ids(tb)
    assert list(ids) == list(ref.lookup_ids(jb))
    rows = dict(zip(ids, gather_many([params["tables"][k] for k in ids], list(ids.values()))))
    return port(params["dense"], rows, tb), want


@pytest.mark.parametrize("name", sorted(MODELS))
def test_training_forward_matches_jax(name):
    port, ref, np_params, params = _pair(name)
    got, want = _forward_pair(port, ref, np_params, params, _seq_batch(2))
    assert sorted(got) == ["mask", "neg", "pos"]
    np.testing.assert_array_equal(got["mask"].numpy(), np.asarray(want["mask"]))
    for k in ("pos", "neg"):
        assert got[k].shape == (6, L - 1)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=RTOL, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_pointwise_forward_score_all_and_score_user_items_match_jax(name):
    """Over attached histories (an empty one, a full one); the pointwise
    forward is ``predict``'s, which serves it with the batch extras."""
    port, ref, np_params, params = _pair(name, 3)
    hist, lens = _history(4)
    port.attach_history(hist, lens)
    ref.attach_history(hist, lens)
    jp = jax.tree.map(jnp.asarray, np_params)
    rng = np.random.default_rng(5)
    users = np.concatenate([np.arange(NUM_USERS), [3, 3]]).astype(np.int32)
    want = np.asarray(ref.score_all(jp, jnp.asarray(users)))
    got = port.score_all(params, torch.from_numpy(users))
    assert got.shape == want.shape == (len(users), NUM_ITEMS)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    cands = rng.integers(0, NUM_ITEMS + 2, (len(users), 7)).astype(np.int32)  # ids past V clip
    want = np.asarray(ref.score_user_items(jp, jnp.asarray(users), jnp.asarray(cands)))
    got = port.score_user_items(params, torch.from_numpy(users), torch.from_numpy(cands))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    batch = {"user": users, "item": rng.integers(0, NUM_ITEMS, len(users)).astype(np.int32),
             "label": np.zeros(len(users), np.float32)}
    got, want = _forward_pair(port, ref, np_params, params, batch)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    served = Recommender(port, params, device="cpu").predict(batch["user"], batch["item"])
    np.testing.assert_allclose(served, got.numpy(), rtol=RTOL, atol=ATOL)
    # The pointwise score is score_all's entry.
    all_scores = port.score_all(params, torch.from_numpy(users)).numpy()
    np.testing.assert_allclose(got.numpy(), all_scores[np.arange(len(users)), batch["item"]],
                               rtol=RTOL, atol=ATOL)


def _datasets(**kw):
    cfg = dict(source="synthetic_implicit", num_users=40, num_items=60, interactions_per_user=9,
               splitter="leave_one_out", seed=3, **kw)
    port, ref = build_dataset(configs.DataConfig(**cfg)), jax_build_dataset(jax_configs.DataConfig(**cfg))
    # Ties in time everywhere but a few rows: the seeded jitter orders them.
    for ds in (port, ref):
        ds.train.times = np.where(np.arange(len(ds.train.times)) % 5 == 0, ds.train.times, 0.0)
    return port, ref


@pytest.mark.parametrize("max_len", [4, 20])
def test_build_sequences_and_sequence_sampler_match_jax(max_len):
    """Cut to the most recent ``max_len`` (4) or padded (20); two epochs of
    batches; ``order_seed`` apart from the shuffle's seed."""
    port_ds, ref_ds = _datasets()
    for seed in (0, 7):
        got, want = build_sequences(port_ds, max_len, seed), jax_build_sequences(ref_ds, max_len, seed)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype == np.int32
            np.testing.assert_array_equal(a, b)
    ours = SequenceSampler(port_ds, 8, max_len, seed=5, order_seed=2)
    ref = JaxSequenceSampler(ref_ds, 8, max_len, seed=5, order_seed=2)
    np.testing.assert_array_equal(ours.active, ref.active)
    assert ours.num_batches() == ref.num_batches() > 0
    for epoch in range(2):
        batches = list(ours.epoch(epoch))
        want = list(ref.epoch(epoch))
        assert len(batches) == len(want) == ours.num_batches()
        for a, b in zip(batches, want):
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_sasrec_loss_matches_jax_and_masks_padding():
    rng = np.random.default_rng(6)
    out = {"pos": rng.normal(size=(5, 9)).astype(np.float32) * 30,
           "neg": rng.normal(size=(5, 9)).astype(np.float32) * 30,
           "mask": rng.random((5, 9)) < 0.6}
    want = float(jax_losses.sasrec({k: jnp.asarray(v) for k, v in out.items()}, {}))
    got = losses.make_loss("sasrec")({k: torch.from_numpy(v) for k, v in out.items()}, {})
    np.testing.assert_allclose(got.item(), want, rtol=1e-6)
    empty = {k: torch.from_numpy(v) for k, v in out.items()}
    empty["mask"] = torch.zeros(5, 9, dtype=torch.bool)
    assert losses.sasrec(empty, {}).item() == 0.0


def _hidden(port, params, seq, users):
    """The encoder's hidden states [B, L, D] of ``seq``."""
    t = params["tables"]
    rows = gather_many([t["item_emb"]], [seq.reshape(-1)])[0].reshape(*seq.shape, -1)
    rows = torch.where((seq < NUM_ITEMS)[:, :, None], rows, 0.0)
    gathered = {"trans_emb": gather_many([t["trans_emb"]], [seq.reshape(-1)])[0]} if "trans_emb" in t else None
    user_rows = t["user_emb"][users.long()] if port.uses_user else None
    return port._encode(params["dense"], rows, seq, user_rows, generator=None, gathered=gathered)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_encoders_are_causal(name):
    """A change of the item at position t+1 leaves every hidden state at
    positions <= t as it was, and changes the one at t+1."""
    port, _, _, params = _pair(name, 7)
    batch = _seq_batch(8)
    seq, users = torch.from_numpy(batch["seq"][[0, 3, 4, 5]]), torch.from_numpy(batch["user"][[0, 3, 4, 5]])
    base = _hidden(port, params, seq, users)
    for t in (0, 4, L - 2):
        changed = seq.clone()
        changed[1:, t + 1] = (changed[1:, t + 1] + 7) % NUM_ITEMS
        other = _hidden(port, params, changed, users)
        np.testing.assert_allclose(other[:, : t + 1].numpy(), base[:, : t + 1].numpy(), rtol=0, atol=1e-6)
        assert not np.allclose(other[1:, t + 1].numpy(), base[1:, t + 1].numpy())


def test_make_dropout_keeps_its_fraction_scaled():
    x = torch.ones(200_000)
    drop = make_dropout(torch.Generator().manual_seed(0), 0.3)
    y = drop(x)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.7) < 0.005
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / 0.7))
    assert torch.equal(make_dropout(None, 0.3)(x), x) and torch.equal(make_dropout(
        torch.Generator(), 0.0)(x), x)
    # Draws follow one another: two sites differ, a reseeded generator repeats.
    again = make_dropout(torch.Generator().manual_seed(0), 0.3)(x)
    assert torch.equal(y, again) and not torch.equal(drop(x), y)


OPTIM = dict(learning_rate=0.01, dense_optimizer="adam", sparse_optimizer="rowwise_adam",
             sparse_learning_rate=0.02)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_one_step_matches_jax(name):
    """One step from JAX's state at dropout 0 with l2 (whose batch size is
    the dict output's "mask" leaf's): the loss, the tables, rowwise Adam's
    leaves and the dense params. The step combines the sequences' and
    negatives' ids into one update of ``item_emb``."""
    port, ref, np_params, _ = _pair(name, 9)
    jb = jax_step.TrainStepBuilder(ref, "sasrec", JaxOptimConfig(**OPTIM), l2_reg=0.01, kernels="xla")
    jstate = jb.init_state(jax.random.PRNGKey(0))
    jstate = {**jstate, "dense": jax.tree.map(jnp.asarray, np_params["dense"])}
    builder = TrainStepBuilder(port, "sasrec", OptimConfig(**OPTIM), l2_reg=0.01, device="cpu")
    state = convert.train_state_from_jax(jax.tree.map(np.asarray, jstate), port)
    batch = _seq_batch(10, b=8)
    jstate, jm = jax.jit(jb.step)(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    state, m = builder.step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=STEP_RTOL)
    for tname, table in jstate["tables"].items():
        np.testing.assert_allclose(state["tables"][tname].numpy(), np.asarray(table), rtol=STEP_RTOL,
                                   atol=STEP_ATOL, err_msg=tname)
        for leaf, v in jstate["sparse_opt"][tname].items():
            np.testing.assert_allclose(state["sparse_opt"][tname][leaf].numpy(), np.asarray(v),
                                       rtol=STEP_RTOL, atol=STEP_ATOL, err_msg=f"{tname} {leaf}")
    want = convert.params_from_jax(jax.tree.map(np.asarray, {"tables": jstate["tables"],
                                                             "dense": jstate["dense"]}), port)
    for got, w in zip(tree_leaves(state["dense"]), tree_leaves(want["dense"])):
        np.testing.assert_allclose(got.numpy(), w.numpy(), rtol=STEP_RTOL, atol=STEP_ATOL)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_build_model_and_checkpoints_carry_the_dense_tree_by_name(tmp_path, name):
    """Each newly ported name builds JAX's tables and dense tree (nested
    ``b{i}``, ``l{i}`` and ``h{h}`` subtrees, FPMC's empty one); a state's
    flat keys are JAX's, and each package restores the other's checkpoint
    leaf for leaf."""
    port, ref = _models(name)
    assert [(s.name, s.shape, s.initializer) for s in port.table_specs()] == [
        (s.name, s.shape, s.initializer) for s in ref.table_specs()]
    params = port.init(torch.Generator().manual_seed(0), "cpu")
    assert jax.tree.map(lambda t: tuple(t.shape), params) == \
        jax.tree.map(lambda a: tuple(a.shape), ref.init(jax.random.PRNGKey(0)))
    jb = jax_step.TrainStepBuilder(ref, "sasrec", JaxOptimConfig(**OPTIM))
    rng = np.random.default_rng(11)
    state = jax.tree.map(lambda x: (rng.normal(size=np.shape(x)).astype(np.float32)
                                    if np.asarray(x).dtype == np.float32 else np.asarray(x) + 3),
                         jb.init_state(jax.random.PRNGKey(0)))
    port_state = convert.train_state_from_jax(state, port)
    got = convert.flat_from_state(port_state, "adam")
    want = {k: np.asarray(v) for k, v in jax_ckpt._flatten(state).items()}
    assert sorted(got) == sorted(want)
    assert any(k.startswith("dense/") for k in got) == (name != "fpmc")
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


# ---- the trainer, serving, the mesh ----

def _config(mod, name, ckpt_dir, **train):
    model = {"sasrec": dict(max_history=10, sasrec_blocks=1, dropout=0.0),
             "caser": dict(max_history=10, caser_h_filters=4, caser_heights=(2, 3), caser_v_filters=2,
                           dropout=0.0)}[name]
    kw = dict(batch_size=16, epochs=2, eval_every_epochs=2, eval_topk=(5, 10), loss="bpr",
              checkpoint_dir=ckpt_dir, checkpoint_every_epochs=2)
    kw.update(train)
    return mod.Config(
        run_name=name,
        data=mod.DataConfig(source="synthetic_implicit", num_users=64, num_items=80,
                            interactions_per_user=10, splitter="leave_one_out", seed=1),
        model=mod.ModelConfig(name=name, embed_dim=8, **model),
        optim=mod.OptimConfig(learning_rate=0.01, dense_optimizer="adam", sparse_optimizer="rowwise_adam"),
        train=mod.TrainConfig(**kw),
        mesh=mod.MeshConfig(data_axis_size=0),  # JAX's single-device path under its 8 CPU devices
    )


def _records(path):
    out = []
    for line in path.read_text().splitlines():
        rec = json.loads(line)
        rec.pop("wall_s")
        rec.pop("examples_per_s", None)
        if rec.get("event") == "run_config":
            rec["config"]["train"]["checkpoint_dir"] = None  # the two runs' own directories
        out.append(rec)
    return out


@pytest.mark.parametrize("name,protocol", [("sasrec", "full"), ("caser", "sampled")])
def test_trainer_matches_jax_and_serves_from_a_checkpoint(tmp_path, name, protocol):
    """From JAX's initial state: the metric streams (the loss coerced from
    bpr to sasrec, the losses, the full-catalog or the sampled eval) match;
    ``from_checkpoint`` serves the checkpoint's ``predict`` and
    ``recommend`` exactly as ``from_trainer`` serves the trainer."""
    train = {"eval_protocol": protocol, "eval_num_candidates": 20} if protocol == "sampled" else {}
    jt = JaxTrainer(_config(jax_configs, name, str(tmp_path / "jax"), **train), quiet=True)
    cfg = _config(configs, name, str(tmp_path / "port"), **train)
    pt = Trainer(cfg, quiet=True, device="cpu")
    assert pt.loss_name == jt.loss_name == "sasrec"
    np.testing.assert_array_equal(pt.model._hist, np.asarray(jt.model._hist))
    pt.state = convert.train_state_from_jax(jax.tree.map(np.asarray, jt.state), pt.model)
    pt.train()
    jt.train()
    got, want = _records(tmp_path / "port" / f"{name}.metrics.jsonl"), \
        _records(tmp_path / "jax" / f"{name}.metrics.jsonl")
    assert {"event": "loss_coerced", "from": "bpr", "to": "sasrec",
            "reason": f"{name} trains on its own reconstruction objective"} in got
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
    assert any(k.startswith("hr@" if protocol == "sampled" else "recall@") for k in got[-1])

    live = Recommender.from_trainer(pt)
    disk = Recommender.from_checkpoint(cfg, device="cpu")
    users = np.array([0, 5, 5, 63], np.int32)
    items = np.array([1, 2, 79, 40], np.int32)
    np.testing.assert_array_equal(disk.predict(users, items), live.predict(users, items))
    for a, b in zip(disk.recommend(users, 10), live.recommend(users, 10)):
        np.testing.assert_array_equal(a, b)
    scores = live.score_catalog(users)
    np.testing.assert_allclose(live.predict(users, items), scores[np.arange(4), items], rtol=RTOL, atol=ATOL)


def test_sequence_path_refusals():
    cfg = _config(configs, "sasrec", None, neg_sampling="popularity")
    with pytest.raises(ValueError, match="'sasrec' data path"):
        Trainer(cfg, quiet=True, device="cpu")
    with pytest.raises(ValueError, match="interaction DataSpec"):
        build_model(ModelConfig(name="gru4rec"), DataSpec.ctr((5, 6), 0))
    with pytest.raises(ValueError, match="num_heads"):
        build_model(ModelConfig(name="sasrec", embed_dim=10, sasrec_heads=3),
                    DataSpec.interaction(NUM_USERS, NUM_ITEMS))
    with pytest.raises(ValueError, match="attach_history"):
        _models("gru4rec")[0].score_all(None, torch.zeros(2, dtype=torch.int32))


MESH_MODELS = {
    "sasrec": dict(max_history=12, sasrec_blocks=1),
    "gru4rec": dict(max_history=12, gru_hidden=16),
    "caser": dict(max_history=12, caser_h_filters=4, caser_heights=(2,), caser_v_filters=2),
    "nfm": dict(mlp_dims=(16,)),
}


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """Every MESH_MODELS config trained on 2 gloo ranks in one spawn."""
    runs = []
    for name, extra in MESH_MODELS.items():
        is_ctr = name == "nfm"
        data = (configs.DataConfig(source="synthetic_ctr", num_examples=4_000, num_dense_features=3,
                                   categorical_vocab_sizes=(40, 30), test_fraction=0.2, seed=2)
                if is_ctr else
                configs.DataConfig(source="synthetic_implicit", num_users=128, num_items=256,
                                   interactions_per_user=12, seed=2))
        cfg = configs.Config(
            run_name=name, data=data, model=configs.ModelConfig(name=name, embed_dim=16, **extra),
            optim=configs.OptimConfig(learning_rate=0.02),
            train=configs.TrainConfig(batch_size=64, epochs=3, eval_every_epochs=0,
                                      loss="logloss" if is_ctr else "bpr"))
        runs.append((name, cfg, None))
    return run_ranks("trainer", 2, {"runs": runs}, tmp_path_factory.mktemp("mesh"), timeout=240.0)


@pytest.mark.parametrize("name", list(MESH_MODELS))
def test_new_families_train_on_two_gloo_ranks(mesh_runs, name):
    """Through the generic lookup and sparse-update seams of the sharded
    step, with no model-specific mesh code: a finite, falling loss."""
    run = mesh_runs[name]
    assert run["mesh"] == {"data": 2, "table": 1}
    losses = [h["loss"] for h in run["history"]]
    assert len(losses) == 3 and np.isfinite(losses).all() and losses[-1] < losses[0], losses
