"""The port's history zoo (FISM, NAIS, Mult-VAE, Mult-DAE, CDAE) against the
JAX package, on the CPU.

At the JAX model's own params (``convert.params_from_jax``, seeded noise on
every dense leaf), the same seeded inputs go through both:

- ``build_history``, ``UserHistorySampler`` and
  ``PairwiseSampler(with_history)`` bit for bit, with users past H items;
- the ``multvae`` and ``cdae`` losses (a history id repeated in a row);
- each model's pairwise and pointwise forward, without noise, over a
  history holding the scored item, one all padding and one of length 1;
  ``score_all`` over attached histories, and NAIS's against its forward;
- one ``TrainStepBuilder.step`` of each against the JAX step at dropout 0
  (Mult-VAE's reparameterisation noise set to 0 on both sides), with the
  sentinel slots in the l2 term and out of the sparse update;
- the trainer against JAX's (FISM, CDAE: the loss coerced, losses and the
  full-catalog eval), serving from it and from its checkpoint; the
  ``loss_coerced`` events; checkpoints of every dense tree both ways.
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
from tfrec_tpu.data.samplers import PairwiseSampler as JaxPairwiseSampler
from tfrec_tpu.data.samplers import UserHistorySampler as JaxUserHistorySampler
from tfrec_tpu.data.samplers import build_history as jax_build_history
from tfrec_tpu.models import DataSpec as JaxDataSpec
from tfrec_tpu.models import build_model as jax_build_model
from tfrec_tpu.train import losses as jax_losses
from tfrec_tpu.train import step as jax_step
from tfrec_tpu.train.trainer import Trainer as JaxTrainer
from tfrec_tpu_torch import configs, convert
from tfrec_tpu_torch.configs import ModelConfig, OptimConfig
from tfrec_tpu_torch.data.dataset import build_dataset
from tfrec_tpu_torch.data.samplers import PairwiseSampler, UserHistorySampler, build_history
from tfrec_tpu_torch.models import CDAE, FISM, NAIS, DataSpec, MultVAE, build_model
from tfrec_tpu_torch.ops.embedding import gather_many
from tfrec_tpu_torch.serve import Recommender
from tfrec_tpu_torch.train import losses
from tfrec_tpu_torch.train.step import TrainStepBuilder, tree_leaves
from tfrec_tpu_torch.train.trainer import Trainer, run
from tfrec_tpu_torch.utils import checkpoint as ckpt

torch.set_num_threads(1)

# A forward of the same arithmetic in another order
# (tests/test_torch_sequential.py), and a step of it through the normalised
# updates.
RTOL, ATOL = 1e-5, 1e-6
STEP_RTOL, STEP_ATOL = 1e-4, 1e-5
# The trainers over a few epochs (tests/test_torch_retrieval_trainer.py):
# losses within TRAIN_RTOL; recall and NDCG over ~60 users, where an
# exchanged rank moves them by ~1e-3 and rounding by ~1e-8.
TRAIN_RTOL = 1e-4
METRIC_ATOL = 1e-6
NUM_USERS, NUM_ITEMS, H = 30, 50, 8
MODELS = {
    "fism": (FISM, dict(max_history=H, fism_alpha=0.7)),
    "nais": (NAIS, dict(max_history=H, nais_attention_dim=6, nais_beta=0.6)),
    "multvae": (MultVAE, dict(max_history=H, vae_hidden=12, vae_latent=4, vae_beta=0.3, dropout=0.0)),
    "multdae": (MultVAE, dict(max_history=H, vae_hidden=12, vae_latent=4, dropout=0.0)),
    "cdae": (CDAE, dict(max_history=H, vae_hidden=12, dropout=0.0)),
}
AUTOENCODERS = ("multvae", "multdae", "cdae")


def _models(name):
    cls, kw = MODELS[name]
    ref = jax_build_model(JaxModelConfig(name=name, embed_dim=8, **kw),
                          JaxDataSpec.interaction(NUM_USERS, NUM_ITEMS))
    port = build_model(ModelConfig(name=name, embed_dim=8, **kw), DataSpec.interaction(NUM_USERS, NUM_ITEMS))
    assert isinstance(port, cls) and type(port).__name__ == type(ref).__name__
    return port, ref


def _jax_params(ref, seed):
    """JAX's init with seeded noise on every leaf (the zero-initialised
    biases too)."""
    rng = np.random.default_rng(seed)
    params = jax.tree.map(np.asarray, ref.init(jax.random.PRNGKey(0)))
    return jax.tree.map(lambda a: (a + 0.05 * rng.normal(size=a.shape)).astype(np.float32), params)


def _pair(name, seed=1):
    port, ref = _models(name)
    np_params = _jax_params(ref, seed)
    return port, ref, np_params, convert.params_from_jax(np_params, port)


def _hist_batch(seed, b=6):
    """Histories: row 0 holds its positive (self-exclusion), row 1 is all
    padding, row 2 has one item, row 3 a repeated item."""
    rng = np.random.default_rng(seed)
    hist = rng.integers(0, NUM_ITEMS, (b, H)).astype(np.int32)
    hist[0, 5:] = NUM_ITEMS
    hist[1, :] = NUM_ITEMS
    hist[2, 1:] = NUM_ITEMS
    hist[3, 2] = hist[3, 0]
    pos = rng.integers(0, NUM_ITEMS, b).astype(np.int32)
    pos[0] = hist[0, 3]
    return {"user": rng.integers(0, NUM_USERS, b).astype(np.int32), "hist": hist,
            "hist_len": (hist < NUM_ITEMS).sum(1).astype(np.int32), "pos": pos,
            "neg": rng.integers(0, NUM_ITEMS, b).astype(np.int32)}


def _history(seed):
    """Attached histories of H items: one user empty, one full."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, H + 1, NUM_USERS).astype(np.int32)
    lens[:2] = [0, H]
    hist = rng.integers(0, NUM_ITEMS, (NUM_USERS, H)).astype(np.int32)
    hist[np.arange(H)[None, :] >= lens[:, None]] = NUM_ITEMS
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


def _allclose(got, want, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=rtol, atol=atol, err_msg=msg)


# ---- the inputs ----

def _datasets(**kw):
    cfg = dict(source="synthetic_implicit", num_users=40, num_items=60, interactions_per_user=9,
               seed=3, **kw)
    return build_dataset(configs.DataConfig(**cfg)), jax_build_dataset(jax_configs.DataConfig(**cfg))


def _same_batches(ours, ref, epochs=2):
    assert ours.num_batches() == ref.num_batches() > 0
    for epoch in range(epochs):
        got, want = list(ours.epoch(epoch)), list(ref.epoch(epoch))
        assert len(got) == len(want) == ours.num_batches()
        for a, b in zip(got, want):
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("max_len", [4, 20])
def test_build_history_and_user_history_sampler_match_jax(max_len):
    """Cut to a seeded subsample of 4 (most users past it) or padded to 20."""
    port_ds, ref_ds = _datasets()
    for seed in (0, 7):
        got, want = build_history(port_ds, max_len, seed), jax_build_history(ref_ds, max_len, seed)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype == np.int32
            np.testing.assert_array_equal(a, b)
    counts = np.bincount(port_ds.train.users, minlength=port_ds.num_users)
    assert (counts > 4).any() and (got[1] == np.minimum(counts, max_len)).all()
    ours, ref = UserHistorySampler(port_ds, 8, max_len, seed=5), JaxUserHistorySampler(ref_ds, 8, max_len, seed=5)
    np.testing.assert_array_equal(ours.active, ref.active)
    _same_batches(ours, ref)


@pytest.mark.parametrize("mode", ["neg", "multi_neg", "no_negatives"])
def test_pairwise_sampler_with_history_matches_jax(mode):
    port_ds, ref_ds = _datasets()
    kw = {"neg": {}, "multi_neg": {"multi_neg": True, "num_negatives": 3},
          "no_negatives": {"no_negatives": True}}[mode]
    ours = PairwiseSampler(port_ds, 16, seed=4, with_history=5, **kw)
    ref = JaxPairwiseSampler(ref_ds, 16, seed=4, with_history=5, **kw)
    _same_batches(ours, ref)
    assert "hist" in next(ours.epoch(0))


def test_losses_match_jax():
    """``multvae`` over padded histories; ``cdae`` with a repeated id (which
    counts once) and a history all padding."""
    rng = np.random.default_rng(2)
    b, v = 5, 9
    logits = (rng.normal(size=(b, v)) * 4).astype(np.float32)
    kl = rng.random(b).astype(np.float32)
    hist = rng.integers(0, v, (b, 4)).astype(np.int32)
    hist[0, 2:] = v
    hist[1, :] = v
    hist[2, 1] = hist[2, 0]
    hist[3, 3] = v - 1
    batch = {"hist": hist}
    jb = {"hist": jnp.asarray(hist)}
    want = float(jax_losses.multvae({"logits": jnp.asarray(logits), "kl": jnp.asarray(kl)}, jb))
    got = losses.make_loss("multvae")({"logits": torch.from_numpy(logits), "kl": torch.from_numpy(kl)},
                                      {"hist": torch.from_numpy(hist)})
    np.testing.assert_allclose(got.item(), want, rtol=1e-6)
    want = float(jax_losses.cdae(jnp.asarray(logits), jb))
    got = losses.make_loss("cdae")(torch.from_numpy(logits), {"hist": torch.from_numpy(batch["hist"])})
    np.testing.assert_allclose(got.item(), want, rtol=1e-6)
    # A repeated id counts once: the loss with the duplicate padded away is the same.
    deduped = hist.copy()
    deduped[2, 1] = v
    np.testing.assert_allclose(losses.cdae(torch.from_numpy(logits), {"hist": torch.from_numpy(deduped)}).item(),
                               got.item(), rtol=1e-7)


# ---- the models ----

@pytest.mark.parametrize("name", sorted(MODELS))
def test_forward_matches_jax(name):
    """The training forward (pairwise for the item-similarity models, the
    reconstruction for the autoencoders) without noise."""
    port, ref, np_params, params = _pair(name)
    batch = _hist_batch(2)
    if name in AUTOENCODERS:
        batch = {k: batch[k] for k in ("user", "hist", "hist_len")}
    got, want = _forward_pair(port, ref, np_params, params, batch)
    if name in ("multvae", "multdae"):
        assert sorted(got) == ["kl", "logits"]
        for k in got:
            _allclose(got[k], want[k], msg=k)
        assert (got["kl"] == 0).all() == (name == "multdae")
    else:
        assert got.shape == want.shape
        _allclose(got, want)


@pytest.mark.parametrize("name", ["fism", "nais"])
def test_pointwise_forward_matches_jax_and_excludes_the_item(name):
    """Pointwise scores, row 0's item in its own history: left out, so the
    score equals the one over the history without it."""
    port, ref, np_params, params = _pair(name, 3)
    batch = _hist_batch(4)
    batch = {"user": batch["user"], "hist": batch["hist"], "item": batch["pos"],
             "label": np.zeros(6, np.float32)}
    got, want = _forward_pair(port, ref, np_params, params, batch)
    _allclose(got, want)
    without = dict(batch, hist=batch["hist"].copy())
    without["hist"][0, 3] = NUM_ITEMS
    other, _ = _forward_pair(port, ref, np_params, params, without)
    np.testing.assert_allclose(other[0].item(), got[0].item(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_score_all_matches_jax_and_serving(name):
    """Over attached histories (an empty one, a full one), for every user
    and a repeated one; ``Recommender.predict`` serves score_all's entries
    (the attached history read for each request)."""
    port, ref, np_params, params = _pair(name, 5)
    hist, lens = _history(6)
    port.attach_history(hist, lens)
    ref.attach_history(hist, lens)
    users = np.concatenate([np.arange(NUM_USERS), [3, 3]]).astype(np.int32)
    want = np.asarray(ref.score_all(jax.tree.map(jnp.asarray, np_params), jnp.asarray(users)))
    got = port.score_all(params, torch.from_numpy(users))
    assert got.shape == want.shape == (len(users), NUM_ITEMS)
    _allclose(got, want)
    items = np.random.default_rng(7).integers(0, NUM_ITEMS, len(users)).astype(np.int32)
    served = Recommender(port, params, device="cpu").predict(users, items)
    scores = got.numpy()[np.arange(len(users)), items]
    if name == "fism":  # score_all leaves no item out of the history; the forward does
        keep = ~(hist[users] == items[:, None]).any(1)
        np.testing.assert_allclose(served[keep], scores[keep], rtol=RTOL, atol=ATOL)
    else:
        np.testing.assert_allclose(served, scores, rtol=RTOL, atol=ATOL)


def test_nais_score_all_is_its_forward_at_every_item():
    """Chunked over the catalog (a chunk of 7 items here): each entry is the
    pointwise forward of that (user, item) over the attached history, the
    item left out of it."""
    from tfrec_tpu_torch.models import nais as nais_mod

    port, _, _, params = _pair("nais", 8)
    hist, lens = _history(9)
    port.attach_history(hist, lens)
    users = torch.arange(NUM_USERS, dtype=torch.int32)
    whole = port.score_all(params, users)
    old = nais_mod.SCORE_CHUNK_FLOATS
    nais_mod.SCORE_CHUNK_FLOATS = NUM_USERS * H * port.attention_dim * 7
    try:
        chunked = port.score_all(params, users)
    finally:
        nais_mod.SCORE_CHUNK_FLOATS = old
    torch.testing.assert_close(chunked, whole, rtol=RTOL, atol=ATOL)
    u = users.repeat_interleave(NUM_ITEMS)
    items = torch.arange(NUM_ITEMS, dtype=torch.int32).repeat(NUM_USERS)
    batch = {"user": u, "item": items}
    rows = dict(zip(port.lookup_ids(batch), gather_many(
        [params["tables"][k] for k in port.lookup_ids(batch)], list(port.lookup_ids(batch).values()))))
    forward = port(params["dense"], rows, batch).reshape(NUM_USERS, NUM_ITEMS)
    torch.testing.assert_close(whole, forward, rtol=RTOL, atol=ATOL)


OPTIM = dict(learning_rate=0.05, dense_optimizer="adagrad", sparse_optimizer="rowwise_adagrad")


@pytest.mark.parametrize("name", sorted(MODELS))
def test_one_step_matches_jax(name, monkeypatch):
    """One step from JAX's state at dropout 0 with l2, whose term counts
    the gathered sentinel rows as JAX's does; the combine drops those slots
    before the Adagrad update. Mult-VAE's eps is 0 on both sides."""
    monkeypatch.setattr(jax.random, "normal", lambda key, shape, dtype=jnp.float32: jnp.zeros(shape, dtype))
    port, ref, np_params, _ = _pair(name, 9)
    if name == "multvae":
        monkeypatch.setattr(port, "noise", lambda mu, generator: torch.zeros_like(mu))
    loss = {"multvae": "multvae", "multdae": "multvae", "cdae": "cdae"}.get(name, "bpr")
    jb = jax_step.TrainStepBuilder(ref, loss, JaxOptimConfig(**OPTIM), l2_reg=0.01, kernels="xla")
    jstate = jb.init_state(jax.random.PRNGKey(0))
    jstate = {**jstate, "tables": jax.tree.map(jnp.asarray, np_params["tables"]),
              "dense": jax.tree.map(jnp.asarray, np_params["dense"])}
    builder = TrainStepBuilder(port, loss, OptimConfig(**OPTIM), l2_reg=0.01, device="cpu")
    assert (builder._generator(0) is not None) == (name == "multvae")
    state = convert.train_state_from_jax(jax.tree.map(np.asarray, jstate), port)
    batch = _hist_batch(10, b=8)
    if name in AUTOENCODERS:
        batch = {k: batch[k] for k in ("user", "hist", "hist_len")}
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
    # The last row, where the sentinel slots were gathered, moved only if
    # the batch names it.
    table = "item_p" if name in ("fism", "nais") else "enc1"
    named = (batch["hist"] == NUM_ITEMS - 1).any()
    moved = not np.array_equal(state["tables"][table][-1].numpy(), np_params["tables"][table][-1])
    assert moved == named


@pytest.mark.parametrize("name", sorted(MODELS))
def test_build_model_and_checkpoints_carry_the_dense_tree_by_name(tmp_path, name):
    """Each name builds JAX's tables and dense tree (NAIS's att_*, the
    autoencoders' weights); a state's flat keys are JAX's, and each package
    restores the other's checkpoint leaf for leaf."""
    port, ref = _models(name)
    assert [(s.name, s.shape, s.initializer, s.init_scale) for s in port.table_specs()] == [
        (s.name, s.shape, s.initializer, s.init_scale) for s in ref.table_specs()]
    params = port.init(torch.Generator().manual_seed(0), "cpu")
    assert jax.tree.map(lambda t: tuple(t.shape), params) == \
        jax.tree.map(lambda a: tuple(a.shape), ref.init(jax.random.PRNGKey(0)))
    jb = jax_step.TrainStepBuilder(ref, "bpr", JaxOptimConfig(learning_rate=0.01, dense_optimizer="adam"))
    rng = np.random.default_rng(11)
    state = jax.tree.map(lambda x: (rng.normal(size=np.shape(x)).astype(np.float32)
                                    if np.asarray(x).dtype == np.float32 else np.asarray(x) + 3),
                         jb.init_state(jax.random.PRNGKey(0)))
    port_state = convert.train_state_from_jax(state, port)
    got = convert.flat_from_state(port_state, "adam")
    want = {k: np.asarray(v) for k, v in jax_ckpt._flatten(state).items()}
    assert sorted(got) == sorted(want)
    assert any(k.startswith("dense/") for k in got) == (name != "fism")
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


# ---- the trainer and serving ----

def _config(mod, name, ckpt_dir=None, loss="bpr", **train):
    model = {"fism": dict(max_history=12, l2_reg=0.01),
             "nais": dict(max_history=12, nais_attention_dim=4, l2_reg=0.01),
             "multvae": dict(max_history=16, vae_hidden=16, vae_latent=8, dropout=0.5),
             "multdae": dict(max_history=16, vae_hidden=16, vae_latent=8, dropout=0.5),
             "cdae": dict(max_history=16, vae_hidden=16, dropout=0.0)}[name]
    autoencoder = name in AUTOENCODERS
    kw = dict(batch_size=16 if autoencoder else 128, epochs=3, eval_every_epochs=3, eval_topk=(5, 10),
              loss=loss, checkpoint_dir=ckpt_dir, checkpoint_every_epochs=3 if ckpt_dir else 0)
    kw.update(train)
    return mod.Config(
        run_name=name,
        data=mod.DataConfig(source="synthetic_implicit", num_users=96, num_items=120,
                            interactions_per_user=14, seed=1),
        model=mod.ModelConfig(name=name, embed_dim=8, **model),
        optim=mod.OptimConfig(learning_rate=0.05 if not autoencoder else 0.01,
                              dense_optimizer="adagrad" if not autoencoder else "adam"),
        train=mod.TrainConfig(**kw),
        mesh=mod.MeshConfig(data_axis_size=0),  # JAX's single-device path under its 8 CPU devices
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
            rec["config"]["train"]["checkpoint_dir"] = None  # the two runs' own directories
        out.append(rec)
    return out


@pytest.mark.parametrize("name,loss,coerced", [("fism", "logloss", "bpr"), ("cdae", "bpr", "cdae")])
def test_trainer_matches_jax_and_serves_from_a_checkpoint(tmp_path, no_tensorboard, name, loss, coerced):
    """From JAX's initial state: the metric streams (the loss coerced, the
    losses, the full-catalog eval) match; ``from_checkpoint`` serves the
    checkpoint's ``predict`` and ``recommend`` exactly as
    ``from_trainer`` serves the trainer."""
    jt = JaxTrainer(_config(jax_configs, name, str(tmp_path / "jax"), loss=loss), quiet=True)
    cfg = _config(configs, name, str(tmp_path / "port"), loss=loss)
    pt = Trainer(cfg, quiet=True, device="cpu")
    assert pt.loss_name == jt.loss_name == coerced
    np.testing.assert_array_equal(pt.model._hist, np.asarray(jt.model._hist))
    pt.state = convert.train_state_from_jax(jax.tree.map(np.asarray, jt.state), pt.model)
    pt.train()
    jt.train()
    got, want = _records(tmp_path / "port" / f"{name}.metrics.jsonl"), \
        _records(tmp_path / "jax" / f"{name}.metrics.jsonl")
    assert any(r.get("event") == "loss_coerced" and r["to"] == coerced for r in got)
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
    assert np.isfinite(live.score_catalog(users)).all()


@pytest.mark.parametrize("name,loss,event", [
    ("fism", "sampled_softmax", ("sampled_softmax", "bpr")),
    ("nais", "hinge", None),
    ("multvae", "bpr", ("bpr", "multvae")),
    ("multdae", "cdae", ("cdae", "multvae")),
    ("cdae", "multvae", ("multvae", "cdae")),
])
def test_loss_coerced_events_match_jax(tmp_path, no_tensorboard, name, loss, event):
    cfgs = {mod.__name__: _config(mod, name, str(tmp_path / mod.__name__), loss=loss)
            for mod in (configs, jax_configs)}
    pt = Trainer(cfgs[configs.__name__], quiet=True, device="cpu")
    jt = JaxTrainer(cfgs[jax_configs.__name__], quiet=True)
    assert pt.loss_name == jt.loss_name

    def events(mod):
        path = tmp_path / mod.__name__ / f"{name}.metrics.jsonl"
        return [r for r in _records(path) if r.get("event") == "loss_coerced"]

    assert events(configs) == events(jax_configs)
    assert [(r["from"], r["to"]) for r in events(configs)] == ([event] if event else [])


@pytest.mark.parametrize("name", ["nais", "multvae", "multdae"])
def test_run_trains_on_the_cpu(name):
    """``run(config, device="cpu")``: a finite history whose loss falls and
    whose recall@10 beats the random ranking's 10/120 over the users'
    held-out items."""
    _, history = run(_config(configs, name, epochs=6, eval_every_epochs=6), quiet=True, device="cpu")
    assert all(np.isfinite(v) for r in history for v in r.values())
    assert history[-1]["loss"] < history[0]["loss"]
    assert history[-1]["recall@10"] > 10 / 120


def test_refusals():
    with pytest.raises(ValueError, match="attach_history"):
        _models("fism")[0].score_all(None, torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="interaction DataSpec"):
        build_model(ModelConfig(name="cdae"), DataSpec.ctr((5, 6), 0))
    port, _, _, params = _pair("nais")
    batch = {k: torch.from_numpy(v) for k, v in _hist_batch(1).items()}
    batch["negs"] = batch.pop("neg")[:, None]
    with pytest.raises(NotImplementedError, match="single-negative"):
        port(params["dense"], dict(zip(port.lookup_ids(batch), gather_many(
            [params["tables"][k] for k in port.lookup_ids(batch)], list(port.lookup_ids(batch).values())))),
             batch)


def test_zoo_configs_match_jax():
    from tfrec_tpu import zoo_configs as jax_zoo
    from tfrec_tpu_torch import zoo_configs as zoo

    for name in ("fism_ml100k", "nais_ml100k", "multvae_ml100k", "cdae_ml100k"):
        assert zoo.ZOO[name] is getattr(zoo, name) and name not in zoo.NOT_PORTED
        assert dataclasses.asdict(zoo.ZOO[name]()) == dataclasses.asdict(getattr(jax_zoo, name)())
        assert dataclasses.asdict(zoo.ZOO[name]("f")) == dataclasses.asdict(getattr(jax_zoo, name)("f"))
