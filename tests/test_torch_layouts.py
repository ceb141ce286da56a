"""The port's lane-packed and stacked CTR table layouts, their lane-grouped
optimizer state, and every duplicate-combine mode of the single-device
step, against the JAX package and against the port's own per-field step,
on the CPU (the kernels' plain versions; tests/test_torch_cuda.py and
chip_smoke.py hold the kernels on the card).

- table specs, ids, slot widths and the layout-invariant init against the
  reference; DCN and FM forwards in each layout against JAX's same layout
  at params from ``params_from_jax``; three steps in each layout against
  JAX's (``kernels="xla"``);
- the packed and stacked steps, the per-table combine (the step's default
  is the batched one) and the host's dedup sorts, bit for bit the
  per-field step, under
  rowwise Adagrad, SGD and rowwise Adam, as tests/test_lane_pack.py and
  tests/test_stacked_tables.py pin them in the reference;
- the combines and ``host_dedup_sorts`` against the per-table combine and
  the reference's arrays; the grouped Adagrad plain version, group by group;
- checkpoints: JAX's default (AUTO, lane-packed) DCN and FM resume in the
  port and continue as JAX does; the port's packed and stacked checkpoints
  restore in JAX; the trainer's ``train.host_dedup``.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tfrec_tpu.configs as jax_configs
from tfrec_tpu.configs import ModelConfig as JaxModelConfig
from tfrec_tpu.configs import OptimConfig as JaxOptimConfig
from tfrec_tpu.models import DataSpec as JaxDataSpec
from tfrec_tpu.models import build_model as jax_build_model
from tfrec_tpu.ops.embedding import combine_duplicate_ids_grouped as jax_combine_grouped
from tfrec_tpu.ops.sparse_optim import make_sparse_optimizer as jax_sparse_optimizer
from tfrec_tpu.train import step as jax_step
from tfrec_tpu.train.trainer import Trainer as JaxTrainer
from tfrec_tpu_torch import configs
from tfrec_tpu_torch.configs import ModelConfig, OptimConfig
from tfrec_tpu_torch.convert import flat_from_state, params_from_jax, train_state_from_jax
from tfrec_tpu_torch.kernels.adagrad_cuda import fused_rowwise_adagrad
from tfrec_tpu_torch.models import DataSpec, build_model
from tfrec_tpu_torch.ops.embedding import (
    combine_duplicate_ids,
    combine_duplicate_ids_grouped,
    gather_many,
)
from tfrec_tpu_torch.serve import Recommender
from tfrec_tpu_torch.train.step import TrainStepBuilder, host_dedup_sorts, tree_leaves
from tfrec_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)

# DCN at d=32: packs of 4 fields by descending vocab, [300, 200, 120, 80]
# and [64, 50] (D = 128 at G = 4, and 64 at G = 2), rows past a field's
# vocab in each; FM at d=64: [200, 90] and [70] alone (G = 1), its linear
# tables one [200, 3] pack. Bags of 3 and 2 ids.
CASES = {
    "dcn": dict(name="dcn", embed_dim=32, num_cross_layers=2, mlp_dims=(16,),
                vocabs=(300, 120, 80, 50, 200, 64), widths=(1, 1, 3, 1, 1, 2), num_dense=3),
    "fm": dict(name="fm", embed_dim=64, vocabs=(200, 90, 70), widths=(1, 3, 2), num_dense=2),
}
LAYOUTS = {"per_field": {}, "lane_packed": {"lane_pack": True}, "stacked": {"stack_tables": True}}
BATCH = 48
# A forward of the same arithmetic in another order (d <= 128 products, a
# small tower), and three steps of it through the normalised updates, as
# tests/test_torch_train.py holds the per-field step against JAX's.
FWD_RTOL, FWD_ATOL = 1e-5, 1e-6
STEP_RTOL, STEP_ATOL = 1e-4, 1e-5
# A JAX run resumed in the port: one epoch of steps in another order
# (tests/test_torch_checkpoint.py).
TRAIN_RTOL = 1e-4


def _spec(case, mod=None):
    c = CASES[case]
    return (mod or DataSpec).ctr(c["vocabs"], c["num_dense"], c["widths"])


def _model_kw(case, layout, jax_side=False):
    kw = {k: v for k, v in CASES[case].items() if k not in ("vocabs", "widths", "num_dense")}
    kw.update(LAYOUTS[layout])
    if jax_side and layout == "per_field":
        kw["lane_pack"] = False  # the reference's AUTO would pack
    return kw


def _models(case, layout):
    port = build_model(ModelConfig(**_model_kw(case, layout)), _spec(case))
    ref = jax_build_model(JaxModelConfig(**_model_kw(case, layout, True)), _spec(case, JaxDataSpec))
    return port, ref


def _batch(seed, case, edge=False):
    """A CTR batch: bag padding in the multi-hot fields; with ``edge`` also
    negative and out-of-range ids in the single-hot ones (the layouts read
    those rows differently, in both packages alike)."""
    c = CASES[case]
    rng = np.random.default_rng(seed)
    cols = []
    for v, w in zip(c["vocabs"], c["widths"]):
        ids = np.minimum(rng.zipf(1.3, (BATCH, w)) - 1, v - 1).astype(np.int32)
        if w > 1:
            ids[rng.random((BATCH, w)) < 0.3] = v
            ids[0] = v  # a whole bag of padding
        elif edge:
            ids[:3, 0] = [-1, v, v + 4]
        cols.append(ids)
    return {"dense": rng.normal(size=(BATCH, c["num_dense"])).astype(np.float32),
            "cat": np.concatenate(cols, axis=1),
            "label": (rng.random(BATCH) < 0.3).astype(np.float32)}


def _torch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ---- the layouts' structure ----

@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("case", sorted(CASES))
def test_specs_ids_and_slot_widths_match_jax(case, layout):
    port, ref = _models(case, layout)
    spec_keys = ("name", "vocab", "dim", "initializer", "init_scale", "lane_groups")
    assert [tuple(getattr(s, k) for k in spec_keys) for s in port.table_specs()] == [
        tuple(getattr(s, k) for k in spec_keys) for s in ref.table_specs()]
    batch = _batch(1, case, edge=True)
    got, want = port.lookup_ids(_torch(batch)), ref.lookup_ids(batch, xp=np)
    assert list(got) == list(want)
    for name in want:
        assert got[name].dtype == torch.int32 and got[name].is_contiguous()
        np.testing.assert_array_equal(got[name].numpy(), want[name], err_msg=name)
        assert port.lane_slot_widths(name) == ref.lane_slot_widths(name)
    assert list(port.layout_blocks()) == [s.name for s in port.table_specs()]


@pytest.mark.parametrize("layout", ["lane_packed", "stacked"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_init_is_layout_invariant(case, layout):
    """The packed or stacked init holds the per-field init of the same seed,
    block for block; a pack's rows past a field's vocab are zeros; splitting
    and joining again gives the tables back."""
    field = build_model(ModelConfig(**_model_kw(case, "per_field")), _spec(case))
    other = build_model(ModelConfig(**_model_kw(case, layout)), _spec(case))
    want = field.init(torch.Generator().manual_seed(3), "cpu")
    got = other.init(torch.Generator().manual_seed(3), "cpu")
    split = other.split_fields(got["tables"])
    assert all(torch.equal(split[n], want["tables"][n]) for n in want["tables"])
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got["dense"]), tree_leaves(want["dense"])))
    covered = {n: torch.zeros(t.shape, dtype=torch.bool) for n, t in got["tables"].items()}
    for n, t in other.split_fields(covered).items():
        t.fill_(True)
    for n, t in got["tables"].items():
        assert not t[~covered[n]].any(), n
    zeros = {n: torch.zeros_like(t) for n, t in got["tables"].items()}
    again = other.join_fields(split, zeros)
    assert all(torch.equal(again[n], got["tables"][n]) for n in got["tables"])


# ---- against JAX: forwards and steps in each layout ----

def _jax_params(ref, seed):
    params = _np(ref.init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    noisy = lambda a: (a + 0.05 * rng.normal(size=a.shape)).astype(np.float32)  # noqa: E731
    params["dense"] = jax.tree_util.tree_map(noisy, params["dense"])
    params["tables"] = {k: noisy(v) for k, v in params["tables"].items()}  # linear tables too
    return params


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_matches_jax_in_each_layout(case, layout):
    """At JAX's params in its layout, read by ``params_from_jax`` into the
    port's model of the same layout (names and shapes kept), the forward
    gives JAX's logits; ``predict_ctr`` serves them."""
    port, ref = _models(case, layout)
    np_params = _jax_params(ref, 2)
    params = params_from_jax(np_params, port)
    assert list(params["tables"]) == [spec.name for spec in port.table_specs()]
    assert set(params["tables"]) == set(np_params["tables"])
    for name, t in np_params["tables"].items():
        np.testing.assert_array_equal(params["tables"][name].numpy(), t)
    batch = _batch(4, case)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jids = ref.lookup_ids(jb)
    jg = {k: jnp.take(jnp.asarray(np_params["tables"][k]), v, axis=0, mode="clip") for k, v in jids.items()}
    want = np.asarray(ref.forward(jax.tree_util.tree_map(jnp.asarray, np_params["dense"]), jg, jb))
    tb = _torch(batch)
    ids = port.lookup_ids(tb)
    rows = dict(zip(ids, gather_many([params["tables"][k] for k in ids], list(ids.values()))))
    got = port(params["dense"], rows, tb)
    np.testing.assert_allclose(got.numpy(), want, rtol=FWD_RTOL, atol=FWD_ATOL)
    served = Recommender(port, params, device="cpu").predict_ctr(batch["dense"], batch["cat"])
    np.testing.assert_array_equal(served, got.numpy())


OPTIMS = {
    "rowwise_adagrad": dict(learning_rate=0.01, dense_optimizer="adam", sparse_optimizer="rowwise_adagrad",
                            sparse_learning_rate=0.05),
    "rowwise_adam": dict(learning_rate=0.01, dense_optimizer="adam", sparse_optimizer="rowwise_adam",
                         sparse_learning_rate=0.01),
}


@pytest.mark.parametrize("opt", sorted(OPTIMS))
@pytest.mark.parametrize("layout", ["lane_packed", "stacked"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_three_steps_match_jax_in_each_layout(case, layout, opt):
    """Three steps from JAX's state in its layout (``train_state_from_jax``,
    [V, G] or [sum V] optimizer state as it is) against JAX's step with
    kernels="xla": losses, tables and every optimizer leaf. The params are
    JAX's init with noise: at FM's init every logit is ~0, so a row's
    linear-term gradient can cancel to within rounding of 0, and the first
    normalised update (lr * g / |g|) then takes either sign."""
    port, ref = _models(case, layout)
    jb = jax_step.TrainStepBuilder(ref, "logloss", JaxOptimConfig(**OPTIMS[opt]), kernels="xla")
    jstate = jb.init_state(jax.random.PRNGKey(0))
    noisy = _jax_params(ref, 1)
    jstate = {**jstate, "tables": jax.tree_util.tree_map(jnp.asarray, noisy["tables"]),
              "dense": jax.tree_util.tree_map(jnp.asarray, noisy["dense"])}
    builder = TrainStepBuilder(port, "logloss", OptimConfig(**OPTIMS[opt]), device="cpu")
    state = train_state_from_jax(_np(jstate), port)
    jstep = jax.jit(jb.step)
    for seed in range(3):
        batch = _batch(10 + seed, case)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, m = builder.step(state, _torch(batch))
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=STEP_RTOL)
    for name, table in jstate["tables"].items():
        np.testing.assert_allclose(state["tables"][name].numpy(), np.asarray(table), rtol=STEP_RTOL,
                                   atol=STEP_ATOL, err_msg=name)
        for k, leaf in jstate["sparse_opt"][name].items():
            np.testing.assert_allclose(state["sparse_opt"][name][k].numpy(), np.asarray(leaf),
                                       rtol=STEP_RTOL, atol=STEP_ATOL, err_msg=f"{name} {k}")


# ---- the port's own modes, bit for bit the per-field per-table step ----

class PerTableBuilder(TrainStepBuilder):
    """The step with its per-table seam overridden: every table's duplicate
    combine and update alone, where the default step combines each group of
    same-shaped tables in one batched sort."""

    def sparse_update(self, *args, **kw):
        return super().sparse_update(*args, **kw)


MODES = {
    # name: (layout, per-table seams, host sorts)
    "lane_packed": ("lane_packed", False, False),
    "stacked": ("stacked", False, False),
    "per_table": ("per_field", True, False),
    "host_sorts": ("per_field", False, True),
    "lane_packed_per_table": ("lane_packed", True, False),
    "lane_packed_host_sorts": ("lane_packed", False, True),
    "stacked_host_sorts": ("stacked", False, True),
}


def _run(case, layout, opt, per_table=False, host_sorts=False, steps=3):
    model = build_model(ModelConfig(**_model_kw(case, layout)), _spec(case))
    optim = OptimConfig(learning_rate=0.02, sparse_optimizer=opt, sparse_learning_rate=0.05)
    builder = (PerTableBuilder if per_table else TrainStepBuilder)(model, "logloss", optim, device="cpu")
    state = builder.init_state(torch.Generator().manual_seed(0))
    losses = []
    for seed in range(steps):
        batch = _batch(20 + seed, case)
        if host_sorts:
            batch.update(host_dedup_sorts(model, batch))
        state, m = builder.step(state, _torch(batch))
        losses.append(m["loss"])
    leaves = {}
    for key in state["sparse_opt"][next(iter(state["sparse_opt"]))]:
        leaves[key] = model.split_fields({n: s[key] for n, s in state["sparse_opt"].items()},
                                         stat=key in ("acc", "v", "t"))
    return torch.stack(losses), model.split_fields(state["tables"]), leaves


@pytest.mark.parametrize("opt", ["rowwise_adagrad", "sgd", "rowwise_adam"])
@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_every_layout_and_combine_is_the_per_field_step_bit_for_bit(case, mode, opt):
    """Three steps in each mode from the same seed (the layout-invariant
    init): losses, per-field tables and per-field optimizer leaves bit for
    bit the per-field run's (its same-shaped tables combined in one batched
    sort). Packed rowwise Adam goes through the per-table seam in every
    mode (its slots)."""
    want = _run(case, "per_field", opt)
    got = _run(case, MODES[mode][0], opt, *MODES[mode][1:])
    assert torch.equal(got[0], want[0])
    assert all(torch.equal(got[1][n], want[1][n]) for n in want[1])
    assert got[2].keys() == want[2].keys()
    for key in want[2]:
        assert all(torch.equal(got[2][key][n], want[2][key][n]) for n in want[2][key]), key


def test_packed_slots_are_each_ids_lane_group_as_in_jax():
    """A pack's id vector holds its fields' ids one after another: rowwise
    Adam's slots say which lane group each id addresses, as the reference's
    ``_slots_for``; only packed tables under rowwise Adam take them."""
    port, ref = _models("dcn", "lane_packed")
    builder = TrainStepBuilder(port, "logloss", OptimConfig(sparse_optimizer="rowwise_adam"), device="cpu")
    jb = jax_step.TrainStepBuilder(ref, "logloss", JaxOptimConfig(sparse_optimizer="rowwise_adam"))
    assert port.lane_slot_widths("pack_1") == (2, 1)  # fields 5 (a bag of 2) and 3
    for name, n in (("pack_0", 6 * BATCH), ("pack_1", 3 * BATCH)):
        assert builder._grouped_adam(name)
        np.testing.assert_array_equal(builder._slots_for(name, n).numpy(), np.asarray(jb._slots_for(name, n)))
    with pytest.raises(ValueError, match="bags of widths"):
        builder._slots_for("pack_1", 3 * BATCH + 1)
    field = TrainStepBuilder(build_model(ModelConfig(**_model_kw("dcn", "per_field")), _spec("dcn")),
                             "logloss", OptimConfig(sparse_optimizer="rowwise_adam"), device="cpu")
    assert field._slots_for("field_0", BATCH) is None and not field._grouped_adam("field_0")


# ---- the combines, the host's sorts, grouped Adagrad ----

def _combine_inputs(seed, f, n, vocab, dim):
    rng = np.random.default_rng(seed)
    ids = rng.integers(-3, vocab + 3, (f, n)).astype(np.int32)
    ids[:, :4] = [3, 3, vocab, -1]
    return ids, rng.normal(size=(f, n, dim)).astype(np.float32)


def test_grouped_and_host_ordered_combines_are_the_per_table_combine():
    """Bit for bit ``combine_duplicate_ids`` table by table, and JAX's
    batched combine within rounding."""
    ids, grads = _combine_inputs(5, 4, 300, 50, 6)
    sentinels = [50, 50, 50, 50]
    tid, tg = torch.from_numpy(ids), torch.from_numpy(grads)
    per = [combine_duplicate_ids(tid[i], tg[i], 50) for i in range(4)]
    gu, gc = combine_duplicate_ids_grouped(tid, tg, torch.tensor(sentinels)[:, None])
    for i, (u, c) in enumerate(per):
        assert torch.equal(gu[i], u) and torch.equal(gc[i], c)
        key = np.where(ids[i] < 0, 50, ids[i]).astype(np.int64) * 300 + np.arange(300)
        order = torch.from_numpy(np.argsort(key, kind="quicksort").astype(np.int32))
        ou, oc = combine_duplicate_ids(tid[i], tg[i], 50, order=order)
        assert torch.equal(ou, u) and torch.equal(oc, c)
    ju, jc = jax_combine_grouped(jnp.asarray(ids), jnp.asarray(grads), sentinels)
    np.testing.assert_array_equal(gu.numpy(), np.asarray(ju))
    np.testing.assert_allclose(gc.numpy(), np.asarray(jc), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_host_dedup_sorts_match_jax(layout):
    port, ref = _models("dcn", layout)
    batch = _batch(6, "dcn", edge=True)
    got, want = host_dedup_sorts(port, batch), jax_step.host_dedup_sorts(ref, batch)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(3) as pool:
        pooled = host_dedup_sorts(port, batch, pool)
    assert all(np.array_equal(pooled[k], got[k]) for k in got)


@pytest.mark.parametrize("dim,groups", [(128, 4), (64, 2), (6, 6), (96, 6)])
def test_grouped_adagrad_plain_version_is_each_groups_own_update(dim, groups):
    """[V, G] accumulators: each group's lanes bit for bit the one-group
    update of that group alone; against JAX's grouped rowwise Adagrad within
    rounding; a G that does not divide D is refused."""
    rng = np.random.default_rng(dim)
    vocab, n = 400, 300
    table = rng.normal(size=(vocab, dim)).astype(np.float32)
    acc = rng.uniform(0, 0.1, (vocab, groups)).astype(np.float32)
    ids = rng.integers(-2, vocab + 2, n).astype(np.int32)
    g = rng.normal(size=(n, groups, dim // groups)).astype(np.float32)
    g[rng.integers(0, groups, n)[:, None] != np.arange(groups)[None, :]] = 0.0
    g = g.reshape(n, dim)
    uids, c = combine_duplicate_ids(torch.from_numpy(ids), torch.from_numpy(g), vocab)
    got_t, got_a = fused_rowwise_adagrad(torch.from_numpy(table.copy()), torch.from_numpy(acc.copy()),
                                         uids, c, 0.05)
    d = dim // groups
    for j in range(groups):
        lanes = slice(j * d, (j + 1) * d)
        t_j, a_j = fused_rowwise_adagrad(torch.from_numpy(table[:, lanes].copy()),
                                         torch.from_numpy(acc[:, j].copy()), uids, c[:, lanes].contiguous(),
                                         0.05)
        assert torch.equal(got_t[:, lanes], t_j) and torch.equal(got_a[:, j], a_j)
    jopt = jax_sparse_optimizer("rowwise_adagrad")
    jt, js = jopt.apply(jnp.asarray(table), {"acc": jnp.asarray(acc)}, jnp.asarray(ids), jnp.asarray(g), 0.05)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(jt), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got_a.numpy(), np.asarray(js["acc"]), rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="divide"):
        fused_rowwise_adagrad(torch.zeros((4, 4)), torch.zeros((4, 3)), uids[:2].clone(), torch.zeros((2, 4)),
                              0.1)


def test_params_move_between_layouts_and_state_only_in_its_own():
    """JAX per-field params into the port's packed and stacked models (and
    JAX packed params into the per-field one) hold the same per-field
    tables; optimizer state of another layout is refused."""
    field, ref = _models("dcn", "per_field")
    np_params = _jax_params(ref, 7)
    want = params_from_jax(np_params, field)["tables"]
    for layout in ("lane_packed", "stacked"):
        other = build_model(ModelConfig(**_model_kw("dcn", layout)), _spec("dcn"))
        moved = params_from_jax(np_params, other)["tables"]
        assert list(moved) == [s.name for s in other.table_specs()]
        split = other.split_fields(moved)
        assert all(torch.equal(split[n], want[n]) for n in want)
        back = params_from_jax({"tables": {k: v.numpy() for k, v in moved.items()},
                                "dense": np_params["dense"]}, field)["tables"]
        assert all(torch.equal(back[n], want[n]) for n in want)
    _, jpacked = _models("dcn", "lane_packed")
    jb = jax_step.TrainStepBuilder(jpacked, "logloss", JaxOptimConfig(), kernels="xla")
    with pytest.raises(ValueError, match="another table layout"):
        train_state_from_jax(_np(jb.init_state(jax.random.PRNGKey(0))), field)


def test_packed_two_field_fm_scores_the_catalog_as_per_field():
    spec = DataSpec.ctr((40, 60), 0)
    field = build_model(ModelConfig(name="fm", embed_dim=16), spec)
    packed = build_model(ModelConfig(name="fm", embed_dim=16, lane_pack=True), spec)
    assert field.dot_decomposition() is not None and packed.dot_decomposition() is None
    params = field.init(torch.Generator().manual_seed(1), "cpu")
    params["tables"] = {k: v + 0.1 * torch.randn(v.shape, generator=torch.Generator().manual_seed(2))
                        for k, v in params["tables"].items()}
    zeros = {s.name: torch.zeros(s.shape) for s in packed.table_specs()}
    pparams = {"tables": packed.join_fields(params["tables"], zeros), "dense": params["dense"]}
    users = torch.arange(0, 40, 3, dtype=torch.int32)
    assert torch.equal(packed.score_all(pparams, users), field.score_all(params, users))


# ---- checkpoints and the trainer ----

def _ctr_config(mod, ckpt_dir=None, epochs=2, layout=None, **train):
    kw = dict(batch_size=128, epochs=epochs, eval_every_epochs=epochs, loss="logloss", seed=1,
              log_every_steps=0, checkpoint_dir=ckpt_dir, checkpoint_every_epochs=1 if ckpt_dir else 0)
    kw.update(train)
    return mod.Config(
        run_name="layouts",
        data=mod.DataConfig(source="synthetic_ctr", num_examples=2400, num_dense_features=3,
                            categorical_vocab_sizes=(60, 40, 30, 25), test_fraction=0.2, seed=5),
        model=mod.ModelConfig(name="dcn", embed_dim=8, num_cross_layers=2, mlp_dims=(16, 8),
                              lane_pack=layout == "lane_pack" or (None if layout is None else False),
                              stack_tables=layout == "stack_tables"),
        optim=mod.OptimConfig(learning_rate=0.01, sparse_learning_rate=0.05),
        train=mod.TrainConfig(**kw), mesh=mod.MeshConfig(data_axis_size=0))


def _fm_config(mod, ckpt_dir=None, epochs=2, layout=None, **train):
    kw = dict(batch_size=256, epochs=epochs, eval_every_epochs=epochs, loss="logloss", seed=0,
              log_every_steps=0, num_negatives=2, checkpoint_dir=ckpt_dir,
              checkpoint_every_epochs=1 if ckpt_dir else 0)
    kw.update(train)
    return mod.Config(
        run_name="layouts_fm",
        data=mod.DataConfig(source="synthetic_implicit", num_users=128, num_items=256,
                            interactions_per_user=16, seed=0, splitter="ratio", synthetic_side_features=True),
        model=mod.ModelConfig(name="fm", embed_dim=16,
                              lane_pack=layout == "lane_pack" or (None if layout is None else False),
                              stack_tables=layout == "stack_tables"),
        optim=mod.OptimConfig(learning_rate=0.05, sparse_optimizer="rowwise_adagrad"),
        train=mod.TrainConfig(**kw), mesh=mod.MeshConfig(data_axis_size=0))


CONFIGS = {"dcn": _ctr_config, "fm_side_fields": _fm_config}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_jax_default_packed_checkpoint_resumes_in_the_port(tmp_path, name):
    """JAX's default config (``lane_pack=None``) packs DCN's and FM's
    tables; the port resumes its epoch-1 checkpoint under the same config,
    takes the packed layout from it, and its second epoch follows JAX's."""
    make = CONFIGS[name]
    whole, half = str(tmp_path / "whole"), str(tmp_path / "half")
    jt = JaxTrainer(make(jax_configs, whole), quiet=True)
    assert jt.model.lane_pack
    jax_hist = jt.train()
    os.makedirs(half)
    shutil.copytree(os.path.join(whole, "step_0000000001"), os.path.join(half, "step_0000000001"))
    pt = Trainer(make(configs, half, resume=True), quiet=True, device="cpu")
    assert pt.model.lane_pack and pt.start_epoch == 1
    got = pt.train()
    assert [r["epoch"] for r in got] == [1]
    np.testing.assert_allclose(got[0]["loss"], jax_hist[1]["loss"], rtol=TRAIN_RTOL)
    np.testing.assert_allclose(got[0]["auc"], jax_hist[1]["auc"], rtol=0, atol=1e-4)
    for k, t in jt.state["tables"].items():
        np.testing.assert_allclose(pt.state["tables"][k].numpy(), np.asarray(t), rtol=TRAIN_RTOL,
                                   atol=STEP_ATOL, err_msg=k)
        np.testing.assert_allclose(pt.state["sparse_opt"][k]["acc"].numpy(),
                                   np.asarray(jt.state["sparse_opt"][k]["acc"]), rtol=TRAIN_RTOL,
                                   atol=STEP_ATOL, err_msg=k)


@pytest.mark.parametrize("layout", ["lane_pack", "stack_tables"])
def test_port_packed_or_stacked_checkpoint_restores_in_jax(tmp_path, layout):
    """The port's packed or stacked run saves under JAX's keys; JAX resumes
    it in the same layout, leaf for leaf."""
    d = str(tmp_path / "ck")
    pt = Trainer(_ctr_config(configs, d, epochs=1, layout=layout), quiet=True, device="cpu")
    pt.train()
    jt = JaxTrainer(_ctr_config(jax_configs, d, epochs=1, layout=layout, resume=True), quiet=True)
    assert jt.start_epoch == 1 and getattr(jt.model, layout)
    flat = flat_from_state(pt.state, "adam")
    from tfrec_tpu.utils.checkpoint import _flatten

    jflat = _flatten(_np({k: jt.state[k] for k in ("tables", "sparse_opt", "dense")}))
    assert {k for k in jflat if k.startswith(("tables/", "sparse_opt/"))} == {
        k for k in flat if k.startswith(("tables/", "sparse_opt/"))}
    for key, leaf in jflat.items():
        np.testing.assert_array_equal(flat[key], leaf, err_msg=key)


def test_trainer_host_dedup_is_the_run_without_bit_for_bit():
    """train.host_dedup: the prefetch worker adds the host's sorts to each
    train batch (not to eval batches), and the run is the run without them,
    bit for bit, in the per-field and the packed layout."""
    for layout in (False, "lane_pack"):
        runs = []
        for host_dedup in (False, True):
            cfg = _fm_config(configs, epochs=1, layout=layout or "per_field", host_dedup=host_dedup,
                             steps_per_dispatch=2)
            t = Trainer(cfg, quiet=True, device="cpu")
            sample = next(t.sampler.epoch(0))
            assert any(k.startswith("_sort_") for k in t._host_batch(sample)) == host_dedup
            assert not any(k.startswith("_sort_") for k in t._host_batch(sample, train=False))
            runs.append((t.train(), t.state))
        (h0, s0), (h1, s1) = runs
        assert [r["loss"] for r in h0] == [r["loss"] for r in h1] and h0[-1]["auc"] == h1[-1]["auc"]
        assert all(torch.equal(torch.as_tensor(a), torch.as_tensor(b))
                   for a, b in zip(tree_leaves(s0), tree_leaves(s1)))
