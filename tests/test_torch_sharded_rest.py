"""The rest of the port's sharded subsystem against the JAX package's mesh
path, on the CPU: the lane-sliced wire of lane-packed row-sharded tables,
FSDP dense params and IRGAN's sharded step.

One spawn of gloo ranks a world size (2 and 4; tests/torch_dist_worker.py
job ``rest``) runs every sharded check, from one converted state, held
against the port's single-device step at both sizes and against JAX's
``RowShardedTable(lane_groups=G)`` and ``ShardedTrainStepBuilder`` on a
mesh of 4 of the 8 virtual CPU devices (tests/conftest.py; IRGAN and the
lane-sliced lookup and update on 2 as well):

- the lane-sliced lookup (exact at the f32 and bf16 wires) and update
  under Adagrad, Adam and SGD (the reference's UPDATE tolerance,
  tests/test_parallel.py:95-99), and 3 packed DCN steps with a multi-hot,
  sentinel-padded field under Adagrad and Adam against JAX's 4-device
  packed mesh steps (tests/test_lane_pack.py:299-353: loss rtol 1e-5,
  tables and state rtol 1e-5, atol 1e-6) and the single-device packed
  step; the "merge" combine, the re-derived route and the permuted layout
  bit for bit the default, the bf16 wire against JAX's; every float buffer
  on the wire [F, N, C, d], never G * d lanes wide (as
  tests/test_lane_pack.py:355-400 pins for JAX);
- FSDP: 3 steps bit for bit the replicated dense params' (losses, tables,
  dense params and moments), at least one leaf split, fewer dense bytes a
  rank, and against JAX's FSDP step (tests/test_parallel.py:305-356);
- IRGAN: 3 sharded steps against JAX's mesh step, JAX's Gumbel draws of the
  global batch passed to the port's ranks.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from tfrec_tpu.configs import MeshConfig as JaxMeshConfig
from tfrec_tpu.configs import ModelConfig as JaxModelConfig
from tfrec_tpu.configs import OptimConfig as JaxOptimConfig
from tfrec_tpu.models import DataSpec as JaxDataSpec
from tfrec_tpu.models import build_model as jax_build_model
from tfrec_tpu.ops.sparse_optim import make_sparse_optimizer as jax_sparse_optimizer
from tfrec_tpu.parallel import embedding as jax_embedding
from tfrec_tpu.parallel.mesh import make_mesh as jax_make_mesh
from tfrec_tpu.parallel.step import ShardedTrainStepBuilder as JaxShardedBuilder
from tfrec_tpu.train.step import TrainStepBuilder as JaxTrainStepBuilder
from tfrec_tpu_torch.configs import MeshConfig, ModelConfig, OptimConfig
from tfrec_tpu_torch.convert import train_state_from_jax
from tfrec_tpu_torch.models import DataSpec, build_model
from tfrec_tpu_torch.parallel.embedding import pad_vocab
from tfrec_tpu_torch.parallel.step import ShardedTrainStepBuilder, fsdp_axis
from tfrec_tpu_torch.train.step import TrainStepBuilder, copy_state
from torch_dist_worker import _np, _tensors, run_ranks

torch.set_num_threads(1)

WORLDS = (2, 4)
JAX_WORLD = 4  # the world size of the JAX mesh steps (IRGAN's at both)
UPDATE_RTOL, UPDATE_ATOL = 1e-5, 1e-6  # tests/test_parallel.py:95-99
LANE_LOSS_RTOL, LANE_RTOL, LANE_ATOL = 1e-5, 1e-5, 1e-6  # tests/test_lane_pack.py:336-353
FSDP_LOSS_RTOL, FSDP_RTOL, FSDP_ATOL = 1e-5, 2e-5, 1e-6  # tests/test_parallel.py:346-356
STEP_RTOL, STEP_ATOL = 2e-4, 1e-5  # tests/test_parallel.py:205-208
IRGAN_RTOL, IRGAN_ATOL = 1e-4, 1e-5  # tests/test_torch_social_adv_zoo.py's 3 steps

# The lane-sliced table: V rows of G groups of d lanes.
LV, LD, LG, LB = 100, 8, 4, 64
# The packed DCN (tests/test_lane_pack.py:307-311): one pack of 4 fields of d=32.
LANE_VOCABS, LANE_WIDTHS, LANE_DENSE, LANE_BATCH = (96, 64, 40, 56), (1, 2, 1, 1), 2, 64
LANE_MODEL = dict(name="dcn", embed_dim=32, mlp_dims=(16,), num_cross_layers=2, lane_pack=True)
LANE_VARIANTS = {"rowwise_adagrad": {"f32": dict(a2a_dtype="float32"),
                                     "bf16": dict(a2a_dtype="bfloat16"),
                                     "merge": dict(a2a_dtype="float32", recv_combine="merge"),
                                     "no_reuse": dict(a2a_dtype="float32", route_reuse=False),
                                     "permute": dict(a2a_dtype="float32", row_permute=True)},
                 "rowwise_adam": {"f32": dict(a2a_dtype="float32"),
                                  "replicated": dict(a2a_dtype="float32", table_sharding="replicated")}}
# FSDP (tests/test_parallel.py:305-356).
FSDP_VOCABS, FSDP_DENSE, FSDP_BATCH = (200, 100, 64), 5, 64
FSDP_MODEL = dict(name="dcn", embed_dim=16, mlp_dims=(64, 32), lane_pack=False)
FSDP_OPTIM = dict(learning_rate=0.01, dense_optimizer="adam", sparse_optimizer="rowwise_adagrad")
# IRGAN on interaction data, K negatives a row.
IRGAN_USERS, IRGAN_ITEMS, IRGAN_K, IRGAN_BATCH, IRGAN_SEED = 30, 50, 4, 16, 4
IRGAN_MODEL = dict(name="irgan", embed_dim=8, irgan_temperature=0.5)
IRGAN_OPTIM = dict(learning_rate=0.05, dense_optimizer="adagrad", sparse_optimizer="rowwise_adagrad")


def _normal(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _ctr_batches(seed, vocabs, widths, num_dense, b, steps=3):
    """CTR batches whose bags are sentinel-padded past a random length
    (tests/test_lane_pack.py's ``_ctr_batch``)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        cols = []
        for v, w in zip(vocabs, widths):
            ids = rng.integers(0, v, (b, w)).astype(np.int32)
            if w > 1:
                keep = rng.integers(1, w + 1, b)
                ids[np.arange(w)[None, :] >= keep[:, None]] = v
            cols.append(ids)
        out.append({"dense": rng.normal(size=(b, num_dense)).astype(np.float32),
                    "cat": np.concatenate(cols, axis=1),
                    "label": rng.integers(0, 2, b).astype(np.float32)})
    return out


def _irgan_batches(steps=3):
    rng = np.random.default_rng(21)
    return [{"user": rng.integers(0, IRGAN_USERS, IRGAN_BATCH).astype(np.int32),
             "pos": rng.integers(0, IRGAN_ITEMS, IRGAN_BATCH).astype(np.int32),
             "negs": rng.integers(0, IRGAN_ITEMS, (IRGAN_BATCH, IRGAN_K)).astype(np.int32)}
            for _ in range(steps)]


def _irgan_draws(steps=3):
    """JAX's Gumbel draw of each step: fold_in(fold_in(PRNGKey(seed), step), 0x1269A7)."""
    return [np.array(jax.random.gumbel(jax.random.fold_in(jax.random.fold_in(
        jax.random.PRNGKey(IRGAN_SEED), s), 0x1269A7), (IRGAN_BATCH, IRGAN_K), dtype=jnp.float32))
            for s in range(steps)]


CASES = {
    "lane_adagrad": dict(model=LANE_MODEL, data_spec=("ctr", (LANE_VOCABS, LANE_DENSE, LANE_WIDTHS)),
                         loss="logloss", optim=dict(learning_rate=0.01, sparse_optimizer="rowwise_adagrad",
                                                    adagrad_init=0.1),
                         batches=lambda: _ctr_batches(9, LANE_VOCABS, LANE_WIDTHS, LANE_DENSE, LANE_BATCH)),
    "lane_adam": dict(model=LANE_MODEL, data_spec=("ctr", (LANE_VOCABS, LANE_DENSE, LANE_WIDTHS)),
                      loss="logloss", optim=dict(learning_rate=0.01, sparse_optimizer="rowwise_adam"),
                      batches=lambda: _ctr_batches(9, LANE_VOCABS, LANE_WIDTHS, LANE_DENSE, LANE_BATCH)),
    "fsdp": dict(model=FSDP_MODEL, data_spec=("ctr", (FSDP_VOCABS, FSDP_DENSE)), loss="logloss",
                 optim=FSDP_OPTIM,
                 batches=lambda: _ctr_batches(5, FSDP_VOCABS, (1,) * 3, FSDP_DENSE, FSDP_BATCH)),
    "irgan": dict(model=IRGAN_MODEL, data_spec=("interaction", (IRGAN_USERS, IRGAN_ITEMS)), loss="irgan",
                  optim=IRGAN_OPTIM, seed=IRGAN_SEED, l2_reg=0.01, batches=_irgan_batches),
}


def _specs(case):
    kind, args = case["data_spec"]
    if kind == "ctr":
        return JaxDataSpec.ctr(*args), DataSpec.ctr(*args)
    return JaxDataSpec.interaction(*args), DataSpec.interaction(*args)


def _jax_model(case):
    return jax_build_model(JaxModelConfig(**case["model"]), _specs(case)[0])


def _port_model(case):
    return build_model(ModelConfig(**case["model"]), _specs(case)[1])


def _case_spec(name):
    """A case for the ranks: its settings, batches and JAX's initial state
    (the single-device builder's init, which the mesh builder pads)."""
    case = CASES[name]
    jb = JaxTrainStepBuilder(_jax_model(case), case["loss"], JaxOptimConfig(**case["optim"]),
                             l2_reg=case.get("l2_reg", 0.0), seed=case.get("seed", 0))
    state = train_state_from_jax(jax.tree.map(np.asarray, jb.init_state(jax.random.PRNGKey(0))),
                                 _port_model(case))
    return {**{k: v for k, v in case.items() if k != "batches"}, "batches": case["batches"](),
            "state": _np(state)}


def _lane_table_spec():
    rng = np.random.default_rng(3)
    vocab_pad = pad_vocab(LV, 4)
    fixed = np.array([3, 3, 3, 0, LV - 1, LV, vocab_pad, vocab_pad + 5, -1, -7, 7, 7], np.int32)
    ids = np.concatenate([fixed, rng.integers(0, LV, LB - fixed.size)]).astype(np.int32)
    slots = rng.integers(0, LG, LB).astype(np.int64)
    slots[:3] = (0, 0, 2)  # id 3 in two groups, twice in one
    grads = _normal(4, (LB, LG, LD)) * (np.arange(LG)[None, :, None] == slots[:, None, None])
    return {"vocab": LV, "dim": LG * LD, "groups": LG, "table": _normal(0, (LV, LG * LD)), "ids": ids,
            "slots": slots, "grads": grads.reshape(LB, LG * LD).astype(np.float32),
            "optimizers": ("rowwise_adagrad", "rowwise_adam", "sgd")}


@functools.lru_cache(maxsize=None)
def _spec():
    """The ranks' spec, the same at every world size."""
    irgan = _case_spec("irgan")
    irgan["draws"] = _irgan_draws()
    lanes = {name: {**_case_spec(name), "variants": LANE_VARIANTS[CASES[name]["optim"]["sparse_optimizer"]]}
             for name in ("lane_adagrad", "lane_adam")}
    return {"lanes": {"table": _lane_table_spec(), "steps": lanes}, "fsdp": _case_spec("fsdp"), "irgan": irgan}


@pytest.fixture(scope="module", params=WORLDS)
def ranks(request, tmp_path_factory):
    """(world size, the spec, rank 0's results): one spawn a world size."""
    world = request.param
    return world, _spec(), run_ranks("rest", world, _spec(), tmp_path_factory.mktemp(f"r{world}"), timeout=150)


def _put(mesh, x, spec):
    return jax.device_put(jnp.asarray(x), NamedSharding(mesh, spec))


# ---- the lane-sliced wire ----

def _jax_lane_table(world, wire=None):
    mesh = jax_make_mesh(world, 1)
    plan = jax_embedding.RowShardedTable(mesh, LV, LG * LD, lane_groups=LG, wire_dtype=wire)
    t = _lane_table_spec()
    padded = np.concatenate([t["table"], np.zeros((plan.vocab_padded - LV, LG * LD), np.float32)])
    return mesh, plan, padded, t


@pytest.mark.parametrize("wire", ["float32", "bfloat16"])
def test_lane_sliced_lookup_matches_jax(ranks, wire):
    world, _, got = ranks
    mesh, plan, padded, t = _jax_lane_table(world, jnp.bfloat16 if wire == "bfloat16" else None)
    out, ovf = jax.jit(plan.lookup)(_put(mesh, padded, P("data", None)), _put(mesh, t["ids"], P("data")),
                                    _put(mesh, t["slots"].astype(np.int32), P("data")))
    rows, overflow = got[f"lookup_{wire}"]
    np.testing.assert_array_equal(rows, np.asarray(out))
    assert overflow == int(ovf) == 2  # the two negatives


@pytest.mark.parametrize("opt_name,wire", [("rowwise_adagrad", "float32"), ("rowwise_adam", "float32"),
                                           ("sgd", "float32"), ("rowwise_adagrad", "bfloat16")])
def test_lane_sliced_update_matches_jax(ranks, opt_name, wire):
    world, _, got = ranks
    mesh, plan, padded, t = _jax_lane_table(world, jnp.bfloat16 if wire == "bfloat16" else None)
    opt = jax_sparse_optimizer(opt_name, adagrad_init=0.05)
    state = jax.tree.map(lambda x: _put(mesh, x, P("data", *([None] * (x.ndim - 1)))),
                         opt.init(jnp.asarray(padded), lane_groups=LG))
    new_t, new_s, ovf = jax.jit(lambda tb, s, i, g, sl: plan.update(tb, s, i, g, opt, 0.1, slots=sl))(
        _put(mesh, padded, P("data", None)), state, _put(mesh, t["ids"], P("data")),
        _put(mesh, t["grads"], P("data", None)), _put(mesh, t["slots"].astype(np.int32), P("data")))
    table, states, overflow = got[f"update_{opt_name}_{wire}"]
    assert overflow == int(ovf) == 2
    np.testing.assert_allclose(table, np.asarray(new_t)[:LV], rtol=UPDATE_RTOL, atol=UPDATE_ATOL)
    assert set(states) == set(new_s)
    for k in new_s:
        np.testing.assert_allclose(states[k], np.asarray(new_s[k])[:LV], rtol=UPDATE_RTOL,
                                   atol=UPDATE_ATOL, err_msg=k)
    assert not np.array_equal(table, t["table"])


def test_the_wire_carries_d_lanes_a_key(ranks):
    """Every float buffer of the exchange is [F, N, C, d]: d = 8 lanes for
    the table of 4 groups, 32 for the packed DCN's pack of 4 fields, never
    the packed row's G * d."""
    world, _, got = ranks
    assert got["table_wire"] and {s[-1] for s in got["table_wire"]} == {LD}
    assert all(s[1] == world for s in got["table_wire"])
    for name in ("lane_adagrad", "lane_adam"):
        assert {s[-1] for s in got[f"{name}_wire"]} == {LANE_MODEL["embed_dim"]}, name


def _jax_mesh_steps(world, case, **mesh_kw):
    """3 steps of JAX's mesh builder -> (losses, logical tables, sparse
    state, dense leaves, overflow)."""
    model = _jax_model(case)
    builder = JaxShardedBuilder(model, case["loss"], JaxOptimConfig(**case["optim"]), jax_make_mesh(world, 1),
                                JaxMeshConfig(**mesh_kw), l2_reg=case.get("l2_reg", 0.0),
                                seed=case.get("seed", 0))
    state = builder.init_state(jax.random.PRNGKey(0))
    step, losses = None, []
    for batch in case["batches"]():
        sh = builder.batch_shardings(batch)
        db = {k: jax.device_put(jnp.asarray(v), sh[k]) for k, v in batch.items()}
        step = step or builder.compile_step(state, db)
        state, metrics = step(state, db)
        losses.append(float(metrics["loss"]))
        assert int(metrics["lookup_overflow"]) == 0
    state = jax.device_get(state)
    vocab = {s.name: s.vocab for s in model.table_specs()}
    return {"losses": losses,
            "tables": {k: np.asarray(v)[:vocab[k]] for k, v in state["tables"].items()},
            "sparse": {k: {leaf: np.asarray(x)[:vocab[k]] for leaf, x in v.items()}
                       for k, v in state["sparse_opt"].items()},
            "dense": [np.asarray(x) for x in jax.tree.leaves(state["dense"])],
            "dense_opt": [np.asarray(x) for x in jax.tree.leaves(state["dense_opt"])]}


def _single_steps(name, spec, model=None):
    """The port's single-device step over the case's global batches from the
    ranks' state -> ``_jax_mesh_steps``' keys."""
    case, steps = CASES[name], spec["steps"][name] if "steps" in spec else spec
    builder = TrainStepBuilder(model or _port_model(case), case["loss"], OptimConfig(**case["optim"]),
                               l2_reg=case.get("l2_reg", 0.0), seed=case.get("seed", 0), device="cpu")
    state, losses = copy_state(_tensors(steps["state"])), []
    for batch in steps["batches"]:
        state, metrics = builder.step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        losses.append(metrics["loss"].item())
    state = _np(state)
    return {"losses": losses, "tables": state["tables"], "sparse": state["sparse_opt"],
            "dense": jax.tree.leaves(state["dense"]), "dense_opt": jax.tree.leaves(state["dense_opt"])}


def _assert_state_close(run, want, loss_rtol, rtol, atol):
    np.testing.assert_allclose(run["losses"], want["losses"], rtol=loss_rtol)
    state = run["state"]
    assert set(state["tables"]) == set(want["tables"])
    for k, w in want["tables"].items():
        np.testing.assert_allclose(state["tables"][k], w, rtol=rtol, atol=atol, err_msg=k)
        assert set(state["sparse_opt"][k]) == set(want["sparse"][k])
        for leaf, x in want["sparse"][k].items():
            np.testing.assert_allclose(state["sparse_opt"][k][leaf], x, rtol=rtol, atol=atol,
                                       err_msg=f"{k} {leaf}")
    got_dense = jax.tree.leaves(state["dense"])
    assert len(got_dense) == len(want["dense"])
    for g, w in zip(got_dense, want["dense"]):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", ["lane_adagrad", "lane_adam"])
def test_packed_steps_match_jax_and_the_single_device_step(ranks, name):
    """3 packed DCN steps (a multi-hot field with sentinel pads) on the
    lane-sliced wire against the single-device packed step and, at world
    4, JAX's 4-device packed mesh steps, from one state."""
    world, spec, got = ranks
    run = got[f"{name}_f32"]
    assert run["overflow"] == [0, 0, 0]
    assert set(run["lanes"].values()) == {4}  # every table on the lane-sliced wire
    assert set(run["plans"].values()) == {"RowShardedTable"}
    _assert_state_close(run, _single_steps(name, spec["lanes"]), LANE_LOSS_RTOL, LANE_RTOL, LANE_ATOL)
    if world == JAX_WORLD:
        _assert_state_close(run, _jax_mesh_steps(world, CASES[name], a2a_dtype="float32"),
                            LANE_LOSS_RTOL, LANE_RTOL, LANE_ATOL)


def test_packed_replicated_tables_under_adam_match_jax(ranks):
    """Replicated lane-packed tables under rowwise Adam: each rank's ids
    are gathered with their own lane groups (the gathered ids are rank
    after rank, not the global batch's field order), held against the
    single-device packed step and, at world 4, JAX's replicated mesh
    step."""
    world, spec, got = ranks
    run = got["lane_adam_replicated"]
    assert set(run["lanes"].values()) == {4} and set(run["plans"].values()) == {"NoneType"}
    _assert_state_close(run, _single_steps("lane_adam", spec["lanes"]), LANE_LOSS_RTOL, LANE_RTOL, LANE_ATOL)
    if world == JAX_WORLD:
        _assert_state_close(run, _jax_mesh_steps(world, CASES["lane_adam"], a2a_dtype="float32",
                                                 table_sharding="replicated"),
                            LANE_LOSS_RTOL, LANE_RTOL, LANE_ATOL)


def test_packed_bf16_wire_matches_jax(ranks):
    """The bf16 wire's losses within 1e-3 of the f32 wire's (chip_smoke's
    rule for the per-field tables) and, at world 4, JAX's bf16 mesh run at
    the step tolerance (both casts round to nearest even)."""
    world, _, got = ranks
    run = got["lane_adagrad_bf16"]
    np.testing.assert_allclose(run["losses"], got["lane_adagrad_f32"]["losses"], rtol=0, atol=1e-3)
    if world == JAX_WORLD:
        _assert_state_close(run, _jax_mesh_steps(world, CASES["lane_adagrad"], a2a_dtype="bfloat16"),
                            STEP_RTOL, STEP_RTOL, STEP_ATOL)


@pytest.mark.parametrize("variant", ["merge", "no_reuse", "permute"])
def test_packed_exchange_options_are_bit_for_bit_the_default(ranks, variant):
    _, _, got = ranks
    ref, run = got["lane_adagrad_f32"], got[f"lane_adagrad_{variant}"]
    assert run["losses"] == ref["losses"] and run["overflow"] == [0, 0, 0]
    for k, t in ref["state"]["tables"].items():
        np.testing.assert_array_equal(run["state"]["tables"][k], t)
        np.testing.assert_array_equal(run["state"]["sparse_opt"][k]["acc"], ref["state"]["sparse_opt"][k]["acc"])


# ---- FSDP ----

def test_fsdp_is_bit_for_bit_the_replicated_step(ranks):
    world, _, got = ranks
    rep, fs = got["fsdp_replicated"], got["fsdp_fsdp"]
    assert fs["split"] >= 1 and rep["split"] == 0
    assert fs["dense_bytes"] < rep["dense_bytes"]
    assert fs["losses"] == rep["losses"]
    for a, b in zip(jax.tree.leaves(fs["state"]), jax.tree.leaves(rep["state"])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(jax.tree.leaves(fs["params"]), jax.tree.leaves(rep["params"])):
        np.testing.assert_array_equal(a, b)
    assert len(jax.tree.leaves(fs["state"]["dense_opt"])) > 2  # adam's moments, whole again


def test_fsdp_matches_jax(ranks):
    """FSDP against the single-device step and, at world 4, JAX's FSDP
    mesh step: losses, tables, accumulators, dense params and moments."""
    world, spec, got = ranks
    wants = [_single_steps("fsdp", spec["fsdp"])]
    if world == JAX_WORLD:
        wants.append(_jax_mesh_steps(world, CASES["fsdp"], a2a_dtype="float32", dense_sharding="fsdp"))
    for want in wants:
        _assert_state_close(got["fsdp_fsdp"], want, FSDP_LOSS_RTOL, FSDP_RTOL, FSDP_ATOL)
        got_opt = [x for x in jax.tree.leaves(got["fsdp_fsdp"]["state"]["dense_opt"]) if np.ndim(x)]
        want_opt = [x for x in want["dense_opt"] if np.ndim(x)]
        assert len(got_opt) == len(want_opt) > 0
        for g, w in zip(got_opt, want_opt):
            np.testing.assert_allclose(g, w, rtol=FSDP_RTOL, atol=FSDP_ATOL)


@pytest.mark.parametrize("shape,n,axis", [((64, 32), 4, 0), ((5, 64), 4, 1), ((3,), 2, None),
                                          ((), 4, None), ((2, 8), 4, 1), ((8,), 8, 0), ((4,), 8, None)])
def test_fsdp_axis_is_the_references_rule(shape, n, axis):
    """The first axis whose size divides by n and is at least n."""
    assert fsdp_axis(shape, n) == axis


# ---- IRGAN ----

def test_irgan_sharded_steps_match_jax(ranks):
    """JAX's mesh step trains the global batch: its Gumbel draw and its
    REINFORCE baseline are the global batch's; the port's ranks take the
    same draws and one all_sum of the rewards."""
    world, _, got = ranks
    run = got["irgan"]
    assert run["overflow"] == [0, 0, 0]
    _assert_state_close(run, _jax_mesh_steps(world, CASES["irgan"], a2a_dtype="float32"),
                        IRGAN_RTOL, IRGAN_RTOL, IRGAN_ATOL)


def test_fsdp_refuses_an_unknown_dense_sharding_and_gspmd_stays_unported():
    from tfrec_tpu_torch.parallel.mesh import Mesh

    mesh = Mesh(shape={"data": 1, "table": 1}, rank=0, device=torch.device("cpu"), backend="gloo")
    model = build_model(ModelConfig(**FSDP_MODEL), DataSpec.ctr(FSDP_VOCABS, FSDP_DENSE))
    with pytest.raises(ValueError, match="unknown mesh.dense_sharding"):
        ShardedTrainStepBuilder(model, "logloss", OptimConfig(), mesh, MeshConfig(dense_sharding="zero3"))
    with pytest.raises(NotImplementedError, match="not ported: it is an A/B of XLA"):
        ShardedTrainStepBuilder(model, "logloss", OptimConfig(), mesh, MeshConfig(table_sharding="gspmd"))
