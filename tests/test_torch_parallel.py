"""The port's row-sharded tables against the JAX package's mesh path, on
the CPU.

The primitives (``pad_vocab``, ``capacity_for``, ``bucket_by_dest``,
``dedup_ids_sorted``) run in this process against JAX's on seeded ids
with sentinels, negatives and overflow. The sharded lookup,
update and step run on 2 and 4 ranks over gloo (tests/torch_dist_worker.py,
one spawn a world size running every check) and are held against
``RowShardedTable`` and ``ShardedTrainStepBuilder`` on a JAX mesh of as
many of the 8 virtual CPU devices (tests/conftest.py), from one state:
lookups exact at the f32 wire, updates under Adagrad, Adam and SGD at the
reference's own tolerance (tests/test_parallel.py:74-99), the bf16 wire
bit for bit, overflow counts at skewed ids equal (and none with
``row_permute``), and 3 steps of DCN and MF at the step tolerance of
tests/test_parallel.py:205-208, also against the port's single-device
step, and the same under ``table_sharding="replicated"``; "merge" and
route reuse bit for bit the default.
"""

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
from tfrec_tpu.ops.embedding import dedup_ids as jax_dedup_ids
from tfrec_tpu.ops.sparse_optim import make_sparse_optimizer as jax_sparse_optimizer
from tfrec_tpu.parallel import embedding as jax_embedding
from tfrec_tpu.parallel.mesh import make_mesh as jax_make_mesh
from tfrec_tpu.parallel.step import ShardedTrainStepBuilder as JaxShardedBuilder
from tfrec_tpu.train.step import TrainStepBuilder as JaxTrainStepBuilder
from tfrec_tpu_torch.configs import MeshConfig, ModelConfig, OptimConfig
from tfrec_tpu_torch.convert import train_state_from_jax
from tfrec_tpu_torch.models import DataSpec, build_model
from tfrec_tpu_torch.ops.embedding import dedup_ids_sorted
from tfrec_tpu_torch.parallel import embedding
from tfrec_tpu_torch.parallel.mesh import Mesh
from tfrec_tpu_torch.parallel.step import ShardedTrainStepBuilder
from tfrec_tpu_torch.train.step import TrainStepBuilder, copy_state
from torch_dist_worker import _np, _tensors, run_ranks

torch.set_num_threads(1)

WORLDS = (2, 4)
V, D, B = 100, 16, 64  # the update and lookup checks (tests/test_parallel.py:25)
STEP_RTOL, STEP_ATOL = 2e-4, 1e-5  # tests/test_parallel.py:205-208
UPDATE_RTOL, UPDATE_ATOL = 1e-5, 1e-6  # tests/test_parallel.py:95-99
OPTIMIZERS = ("rowwise_adagrad", "rowwise_adam", "sgd")
CTR_VOCABS = (40, 60, 35, 50)
CTR_MODEL = dict(name="dcn", embed_dim=8, mlp_dims=(16,), num_cross_layers=2, lane_pack=False)
CTR_OPTIM = dict(learning_rate=0.01, sparse_optimizer="rowwise_adagrad", adagrad_init=0.1)
CTR_BATCH = 256
MF_USERS, MF_ITEMS, MF_BATCH = 70, 90, 128
MF_OPTIM = dict(learning_rate=0.05, dense_optimizer="adagrad", sparse_optimizer="rowwise_adagrad")
SKEW_VOCAB, SKEW_DIM, SKEW_IDS = 100_000, 16, 8192
# The capacity factor at which contiguous blocks overflow on zipf(1.2)
# frequency-sorted ids (tests/test_parallel.py:711-741) at each world size.
SKEW_FACTOR = {2: 0.75, 4: 1.5}


def _normal(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _edge_ids(seed, n, vocab, padded):
    """Duplicates, negatives, sentinels (vocab, the padded vocab and past
    it) and a uniform rest."""
    rng = np.random.default_rng(seed)
    fixed = np.array([3, 3, 3, 0, vocab - 1, vocab, padded, padded + 5, -1, -7, 7, 7], np.int32)
    return np.concatenate([fixed, rng.integers(0, vocab, n - fixed.size)]).astype(np.int32)


def _zipf_sorted_ids(rng, n, vocab, a=1.2):
    ids = rng.zipf(a, size=2 * n) - 1
    return ids[ids < vocab][:n].astype(np.int32)


# ---- the primitives, in process ----

@pytest.mark.parametrize("vocab,shards", [(100, 2), (100, 4), (100_000, 8), (7, 3), (1, 1)])
def test_pad_vocab_and_capacity_match_jax(vocab, shards):
    assert embedding.pad_vocab(vocab, shards) == jax_embedding.pad_vocab(vocab, shards)
    for b, factor in ((64, 2.0), (4096, 1.0), (8192, 2.0), (5, 0.5)):
        assert embedding.capacity_for(b, shards, factor) == jax_embedding.capacity_for(b, shards, factor)


@pytest.mark.parametrize("sorted_ids", [False, True])
def test_bucket_by_dest_matches_jax(sorted_ids):
    rng = np.random.default_rng(1)
    shards, rps, cap = 4, 16, 5
    sentinel = shards * rps
    ids = np.concatenate([rng.integers(0, 20, 30), [sentinel, sentinel + 3, -1, -2],
                          rng.integers(0, sentinel, 26)]).astype(np.int32)
    if sorted_ids:
        ids = np.sort(ids)
    got = embedding.bucket_by_dest(torch.from_numpy(ids), shards, rps, cap, sentinel, ids_sorted=sorted_ids)
    want = jax_embedding.bucket_by_dest(jnp.asarray(ids), shards, rps, cap, sentinel, ids_sorted=sorted_ids)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got[2]) > 2  # capacity drops and the two negatives, counted


def test_dedup_ids_matches_jax():
    ids = _edge_ids(2, 80, 50, 56)
    got_u, got_inv, order = dedup_ids_sorted(torch.from_numpy(ids), 56)
    want_u, want_inv = jax_dedup_ids(jnp.asarray(ids), 56)
    np.testing.assert_array_equal(got_u.numpy(), np.asarray(want_u))
    np.testing.assert_array_equal(got_inv.numpy(), np.asarray(want_inv))
    np.testing.assert_array_equal(got_u.numpy()[got_inv.numpy()], ids)
    np.testing.assert_array_equal(order.numpy(), np.argsort(ids, kind="stable"))


def _cpu_mesh(size=1, rank=0):
    """A mesh object for checks that make no collective call."""
    return Mesh(shape={"data": size, "table": 1}, rank=rank, device=torch.device("cpu"),
                backend="gloo")


@pytest.mark.parametrize("what,build", [
    ("fsdp", lambda m: ShardedTrainStepBuilder(
        _ctr_model(), "logloss", OptimConfig(), m, MeshConfig(dense_sharding="fsdp"))),
    ("lane-packed", lambda m: ShardedTrainStepBuilder(
        _ctr_model(lane_pack=True), "logloss", OptimConfig(), m, MeshConfig())),
])
def test_the_remainder_of_item_11_is_refused_by_name(what, build):
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 11"):
        build(_cpu_mesh())


def test_gspmd_is_refused_as_never_ported():
    with pytest.raises(NotImplementedError, match="not ported: it is an A/B of XLA"):
        ShardedTrainStepBuilder(_ctr_model(), "logloss", OptimConfig(), _cpu_mesh(),
                                MeshConfig(table_sharding="gspmd"))


def test_shard_rows_is_the_padded_permuted_block():
    """Each rank's block of the padded, permuted table, as the reference's
    _init_padded lays it out (phys = logical[inv_perm])."""
    table = _normal(0, (V, 3))
    for permute in (False, True):
        want = np.asarray(jax_embedding.RowShardedTable(jax_make_mesh(4, 1), V, 3, permute=permute)
                          .inv_perm_rows())
        padded = np.concatenate([table, np.zeros((want.size - V, 3), np.float32)])[want]
        blocks = [embedding.RowShardedTable(_cpu_mesh(4, r), V, 3, permute=permute)
                  .shard_rows(torch.from_numpy(table)).numpy() for r in range(4)]
        np.testing.assert_array_equal(np.concatenate(blocks), padded)


# ---- the sharded paths, on N ranks against a JAX mesh of N devices ----

def _ctr_model(**kw):
    return build_model(ModelConfig(**{**CTR_MODEL, **kw}), DataSpec.ctr(CTR_VOCABS, 2))


def _ctr_batches(steps=3):
    rng = np.random.default_rng(13)
    return [{"dense": rng.normal(size=(CTR_BATCH, 2)).astype(np.float32),
             "cat": np.stack([rng.integers(0, v, CTR_BATCH) for v in CTR_VOCABS], 1).astype(np.int32),
             "label": rng.integers(0, 2, CTR_BATCH).astype(np.float32)} for _ in range(steps)]


def _mf_batches(steps=3):
    rng = np.random.default_rng(17)
    return [{"user": rng.integers(0, MF_USERS, MF_BATCH).astype(np.int32),
             "pos": rng.integers(0, MF_ITEMS, MF_BATCH).astype(np.int32),
             "neg": rng.integers(0, MF_ITEMS, MF_BATCH).astype(np.int32)} for _ in range(steps)]


STEP_CASES = {
    "dcn": dict(model=CTR_MODEL, data_spec=("ctr", (CTR_VOCABS, 2)), loss="logloss",
                optim=CTR_OPTIM, l2_reg=0.001, batches=_ctr_batches),
    "mf": dict(model=dict(name="mf", embed_dim=8), data_spec=("interaction", (MF_USERS, MF_ITEMS)),
               loss="bpr", optim=MF_OPTIM, batches=_mf_batches),
}
# Each case's variants on the ranks; "f32" and "replicated" are held
# against JAX.
VARIANTS = {"f32": dict(a2a_dtype="float32"),
            "replicated": dict(a2a_dtype="float32", table_sharding="replicated"),
            "merge": dict(a2a_dtype="float32", recv_combine="merge"),
            "no_reuse": dict(a2a_dtype="float32", route_reuse=False),
            "permute": dict(a2a_dtype="float32", row_permute=True)}


def _jax_model(case):
    kind, args = case["data_spec"]
    spec = JaxDataSpec.ctr(*args) if kind == "ctr" else JaxDataSpec.interaction(*args)
    return jax_build_model(JaxModelConfig(**case["model"]), spec)


def _spec(world):
    t = {"vocab": V, "dim": D, "table": _normal(0, (V, D)), "grads": _normal(4, (B, D)),
         "ids": _edge_ids(3, B, V, embedding.pad_vocab(V, world)), "optimizers": OPTIMIZERS}
    rng = np.random.default_rng(5)
    skew = {"vocab": SKEW_VOCAB, "dim": SKEW_DIM, "factor": SKEW_FACTOR[world],
            "ids": _zipf_sorted_ids(rng, SKEW_IDS, SKEW_VOCAB),
            "table": _normal(1, (SKEW_VOCAB, SKEW_DIM))}
    steps = {}
    for name, case in STEP_CASES.items():
        jax_state = JaxTrainStepBuilder(_jax_model(case), case["loss"], JaxOptimConfig(**case["optim"]),
                                        l2_reg=case.get("l2_reg", 0.0)).init_state(jax.random.PRNGKey(0))
        port_model = build_model(ModelConfig(**case["model"]), (
            DataSpec.ctr if case["data_spec"][0] == "ctr" else DataSpec.interaction)(*case["data_spec"][1]))
        state = train_state_from_jax(jax.tree.map(np.asarray, jax_state), port_model)
        steps[name] = {**{k: v for k, v in case.items() if k != "batches"}, "batches": case["batches"](),
                       "variants": VARIANTS, "state": _np(state)}
    return {"table": t, "skew": skew, "steps": steps}


@pytest.fixture(scope="module", params=WORLDS)
def ranks(request, tmp_path_factory):
    """(world size, the spec, rank 0's results): one spawn a world size."""
    world = request.param
    spec = _spec(world)
    return world, spec, run_ranks("parallel", world, spec, tmp_path_factory.mktemp(f"w{world}"),
                                  timeout=150)


def _put(mesh, x, spec):
    return jax.device_put(jnp.asarray(x), NamedSharding(mesh, spec))


def _jax_table(world, permute=False, vocab=V, dim=D, table=None, **kw):
    mesh = jax_make_mesh(world, 1)
    plan = jax_embedding.RowShardedTable(mesh, vocab, dim, permute=permute, **kw)
    padded = np.concatenate([table, np.zeros((plan.vocab_padded - vocab, dim), np.float32)])
    padded = padded[np.asarray(plan.inv_perm_rows())]
    return mesh, plan, padded


def test_sharded_lookup_matches_jax(ranks):
    world, spec, got = ranks
    t = spec["table"]
    for wire, dtype in (("float32", None), ("bfloat16", jnp.bfloat16)):
        mesh, plan, padded = _jax_table(world, table=t["table"], wire_dtype=dtype)
        out, ovf = jax.jit(plan.lookup)(_put(mesh, padded, P("data", None)), _put(mesh, t["ids"], P("data")))
        rows, overflow = got[f"lookup_{wire}"]
        # Exact at both wires: the bf16 cast rounds to nearest even in both.
        np.testing.assert_array_equal(rows, np.asarray(out), err_msg=wire)
        assert overflow == int(ovf) == 2  # the two negatives; sentinels are not counted
    threes = got["lookup_float32"][0][t["ids"] == 3]
    np.testing.assert_array_equal(threes, np.broadcast_to(t["table"][3], threes.shape))


@pytest.mark.parametrize("opt_name,wire", [(o, "float32") for o in OPTIMIZERS]
                         + [("rowwise_adagrad", "bfloat16")])
def test_sharded_update_matches_jax(ranks, opt_name, wire):
    world, spec, got = ranks
    t = spec["table"]
    mesh, plan, padded = _jax_table(world, table=t["table"],
                                    wire_dtype=jnp.bfloat16 if wire == "bfloat16" else None)
    opt = jax_sparse_optimizer(opt_name, adagrad_init=0.05)
    state = jax.tree.map(lambda x: _put(mesh, x, P("data", *([None] * (x.ndim - 1)))), opt.init(jnp.asarray(padded)))
    new_t, new_s, ovf = jax.jit(lambda tb, s, i, g: plan.update(tb, s, i, g, opt, 0.1))(
        _put(mesh, padded, P("data", None)), state, _put(mesh, t["ids"], P("data")),
        _put(mesh, t["grads"], P("data", None)))
    table, states, overflow = got[f"update_{opt_name}_{wire}"]
    assert overflow == int(ovf) == 2
    np.testing.assert_allclose(table, np.asarray(new_t)[:V], rtol=UPDATE_RTOL, atol=UPDATE_ATOL)
    assert set(states) == set(new_s)
    for k in new_s:
        np.testing.assert_allclose(states[k], np.asarray(new_s[k])[:V], rtol=UPDATE_RTOL, atol=UPDATE_ATOL)


def test_skewed_overflow_counts_match_jax_and_row_permute_fixes_them(ranks):
    world, spec, got = ranks
    skew = spec["skew"]
    for permute in (False, True):
        mesh, plan, padded = _jax_table(world, permute, SKEW_VOCAB, SKEW_DIM, skew["table"],
                                        capacity_factor=skew["factor"])
        out, ovf = jax.jit(plan.lookup)(_put(mesh, padded, P("data", None)),
                                        _put(mesh, skew["ids"], P("data")))
        rows, overflow = got[f"skew_{permute}"]
        assert overflow == int(ovf), permute
        np.testing.assert_array_equal(rows, np.asarray(out))
    assert got["skew_False"][1] > 100 and got["skew_True"][1] == 0


def _jax_steps(world, case, table_sharding="row"):
    model = _jax_model(case)
    ocfg = JaxOptimConfig(**case["optim"])
    mesh = jax_make_mesh(world, 1)
    builder = JaxShardedBuilder(model, case["loss"], ocfg, mesh,
                                JaxMeshConfig(a2a_dtype="float32", table_sharding=table_sharding),
                                l2_reg=case.get("l2_reg", 0.0))
    state = builder.init_state(jax.random.PRNGKey(0))
    step = None
    losses = []
    for batch in case["batches"]():
        sh = builder.batch_shardings(batch)
        db = {k: jax.device_put(jnp.asarray(v), sh[k]) for k, v in batch.items()}
        step = step or builder.compile_step(state, db)
        state, metrics = step(state, db)
        losses.append(float(metrics["loss"]))
        assert int(metrics["lookup_overflow"]) == 0
    state = jax.device_get(state)
    vocab = {s.name: s.vocab for s in model.table_specs()}
    return {"tables": {k: np.asarray(v)[:vocab[k]] for k, v in state["tables"].items()},
            "acc": {k: np.asarray(v["acc"])[:vocab[k]] for k, v in state["sparse_opt"].items()},
            "dense": jax.tree.leaves(state["dense"]), "losses": losses}


def _assert_steps_close(run, want):
    state = run["state"]
    np.testing.assert_allclose(run["losses"], want["losses"], rtol=STEP_RTOL)
    for k in want["tables"]:
        np.testing.assert_allclose(state["tables"][k], want["tables"][k], rtol=STEP_RTOL, atol=STEP_ATOL)
        np.testing.assert_allclose(state["sparse_opt"][k]["acc"], want["acc"][k], rtol=STEP_RTOL, atol=STEP_ATOL)
    got_dense = jax.tree.leaves(jax.tree.map(np.asarray, state["dense"]))
    for g, w in zip(got_dense, want["dense"]):
        np.testing.assert_allclose(g, np.asarray(w), rtol=STEP_RTOL, atol=STEP_ATOL)


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_sharded_steps_match_jax_and_the_single_device_step(ranks, name):
    world, spec, got = ranks
    case = STEP_CASES[name]
    run = got[f"{name}_f32"]
    assert run["overflow"] == [0, 0, 0]
    _assert_steps_close(run, _jax_steps(world, case))
    # The port's own single-device step from the same state.
    model = build_model(ModelConfig(**case["model"]), (
        DataSpec.ctr if case["data_spec"][0] == "ctr" else DataSpec.interaction)(*case["data_spec"][1]))
    single = TrainStepBuilder(model, case["loss"], OptimConfig(**case["optim"]),
                              l2_reg=case.get("l2_reg", 0.0), device="cpu")
    s = copy_state(_tensors(spec["steps"][name]["state"]))
    for batch in spec["steps"][name]["batches"]:
        s, _ = single.step(s, {k: torch.from_numpy(v) for k, v in batch.items()})
    for k, v in s["tables"].items():
        np.testing.assert_allclose(run["state"]["tables"][k], v.numpy(), rtol=STEP_RTOL, atol=STEP_ATOL)


@pytest.mark.parametrize("name", list(STEP_CASES))
@pytest.mark.parametrize("variant", ["merge", "no_reuse", "permute"])
def test_merge_route_reuse_and_row_permute_are_bit_for_bit_the_default(ranks, name, variant):
    """A pure change of the exchange (tests/test_parallel.py:657-789): the
    merged receive combine, the re-derived route and the permuted layout
    (its tables read back logical) give the default run's losses, tables
    and accumulators bit for bit. MF under row_permute is refused (its
    item table would be scored in physical order), as in the reference."""
    if name == "mf" and variant == "permute":
        with pytest.raises(ValueError, match="row_permute is for CTR workloads"):
            ShardedTrainStepBuilder(build_model(ModelConfig(**STEP_CASES["mf"]["model"]),
                                                DataSpec.interaction(MF_USERS, MF_ITEMS)),
                                    "bpr", OptimConfig(), _cpu_mesh(), MeshConfig(row_permute=True))
        return
    _, _, got = ranks
    ref, run = got[f"{name}_f32"], got[f"{name}_{variant}"]
    assert run["losses"] == ref["losses"]
    for k in ref["state"]["tables"]:
        np.testing.assert_array_equal(run["state"]["tables"][k], ref["state"]["tables"][k])
        np.testing.assert_array_equal(run["state"]["sparse_opt"][k]["acc"], ref["state"]["sparse_opt"][k]["acc"])


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_replicated_tables_match_jax(ranks, name):
    """``table_sharding="replicated"``: whole tables on every rank, looked
    up locally and updated from every rank's ids and 1/N-scaled gradient
    rows (all-gathered), held against JAX's replicated mesh step; the
    replicas stay equal."""
    world, _, got = ranks
    run = got[f"{name}_replicated"]
    assert run["overflow"] == [0, 0, 0] and run["replicas_equal"]
    _assert_steps_close(run, _jax_steps(world, STEP_CASES[name], "replicated"))
