"""The port's column-sharded tables against the JAX package's, on the CPU.

``ColShardedTable``'s lookup and update and the sharded step under
``mesh.table_sharding="col"`` run on a (2, 2) mesh of 4 gloo ranks and a
(1, 2) mesh of 2 (tests/torch_dist_worker.py, one spawn each), held against
``tfrec_tpu.parallel``'s ``ColShardedTable`` and
``ShardedTrainStepBuilder`` on a JAX mesh of the same shape over the 8
virtual CPU devices (tests/conftest.py), from one state: the lookup bit for
bit (negative ids zeroed and counted, ids past V clamped as bag padding),
updates under rowwise Adagrad, rowwise Adam and SGD at the reference's own
tolerance (tests/test_parallel.py:95-99), overflow at a small capacity
factor equal to JAX's count, and 3 steps of DCN and of MF (whose [V, 1]
``item_bias`` replicates) at the step tolerance of
tests/test_parallel.py:205-208, also against the port's single-device
step. The two-axis mesh's layout and groups, the col plan's refusals and
the column statistic run in process.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from test_torch_parallel import (
    OPTIMIZERS,
    STEP_ATOL,
    STEP_CASES,
    STEP_RTOL,
    UPDATE_ATOL,
    UPDATE_RTOL,
    _ctr_model,
    _edge_ids,
    _jax_model,
    _normal,
)
from tfrec_tpu.configs import MeshConfig as JaxMeshConfig
from tfrec_tpu.configs import OptimConfig as JaxOptimConfig
from tfrec_tpu.ops.sparse_optim import make_sparse_optimizer as jax_sparse_optimizer
from tfrec_tpu.parallel import embedding as jax_embedding
from tfrec_tpu.parallel.mesh import make_mesh as jax_make_mesh
from tfrec_tpu.parallel.step import ShardedTrainStepBuilder as JaxShardedBuilder
from tfrec_tpu.train.step import TrainStepBuilder as JaxTrainStepBuilder
from tfrec_tpu_torch.configs import MeshConfig, ModelConfig, OptimConfig
from tfrec_tpu_torch.convert import train_state_from_jax
from tfrec_tpu_torch.models import DataSpec, build_model
from tfrec_tpu_torch.ops.sparse_optim import make_sparse_optimizer
from tfrec_tpu_torch.parallel.embedding import ColShardedTable
from tfrec_tpu_torch.parallel.mesh import Mesh
from tfrec_tpu_torch.parallel.step import ShardedTrainStepBuilder
from tfrec_tpu_torch.train.step import TrainStepBuilder, copy_state
from torch_dist_worker import _np, _tensors, run_ranks

torch.set_num_threads(1)

MESHES = ((2, 2), (1, 2))
V, D, B = 100, 16, 64
SMALL_FACTOR = 0.3  # capacity_for(32, 1, 0.3) = 10 distinct ids of a local 32: drops


def _port_model(case):
    kind, args = case["data_spec"]
    return build_model(ModelConfig(**case["model"]),
                       (DataSpec.ctr if kind == "ctr" else DataSpec.interaction)(*args))


def _spec(shape):
    t = {"vocab": V, "dim": D, "table": _normal(0, (V, D)), "grads": _normal(4, (B, D)),
         "ids": _edge_ids(3, B, V, V + 8), "optimizers": OPTIMIZERS, "small_factor": SMALL_FACTOR}
    steps = {}
    for name, case in STEP_CASES.items():
        jax_state = JaxTrainStepBuilder(_jax_model(case), case["loss"], JaxOptimConfig(**case["optim"]),
                                        l2_reg=case.get("l2_reg", 0.0)).init_state(jax.random.PRNGKey(0))
        state = train_state_from_jax(jax.tree.map(np.asarray, jax_state), _port_model(case))
        steps[name] = {**{k: v for k, v in case.items() if k != "batches"}, "batches": case["batches"](),
                       "state": _np(state)}
    return {"table_axis": shape[1], "table": t, "steps": steps}


@pytest.fixture(scope="module", params=MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def ranks(request, tmp_path_factory):
    """((D, T), the spec, rank 0's results): one spawn a mesh shape."""
    shape = request.param
    spec = _spec(shape)
    got = run_ranks("colshard", shape[0] * shape[1], spec,
                    tmp_path_factory.mktemp(f"col{shape[0]}x{shape[1]}"), timeout=150)
    assert got["shape"] == {"data": shape[0], "table": shape[1]}
    return shape, spec, got


def _put(mesh, x, spec):
    return jax.device_put(jnp.asarray(x), NamedSharding(mesh, spec))


def _state_spec(x):
    return P(None, "table") if x.ndim == 2 else P(None)


def test_col_lookup_matches_jax_bit_for_bit(ranks):
    shape, spec, got = ranks
    t = spec["table"]
    mesh = jax_make_mesh(*shape)
    ct = jax_embedding.ColShardedTable(mesh, V, D)
    out, ovf = jax.jit(ct.lookup)(_put(mesh, t["table"], P(None, "table")), _put(mesh, t["ids"], P("data")))
    rows, overflow = got["lookup"]
    np.testing.assert_array_equal(rows, np.asarray(out))
    assert overflow == int(ovf) == 2  # the two negatives; ids past V are bag padding
    ids = t["ids"]
    np.testing.assert_array_equal(rows[ids < 0], 0.0)
    np.testing.assert_array_equal(rows[ids >= V], np.broadcast_to(t["table"][V - 1], rows[ids >= V].shape))


@pytest.mark.parametrize("opt_name", OPTIMIZERS)
@pytest.mark.parametrize("factor", [2.0, SMALL_FACTOR])
def test_col_update_matches_jax(ranks, opt_name, factor):
    """Every optimizer at the default capacity (nothing dropped but the
    negatives) and at a small one, whose dropped ids are JAX's count."""
    shape, spec, got = ranks
    t = spec["table"]
    mesh = jax_make_mesh(*shape)
    ct = jax_embedding.ColShardedTable(mesh, V, D, capacity_factor=factor)
    opt = jax_sparse_optimizer(opt_name, adagrad_init=0.05)
    state = jax.tree.map(lambda x: _put(mesh, x, _state_spec(x)), opt.init(jnp.asarray(t["table"])))
    new_t, new_s, ovf = jax.jit(lambda tb, s, i, g: ct.update(tb, s, i, g, opt, 0.1))(
        _put(mesh, t["table"], P(None, "table")), state, _put(mesh, t["ids"], P("data")),
        _put(mesh, t["grads"], P("data", None)))
    table, states, overflow = got[f"update_{opt_name}_{factor}"]
    assert overflow == int(ovf)
    assert (overflow == 2) == (factor == 2.0)  # the small capacity drops ids, counted
    np.testing.assert_allclose(table, np.asarray(new_t), rtol=UPDATE_RTOL, atol=UPDATE_ATOL)
    assert set(states) == set(new_s)
    for k in new_s:
        np.testing.assert_allclose(states[k], np.asarray(new_s[k]), rtol=UPDATE_RTOL, atol=UPDATE_ATOL)


def test_tables_updated_together_are_each_updated_alone(ranks):
    """The col update batches tables of one shape: bit for bit a call a
    table."""
    _, _, got = ranks
    assert got["pair_bitwise"]


def _jax_col_steps(shape, case):
    model = _jax_model(case)
    mesh = jax_make_mesh(*shape)
    builder = JaxShardedBuilder(model, case["loss"], JaxOptimConfig(**case["optim"]), mesh,
                                JaxMeshConfig(a2a_dtype="float32", table_sharding="col"),
                                l2_reg=case.get("l2_reg", 0.0))
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
    kinds = {k: type(p).__name__ if p is not None else "NoneType" for k, p in builder.plans.items()}
    return state, losses, kinds


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_col_steps_match_jax_and_the_single_device_step(ranks, name):
    shape, spec, got = ranks
    case = STEP_CASES[name]
    run = got["steps"][name]
    want, want_losses, kinds = _jax_col_steps(shape, case)
    assert run["kinds"] == kinds  # col tables, and MF's [V, 1] bias replicated
    if name == "mf":
        assert kinds["item_bias"] == "NoneType" and kinds["item_emb"] == "ColShardedTable"
    assert run["overflow"] == [0, 0, 0]
    np.testing.assert_allclose(run["losses"], want_losses, rtol=STEP_RTOL)
    state = run["state"]
    for k, v in want["tables"].items():
        np.testing.assert_allclose(state["tables"][k], np.asarray(v), rtol=STEP_RTOL, atol=STEP_ATOL)
        for leaf, w in want["sparse_opt"][k].items():
            np.testing.assert_allclose(state["sparse_opt"][k][leaf], np.asarray(w), rtol=STEP_RTOL,
                                       atol=STEP_ATOL)
    for g, w in zip(jax.tree.leaves(jax.tree.map(np.asarray, state["dense"])), jax.tree.leaves(want["dense"])):
        np.testing.assert_allclose(g, np.asarray(w), rtol=STEP_RTOL, atol=STEP_ATOL)
    single = TrainStepBuilder(_port_model(case), case["loss"], OptimConfig(**case["optim"]),
                              l2_reg=case.get("l2_reg", 0.0), device="cpu")
    s = copy_state(_tensors(spec["steps"][name]["state"]))
    for batch in spec["steps"][name]["batches"]:
        s, _ = single.step(s, {k: torch.from_numpy(v) for k, v in batch.items()})
    for k, v in s["tables"].items():
        np.testing.assert_allclose(state["tables"][k], v.numpy(), rtol=STEP_RTOL, atol=STEP_ATOL)


# ---- in process ----

def _mesh(data, table, rank):
    return Mesh(shape={"data": data, "table": table}, rank=rank, device=torch.device("cpu"),
                backend="gloo")


def test_the_mesh_is_the_references_row_major_layout():
    """Rank r is (r // T, r % T), as the reference reshapes its devices."""
    jax_mesh = jax_make_mesh(2, 4)
    for r, dev in enumerate(np.asarray(jax_mesh.devices).reshape(-1)):
        m = _mesh(2, 4, r)
        assert (m.data_index, m.table_index) == tuple(int(x) for x in np.argwhere(
            np.asarray(jax_mesh.devices) == dev)[0])
        assert m.size == 2 and m.world == 8 and m.index("table") == r % 4


def test_col_plans_shard_columns_and_replicate_rowwise_leaves():
    table = torch.from_numpy(_normal(0, (V, D)))
    acc = torch.arange(V, dtype=torch.float32)
    blocks = [ColShardedTable(_mesh(2, 4, r), V, D) for r in range(8)]
    for r, plan in enumerate(blocks):
        t = r % 4
        torch.testing.assert_close(plan.shard(table), table[:, t * 4:(t + 1) * 4], rtol=0, atol=0)
        assert torch.equal(plan.shard(acc), acc) and plan.logical_shape((V, 4)) == (V, D)
        assert plan.is_block(plan.shard(table)) and not plan.is_block(acc)
    with pytest.raises(ValueError, match="must divide by the table axis"):
        ColShardedTable(_mesh(1, 3, 0), V, D)


def test_col_refuses_lane_packed_tables_and_warns_at_one_column_shard():
    with pytest.raises(ValueError, match="column sharding would split across lane groups"):
        ShardedTrainStepBuilder(_ctr_model(lane_pack=True), "logloss", OptimConfig(), _mesh(1, 2, 0),
                                MeshConfig(table_sharding="col"))
    with pytest.warns(UserWarning, match="table axis of size 1"):
        ShardedTrainStepBuilder(_ctr_model(), "logloss", OptimConfig(), _mesh(1, 1, 0),
                                MeshConfig(table_sharding="col"))
    model = build_model(ModelConfig(name="dcn", embed_dim=6, mlp_dims=(8,), num_cross_layers=1,
                                    lane_pack=False), DataSpec.ctr((10, 12), 1))
    with pytest.warns(UserWarning, match="REPLICATING instead of column-sharding"):
        b = ShardedTrainStepBuilder(model, "logloss", OptimConfig(), _mesh(1, 4, 0),
                                    MeshConfig(table_sharding="col"))
    assert all(p is None for p in b.plans.values())


@pytest.mark.parametrize("opt_name", ["rowwise_adagrad", "rowwise_adam"])
def test_the_column_statistic_of_a_whole_row_is_the_single_device_rule(opt_name):
    """One shard holding every column (T = 1): the column statistic equals
    the local mean square, so the plain rule with it is the optimizer's
    own, and JAX's with stat_axis at full_dim = D."""
    opt = make_sparse_optimizer(opt_name, adagrad_init=0.05)
    table = torch.from_numpy(_normal(0, (V, D)))
    ids = torch.from_numpy(_edge_ids(3, B, V, V + 8).clip(0, V - 1))
    grads = torch.from_numpy(_normal(4, (B, D)))
    from tfrec_tpu_torch.ops.embedding import combine_duplicate_ids

    uids, g = combine_duplicate_ids(ids, grads, sentinel=V)
    want_t, want_s = opt.apply_deduped(table.clone(), opt.init(table), uids, g, 0.1)
    got_t, got_s = opt.apply_deduped(table.clone(), opt.init(table), uids, g, 0.1,
                                     stat=(g * g).sum(dim=-1) / D)
    torch.testing.assert_close(got_t, want_t, rtol=UPDATE_RTOL, atol=UPDATE_ATOL)
    for k in want_s:
        torch.testing.assert_close(got_s[k], want_s[k], rtol=UPDATE_RTOL, atol=UPDATE_ATOL)
    # Slots with no real id change nothing.
    empty = torch.full((B,), V, dtype=torch.int32)
    t2, s2 = opt.apply_deduped(table.clone(), opt.init(table), empty, g, 0.1, stat=torch.ones(B))
    torch.testing.assert_close(t2, table, rtol=0, atol=0)
    for k, v in opt.init(table).items():
        torch.testing.assert_close(s2[k], v, rtol=0, atol=0)
    grouped = opt.init(table, lane_groups=2)
    with pytest.raises(ValueError, match="lane-packed tables do not support column sharding"):
        opt.apply_deduped(table.clone(), grouped, uids, g, 0.1, stat=torch.zeros(B))
