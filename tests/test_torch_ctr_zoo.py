"""The rest of the port's CTR zoo (DeepFM, Wide & Deep, NFM, DLRM) against
the JAX package, on the CPU.

At the JAX model's own params (``convert.params_from_jax``, seeded noise on
the leaves JAX initialises to constants), the same seeded batches go
through both:

- each model's forward in the per-field, lane-packed and stacked layouts
  (bags sentinel-padded, dense features), and ``predict_ctr``;
- multi-hot DeepFM and Wide & Deep at mixed field widths
  (tests/test_multihot.py:79 and :139);
- one ``TrainStepBuilder.step`` of each against the JAX step
  (kernels="xla"): loss, tables, the optimizer's leaves, dense params;
- ``build_model``'s tables and dense trees against JAX's, and a checkpoint
  in the JAX on-disk layout both ways.

On CPU tensors the gather and Adagrad wrappers take their plain versions;
the card holds the kernels against them (chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tfrec_tpu.utils.checkpoint as jax_ckpt
from tfrec_tpu.configs import ModelConfig as JaxModelConfig
from tfrec_tpu.configs import OptimConfig as JaxOptimConfig
from tfrec_tpu.models import DataSpec as JaxDataSpec
from tfrec_tpu.models import build_model as jax_build_model
from tfrec_tpu.models.nfm import bi_interaction as jax_bi_interaction
from tfrec_tpu.train import step as jax_step
from tfrec_tpu_torch import convert
from tfrec_tpu_torch.configs import ModelConfig, OptimConfig
from tfrec_tpu_torch.models import DLRM, NFM, DataSpec, DeepFM, WideDeep, build_model
from tfrec_tpu_torch.models.nfm import bi_interaction
from tfrec_tpu_torch.ops.embedding import gather_many
from tfrec_tpu_torch.serve import Recommender
from tfrec_tpu_torch.train.step import TrainStepBuilder, tree_leaves
from tfrec_tpu_torch.utils import checkpoint as ckpt

torch.set_num_threads(1)

# A forward of the same arithmetic in another order (tests/test_torch_fm_ncf.py),
# and one step of it through the normalised updates
# (tests/test_torch_layouts.py).
RTOL, ATOL = 1e-5, 1e-6
STEP_RTOL, STEP_ATOL = 1e-4, 1e-5
VOCABS = (37, 52, 45, 60, 11)
WIDTHS = (1, 1, 3, 1, 1)  # field 2 is a multi-hot bag, sentinel-padded
NUM_DENSE = 3
DIM = 16  # 8 fields a 128-lane pack in the lane-packed layout
BATCH = 32
MODELS = {
    "deepfm": (DeepFM, dict(mlp_dims=(16, 8))),
    "widedeep": (WideDeep, dict(mlp_dims=(16, 8))),
    "nfm": (NFM, dict(mlp_dims=(12,))),
    "dlrm": (DLRM, dict(mlp_dims=(16, 8))),
}
LAYOUTS = {"per_field": {}, "lane_packed": {"lane_pack": True}, "stacked": {"stack_tables": True}}


def _models(name, layout="per_field", widths=WIDTHS, **kw):
    cls, extra = MODELS[name]
    mkw = dict(name=name, embed_dim=DIM, **extra, **LAYOUTS[layout], **kw)
    ref = jax_build_model(JaxModelConfig(**{"lane_pack": False, **mkw}),
                          JaxDataSpec.ctr(VOCABS, NUM_DENSE, widths))
    port = build_model(ModelConfig(**mkw), DataSpec.ctr(VOCABS, NUM_DENSE, widths))
    assert isinstance(port, cls) and type(port).__name__ == type(ref).__name__
    return port, ref


def _jax_params(ref, seed):
    """JAX's init as numpy, with seeded noise on every leaf (linear tables,
    w0 and biases start at zero there)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (np.asarray(a) + 0.1 * rng.normal(size=np.shape(a))).astype(np.float32),
                        ref.init(jax.random.PRNGKey(0)))


def _batch(seed, widths=WIDTHS):
    """Duplicates, sentinel-padded bags (row 0 all padding) and dense
    features."""
    rng = np.random.default_rng(seed)
    cols = []
    for v, w in zip(VOCABS, widths):
        ids = rng.integers(0, v, (BATCH, w))
        if w > 1:
            ids[rng.random((BATCH, w)) < 0.3] = v
            ids[0] = v
        cols.append(ids)
    return {"dense": rng.normal(size=(BATCH, NUM_DENSE)).astype(np.float32),
            "cat": np.concatenate(cols, axis=1).astype(np.int32),
            "label": (rng.random(BATCH) < 0.4).astype(np.float32)}


def _forward_pair(port, ref, np_params, params, batch):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jg = {k: jnp.take(jnp.asarray(np_params["tables"][k]), v, axis=0, mode="clip")
          for k, v in ref.lookup_ids(jb).items()}
    want = np.asarray(ref.forward(jax.tree.map(jnp.asarray, np_params["dense"]), jg, jb))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    ids = port.lookup_ids(tb)
    rows = dict(zip(ids, gather_many([params["tables"][k] for k in ids], list(ids.values()))))
    return port(params["dense"], rows, tb), want


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("name", sorted(MODELS))
def test_forward_matches_jax_in_each_layout(name, layout):
    """JAX's params in its layout, read into the port's model of the same
    layout; ``predict_ctr`` serves the forward's logits."""
    port, ref = _models(name, layout)
    np_params = _jax_params(ref, 1)
    params = convert.params_from_jax(np_params, port)
    assert list(params["tables"]) == [s.name for s in port.table_specs()]
    assert set(params["tables"]) == set(np_params["tables"])
    batch = _batch(2)
    got, want = _forward_pair(port, ref, np_params, params, batch)
    assert got.shape == want.shape == (BATCH,)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    served = Recommender(port, params, device="cpu").predict_ctr(batch["dense"], batch["cat"])
    np.testing.assert_array_equal(served, got.numpy())


@pytest.mark.parametrize("case", ["multi-hot deepfm", "mixed-width widedeep"])
def test_multihot_deepfm_and_mixed_width_widedeep_match_jax(case):
    """DeepFM over two bags of 4 and 2 ids; Wide & Deep at field widths
    16, 8, 4, 8 and 4 (its tower reads their concatenation)."""
    if case == "multi-hot deepfm":
        widths = (4, 1, 2, 1, 1)
        port, ref = _models("deepfm", widths=widths)
    else:
        widths = WIDTHS
        port, ref = _models("widedeep", field_dims=(16, 8, 4, 8, 4))
        assert port.field_dims == ref.field_dims == (16, 8, 4, 8, 4)
    np_params = _jax_params(ref, 3)
    params = convert.params_from_jax(np_params, port)
    got, want = _forward_pair(port, ref, np_params, params, _batch(4, widths))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_bi_interaction_and_dlrm_pair_order_match_jax():
    """NFM's bi-interaction vector; DLRM's pairs in ``np.tril_indices``'
    order (the top MLP's first weight reads them so)."""
    x = np.random.default_rng(5).normal(size=(7, 5, 6)).astype(np.float32)
    np.testing.assert_allclose(bi_interaction(torch.from_numpy(x)).numpy(),
                               np.asarray(jax_bi_interaction(jnp.asarray(x))), rtol=RTOL, atol=ATOL)
    nv = len(VOCABS) + 1  # the bottom MLP's vector and the fields
    rows, cols = torch.tril_indices(nv, nv, -1)
    want_rows, want_cols = np.tril_indices(nv, k=-1)
    np.testing.assert_array_equal(rows.numpy(), want_rows)
    np.testing.assert_array_equal(cols.numpy(), want_cols)


OPTIM = dict(learning_rate=0.01, dense_optimizer="adam", sparse_optimizer="rowwise_adagrad",
             sparse_learning_rate=0.05)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_one_step_matches_jax(name):
    """One step from JAX's state (noisy params) with l2: the loss, every
    table and accumulator, and the dense params after Adam."""
    port, ref = _models(name)
    jb = jax_step.TrainStepBuilder(ref, "logloss", JaxOptimConfig(**OPTIM), l2_reg=0.01, kernels="xla")
    jstate = jb.init_state(jax.random.PRNGKey(0))
    noisy = _jax_params(ref, 6)
    jstate = {**jstate, "tables": jax.tree.map(jnp.asarray, noisy["tables"]),
              "dense": jax.tree.map(jnp.asarray, noisy["dense"])}
    builder = TrainStepBuilder(port, "logloss", OptimConfig(**OPTIM), l2_reg=0.01, device="cpu")
    state = convert.train_state_from_jax(jax.tree.map(np.asarray, jstate), port)
    batch = _batch(7)
    jstate, jm = jax.jit(jb.step)(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    state, m = builder.step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=STEP_RTOL)
    for tname, table in jstate["tables"].items():
        np.testing.assert_allclose(state["tables"][tname].numpy(), np.asarray(table), rtol=STEP_RTOL,
                                   atol=STEP_ATOL, err_msg=tname)
        np.testing.assert_allclose(state["sparse_opt"][tname]["acc"].numpy(),
                                   np.asarray(jstate["sparse_opt"][tname]["acc"]), rtol=STEP_RTOL,
                                   atol=STEP_ATOL, err_msg=tname)
    want_dense = convert.params_from_jax(jax.tree.map(np.asarray, {"tables": jstate["tables"],
                                                                   "dense": jstate["dense"]}), port)
    for got, want in zip(tree_leaves(state["dense"]), tree_leaves(want_dense["dense"])):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=STEP_RTOL, atol=STEP_ATOL)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_build_model_builds_the_reference_tables_and_dense_tree(name):
    """Each newly ported name builds: JAX's table names, shapes and
    initializers, and its dense tree's keys and shapes; a seeded init
    repeats."""
    port, ref = _models(name)
    assert [(s.name, s.shape, s.initializer) for s in port.table_specs()] == [
        (s.name, s.shape, s.initializer) for s in ref.table_specs()]
    params = port.init(torch.Generator().manual_seed(0), "cpu")
    jparams = ref.init(jax.random.PRNGKey(0))
    assert jax.tree.map(lambda t: tuple(t.shape), params) == jax.tree.map(lambda a: tuple(a.shape), jparams)
    again = port.init(torch.Generator().manual_seed(0), "cpu")
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(params), tree_leaves(again)))
    if port.use_linear_tables:
        assert not any(params["tables"][f"lin_{f}"].any() for f in range(len(VOCABS)))


def test_checkpoint_round_trip_in_the_jax_layout(tmp_path):
    """DLRM's state (nested top and bottom MLPs) under Adam and rowwise
    Adagrad: the port's flat keys are JAX's, JAX restores the port's
    checkpoint leaf for leaf, and the port JAX's."""
    port, ref = _models("dlrm")
    jb = jax_step.TrainStepBuilder(ref, "logloss", JaxOptimConfig(**OPTIM))
    rng = np.random.default_rng(8)
    state = jax.tree.map(lambda x: (rng.normal(size=np.shape(x)).astype(np.float32)
                                    if np.asarray(x).dtype == np.float32 else np.asarray(x) + 3),
                         jb.init_state(jax.random.PRNGKey(0)))
    port_state = convert.train_state_from_jax(state, port)
    got = convert.flat_from_state(port_state, "adam")
    want = {k: np.asarray(v) for k, v in jax_ckpt._flatten(state).items()}
    assert sorted(got) == sorted(want) and any(k.startswith("dense/bottom/") for k in got)
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
