"""The port's serving slice against the JAX package, on the CPU.

The JAX DCN (``backend="pallas"``, its cross kernel in interpret mode)
serves ``predict_ctr`` from its params; the same params, as numpy, go
through ``convert.params_from_jax`` into the port's ``Recommender`` on the
CPU, which must give the same logits. Per-field, lane-packed and stacked
JAX tables all convert to the port's per-field tables.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfrec_tpu.configs import ModelConfig as JaxModelConfig
from tfrec_tpu.models import DataSpec as JaxDataSpec
from tfrec_tpu.models import build_model as jax_build_model
from tfrec_tpu.serve import Recommender as JaxRecommender
from tfrec_tpu_torch.configs import ModelConfig
from tfrec_tpu_torch.convert import params_from_jax
from tfrec_tpu_torch.models import DataSpec, build_model
from tfrec_tpu_torch.serve import Recommender

torch.set_num_threads(1)

VOCABS = (37, 52, 45, 60)
WIDTHS = (1, 1, 3, 1)  # field 2 is a multi-hot bag, sentinel-padded
NUM_DENSE = 3
BATCH = 32


def _requests(seed, layout="per_field"):
    """Dense features and ids with duplicates, sentinel-padded bags (rows
    0-3 all padding) and negative ids.

    Out-of-range ids of a single-hot field are not masked, and the JAX
    layouts read different rows for them: per-field tables clamp to the
    field's own last row, a lane pack to its pack's last row, the stacked
    table to the last field's last row. The port clamps per field, so the
    packed and stacked cases keep single-hot ids in range. The stacked
    layout also offsets ids into one table, so a negative id of field f
    reads field f-1's rows there: that case has no negative ids."""
    rng = np.random.default_rng(seed)
    dense = rng.normal(size=(BATCH, NUM_DENSE)).astype(np.float32)
    low = 0 if layout == "stacked" else -2
    cols = []
    for v, w in zip(VOCABS, WIDTHS):
        edge = w > 1 or layout == "per_field"  # out-of-range ids allowed
        cols.append(rng.integers(low if edge else 0, v + 2 if edge else v, size=(BATCH, w)))
    cat = np.concatenate(cols, axis=1).astype(np.int32)
    cat[:4, 2:5] = VOCABS[2]
    cat[4, 2:5] = [5, VOCABS[2], VOCABS[2]]
    if layout == "per_field":
        cat[5, 0] = VOCABS[0]
        cat[6, 1] = -1
    return dense, cat


def _jax_params(model, seed):
    """JAX init params as numpy, with seeded noise on the dense leaves so
    the zero-initialised biases are exercised too."""
    params = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(seed)
    params["dense"] = jax.tree.map(
        lambda a: (a + 0.05 * rng.normal(size=a.shape)).astype(np.float32), params["dense"]
    )
    return params


CASES = {
    # name: (model name, cross_rank, JAX table layout)
    "dcn_per_field": ("dcn", 0, "per_field"),
    "dcn_lane_packed": ("dcn", 0, "lane_packed"),
    "dcn_stacked": ("dcn", 0, "stacked"),
    "dcnv2_lowrank": ("dcnv2", 4, "per_field"),
    "dcnv2_fullrank": ("dcnv2", 0, "per_field"),
}
FIRST_TABLE = {"per_field": "field_0", "lane_packed": "pack_0", "stacked": "fields"}


@pytest.mark.parametrize("case", sorted(CASES))
def test_predict_ctr_matches_jax(case):
    name, rank, layout = CASES[case]
    jcfg = JaxModelConfig(name=name, embed_dim=8, num_cross_layers=2, mlp_dims=(16, 8),
                          cross_rank=rank, lane_pack=layout == "lane_packed",
                          stack_tables=layout == "stacked")
    jmodel = jax_build_model(jcfg, JaxDataSpec.ctr(VOCABS, NUM_DENSE, WIDTHS), backend="pallas")
    np_params = _jax_params(jmodel, seed=1)
    assert FIRST_TABLE[layout] in np_params["tables"]
    dense, cat = _requests(2, layout)
    want = JaxRecommender(jmodel, jax.tree.map(jnp.asarray, np_params)).predict_ctr(dense, cat)

    cfg = ModelConfig(name=name, embed_dim=8, num_cross_layers=2, mlp_dims=(16, 8), cross_rank=rank)
    model = build_model(cfg, DataSpec.ctr(VOCABS, NUM_DENSE, WIDTHS))
    got = Recommender(model, params_from_jax(np_params, model), device="cpu").predict_ctr(dense, cat)
    assert got.shape == (BATCH,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_seeded_init_serves_finite_logits_of_the_reference_shape():
    cfg = ModelConfig(name="dcn", embed_dim=8, num_cross_layers=2, mlp_dims=(16, 8))
    model = build_model(cfg, DataSpec.ctr(VOCABS, NUM_DENSE, WIDTHS))
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    jmodel = jax_build_model(JaxModelConfig(name="dcn", embed_dim=8, num_cross_layers=2,
                                            mlp_dims=(16, 8), lane_pack=False),
                             JaxDataSpec.ctr(VOCABS, NUM_DENSE, WIDTHS))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    shapes = jax.tree.map(lambda a: tuple(a.shape), jparams)
    assert jax.tree.map(lambda t: tuple(t.shape), params) == shapes
    again = model.init(torch.Generator().manual_seed(0), "cpu")
    assert all(torch.equal(params["tables"][k], again["tables"][k]) for k in params["tables"])
    logits = Recommender(model, params, device="cpu").predict_ctr(*_requests(3))
    assert logits.shape == (BATCH,) and np.isfinite(logits).all()


def test_params_from_jax_rejects_an_unknown_layout():
    model = build_model(ModelConfig(name="dcn", embed_dim=8, mlp_dims=(8,)),
                        DataSpec.ctr(VOCABS, NUM_DENSE, WIDTHS))
    with pytest.raises(ValueError, match="table layout"):
        params_from_jax({"tables": {"user_emb": np.zeros((3, 8))}, "dense": {}}, model)
    with pytest.raises(ValueError, match="lane-packed"):
        params_from_jax({"tables": {"pack_0": np.zeros((60, 32)), "pack_1": np.zeros((1, 8))},
                         "dense": {}}, model)


def test_default_device_is_cuda_and_refuses_to_fall_back():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device serves there")
    model = build_model(ModelConfig(name="dcn", embed_dim=8, mlp_dims=(8,)),
                        DataSpec.ctr(VOCABS, NUM_DENSE, WIDTHS))
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Recommender(model, params)


def test_build_model_guards():
    spec = DataSpec.ctr(VOCABS, NUM_DENSE, WIDTHS)
    with pytest.raises(ValueError, match="dcnv2"):
        build_model(ModelConfig(name="dcn", cross_rank=4), spec)
    # The lane-packed and stacked layouts build (one pack of 16 fields at
    # d=8; one stacked table), and refuse mixed dims.
    for kw, names in (({"lane_pack": True}, ["pack_0"]), ({"stack_tables": True}, ["fields"])):
        assert [s.name for s in build_model(ModelConfig(name="dcn", embed_dim=8, **kw), spec).table_specs()] == names
        with pytest.raises(ValueError, match="equal per-field"):
            build_model(ModelConfig(name="dcn", field_dims=(8, 8, 8, 16), **kw), spec)
    with pytest.raises(ValueError, match="EASE needs an interaction DataSpec"):
        build_model(ModelConfig(name="ease"), spec)
    with pytest.raises(ValueError, match="interaction DataSpec"):
        build_model(ModelConfig(name="mf"), spec)
    # AUTO lane packing builds per-field tables in the port.
    model = build_model(ModelConfig(name="dcn", embed_dim=8, lane_pack=None), spec)
    assert [s.name for s in model.table_specs()] == [f"field_{f}" for f in range(4)]
