"""The port's FM and NCF models (configs 2 and 3) against the JAX package,
on the CPU.

The same seeded inputs go through the JAX model and its counterpart in the
port, at the JAX model's own params (``convert.params_from_jax``), with
seeded noise on the leaves JAX initialises to constants (FM's linear
tables and w0, GMF's h and b, NeuMF's biases) so their paths count:

- FM's forward, ``linear_sum``, ``fm_second_order`` over ``field_stack``,
  with a multi-hot bag (sentinel-padded) and dense features, from JAX
  params in each table layout (per-field, lane-packed, stacked), and the
  2-field form's ``score_all`` and ``dot_decomposition``;
- GMF, MLP and NeuMF ``forward`` on pointwise, single-negative,
  K-negative and in-batch batches, and ``score_items`` / ``score_all``
  over item chunks whose last chunk clamps;
- ``build_model``'s tables and dense trees against JAX's.

On CPU tensors the gather wrapper takes its plain version; the card holds
the kernel against it (tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfrec_tpu.configs import ModelConfig as JaxModelConfig
from tfrec_tpu.models import DataSpec as JaxDataSpec
from tfrec_tpu.models import build_model as jax_build_model
from tfrec_tpu.models.ctr_base import fm_second_order as jax_fm_second_order
from tfrec_tpu_torch.configs import ModelConfig
from tfrec_tpu_torch.convert import params_from_jax
from tfrec_tpu_torch.models import FM, GMF, MLP, DataSpec, NeuMF, build_model
from tfrec_tpu_torch.models.ctr_base import fm_second_order
from tfrec_tpu_torch.ops.embedding import gather_many

torch.set_num_threads(1)

# Sums of d=32 products and pairwise terms in another order than XLA's.
RTOL, ATOL = 1e-5, 1e-6
VOCABS = (37, 52, 45, 60, 11)
WIDTHS = (1, 1, 3, 1, 1)  # field 2 is a multi-hot bag, sentinel-padded
NUM_DENSE = 2
DIM = 32  # 4 fields a 128-lane pack in JAX's packed layout
BATCH = 24
NUM_USERS, NUM_ITEMS = 40, 75


def _noisy(tree, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (a + scale * rng.normal(size=a.shape)).astype(np.float32), tree)


def _jax_params(jmodel, seed, tables=()):
    """JAX's init as numpy, with seeded noise on the dense leaves and on
    the named tables."""
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    params["dense"] = _noisy(params["dense"], seed)
    for name in tables:
        params["tables"][name] = _noisy(params["tables"][name], seed + 1, 0.3)
    return params


def _cat(rng, layout):
    """Ids with duplicates, sentinel-padded bags (rows 0-3 all padding) and,
    in the per-field layout, out-of-range single-hot ids (the JAX layouts
    read different rows for those: tests/test_torch_serve.py)."""
    low = 0 if layout == "stacked" else -2
    cols = []
    for v, w in zip(VOCABS, WIDTHS):
        edge = w > 1 or layout == "per_field"
        cols.append(rng.integers(low if edge else 0, v + 2 if edge else v, size=(BATCH, w)))
    cat = np.concatenate(cols, axis=1).astype(np.int32)
    cat[:4, 2:5] = VOCABS[2]
    cat[4, 2:5] = [5, VOCABS[2], VOCABS[2]]
    return cat


def _jax_gathered(jmodel, np_params, batch):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    return jb, {name: jnp.take(jnp.asarray(np_params["tables"][name]), i, axis=0, mode="clip")
                for name, i in jmodel.lookup_ids(jb).items()}


def _gathered(model, params, batch):
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    ids = model.lookup_ids(tb)
    return tb, dict(zip(ids, gather_many([params["tables"][k] for k in ids], list(ids.values()))))


LAYOUTS = {"per_field": {}, "lane_packed": {"lane_pack": True}, "stacked": {"stack_tables": True}}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_fm_forward_linear_sum_and_second_order_match_jax(layout):
    jmodel = jax_build_model(JaxModelConfig(**{"name": "fm", "embed_dim": DIM, "lane_pack": False,
                                               **LAYOUTS[layout]}),
                             JaxDataSpec.ctr(VOCABS, NUM_DENSE, WIDTHS))
    lin = {"per_field": [f"lin_{f}" for f in range(len(VOCABS))], "lane_packed": ["linpack_0"],
           "stacked": ["lin"]}[layout]
    np_params = _jax_params(jmodel, 1, tables=lin)
    assert set(lin) <= set(np_params["tables"])
    model = build_model(ModelConfig(name="fm", embed_dim=DIM), DataSpec.ctr(VOCABS, NUM_DENSE, WIDTHS))
    assert isinstance(model, FM)
    params = params_from_jax(np_params, model)
    assert list(params["tables"]) == [s.name for s in model.table_specs()]
    assert params["tables"]["lin_3"].shape == (VOCABS[3], 1) and params["tables"]["lin_3"].any()

    rng = np.random.default_rng(2)
    batch = {"dense": rng.normal(size=(BATCH, NUM_DENSE)).astype(np.float32), "cat": _cat(rng, layout),
             "label": np.zeros(BATCH, np.float32)}
    jb, jg = _jax_gathered(jmodel, np_params, batch)
    tb, g = _gathered(model, params, batch)
    pairs = {
        "forward": (model(params["dense"], g, tb), jmodel.forward(np_params["dense"], jg, jb)),
        "linear_sum": (model.linear_sum(g, tb), jmodel.linear_sum(jg, jb)),
        "field_stack": (model.field_stack(g, tb), jmodel.field_stack(jg, jb)),
        "fm_second_order": (fm_second_order(model.field_stack(g, tb)),
                            jax_fm_second_order(jmodel.field_stack(jg, jb))),
    }
    for what, (got, want) in pairs.items():
        want = np.asarray(want)
        assert got.shape == want.shape, what
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL, err_msg=what)
    assert pairs["forward"][0].shape == (BATCH,)


def _fm_2field_pair():
    jmodel = jax_build_model(JaxModelConfig(name="fm", embed_dim=16), JaxDataSpec.ctr((NUM_USERS, NUM_ITEMS), 0))
    assert jmodel.dot_decomposition() is not None  # AUTO packing skips the retrieval form
    np_params = _jax_params(jmodel, 3, tables=("lin_0", "lin_1"))
    model = build_model(ModelConfig(name="fm", embed_dim=16), DataSpec.ctr((NUM_USERS, NUM_ITEMS), 0))
    return jmodel, np_params, model, params_from_jax(np_params, model)


def test_fm_two_field_score_all_and_dot_decomposition_match_jax():
    jmodel, np_params, model, params = _fm_2field_pair()
    users = np.array([0, 7, 7, NUM_USERS - 1, 19], np.int32)
    want = np.asarray(jmodel.score_all(jax.tree.map(jnp.asarray, np_params), jnp.asarray(users)))
    got = model.score_all(params, torch.from_numpy(users))
    assert got.shape == want.shape == (5, NUM_ITEMS)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    # score_all is the pointwise forward of every (user, item) pair.
    cat = np.stack([np.repeat(users, NUM_ITEMS), np.tile(np.arange(NUM_ITEMS), len(users))], 1).astype(np.int32)
    tb, g = _gathered(model, params, {"dense": np.zeros((len(cat), 0), np.float32), "cat": cat})
    np.testing.assert_allclose(model(params["dense"], g, tb).reshape(5, NUM_ITEMS).numpy(), want,
                               rtol=RTOL, atol=ATOL)
    spec, jspec = model.dot_decomposition(), jmodel.dot_decomposition()
    assert (spec.user_table, spec.item_table, spec.bias_table) == (
        jspec.user_table, jspec.item_table, jspec.bias_table)


def test_fm_with_side_fields_refuses_score_all_as_jax():
    spec = (NUM_USERS, NUM_ITEMS, 2, 7)
    jmodel = jax_build_model(JaxModelConfig(name="fm", embed_dim=16, lane_pack=False), JaxDataSpec.ctr(spec, 0))
    model = build_model(ModelConfig(name="fm", embed_dim=16), DataSpec.ctr(spec, 0))
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(NotImplementedError, match="2-field") as ours:
        model.score_all(params, torch.zeros(2, dtype=torch.int32))
    with pytest.raises(NotImplementedError) as ref:
        jmodel.score_all(jmodel.init(jax.random.PRNGKey(0)), jnp.zeros(2, jnp.int32))
    assert str(ours.value) == str(ref.value)
    assert model.dot_decomposition() is None and jmodel.dot_decomposition() is None


# ---- GMF, MLP, NeuMF ----

NCF = {  # name: ModelConfig keywords
    "gmf": dict(name="gmf", gmf_dim=8),
    "mlp": dict(name="mlp", mlp_embed_dim=8, mlp_dims=(16, 8)),
    "neumf": dict(name="neumf", gmf_dim=8, mlp_embed_dim=6, mlp_dims=(12, 8, 4)),
}


def _ncf_pair(name, chunk=None):
    kw = NCF[name]
    jmodel = jax_build_model(JaxModelConfig(**kw), JaxDataSpec.interaction(NUM_USERS, NUM_ITEMS))
    model = build_model(ModelConfig(**kw), DataSpec.interaction(NUM_USERS, NUM_ITEMS))
    assert type(model).__name__ == type(jmodel).__name__
    if chunk is not None:
        jmodel.eval_chunk = model.eval_chunk = chunk
    np_params = _jax_params(jmodel, 4)
    params = params_from_jax(np_params, model)
    assert list(params["tables"]) == [s.name for s in jmodel.table_specs()]
    return jmodel, np_params, model, params


def _ncf_batches(seed, k=3):
    rng = np.random.default_rng(seed)

    def ids(vocab, *shape):
        return rng.integers(0, vocab, (BATCH, *shape)).astype(np.int32)

    user = ids(NUM_USERS)
    return {
        "pointwise": {"user": user, "item": ids(NUM_ITEMS), "label": np.zeros(BATCH, np.float32)},
        "single negative": {"user": user, "pos": ids(NUM_ITEMS), "neg": ids(NUM_ITEMS)},
        "multi-negative": {"user": user, "pos": ids(NUM_ITEMS), "negs": ids(NUM_ITEMS, k)},
        "in-batch": {"user": user, "pos": ids(NUM_ITEMS)},
    }


BRANCH_SHAPES = {"pointwise": (BATCH,), "single negative": (BATCH,), "multi-negative": (BATCH, 4),
                 "in-batch": (BATCH, BATCH)}


@pytest.mark.parametrize("branch", sorted(BRANCH_SHAPES))
@pytest.mark.parametrize("name", sorted(NCF))
def test_ncf_forward_matches_jax(name, branch):
    """Each batch kind; in-batch scores exist for GMF only, and MLP and
    NeuMF refuse them with the reference's message."""
    jmodel, np_params, model, params = _ncf_pair(name)
    batch = _ncf_batches(5)[branch]
    jb, jg = _jax_gathered(jmodel, np_params, batch)
    tb, g = _gathered(model, params, batch)
    assert list(model.lookup_ids(tb)) == list(jmodel.lookup_ids(jb))
    if branch == "in-batch" and name != "gmf":
        with pytest.raises(NotImplementedError) as ours:
            model(params["dense"], g, tb)
        with pytest.raises(NotImplementedError) as ref:
            jmodel.forward(np_params["dense"], jg, jb)
        assert str(ours.value) == str(ref.value)
        return
    got = model(params["dense"], g, tb)
    want = np.asarray(jmodel.forward(np_params["dense"], jg, jb))
    assert got.shape == want.shape == BRANCH_SHAPES[branch]
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", sorted(NCF))
def test_ncf_score_items_and_score_all_match_jax(name):
    """Chunks of 32 over 75 items: the last chunk's ids clamp to V-1 and the
    scores are cut to V."""
    jmodel, np_params, model, params = _ncf_pair(name, chunk=32)
    jp = jax.tree.map(jnp.asarray, np_params)
    users = np.array([0, 3, 3, NUM_USERS - 1, 11, 30], np.int32)
    items = np.array([4, 0, NUM_ITEMS - 1, 4, 50], np.int32)
    want = np.asarray(jmodel.score_items(jp, jnp.asarray(users), jnp.asarray(items)))
    got = model.score_items(params, torch.from_numpy(users), torch.from_numpy(items))
    assert got.shape == want.shape == (6, 5)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    want = np.asarray(jmodel.score_all(jp, jnp.asarray(users)))
    got = model.score_all(params, torch.from_numpy(users))
    assert got.shape == want.shape == (6, NUM_ITEMS)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    # score_all is the pointwise forward of every (user, item) pair.
    pointwise = model.score_items(params, torch.from_numpy(users), torch.arange(NUM_ITEMS, dtype=torch.int32))
    np.testing.assert_allclose(got.numpy(), pointwise.numpy(), rtol=RTOL, atol=ATOL)


def test_gmf_dot_decomposition_matches_jax():
    jmodel, np_params, model, params = _ncf_pair("gmf")
    spec, jspec = model.dot_decomposition(), jmodel.dot_decomposition()
    assert (spec.user_table, spec.item_table, spec.bias_table) == (
        jspec.user_table, jspec.item_table, jspec.bias_table)
    rows = np.array(np_params["tables"]["user_emb"][:5])
    want = np.asarray(jspec.user_vecs(jax.tree.map(jnp.asarray, np_params["dense"]), jnp.asarray(rows)))
    got = spec.user_vecs(params["dense"], torch.from_numpy(rows))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    assert model.dot_decomposition() is not None
    assert _ncf_pair("neumf")[2].dot_decomposition() is None


@pytest.mark.parametrize("name", ["fm", *sorted(NCF)])
def test_build_model_matches_the_reference_tables_and_dense_tree(name):
    """Table names, shapes and initializers, and the dense tree's shapes,
    as JAX builds them; a seeded init repeats; NeuMF keeps the reference's
    warm-start aliases."""
    if name == "fm":
        kw, jspec, spec = dict(name="fm", embed_dim=16), JaxDataSpec.ctr(VOCABS, 3), DataSpec.ctr(VOCABS, 3)
        kw_jax = dict(kw, lane_pack=False)
    else:
        kw = kw_jax = NCF[name]
        jspec, spec = JaxDataSpec.interaction(NUM_USERS, NUM_ITEMS), DataSpec.interaction(NUM_USERS, NUM_ITEMS)
    jmodel = jax_build_model(JaxModelConfig(**kw_jax), jspec)
    model = build_model(ModelConfig(**kw), spec)
    assert [(s.name, s.shape, s.initializer) for s in model.table_specs()] == [
        (s.name, s.shape, s.initializer) for s in jmodel.table_specs()]
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    jparams = jmodel.init(jax.random.PRNGKey(0))
    assert jax.tree.map(lambda t: tuple(t.shape), params) == jax.tree.map(lambda a: tuple(a.shape), jparams)
    again = model.init(torch.Generator().manual_seed(0), "cpu")
    assert all(torch.equal(a, b) for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(again)))
    if name == "neumf":
        assert model.warm_start_aliases() == jmodel.warm_start_aliases()
    if name == "fm":
        assert not any(params["tables"][f"lin_{f}"].any() for f in range(len(VOCABS)))


def test_build_model_guards_of_the_new_models():
    inter = DataSpec.interaction(NUM_USERS, NUM_ITEMS)
    for name in ("gmf", "mlp", "neumf"):
        with pytest.raises(ValueError, match="applies to CTR models"):
            build_model(ModelConfig(name=name, lane_pack=True), inter)
        with pytest.raises(ValueError, match="interaction DataSpec"):
            build_model(ModelConfig(name=name), DataSpec.ctr(VOCABS, 0))
    # FM builds the reference's lane-packed and stacked layouts, with its checks.
    packed = build_model(ModelConfig(name="fm", lane_pack=True), DataSpec.ctr(VOCABS, 0))
    jpacked = jax_build_model(JaxModelConfig(name="fm", lane_pack=True), JaxDataSpec.ctr(VOCABS, 0))
    assert [(s.name, s.shape, s.lane_groups) for s in packed.table_specs()] == [
        (s.name, s.shape, s.lane_groups) for s in jpacked.table_specs()]
    stacked = build_model(ModelConfig(name="fm", stack_tables=True), DataSpec.ctr(VOCABS, 0))
    assert [s.name for s in stacked.table_specs()] == ["fields", "lin"]
    with pytest.raises(ValueError, match="mutually exclusive"):
        build_model(ModelConfig(name="fm", lane_pack=True, stack_tables=True), DataSpec.ctr(VOCABS, 0))
    with pytest.raises(ValueError, match="dividing 128"):
        build_model(ModelConfig(name="fm", embed_dim=48, lane_pack=True), DataSpec.ctr(VOCABS, 0))
    with pytest.raises(ValueError, match="equal field dims"):
        build_model(ModelConfig(name="fm", field_dims=(8, 8, 8, 8, 16)), DataSpec.ctr(VOCABS, 0))
    assert isinstance(build_model(ModelConfig(name="gmf", gmf_dim=0, embed_dim=12), inter), GMF)
    assert build_model(ModelConfig(name="gmf", gmf_dim=0, embed_dim=12), inter).embed_dim == 12
    assert isinstance(build_model(ModelConfig(name="mlp"), inter), MLP)
    assert isinstance(build_model(ModelConfig(name="neumf"), inter), NeuMF)


def test_params_from_jax_refuses_fm_tables_without_their_linear_tables():
    model = build_model(ModelConfig(name="fm", embed_dim=DIM), DataSpec.ctr(VOCABS, 0))
    fields = {f"field_{f}": np.zeros((v, DIM), np.float32) for f, v in enumerate(VOCABS)}
    with pytest.raises(ValueError, match="table layout"):
        params_from_jax({"tables": fields, "dense": {"w0": np.zeros(())}}, model)
    with pytest.raises(ValueError, match="lane-packed"):
        params_from_jax({"tables": {"pack_0": np.zeros((60, 128)), "pack_1": np.zeros((45, 32))},
                         "dense": {}}, model)
