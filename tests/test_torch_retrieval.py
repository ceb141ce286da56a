"""The port's retrieval slice (config 1, MF + BPR) against the JAX package,
on the CPU.

The same seeded inputs go through the JAX function and its counterpart in
the port: the interaction data (``synthetic_implicit``, both splitters,
the padded positives) and the samplers, array for array; ``MF`` from the
JAX model's own params (``convert.params_from_jax``); the pairwise and
pointwise losses; the ranking metrics; the masking and top-k of
``eval/retrieval.py`` and its evaluator; three train steps of MF under each
pairwise loss from JAX's state; device negatives; and ``Recommender``'s
``predict``, ``score_catalog`` and ``recommend``. On CPU tensors the
gather and Adagrad wrappers take their plain versions; the card holds the
kernels against those (tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfrec_tpu.configs import DataConfig as JaxDataConfig
from tfrec_tpu.configs import OptimConfig as JaxOptimConfig
from tfrec_tpu.data import dataset as jax_dataset
from tfrec_tpu.data import samplers as jax_samplers
from tfrec_tpu.data.synthetic import synthetic_implicit as jax_synthetic_implicit
from tfrec_tpu.eval import retrieval as jax_retrieval
from tfrec_tpu.eval.metrics import ranking_metrics_from_topk as jax_ranking_metrics
from tfrec_tpu.models import DataSpec as JaxDataSpec
from tfrec_tpu.models.mf import MF as JaxMF
from tfrec_tpu.serve import Recommender as JaxRecommender
from tfrec_tpu.train import losses as jax_losses
from tfrec_tpu.train import step as jax_step
from tfrec_tpu_torch.configs import DataConfig, ModelConfig, OptimConfig
from tfrec_tpu_torch.convert import params_from_jax, train_state_from_jax
from tfrec_tpu_torch.data import dataset, samplers
from tfrec_tpu_torch.data.synthetic import synthetic_implicit
from tfrec_tpu_torch.eval import retrieval
from tfrec_tpu_torch.eval.metrics import ranking_metrics_from_topk
from tfrec_tpu_torch.models import DataSpec, build_model
from tfrec_tpu_torch.models.mf import MF
from tfrec_tpu_torch.serve import Recommender
from tfrec_tpu_torch.train import losses
from tfrec_tpu_torch.train.step import TrainStepBuilder

torch.set_num_threads(1)

# MF's scores are row dots of d = 16 (and one [B, D] x [D, B] product),
# summed in another order than XLA's.
FWD_RTOL, FWD_ATOL = 1e-5, 1e-6
LOSS_RTOL = 1e-6
# Ranking metrics: means over users of f32 ratios, summed in another order.
METRIC_RTOL = 1e-6
METRIC_ATOL = 1e-6
# Three steps of MF: the rowwise Adagrad update is lr * g / rms(g), so a
# gradient's rounding moves a table row by ~1e-7 of lr.
STEP_LOSS_RTOL, STEP_TABLE_ATOL = 1e-5, 1e-6
NUM_USERS, NUM_ITEMS, DIM = 60, 90, 16


def _data_config(mod, **kw):
    base = dict(source="synthetic_implicit", num_users=NUM_USERS, num_items=NUM_ITEMS,
                interactions_per_user=10, seed=3)
    base.update(kw)
    return mod(**base)


def _datasets(**kw):
    return (dataset.build_dataset(_data_config(DataConfig, **kw)),
            jax_dataset.build_dataset(_data_config(JaxDataConfig, **kw)))


def _assert_interactions_equal(got, want):
    assert (got.num_users, got.num_items) == (want.num_users, want.num_items)
    for field in ("users", "items", "ratings", "times"):
        a, e = getattr(got, field), getattr(want, field)
        assert a.dtype == e.dtype, field
        np.testing.assert_array_equal(a, e, err_msg=field)


# ---- data ----

def test_synthetic_implicit_matches_the_reference():
    _assert_interactions_equal(synthetic_implicit(40, 70, 9, latent_rank=4, seed=5),
                               jax_synthetic_implicit(40, 70, 9, latent_rank=4, seed=5))


@pytest.mark.parametrize("kw", [
    {},
    {"splitter": "leave_one_out"},
    {"test_fraction": 0.35, "min_interactions": 3},
    {"binarize_threshold": 1.0, "splitter": "leave_one_out"},
])
def test_build_dataset_and_padded_positives_match_the_reference(kw):
    got, want = _datasets(**kw)
    assert (got.num_users, got.num_items) == (want.num_users, want.num_items)
    _assert_interactions_equal(got.train, want.train)
    _assert_interactions_equal(got.test, want.test)
    for name in ("train_csr", "test_csr"):
        a, e = getattr(got, name), getattr(want, name)
        assert (a != e).nnz == 0 and a.dtype == e.dtype
    for pad_to in (None, 3):
        for a, e in zip(got.train_items_padded(pad_to), want.train_items_padded(pad_to)):
            assert a.dtype == e.dtype
            np.testing.assert_array_equal(a, e)
    for a, e in zip(retrieval.padded_positives(got.test_csr),
                    jax_retrieval.padded_positives(want.test_csr)):
        np.testing.assert_array_equal(a, e)


def test_build_dataset_refuses_what_is_not_ported():
    # The trust graph is built (tests/test_torch_social_adv_zoo.py holds it to
    # JAX's); an edge file that does not exist is refused.
    social = dataset.build_dataset(_data_config(DataConfig, social_degree=3)).social
    assert social is not None and social.shape[0] == social.shape[1] and social.nnz > 0
    with pytest.raises(OSError):
        dataset.build_dataset(_data_config(DataConfig, social_path="no_such_edges.txt"))
    with pytest.raises(ValueError, match="splitter"):
        dataset.build_dataset(_data_config(DataConfig, splitter="given"))
    with pytest.raises(ValueError, match="source"):
        dataset.build_dataset(_data_config(DataConfig, source="synthetic_ctr"))


SAMPLERS = {
    # name: (sampler class name, keyword arguments)
    "pairwise": ("PairwiseSampler", {"num_negatives": 2}),
    "pairwise, popularity": ("PairwiseSampler", {"num_negatives": 1, "popularity": 0.75}),
    "multi_neg": ("PairwiseSampler", {"num_negatives": 4, "multi_neg": True}),
    "no_negatives": ("PairwiseSampler", {"no_negatives": True}),
    "pointwise": ("PointwiseSampler", {"num_negatives": 3}),
    "pointwise, popularity": ("PointwiseSampler", {"num_negatives": 2, "popularity": 0.5}),
}


@pytest.mark.parametrize("case", sorted(SAMPLERS))
def test_samplers_match_the_reference(case):
    ours, ref = _datasets()
    cls, kw = SAMPLERS[case]
    kw = dict(kw)
    beta = kw.pop("popularity", None)
    if beta is not None:
        cdf = samplers.popularity_cdf(ours, beta)
        np.testing.assert_array_equal(cdf, jax_samplers.popularity_cdf(ref, beta))
        kw["neg_cdf"] = cdf
    got_s = getattr(samplers, cls)(ours, 64, seed=11, **kw)
    want_s = getattr(jax_samplers, cls)(ref, 64, seed=11, **kw)
    assert got_s.num_batches() == want_s.num_batches() > 2
    for epoch in range(2):
        got, want = list(got_s.epoch(epoch)), list(want_s.epoch(epoch))
        assert len(got) == len(want) == got_s.num_batches()
        for a, e in zip(got, want):
            assert a.keys() == e.keys()
            for k in a:
                assert a[k].dtype == e[k].dtype, k
                np.testing.assert_array_equal(a[k], e[k], err_msg=k)


def test_pairwise_sampler_refuses_histories():
    """Refused until the history models were ported; now each batch carries
    its users' histories exactly as the reference's does."""
    port, ref = _datasets()
    ours = samplers.PairwiseSampler(port, 64, with_history=5)
    want = next(jax_samplers.PairwiseSampler(ref, 64, with_history=5).epoch(0))
    got = next(ours.epoch(0))
    assert got.keys() == want.keys() >= {"hist", "hist_len"}
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---- the model and the losses ----

def _mf_pair(num_users=NUM_USERS, num_items=NUM_ITEMS, dim=DIM):
    """The JAX MF and the port's, with the same params: JAX's own init,
    the zero-initialised item bias given seeded values so that its path
    counts."""
    jmodel = JaxMF(JaxDataSpec.interaction(num_users, num_items), dim)
    np_params = jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    assert not np_params["tables"]["item_bias"].any() and np_params["dense"] == {}
    np_params["tables"]["item_bias"] = (
        0.3 * np.random.default_rng(1).normal(size=(num_items, 1))).astype(np.float32)
    model = build_model(ModelConfig(name="mf", embed_dim=dim), DataSpec.interaction(num_users, num_items))
    params = params_from_jax(np_params, model)
    assert list(params["tables"]) == ["user_emb", "item_emb", "item_bias"]
    for name, t in params["tables"].items():
        np.testing.assert_array_equal(t.numpy(), np_params["tables"][name])
    return jmodel, np_params, model, params


def _mf_batches(seed, bsz=24, k=4):
    """One batch of each forward branch, ids in range."""
    rng = np.random.default_rng(seed)

    def ids(n, vocab, *shape):
        return rng.integers(0, vocab, (n, *shape)).astype(np.int32)

    user = ids(bsz, NUM_USERS)
    return {
        "pointwise": {"user": user, "item": ids(bsz, NUM_ITEMS),
                      "label": (rng.random(bsz) < 0.5).astype(np.float32)},
        "single negative": {"user": user, "pos": ids(bsz, NUM_ITEMS), "neg": ids(bsz, NUM_ITEMS)},
        "multi-negative": {"user": user, "pos": ids(bsz, NUM_ITEMS), "negs": ids(bsz, NUM_ITEMS, k)},
        "in-batch": {"user": user, "pos": ids(bsz, NUM_ITEMS)},
    }


def _forward_both(jmodel, np_params, model, params, batch):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jgathered = {name: jnp.take(jnp.asarray(np_params["tables"][name]), i, axis=0)
                 for name, i in jmodel.lookup_ids(jb).items()}
    want = np.asarray(jmodel.forward({}, jgathered, jb))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    ids = model.lookup_ids(tb)
    assert list(ids) == list(jmodel.lookup_ids(jb))
    gathered = {name: params["tables"][name][i.long()] for name, i in ids.items()}
    return model(params["dense"], gathered, tb), want


@pytest.mark.parametrize("branch", ["pointwise", "single negative", "multi-negative", "in-batch"])
def test_mf_forward_matches_jax(branch):
    jmodel, np_params, model, params = _mf_pair()
    batch = _mf_batches(2)[branch]
    got, want = _forward_both(jmodel, np_params, model, params, batch)
    shapes = {"pointwise": (24,), "single negative": (24,), "multi-negative": (24, 5),
              "in-batch": (24, 24)}
    assert got.shape == want.shape == shapes[branch]
    np.testing.assert_allclose(got.numpy(), want, rtol=FWD_RTOL, atol=FWD_ATOL)


def test_mf_score_all_and_dot_decomposition_match_jax():
    jmodel, np_params, model, params = _mf_pair()
    users = np.array([0, 5, 5, NUM_USERS - 1, 17], np.int32)
    want = np.asarray(jmodel.score_all(jax.tree_util.tree_map(jnp.asarray, np_params), jnp.asarray(users)))
    got = model.score_all(params, torch.from_numpy(users))
    assert got.shape == want.shape == (5, NUM_ITEMS)
    np.testing.assert_allclose(got.numpy(), want, rtol=FWD_RTOL, atol=FWD_ATOL)
    spec, jspec = model.dot_decomposition(), jmodel.dot_decomposition()
    assert (spec.user_table, spec.item_table, spec.bias_table) == (
        jspec.user_table, jspec.item_table, jspec.bias_table)
    rows = params["tables"]["user_emb"][users]
    assert spec.user_vecs({}, rows) is rows


LOSS_CASES = {
    # name: (loss, the forward branch whose output it takes)
    "bpr": ("bpr", "single negative"),
    "bpr, K negatives": ("bpr", "multi-negative"),
    "hinge": ("hinge", "single negative"),
    "hinge, K negatives": ("hinge", "multi-negative"),
    "sampled_softmax": ("sampled_softmax", "multi-negative"),
    "in_batch_softmax": ("in_batch_softmax", "in-batch"),
    "logloss": ("logloss", "pointwise"),
    "mse": ("mse", "pointwise"),
}


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_losses_on_mf_outputs_match_jax(case):
    """Each loss on MF's output for its batches, as they are and scaled by
    40 (large margins: the stable forms)."""
    loss, branch = LOSS_CASES[case]
    jmodel, np_params, model, params = _mf_pair()
    batch = _mf_batches(3)[branch]
    got, want = _forward_both(jmodel, np_params, model, params, batch)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    for scale in (1.0, 40.0):
        value = losses.make_loss(loss)(got * scale, tb)
        np.testing.assert_allclose(value.item(), float(jax_losses.make_loss(loss)(jnp.asarray(want * scale), jb)),
                                   rtol=LOSS_RTOL, err_msg=f"scale {scale}")


def test_losses_refuse_what_they_do_not_take():
    with pytest.raises(ValueError, match="multi-negative"):
        losses.sampled_softmax(torch.zeros(4), {})
    with pytest.raises(ValueError, match=r"\[B, B\]"):
        losses.in_batch_softmax(torch.zeros((4, 5)), {})
    assert losses.PAIRWISE_LOSSES == jax_losses.PAIRWISE_LOSSES
    assert losses.MULTI_NEG_LOSSES == jax_losses.MULTI_NEG_LOSSES
    assert losses.IN_BATCH_LOSSES == jax_losses.IN_BATCH_LOSSES


def test_build_model_builds_mf_and_refuses_by_item():
    spec = DataSpec.interaction(NUM_USERS, NUM_ITEMS)
    model = build_model(ModelConfig(name="mf", embed_dim=8), spec)
    assert isinstance(model, MF) and model.use_bias
    assert [(s.name, s.shape, s.initializer) for s in model.table_specs()] == [
        ("user_emb", (NUM_USERS, 8), "normal"), ("item_emb", (NUM_ITEMS, 8), "normal"),
        ("item_bias", (NUM_ITEMS, 1), "zeros")]
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    assert not params["tables"]["item_bias"].any() and params["dense"] == {}
    # The long tail builds (item 12 is done): the model of each name.
    for name, cls in (("sbpr", "SBPR"), ("ease", "EASE"), ("irgan", "IRGAN"), ("wrmf", "WRMF")):
        assert type(build_model(ModelConfig(name=name), spec)).__name__ == cls
    with pytest.raises(ValueError, match="CTR models"):
        build_model(ModelConfig(name="mf", lane_pack=True), spec)
    with pytest.raises(ValueError, match="unknown model"):
        build_model(ModelConfig(name="nope"), spec)


# ---- ranking metrics, masking and top-k ----

def test_ranking_metrics_match_jax():
    rng = np.random.default_rng(4)
    users, v, k_max, max_t = 40, 120, 20, 7
    topk = np.stack([rng.choice(v, k_max, replace=False) for _ in range(users)]).astype(np.int32)
    padded = np.full((users, max_t), v, np.int32)
    counts = rng.integers(0, max_t + 1, users).astype(np.int32)
    counts[:5] = 0  # users with no test items
    for u in range(users):
        # Test items drawn partly from the user's top-k, so that hits happen.
        pool = np.concatenate([topk[u, : 2 * max_t], rng.choice(v, max_t)])
        padded[u, : counts[u]] = rng.choice(np.unique(pool), counts[u], replace=False)
    ks = (1, 5, 20)
    got = ranking_metrics_from_topk(torch.from_numpy(topk), torch.from_numpy(padded),
                                    torch.from_numpy(counts), ks)
    want = jax_ranking_metrics(jnp.asarray(topk), jnp.asarray(padded), jnp.asarray(counts), ks)
    assert set(got) == set(want) and len(got) == 15
    for key in want:
        assert got[key].dtype == torch.float32 and got[key].dim() == 0
        np.testing.assert_allclose(got[key].item(), float(want[key]), rtol=METRIC_RTOL, err_msg=key)
    assert float(want["recall@20"]) > 0.2  # the case has hits


def _assert_same_topk(got_vals, got_ids, want_vals, want_ids, scores):
    """Values equal exactly; ids equal wherever a value is not tied with
    another score of its row (``torch.topk`` orders ties as it likes), and
    a tied id is one of the row's items of that value, each id once."""
    got_vals, got_ids = np.asarray(got_vals), np.asarray(got_ids)
    want_vals, want_ids = np.asarray(want_vals), np.asarray(want_ids)
    np.testing.assert_array_equal(got_vals, want_vals)
    for r in range(scores.shape[0]):
        row = scores[r]
        for j, (val, gi, wi) in enumerate(zip(got_vals[r], got_ids[r], want_ids[r])):
            if (row == val).sum() == 1:
                assert gi == wi, (r, j)
            else:
                assert row[gi] == val, (r, j)
        assert len(set(got_ids[r].tolist())) == len(got_ids[r])


def _score_case(seed, b=6, v=50):
    scores = np.random.default_rng(seed).normal(size=(b, v)).astype(np.float32)
    padded = np.full((b, 9), v, np.int32)
    counts = np.array([0, 3, 9, 9, 2, 5], np.int32)[:b]
    rng = np.random.default_rng(seed + 1)
    for r in range(b):
        padded[r, : counts[r]] = rng.choice(v, counts[r], replace=False)
    padded[1, 1] = padded[1, 0]        # a repeated exclusion
    padded[3, :] = v                   # counts 9, every slot the sentinel
    padded[4, 4] = 7                   # past the count: not excluded
    padded[5, 1] = -3                  # counts from the end, as the reference's scatter
    return scores, padded, counts


def test_mask_items_matches_jax_and_the_reference_case():
    scores, padded, counts = _score_case(5)
    want = np.asarray(jax_retrieval.mask_items(jnp.asarray(scores), jnp.asarray(padded), jnp.asarray(counts)))
    got = retrieval.mask_items(torch.from_numpy(scores.copy()), torch.from_numpy(padded),
                               torch.from_numpy(counts))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[0] == scores[0]).all() and (want[3] == scores[3]).all()  # nothing, all sentinels
    assert (want[1] == retrieval.NEG_INF).sum() == 2 and (want[2] == retrieval.NEG_INF).sum() == 9
    assert want[4, 7] == scores[4, 7] and want[5, 50 - 3] == retrieval.NEG_INF
    # tests/test_metrics.py's case.
    s = torch.tensor([[5.0, 4.0, 3.0, 2.0], [1.0, 2.0, 3.0, 4.0]])
    excl, cnt = torch.tensor([[0, 4], [3, 2]], dtype=torch.int32), torch.tensor([1, 2], dtype=torch.int32)
    masked = retrieval.mask_items(s.clone(), excl, cnt)
    assert masked[0, 0] < -1e29 and masked[0, 1] == 4.0
    _, ids = retrieval.topk_scores(s.clone(), 2, excl, cnt)
    assert ids.dtype == torch.int32 and ids.tolist() == [[1, 2], [1, 0]]


@pytest.mark.parametrize("method", ["exact", "approx"])
def test_topk_scores_and_candidate_topk_match_jax(method):
    scores, padded, counts = _score_case(6)
    for k in (1, 10, 45):  # 45: past the unmasked items of the row with 9 exclusions
        want_v, want_i = jax_retrieval.topk_scores(jnp.asarray(scores), k, jnp.asarray(padded),
                                                   jnp.asarray(counts), method="exact")
        got_v, got_i = retrieval.topk_scores(torch.from_numpy(scores.copy()), k, torch.from_numpy(padded),
                                             torch.from_numpy(counts), method=method)
        masked = np.asarray(jax_retrieval.mask_items(jnp.asarray(scores), jnp.asarray(padded),
                                                     jnp.asarray(counts)))
        _assert_same_topk(got_v.numpy(), got_i.numpy(), want_v, want_i, masked)
        cv, ci = retrieval.candidate_topk(torch.from_numpy(scores), k, method)
        jv, ji = jax_retrieval.candidate_topk(jnp.asarray(scores), k, "exact")
        _assert_same_topk(cv.numpy(), ci.numpy(), jv, ji, scores)
    with pytest.raises(ValueError, match="topk method"):
        retrieval.candidate_topk(torch.from_numpy(scores), 3, "nope")


def _clear(vals, tol=1e-4):
    """Where a row's value lies further than ``tol`` from both neighbours:
    there two products' last-bit differences cannot reorder the ids."""
    gaps = np.abs(np.diff(vals, axis=1)) > tol
    clear = np.ones(vals.shape, bool)
    clear[:, 1:] &= gaps
    clear[:, :-1] &= gaps
    return clear


@pytest.mark.parametrize("chunk,k", [(16, 7), (50, 12), (64, 45)])
def test_chunked_topk_matches_jax(chunk, k):
    """Chunks that do not divide the catalog (16 into 50), one chunk, a
    chunk wider than the catalog; exclusions with a repeat, all sentinels
    and slots past the count; at k = 45 past the 41 items that a row with
    9 exclusions keeps."""
    rng = np.random.default_rng(8)
    v, dim = 50, 8
    n_chunks = -(-v // chunk)
    items = np.zeros((n_chunks * chunk, dim), np.float32)
    items[:v] = rng.normal(size=(v, dim))
    queries = rng.normal(size=(6, dim)).astype(np.float32)
    _, padded, counts = _score_case(9, v=v)
    padded[5, 1] = 11  # chunked_topk drops negative ids where mask_items wraps them

    def jfn(u, start):
        return jnp.asarray(queries)[u] @ jax.lax.dynamic_slice_in_dim(jnp.asarray(items), start, chunk).T

    def tfn(u, start):
        return torch.from_numpy(queries)[u.long()] @ torch.from_numpy(items[start : start + chunk]).T

    users = np.arange(6, dtype=np.int32)
    want_v, want_i = (np.asarray(a) for a in jax_retrieval.chunked_topk(
        jfn, jnp.asarray(users), v, k, chunk, jnp.asarray(padded), jnp.asarray(counts)))
    got_v, got_i = retrieval.chunked_topk(tfn, torch.from_numpy(users), v, k, chunk,
                                          torch.from_numpy(padded), torch.from_numpy(counts))
    assert got_i.dtype == torch.int32 and got_v.shape == got_i.shape == (6, k)
    np.testing.assert_allclose(got_v.numpy(), want_v, rtol=FWD_RTOL, atol=FWD_ATOL)
    clear = _clear(want_v)
    np.testing.assert_array_equal(got_i.numpy()[clear], want_i[clear])
    # Masked slots are the sentinel in both (none where k fits every row).
    np.testing.assert_array_equal(got_i.numpy() == v, want_i == v)
    assert (want_i == v).any() == (k > 41)


@pytest.mark.parametrize("user_batch", [16, 7])
def test_retrieval_evaluator_matches_jax(user_batch):
    """Fixed scores [U, V] for both evaluators, so the metrics depend only on
    the masking, the top-k and the sums: every user with test items, in
    batches of 16 or 7 (a final partial batch either way)."""
    ours, ref = _datasets()
    scores = np.random.default_rng(12).normal(size=(ours.num_users, ours.num_items)).astype(np.float32)
    ks = (1, 5, 20)
    ev = retrieval.RetrievalEvaluator(lambda p, u: torch.from_numpy(scores)[u.long()].clone(), ours, ks,
                                      user_batch=user_batch, device="cpu")
    assert len(ev.users_with_test) % user_batch != 0
    got = ev(None)
    want = jax_retrieval.RetrievalEvaluator(lambda p, u: jnp.asarray(scores)[u], ref, ks,
                                            user_batch=user_batch)(None)
    assert list(got) == sorted(want) and len(got) == 15
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=METRIC_ATOL, err_msg=key)
    assert retrieval.evaluate_retrieval(lambda p, u: torch.from_numpy(scores)[u.long()].clone(), None, ours,
                                        ks, user_batch, device="cpu") == got


# ---- the train step ----

def _builders(loss, l2_reg=0.03, device_negatives=False):
    optim = dict(learning_rate=0.1, dense_optimizer="adagrad", sparse_optimizer="rowwise_adagrad")
    jmodel = JaxMF(JaxDataSpec.interaction(NUM_USERS, NUM_ITEMS), DIM)
    jb = jax_step.TrainStepBuilder(jmodel, loss, JaxOptimConfig(**optim), l2_reg=l2_reg,
                                   device_negatives=device_negatives, num_items=NUM_ITEMS)
    model = build_model(ModelConfig(name="mf", embed_dim=DIM), DataSpec.interaction(NUM_USERS, NUM_ITEMS))
    builder = TrainStepBuilder(model, loss, OptimConfig(**optim), l2_reg=l2_reg, device="cpu",
                               device_negatives=device_negatives, num_items=NUM_ITEMS)
    return jb, builder


def _pair_batches(loss, steps=3):
    """Batches from the JAX pairwise sampler over a small dataset, as the
    trainer makes them for ``loss``."""
    ref = _datasets()[1]
    sampler = jax_samplers.PairwiseSampler(
        ref, 96, num_negatives=4 if loss == "sampled_softmax" else 1, seed=2,
        multi_neg=loss == "sampled_softmax", no_negatives=loss == "in_batch_softmax")
    batches = list(sampler.epoch(0))[:steps]
    assert len(batches) == steps
    return batches


@pytest.mark.parametrize("loss", ["bpr", "hinge", "sampled_softmax", "in_batch_softmax"])
def test_three_mf_train_steps_match_jax(loss):
    """MF at config 1's l2_reg (0.03: the gathered rows of all three tables,
    pos and neg, over the batch size) with dense Adagrad on an empty dense
    tree and rowwise Adagrad at lr 0.1, three steps from JAX's state."""
    jb, builder = _builders(loss)
    jstate = jb.init_state(jax.random.PRNGKey(0))
    state = train_state_from_jax(jax.tree_util.tree_map(np.asarray, jstate), builder.model)
    assert state["dense"] == {} and state["dense_opt"] == {"count": 0, "sum_of_squares": {}}
    assert not state["tables"]["item_bias"].any()
    jstep = jax.jit(jb.step)
    for batch in _pair_batches(loss):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, m = builder.step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=STEP_LOSS_RTOL)
    assert state["step"] == int(jstate["step"]) == 3 and state["dense_opt"]["count"] == 3
    for name in jstate["tables"]:
        np.testing.assert_allclose(state["tables"][name].numpy(), np.asarray(jstate["tables"][name]),
                                   rtol=0, atol=STEP_TABLE_ATOL, err_msg=name)
        # Mean squares of gradients: a gradient that sums terms of both signs
        # keeps its absolute rounding, so the tolerance is relative to the
        # table's largest accumulator.
        want_acc = np.asarray(jstate["sparse_opt"][name]["acc"])
        np.testing.assert_allclose(state["sparse_opt"][name]["acc"].numpy(), want_acc, rtol=1e-5,
                                   atol=1e-5 * np.abs(want_acc).max(), err_msg=name)
    assert state["tables"]["item_bias"].any()  # the bias trains


def test_device_negatives_draw_in_range_repeat_and_match_jax_when_injected():
    jb, builder = _builders("bpr", device_negatives=True)
    jstate = jb.init_state(jax.random.PRNGKey(0))
    start = train_state_from_jax(jax.tree_util.tree_map(np.asarray, jstate), builder.model)
    batch = {k: torch.from_numpy(v) for k, v in _pair_batches("in_batch_softmax", 1)[0].items()}
    gen = builder._generator(5)
    drawn = builder._draw_negatives(batch, gen)["neg"]
    again = builder._draw_negatives(batch, builder._generator(5))["neg"]
    other = builder._draw_negatives(batch, builder._generator(6))["neg"]
    assert drawn.dtype == torch.int32 and drawn.shape == batch["pos"].shape
    assert 0 <= int(drawn.min()) and int(drawn.max()) < NUM_ITEMS
    assert torch.equal(drawn, again) and not torch.equal(drawn, other)
    big = builder._draw_negatives({"pos": torch.zeros(20_000, dtype=torch.int32)}, builder._generator(0))
    assert set(big["neg"].unique().tolist()) == set(range(NUM_ITEMS))  # every item can be drawn
    # A step draws them and repeats; batches with negatives pass unchanged.
    one, m1 = builder.step(dict(start), batch)
    assert one["step"] == 1 and np.isfinite(m1["loss"].item())
    with_neg = {**batch, "neg": drawn}
    assert builder._draw_negatives(with_neg, gen) is with_neg
    # The negatives injected: the step is JAX's step on the same batch.
    jstate, jm = jax.jit(jb.step)(jstate, {k: jnp.asarray(v.numpy()) for k, v in with_neg.items()})
    state = train_state_from_jax(jax.tree_util.tree_map(np.asarray, jb.init_state(jax.random.PRNGKey(0))),
                                 builder.model)
    state, m = builder.step(state, with_neg)
    np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=STEP_LOSS_RTOL)
    for name in jstate["tables"]:
        np.testing.assert_allclose(state["tables"][name].numpy(), np.asarray(jstate["tables"][name]),
                                   rtol=0, atol=STEP_TABLE_ATOL, err_msg=name)


@pytest.mark.parametrize("loss", ["logloss", "sampled_softmax", "in_batch_softmax"])
def test_device_negatives_refuse_other_losses_as_the_reference(loss):
    with pytest.raises(ValueError, match="bpr/hinge") as ours:
        _builders(loss, device_negatives=True)
    model = JaxMF(JaxDataSpec.interaction(4, 4), 2)
    with pytest.raises(ValueError) as ref:
        jax_step.TrainStepBuilder(model, loss, JaxOptimConfig(), device_negatives=True)
    assert str(ours.value) == str(ref.value)


# ---- serving ----

def _recommenders():
    jmodel, np_params, model, params = _mf_pair()
    ours, ref = _datasets()
    jrec = JaxRecommender(jmodel, jax.tree_util.tree_map(jnp.asarray, np_params), dataset=ref,
                          topk_method="exact")
    rec = Recommender(model, params, dataset=ours, device="cpu")
    return jrec, rec


def test_recommender_predict_and_score_catalog_match_jax():
    jrec, rec = _recommenders()
    rng = np.random.default_rng(13)
    users = rng.integers(0, NUM_USERS, 40).astype(np.int32)
    items = rng.integers(0, NUM_ITEMS, 40).astype(np.int32)
    users[:2], items[2:4] = [-3, NUM_USERS + 5], [-1, NUM_ITEMS]  # clamp, as mode="clip"
    got, want = rec.predict(users, items), jrec.predict(users, items)
    assert got.dtype == np.float32 and got.shape == (40,)
    np.testing.assert_allclose(got, want, rtol=FWD_RTOL, atol=FWD_ATOL)
    in_range = users[2:]
    np.testing.assert_allclose(rec.score_catalog(in_range), jrec.score_catalog(in_range),
                               rtol=FWD_RTOL, atol=FWD_ATOL)


@pytest.mark.parametrize("exclude_train", [True, False])
def test_recommender_recommend_matches_jax(exclude_train):
    jrec, rec = _recommenders()
    users = np.array([0, 3, 3, 17, NUM_USERS - 1], np.int32)
    k = 12
    got_ids, got_vals = rec.recommend(users, k, exclude_train=exclude_train)
    want_ids, want_vals = jrec.recommend(users, k, exclude_train=exclude_train)
    assert got_ids.dtype == np.int32 and got_ids.shape == got_vals.shape == (5, k)
    np.testing.assert_allclose(got_vals, want_vals, rtol=FWD_RTOL, atol=FWD_ATOL)
    clear = _clear(want_vals)  # two products' scores differ in the last bits
    assert clear.mean() > 0.5
    np.testing.assert_array_equal(got_ids[clear], want_ids[clear])
    train = rec.dataset.train_csr
    seen = 0
    for r, u in enumerate(users):
        excluded = set(train.indices[train.indptr[u] : train.indptr[u + 1]].tolist())
        seen += len(excluded & set(got_ids[r].tolist()))
    assert (seen == 0) == exclude_train


def test_recommender_from_trainer_and_refusals():
    jrec, rec = _recommenders()
    assert rec.topk_method == "approx" and rec._num_items() == NUM_ITEMS

    class FakeTrainer:
        model, params, dataset, device = rec.model, rec.params, rec.dataset, torch.device("cpu")

    served = Recommender.from_trainer(FakeTrainer)
    assert served.dataset is rec.dataset and served.device.type == "cpu"
    np.testing.assert_array_equal(served.recommend([1, 2], 5)[0], rec.recommend([1, 2], 5)[0])
    no_data = Recommender(rec.model, rec.params, device="cpu")
    assert no_data._num_items() == NUM_ITEMS and no_data._train_exclusions([1]) == (None, None)
    quant = Recommender(rec.model, rec.params, dataset=rec.dataset, device="cpu", quantize=True)
    assert quant._quant.values.dtype == torch.int8
    np.testing.assert_array_equal(quant.recommend([1, 2], 5)[0], rec.recommend([1, 2], 5)[0])
    for kw in ({"mesh": object()}, {"state": {}}):  # a live sharded state needs its layout
        with pytest.raises(ValueError, match="takes mesh=, state= and the builder="):
            Recommender(rec.model, rec.params, device="cpu", **kw)
    with pytest.raises(ValueError, match="topk method"):
        Recommender(rec.model, rec.params, device="cpu", topk_method="nope")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Recommender(rec.model, rec.params)
