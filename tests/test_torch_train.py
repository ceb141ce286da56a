"""The port's training slice against the JAX package, on the CPU.

Inputs are made with numpy from seeds and go through the JAX function and
its counterpart in the port. On CPU tensors the port's kernel wrappers take
their plain versions (the CUDA kernels are held against those on the card
by tests/test_torch_cuda.py and chip_smoke.py); the JAX Pallas kernels run
in interpret mode, as tests/test_kernels.py runs them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tfrec_tpu.configs import ModelConfig as JaxModelConfig
from tfrec_tpu.configs import OptimConfig as JaxOptimConfig
from tfrec_tpu.data.synthetic import synthetic_ctr as jax_synthetic_ctr
from tfrec_tpu.kernels.cross_pallas import cross_stack_pallas
from tfrec_tpu.kernels.scatter_pallas import fused_rowwise_adagrad as jax_fused_adagrad
from tfrec_tpu.models import DataSpec as JaxDataSpec
from tfrec_tpu.models import build_model as jax_build_model
from tfrec_tpu.ops.embedding import combine_duplicate_ids as jax_combine
from tfrec_tpu.ops.sparse_optim import make_sparse_optimizer as jax_sparse_optimizer
from tfrec_tpu.train import losses as jax_losses
from tfrec_tpu.train import step as jax_step
from tfrec_tpu_torch.configs import ModelConfig, OptimConfig
from tfrec_tpu_torch.convert import train_state_from_jax
from tfrec_tpu_torch.data.synthetic import synthetic_ctr
from tfrec_tpu_torch.kernels.adagrad_cuda import (
    fused_rowwise_adagrad,
    fused_rowwise_adagrad_multi,
    fused_rowwise_adagrad_multi_ref,
    fused_rowwise_adagrad_ref,
)
from tfrec_tpu_torch.kernels.cross import cross_stack
from tfrec_tpu_torch.kernels.cross_cuda import (
    cross_v1_bwd,
    cross_v1_bwd_ref,
    cross_v1_fwd,
    cross_v1_fwd_ref,
)
from tfrec_tpu_torch.models import DataSpec, build_model
from tfrec_tpu_torch.models.layers import apply_mlp
from tfrec_tpu_torch.ops.embedding import combine_duplicate_ids, gather
from tfrec_tpu_torch.ops.sparse_optim import make_sparse_optimizer
from tfrec_tpu_torch.train import losses
from tfrec_tpu_torch.train.step import (
    TrainStepBuilder,
    apply_updates,
    copy_state,
    host_dedup_sorts,
    make_dense_tx,
    make_schedule,
    tree_leaves,
)

torch.set_num_threads(1)

VOCABS = (37, 52, 45, 60)
WIDTHS = (1, 1, 3, 1)  # field 2 is a multi-hot bag, sentinel-padded
NUM_DENSE = 3
BATCH = 64
# The JAX package's own xla-versus-pallas step test holds three steps of
# two implementations of the same arithmetic to this tolerance
# (tests/test_kernels.py:185-191): sums in another order, through Adam and
# Adagrad's normalised updates, over three steps.
STEP_RTOL, STEP_ATOL = 1e-4, 1e-5


def _normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _ids(seed, vocab, n):
    """Duplicates, negatives and sentinels (== vocab and beyond)."""
    rng = np.random.default_rng(seed)
    fixed = np.array([3, 3, 3, 0, vocab - 1, vocab, vocab, vocab + 2, -1, -4, 7, 7], np.int32)
    return np.concatenate([fixed, rng.integers(-2, vocab + 2, n - fixed.size)]).astype(np.int32)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# ---- ops/embedding.combine_duplicate_ids ----

@pytest.mark.parametrize("vocab,n,dim", [(20, 40, 8), (300, 96, 5)])
def test_combine_duplicate_ids_matches_jax(vocab, n, dim):
    ids = _ids(vocab, vocab, n)
    grads = _normal(n, (n, dim))
    want_u, want_g = jax_combine(jnp.asarray(ids), jnp.asarray(grads), sentinel=vocab)
    got_u, got_g = combine_duplicate_ids(torch.from_numpy(ids), torch.from_numpy(grads), vocab)
    assert got_u.dtype == torch.int32 and got_u.shape == (n,) and got_g.shape == (n, dim)
    np.testing.assert_array_equal(got_u.numpy(), np.asarray(want_u))
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=1e-6, atol=1e-6)
    # The real ids lead, ascending, each once (ids past the sentinel form
    # segments of their own, before the sentinel tail).
    u = got_u.numpy()
    real = u[u < vocab]
    assert (u[: real.size] == real).all() and (np.diff(real) > 0).all()


# ---- kernels/adagrad_cuda ----

def test_fused_rowwise_adagrad_ref_matches_jax_kernel_and_apply():
    rng = np.random.default_rng(0)
    vocab, dim, n = 40, 16, 24
    table = rng.normal(size=(vocab, dim)).astype(np.float32)
    ids = _ids(1, vocab, n)
    grads = rng.normal(size=(n, dim)).astype(np.float32)
    jopt = jax_sparse_optimizer("rowwise_adagrad", adagrad_init=0.05)
    jstate = jopt.init(jnp.asarray(table))
    want_table, want_state = jopt.apply(jnp.asarray(table), jstate, jnp.asarray(ids),
                                        jnp.asarray(grads), 0.1)
    juids, jg = jax_combine(jnp.asarray(ids), jnp.asarray(grads), sentinel=vocab)
    kern_table, kern_acc = jax.jit(lambda t, a, u, g: jax_fused_adagrad(t, a, u, g, 0.1))(
        jnp.asarray(table), jstate["acc"], juids, jg)

    uids, g = combine_duplicate_ids(torch.from_numpy(ids), torch.from_numpy(grads), vocab)
    t = torch.from_numpy(table.copy())
    acc = torch.full((vocab,), 0.05)
    got_t, got_acc = fused_rowwise_adagrad_ref(t, acc, uids, g, 0.1)
    assert got_t is t and got_acc is acc  # in place
    for want_t, want_a in ((want_table, want_state["acc"]), (kern_table, kern_acc)):
        np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got_acc.numpy(), np.asarray(want_a), rtol=1e-5)
    # Rows no real id touched (incl. row 0, which only negative ids name
    # here if at all, and the rows past the ids) are unchanged.
    touched = np.unique(ids[(ids >= 0) & (ids < vocab)])
    untouched = np.setdiff1d(np.arange(vocab), touched)
    np.testing.assert_array_equal(got_t.numpy()[untouched], table[untouched])
    # The wrapper takes the plain version for CPU tensors and counts nothing.
    before = fused_rowwise_adagrad.launches
    t2, a2 = torch.from_numpy(table.copy()), torch.full((vocab,), 0.05)
    fused_rowwise_adagrad(t2, a2, uids, g, 0.1)
    assert fused_rowwise_adagrad.launches == before
    assert torch.equal(t2, got_t) and torch.equal(a2, got_acc)


def test_fused_rowwise_adagrad_contract():
    table, acc = torch.zeros((6, 4)), torch.zeros(6)
    uids, g = torch.tensor([0, 6], dtype=torch.int32), torch.ones((2, 4))
    with pytest.raises(TypeError, match="int32"):
        fused_rowwise_adagrad(table, acc, uids.long(), g, 0.1)
    with pytest.raises(TypeError, match=r"acc must be \[6\]"):
        fused_rowwise_adagrad(table, acc[:5], uids, g, 0.1)
    with pytest.raises(TypeError, match="grads"):
        fused_rowwise_adagrad(table, acc, uids, g[:, :3], 0.1)
    with pytest.raises(ValueError, match="contiguous"):
        fused_rowwise_adagrad(table, acc, uids, torch.ones((4, 2)).t(), 0.1)
    with pytest.raises(TypeError, match="numbers"):
        fused_rowwise_adagrad(table, acc, uids, g, torch.tensor(0.1))
    with pytest.raises(NotImplementedError, match="cuda or cpu"):
        fused_rowwise_adagrad(table.to("meta"), acc.to("meta"), uids.to("meta"), g.to("meta"), 0.1)


# (vocab, dim, slots) per table: mixed dims; and more tables than one
# launch's descriptor holds (64), of one shape so the jitted JAX kernel
# compiles once.
ADAGRAD_TABLES = {
    "mixed_dims": [(40, 4, 24), (52, 8, 30), (37, 12, 24)],
    "past_one_launch": [(13, 4, 16)] * 70,
}


def _adagrad_inputs(case):
    """Per table: table, acc, and the ids and grads of a batch (numpy)."""
    out = []
    for f, (vocab, dim, n) in enumerate(ADAGRAD_TABLES[case]):
        rng = np.random.default_rng(300 + f)
        out.append((rng.normal(size=(vocab, dim)).astype(np.float32),
                    rng.uniform(0.0, 0.1, vocab).astype(np.float32), _ids(400 + f, vocab, n),
                    rng.normal(size=(n, dim)).astype(np.float32)))
    return out


@pytest.mark.parametrize("case", sorted(ADAGRAD_TABLES))
def test_fused_rowwise_adagrad_multi_ref_matches_jax_kernel_per_table(case):
    inputs = _adagrad_inputs(case)
    jfused = jax.jit(lambda t, a, u, g: jax_fused_adagrad(t, a, u, g, 0.1))
    tables, accs, uids, grads = [], [], [], []
    for table, acc, ids, g in inputs:
        u, c = combine_duplicate_ids(torch.from_numpy(ids), torch.from_numpy(g), table.shape[0])
        tables.append(torch.from_numpy(table.copy()))
        accs.append(torch.from_numpy(acc.copy()))
        uids.append(u)
        grads.append(c)
    wrapped = ([t.clone() for t in tables], [a.clone() for a in accs])
    got_t, got_a = fused_rowwise_adagrad_multi_ref(tables, accs, uids, grads, 0.1)
    assert all(a is b for a, b in zip(got_t + got_a, tables + accs))  # in place
    before = fused_rowwise_adagrad_multi.launches
    fused_rowwise_adagrad_multi(*wrapped, uids, grads, 0.1)  # the plain version on CPU tensors
    assert fused_rowwise_adagrad_multi.launches == before
    for (table, acc, ids, g), t, a, wt, wa in zip(inputs, got_t, got_a, *wrapped):
        juids, jg = jax_combine(jnp.asarray(ids), jnp.asarray(g), sentinel=table.shape[0])
        want_t, want_a = jfused(jnp.asarray(table), jnp.asarray(acc), juids, jg)
        np.testing.assert_allclose(t.numpy(), np.asarray(want_t), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(a.numpy(), np.asarray(want_a), rtol=1e-5)
        assert torch.equal(wt, t) and torch.equal(wa, a)


def test_fused_rowwise_adagrad_multi_contract():
    """Tables of one call share a device, one lr and one eps; no two tables
    or accumulators may share memory (their updates would race on the
    card); empty tables are no-ops. A CPU call launches nothing."""
    t1, a1 = torch.zeros((6, 4)), torch.zeros(6)
    t2, a2 = torch.zeros((5, 3)), torch.zeros(5)
    u1, g1 = torch.tensor([0, 6], dtype=torch.int32), torch.ones((2, 4))
    u2, g2 = torch.tensor([4], dtype=torch.int32), torch.ones((1, 3))
    empty_u, empty_g = torch.zeros(0, dtype=torch.int32), torch.zeros((0, 3))
    before = fused_rowwise_adagrad_multi.launches
    out = fused_rowwise_adagrad_multi([t1, t2], [a1, a2], [u1, empty_u], [g1, empty_g], 0.1)
    assert fused_rowwise_adagrad_multi.launches == before
    assert out[0][0] is t1 and out[1][1] is a2
    assert bool((t1[0] != 0).all()) and a1[0] > 0 and not t1[1:].any()  # slot 1 is a sentinel
    assert not t2.any() and not a2.any()
    assert fused_rowwise_adagrad_multi([], [], [], [], 0.1) == ([], [])
    with pytest.raises(ValueError, match="2 tables, 1 accs"):
        fused_rowwise_adagrad_multi([t1, t2], [a1], [u1, u2], [g1, g2], 0.1)
    with pytest.raises(TypeError, match="int32"):
        fused_rowwise_adagrad_multi([t1, t2], [a1, a2], [u1, u2.long()], [g1, g2], 0.1)
    with pytest.raises(TypeError, match=r"acc must be \[5\]"):
        fused_rowwise_adagrad_multi([t1, t2], [a1, a1], [u1, u2], [g1, g2], 0.1)
    with pytest.raises(TypeError, match="float32"):
        fused_rowwise_adagrad_multi([t1, t2], [a1, a2], [u1, u2], [g1, g2.double()], 0.1)
    with pytest.raises(ValueError, match="contiguous"):
        fused_rowwise_adagrad_multi([t1, t2], [a1, a2], [u1, torch.tensor([1, 2], dtype=torch.int32)],
                                    [g1, torch.ones((3, 2)).t()], 0.1)
    with pytest.raises(ValueError, match="one device"):
        fused_rowwise_adagrad_multi([t1, t2], [a1, a2.to("meta")], [u1, u2], [g1, g2], 0.1)
    with pytest.raises(TypeError, match="numbers"):
        fused_rowwise_adagrad_multi([t1, t2], [a1, a2], [u1, u2], [g1, g2], 0.1, torch.tensor(1e-8))
    with pytest.raises(ValueError, match="share memory"):
        fused_rowwise_adagrad_multi([t1, t1], [a1, a1.clone()], [u1, u1], [g1, g1], 0.1)
    with pytest.raises(ValueError, match="share memory"):  # views that overlap on row 2
        fused_rowwise_adagrad_multi([t1[:3], t1[2:]], [torch.zeros(3), torch.zeros(4)], [u2[:0], u2[:0]],
                                    [g1[:0], g1[:0]], 0.1)
    with pytest.raises(NotImplementedError, match="cuda or cpu"):
        fused_rowwise_adagrad_multi([t.to("meta") for t in (t1, t2)], [a.to("meta") for a in (a1, a2)],
                                    [u.to("meta") for u in (u1, u2)], [g.to("meta") for g in (g1, g2)], 0.1)


# ---- ops/sparse_optim ----

@pytest.mark.parametrize("name", ["sgd", "rowwise_adagrad", "rowwise_adam"])
@pytest.mark.parametrize("deduped", [False, True])
def test_sparse_optimizer_matches_jax(name, deduped):
    vocab, dim, n = 30, 8, 40
    table = _normal(2, (vocab, dim))
    jopt = jax_sparse_optimizer(name, adagrad_init=0.1)
    opt = make_sparse_optimizer(name, adagrad_init=0.1)
    jt, jstate = jnp.asarray(table), jopt.init(jnp.asarray(table))
    t = torch.from_numpy(table.copy())
    state = opt.init(t)
    assert sorted(state) == sorted(jstate)
    for i, lr in enumerate((0.1, 0.05)):  # two updates: the state carries over
        ids, grads = _ids(10 + i, vocab, n), _normal(20 + i, (n, dim))
        if deduped:
            uids, g = jax_combine(jnp.asarray(ids), jnp.asarray(grads), sentinel=vocab)
            jt, jstate = jopt.apply_deduped(jt, jstate, uids, g, lr)
            tu, tg = combine_duplicate_ids(torch.from_numpy(ids), torch.from_numpy(grads), vocab)
            t, state = opt.apply_deduped(t, state, tu, tg, lr)
        else:
            jt, jstate = jopt.apply(jt, jstate, jnp.asarray(ids), jnp.asarray(grads), lr)
            t, state = opt.apply(t, state, torch.from_numpy(ids), torch.from_numpy(grads), lr)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), rtol=1e-5, atol=1e-6)
    for k in jstate:
        np.testing.assert_allclose(state[k].numpy(), np.asarray(jstate[k]), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("name", ["sgd", "rowwise_adagrad", "rowwise_adam"])
def test_apply_deduped_many_is_apply_deduped_table_by_table(name):
    """One call over every table (for rowwise Adagrad one launch on a card)
    gives the bits of ``apply_deduped`` on each table in turn."""
    opt = make_sparse_optimizer(name, adagrad_init=0.1)
    inputs = _adagrad_inputs("mixed_dims")
    deduped = [combine_duplicate_ids(torch.from_numpy(ids), torch.from_numpy(g), table.shape[0])
               for table, _, ids, g in inputs]
    many_t = [torch.from_numpy(table.copy()) for table, *_ in inputs]
    one_t = [t.clone() for t in many_t]
    many_s = [opt.init(t) for t in many_t]
    one_s = [opt.init(t) for t in one_t]
    for lr in (0.1, 0.05):  # twice: the state carries over
        many_t, many_s = opt.apply_deduped_many(many_t, many_s, [u for u, _ in deduped],
                                                [g for _, g in deduped], lr)
        for i, (u, g) in enumerate(deduped):
            one_t[i], one_s[i] = opt.apply_deduped(one_t[i], one_s[i], u, g, lr)
    for a, b, sa, sb in zip(many_t, one_t, many_s, one_s):
        assert torch.equal(a, b) and sorted(sa) == sorted(sb)
        assert all(torch.equal(sa[k], sb[k]) for k in sa)


@pytest.mark.parametrize("name", ["rowwise_adagrad", "rowwise_adam", "sgd"])
def test_sparse_optimizer_refuses_lane_grouped_state(name):
    """Lane-grouped [V, G] state (lane-packed tables) is the reference's,
    and a grouped update is each group's own per-table update; only grouped
    Adam's ``apply_deduped``, which cannot tell the touched groups, refuses
    (its ``apply`` takes the slots); an unknown optimizer is refused."""
    opt, jopt = make_sparse_optimizer(name), jax_sparse_optimizer(name)
    table = _normal(11, (8, 4))
    state = opt.init(torch.from_numpy(table), lane_groups=2)
    want = jopt.init(jnp.asarray(table), lane_groups=2)
    assert {k: tuple(v.shape) for k, v in state.items()} == {k: tuple(v.shape) for k, v in want.items()}
    ids = np.array([1, 2, 2, 5, 8, -1], np.int32)
    grads = _normal(12, (6, 4))
    grads[1, 2:] = 0.0  # id 2 touches group 0 only at this position
    slots = np.array([0, 0, 1, 1, 0, 1], np.int32)
    got_t, got_s = opt.apply(torch.from_numpy(table.copy()), state, torch.from_numpy(ids),
                             torch.from_numpy(grads), 0.1, slots=torch.from_numpy(slots))
    want_t, want_s = jopt.apply(jnp.asarray(table), want, jnp.asarray(ids), jnp.asarray(grads), 0.1,
                                slots=jnp.asarray(slots))
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), rtol=1e-6, atol=1e-7)
    for k in got_s:
        np.testing.assert_allclose(got_s[k].numpy(), np.asarray(want_s[k]), rtol=1e-6, atol=1e-7)
    if name == "rowwise_adam":
        with pytest.raises(ValueError, match="slots"):
            opt.apply_deduped(torch.zeros((8, 4)), opt.init(torch.zeros((8, 4)), lane_groups=2),
                              torch.tensor([1, 2], dtype=torch.int32), torch.ones((2, 4)), 0.1)
        with pytest.raises(ValueError, match="slot"):
            opt.apply(torch.zeros((8, 4)), opt.init(torch.zeros((8, 4)), lane_groups=2),
                      torch.tensor([1, 2], dtype=torch.int32), torch.ones((2, 4)), 0.1)
    with pytest.raises(ValueError, match="unknown sparse optimizer"):
        make_sparse_optimizer("nope")


# ---- kernels/cross_cuda: the backward ----

@pytest.mark.parametrize("batch,dim,layers", [(64, 32, 3), (50, 45, 2)])
def test_cross_v1_bwd_ref_matches_jax_vjp_and_autograd(batch, dim, layers):
    x0, g = _normal(30, (batch, dim)), _normal(31, (batch, dim))
    w, b = _normal(32, (layers, dim), dim**-0.5), _normal(33, (layers, dim), 0.1)
    _, vjp = jax.vjp(cross_stack_pallas, jnp.asarray(x0), {"w": jnp.asarray(w), "b": jnp.asarray(b)})
    jdx0, jparams = vjp(jnp.asarray(g))
    want = (np.asarray(jdx0), np.asarray(jparams["w"]), np.asarray(jparams["b"]))

    tx0, tw, tb, tg = (torch.from_numpy(a) for a in (x0, w, b, g))
    got = cross_v1_bwd_ref(tx0, tw, tb, tg)
    for a, e in zip(got, want):
        np.testing.assert_allclose(a.numpy(), e, rtol=1e-4, atol=1e-5)
    # Torch autograd of the plain forward. dw and db are batch sums taken in
    # another order, so an element that nearly cancels is held to 1e-6 of
    # the largest magnitude rather than to its own.
    leaves = [t.clone().requires_grad_() for t in (tx0, tw, tb)]
    auto = torch.autograd.grad(cross_v1_fwd_ref(*leaves), leaves, tg)
    for a, e in zip(got, auto):
        torch.testing.assert_close(a, e, rtol=1e-5, atol=1e-6 * e.abs().max().item())
    # The wrapper on CPU tensors, given the forward's s, and the autograd
    # Function behind cross_stack, both run the same plain formula.
    out, s = cross_v1_fwd(tx0, tw, tb, want_s=True)
    assert s.shape == (batch, layers)
    before = cross_v1_bwd.launches
    for a, e in zip(cross_v1_bwd(tx0, tw, tb, s, tg), got):
        torch.testing.assert_close(a, e, rtol=1e-6, atol=1e-6)
    assert cross_v1_bwd.launches == before
    leaves = [t.clone().requires_grad_() for t in (tx0, tw, tb)]
    y = cross_stack(leaves[0], {"w": leaves[1], "b": leaves[2]})
    torch.testing.assert_close(y, out)
    for a, e in zip(torch.autograd.grad(y, leaves, tg), got):
        torch.testing.assert_close(a, e, rtol=1e-6, atol=1e-6)


def _cross_v1_bwd_regrouped(x0, w, b, s, g):
    """The backward kernel's arithmetic (csrc/cross.cu), in float32: with
    c_l = 1 + sum_{m<l} s_m and B_l = sum_{m<l} b_m (x_l = x0 c_l + B_l), a
    row needs q = x0 . g and p_m = x0 . w_m; ds_{L-1} = q, ds_l = q +
    sum_{m>l} ds_m p_m; dx0 = g c_L + sum_m (c_m ds_m) w_m; dw_l = sum_batch
    x0 c_l ds_l + B_l sum_batch ds_l; db_l = sum_batch g + sum_{m>l}
    (sum_batch ds_m) w_m. Blocks of 16 contiguous rows each finish a dw and
    db partial, summed in order; the dots and dx0 are matmuls. So this
    checks the regrouped algebra in float32, not the kernel's own rounding
    (its strided rows a block and fixed fmaf chains): the card tests check
    that against the plain version."""
    layers = w.shape[0]
    dots = torch.cat([(x0 * g).sum(1, keepdim=True), x0 @ w[1:].T], dim=1)  # q, p_1..p_{L-1}
    ds = [None] * layers
    ds[-1] = dots[:, 0]
    run = torch.zeros_like(dots[:, 0])
    for l in range(layers - 2, -1, -1):
        run = ds[l + 1] * dots[:, l + 1] + run
        ds[l] = dots[:, 0] + run
    ds = torch.stack(ds, dim=1)
    c = torch.cumsum(torch.cat([torch.ones_like(s[:, :1]), s], dim=1), dim=1)  # c_0 .. c_L
    e = c[:, :layers] * ds
    dx0 = g * c[:, layers:] + e @ w
    bsum = torch.cumsum(torch.cat([torch.zeros_like(b[:1]), b[:-1]]), dim=0)  # B_l
    dw = torch.zeros_like(w)
    db = torch.zeros_like(b)
    for rows in torch.arange(x0.shape[0]).split(16):  # blocks of 16 rows
        dsum = ds[rows].sum(0)
        dw += e[rows].T @ x0[rows] + bsum * dsum[:, None]
        part = g[rows].sum(0)
        for l in range(layers - 1, -1, -1):
            db[l] += part
            part = part + dsum[l] * w[l]
    return dx0, dw, db


# The flagship's width; L = 1, where the recurrence is empty; and L = 40 at
# an odd width, past the 227 KB of [2, L, d] sums the old kernel kept.
@pytest.mark.parametrize("batch,dim,layers", [(64, 845, 3), (50, 45, 1), (33, 61, 40)])
def test_cross_v1_bwd_regrouped_matches_jax_vjp_and_the_plain_version(batch, dim, layers):
    """The regrouped formulas of the backward kernel, replayed in float32,
    against the reference's VJP (Pallas, interpret mode) and the plain
    version, at the kernel's tolerance on the card: sums regrouped in f32,
    so the absolute tolerance is relative to the largest value."""
    x0, g = _normal(36, (batch, dim)), _normal(37, (batch, dim))
    w, b = _normal(38, (layers, dim), dim**-0.5), _normal(39, (layers, dim), 0.1)
    _, vjp = jax.vjp(cross_stack_pallas, jnp.asarray(x0), {"w": jnp.asarray(w), "b": jnp.asarray(b)})
    jdx0, jparams = vjp(jnp.asarray(g))
    want_jax = (np.asarray(jdx0), np.asarray(jparams["w"]), np.asarray(jparams["b"]))
    tx0, tw, tb, tg = (torch.from_numpy(a) for a in (x0, w, b, g))
    _, s = cross_v1_fwd_ref(tx0, tw, tb, want_s=True)
    got = _cross_v1_bwd_regrouped(tx0, tw, tb, s, tg)
    for a, e, p in zip(got, cross_v1_bwd_ref(tx0, tw, tb, tg, s), want_jax):
        torch.testing.assert_close(a, e, rtol=1e-5, atol=1e-5 * e.abs().max().item())
        np.testing.assert_allclose(a.numpy(), p, rtol=1e-5, atol=1e-5 * np.abs(p).max())


def test_cross_v1_bwd_contract():
    x0, w = torch.from_numpy(_normal(34, (5, 6))), torch.from_numpy(_normal(35, (2, 6)))
    s = torch.zeros((5, 2))
    with pytest.raises(ValueError, match=r"s \[5, 2\]"):
        cross_v1_bwd(x0, w, w, s[:, :1].contiguous(), x0)
    with pytest.raises(TypeError, match="float32"):
        cross_v1_bwd(x0, w, w, s, x0.double())
    with pytest.raises(NotImplementedError, match="cuda or cpu"):
        cross_v1_bwd(*(t.to("meta") for t in (x0, w, w, s, x0)))


# ---- train/losses, the schedule and the dense transforms ----

def test_logloss_matches_jax_and_unported_losses_are_refused():
    logits = _normal(40, (33,), 4.0)
    labels = (np.random.default_rng(41).random(33) < 0.5).astype(np.float32)
    want = jax_losses.logloss(jnp.asarray(logits), {"label": jnp.asarray(labels)})
    got = losses.make_loss("logloss")(torch.from_numpy(logits), {"label": torch.from_numpy(labels)})
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    assert losses.make_loss("sbpr") is losses.sbpr  # the long tail's losses are ported
    with pytest.raises(ValueError, match="unknown loss"):
        losses.make_loss("nope")


@pytest.mark.parametrize("kw", [
    {},
    {"warmup_steps": 3},
    {"lr_schedule": "cosine", "decay_steps": 7},
    {"lr_schedule": "linear", "decay_steps": 5, "warmup_steps": 2},
])
def test_make_schedule_matches_jax(kw):
    want = jax_step.make_schedule(JaxOptimConfig(**kw), 0.3)
    got = make_schedule(OptimConfig(**kw), 0.3)
    for step in range(10):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6)


def test_make_schedule_refuses_bad_shapes():
    with pytest.raises(ValueError, match="unknown lr_schedule"):
        make_schedule(OptimConfig(lr_schedule="step", warmup_steps=1), 0.1)
    with pytest.raises(ValueError, match="decay_steps"):
        make_schedule(OptimConfig(lr_schedule="cosine"), 0.1)


@pytest.mark.parametrize("opt", ["adam", "adagrad", "sgd"])
@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_dense_tx_matches_optax(opt, weight_decay):
    kw = dict(dense_optimizer=opt, learning_rate=0.05, weight_decay=weight_decay,
              adagrad_init=0.1, lr_schedule="cosine", decay_steps=4)
    jtx = jax_step.make_dense_tx(JaxOptimConfig(**kw))
    tx = make_dense_tx(OptimConfig(**kw))
    params = {"a": _normal(50, (4, 3)), "mlp": [(_normal(51, (3, 2)), _normal(52, (2,)))]}
    jp = jax.tree.map(jnp.asarray, params)
    tp = jax.tree.map(torch.from_numpy, params)
    jstate, state = jtx.init(jp), tx.init(tp)
    for i in range(3):  # the same gradients three times: the state carries over
        grads = {"a": _normal(60 + i, (4, 3)), "mlp": [(_normal(70 + i, (3, 2)), _normal(80 + i, (2,)))]}
        ju, jstate = jtx.update(jax.tree.map(jnp.asarray, grads), jstate, jp)
        jp = optax.apply_updates(jp, ju)
        u, state = tx.update(jax.tree.map(torch.from_numpy, grads), state, tp)
        tp = apply_updates(tp, u)
    for a, e in zip(tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(e), rtol=1e-5, atol=1e-7)
    assert state["count"] == 3


# ---- train/step: three steps against JAX ----

def _batches(seed, steps):
    dense, cat, label = synthetic_ctr(BATCH * steps, NUM_DENSE, VOCABS, seed=seed,
                                      field_widths=WIDTHS)
    cat[:2, 2:5] = VOCABS[2]  # whole bags of padding
    cat[2, 0] = -1            # a negative id in a single-hot field
    return [(dense[i * BATCH:(i + 1) * BATCH], cat[i * BATCH:(i + 1) * BATCH],
             label[i * BATCH:(i + 1) * BATCH]) for i in range(steps)]


# model name -> cross_rank: DCN-v1, and low-rank DCN-v2 (its cross through
# cross_stack_pallas_v2 in JAX with kernels="pallas", CrossV2 in the port).
RANKS = {"dcn": 0, "dcnv2": 4}


def _jax_builder(kernels, l2_reg, optim, name="dcn"):
    jmodel = jax_build_model(
        JaxModelConfig(name=name, embed_dim=8, num_cross_layers=2, mlp_dims=(16, 8),
                       cross_rank=RANKS[name], lane_pack=False),
        JaxDataSpec.ctr(VOCABS, NUM_DENSE, WIDTHS), backend=kernels)
    return jax_step.TrainStepBuilder(jmodel, "logloss", JaxOptimConfig(**optim),
                                     l2_reg=l2_reg, kernels=kernels)


def _port_builder(l2_reg, optim, name="dcn"):
    model = build_model(ModelConfig(name=name, embed_dim=8, num_cross_layers=2, mlp_dims=(16, 8),
                                    cross_rank=RANKS[name]),
                        DataSpec.ctr(VOCABS, NUM_DENSE, WIDTHS))
    return TrainStepBuilder(model, "logloss", OptimConfig(**optim), l2_reg=l2_reg, device="cpu")


OPTIM = dict(learning_rate=0.01, dense_optimizer="adam", sparse_optimizer="rowwise_adagrad",
             sparse_learning_rate=0.05)


@pytest.mark.parametrize("name", sorted(RANKS))
@pytest.mark.parametrize("kernels", ["xla", "pallas"])
@pytest.mark.parametrize("l2_reg", [0.0, 1e-3])
def test_three_train_steps_match_jax(kernels, l2_reg, name):
    """DCN-v1 and low-rank DCN-v2, dense Adam plus rowwise Adagrad: the port
    (plain versions) against the JAX step with kernels="xla" and with
    kernels="pallas" (model backend "pallas", interpret mode), from the same
    JAX state."""
    jb = _jax_builder(kernels, l2_reg, OPTIM, name)
    jstate = jb.init_state(jax.random.PRNGKey(0))
    builder = _port_builder(l2_reg, OPTIM, name)
    if name == "dcnv2":
        assert set(jstate["dense"]["cross"]) == {"u", "v", "b"}
    state = train_state_from_jax(_np(jstate), builder.model)
    jstep = jax.jit(jb.step)
    for dense, cat, label in _batches(1, 3):
        jstate, jm = jstep(jstate, {"dense": jnp.asarray(dense), "cat": jnp.asarray(cat),
                                    "label": jnp.asarray(label)})
        state, m = builder.step(state, {"dense": torch.from_numpy(dense),
                                        "cat": torch.from_numpy(cat),
                                        "label": torch.from_numpy(label)})
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=STEP_RTOL)
    assert state["step"] == int(jstate["step"]) == 3
    for name in jstate["tables"]:
        np.testing.assert_allclose(state["tables"][name].numpy(), np.asarray(jstate["tables"][name]),
                                   rtol=STEP_RTOL, atol=STEP_ATOL)
        np.testing.assert_allclose(state["sparse_opt"][name]["acc"].numpy(),
                                   np.asarray(jstate["sparse_opt"][name]["acc"]),
                                   rtol=STEP_RTOL, atol=STEP_ATOL)
    _assert_dense_close(state["dense"], _np(jstate["dense"]))


def _assert_dense_close(got, want):
    if isinstance(got, dict):
        assert set(got) == set(want)
        for k in got:
            _assert_dense_close(got[k], want[k])
    elif isinstance(got, (list, tuple)):
        assert len(got) == len(want)
        for a, e in zip(got, want):
            _assert_dense_close(a, e)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=STEP_RTOL, atol=STEP_ATOL)


def test_multi_step_is_k_steps_and_train_state_round_trips():
    """train_state_from_jax carries a JAX state (after a JAX step) over
    exactly; multi_step over [K] batches equals K single steps."""
    jb = _jax_builder("xla", 0.0, OPTIM)
    jstate = jb.init_state(jax.random.PRNGKey(1))
    dense, cat, label = _batches(2, 1)[0]
    jstate, _ = jax.jit(jb.step)(jstate, {"dense": jnp.asarray(dense), "cat": jnp.asarray(cat),
                                          "label": jnp.asarray(label)})
    np_state = _np(jstate)
    builder = _port_builder(0.0, OPTIM)
    state = train_state_from_jax(np_state, builder.model)
    assert state["step"] == 1 and state["dense_opt"]["count"] == 1
    for name in np_state["tables"]:
        np.testing.assert_array_equal(state["tables"][name].numpy(), np_state["tables"][name])
        np.testing.assert_array_equal(state["sparse_opt"][name]["acc"].numpy(),
                                      np_state["sparse_opt"][name]["acc"])
    adam = np_state["dense_opt"][0]
    for key in ("mu", "nu"):
        _assert_dense_close(state["dense_opt"][key], getattr(adam, key))
    np.testing.assert_array_equal(state["dense"]["cross"]["w"].numpy(), np_state["dense"]["cross"]["w"])

    batches = _batches(3, 3)
    stacked = {k: torch.from_numpy(np.stack([b[i] for b in batches]))
               for i, k in enumerate(("dense", "cat", "label"))}
    one = copy_state(state)
    losses_one = []
    for dense, cat, label in batches:
        one, m = builder.step(one, {"dense": torch.from_numpy(dense), "cat": torch.from_numpy(cat),
                                    "label": torch.from_numpy(label)})
        losses_one.append(m["loss"])
    multi, out = builder.multi_step(state, stacked)
    assert multi["step"] == one["step"] == 4
    assert torch.equal(out["loss"], losses_one[-1])
    assert torch.equal(out["loss_mean"], torch.stack(losses_one).mean())
    for a, e in zip(tree_leaves(multi), tree_leaves(one)):
        assert torch.equal(a, e) if isinstance(a, torch.Tensor) else a == e


def test_lookup_rows_share_one_buffer_and_each_gets_its_own_gradient():
    """The gathered rows of every table are views of one allocation and
    autograd leaves: the gradients equal those through separately gathered
    rows, one per table."""

    class PerTableLookup(TrainStepBuilder):
        def lookup(self, tables, ids):
            return {name: gather(tables[name], i) for name, i in ids.items()}, {}

    builder = _port_builder(1e-3, OPTIM)
    model = builder.model
    state = builder.init_state(torch.Generator().manual_seed(0))
    dense, cat, label = _batches(5, 1)[0]
    batch = {"dense": torch.from_numpy(dense), "cat": torch.from_numpy(cat),
             "label": torch.from_numpy(label)}
    ids = model.lookup_ids(batch)
    rows, _ = builder.lookup(state["tables"], ids)
    assert len({r.untyped_storage().data_ptr() for r in rows.values()}) == 1
    loss, dense_grad, row_grads, _ = builder.loss_and_grads(state, batch)
    per_table = PerTableLookup(model, "logloss", OptimConfig(**OPTIM), l2_reg=1e-3, device="cpu")
    want_loss, want_dense, want_rows, _ = per_table.loss_and_grads(state, batch)
    assert list(row_grads) == list(ids) and torch.equal(loss, want_loss)
    for name in ids:
        assert row_grads[name].shape == rows[name].shape
        assert torch.equal(row_grads[name], want_rows[name])
    for a, b in zip(tree_leaves(dense_grad), tree_leaves(want_dense)):
        assert torch.equal(a, b)


def test_sparse_update_is_one_call_for_all_tables_unless_per_table_seams_are_overridden():
    """The default step combines the duplicates (same-shaped tables in one
    batched sort), then makes one ``sparse_update_deduped_all`` call; a subclass that overrides
    ``sparse_update_deduped`` (or ``sparse_update``) is called table by
    table instead, with the same result, bit for bit."""
    calls = []

    class AllAtOnce(TrainStepBuilder):
        def sparse_update_deduped_all(self, tables, opt_states, uids, grads, lr):
            calls.append(list(uids))
            return super().sparse_update_deduped_all(tables, opt_states, uids, grads, lr)

    class TableByTable(TrainStepBuilder):
        def sparse_update_deduped(self, name, table, opt_state, uids, g, lr):
            calls.append(name)
            return super().sparse_update_deduped(name, table, opt_state, uids, g, lr)

    model = _port_builder(0.0, OPTIM).model
    builders = [cls(model, "logloss", OptimConfig(**OPTIM), device="cpu") for cls in (AllAtOnce, TableByTable)]
    state = builders[0].init_state(torch.Generator().manual_seed(0))
    dense, cat, label = _batches(6, 1)[0]
    batch = {"dense": torch.from_numpy(dense), "cat": torch.from_numpy(cat),
             "label": torch.from_numpy(label)}
    names = list(model.lookup_ids(batch))
    one, _ = builders[0].step(copy_state(state), batch)
    assert calls == [names]
    calls.clear()
    two, _ = builders[1].step(copy_state(state), batch)
    assert calls == names
    for a, b in zip(tree_leaves(one), tree_leaves(two)):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b


def test_synthetic_ctr_matches_the_reference():
    for kw in ({}, {"vocab_sizes": VOCABS, "num_dense": NUM_DENSE, "field_widths": WIDTHS}):
        got = synthetic_ctr(500, seed=7, **kw)
        want = jax_synthetic_ctr(500, seed=7, **kw)
        for a, e in zip(got, want):
            assert a.dtype == e.dtype
            np.testing.assert_array_equal(a, e)


def test_dropout_zero_is_no_dropout_and_half_keeps_half_scaled_by_two():
    gen = torch.Generator().manual_seed(0)
    params = [(torch.eye(4000), torch.zeros(4000))]
    x = torch.ones((2, 4000))
    plain = apply_mlp(params, x, final_linear=False)
    assert torch.equal(apply_mlp(params, x, final_linear=False, dropout=0.0, generator=gen), plain)
    assert torch.equal(apply_mlp(params, x, final_linear=False, dropout=0.5), plain)  # no generator
    dropped = apply_mlp(params, x, final_linear=False, dropout=0.5, generator=gen)
    kept = dropped != 0
    assert set(dropped[kept].tolist()) == {2.0}
    assert abs(kept.float().mean().item() - 0.5) < 0.02
    # The model passes its config's dropout through, and a training step
    # with dropout > 0 draws a generator.
    model = build_model(ModelConfig(name="dcn", embed_dim=8, num_cross_layers=2, mlp_dims=(16, 8),
                                    dropout=0.5), DataSpec.ctr(VOCABS, NUM_DENSE, WIDTHS))
    assert model.dropout == 0.5
    builder = TrainStepBuilder(model, "logloss", OptimConfig(), device="cpu")
    assert builder._generator(0) is not None
    assert _port_builder(0.0, OPTIM)._generator(0) is None


def test_train_step_builder_defaults_to_cuda_and_refuses_unported_options():
    model = build_model(ModelConfig(name="dcn", embed_dim=8, mlp_dims=(8,)),
                        DataSpec.ctr(VOCABS, NUM_DENSE, WIDTHS))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TrainStepBuilder(model, "logloss", OptimConfig())
    with pytest.raises(ValueError, match=r"\(bpr/hinge\), not 'logloss'"):
        TrainStepBuilder(model, "logloss", OptimConfig(), device="cpu", device_negatives=True)
    # The per-table combine (the per-table seam overridden) and the host's
    # dedup sorts ("_sort_<table>" batch keys, stripped before the model)
    # give the default step, whose same-shaped tables share one batched
    # combine, bit for bit.
    builder = TrainStepBuilder(model, "logloss", OptimConfig(), device="cpu")
    state = builder.init_state(torch.Generator().manual_seed(0))
    dense, cat, label = _batches(4, 1)[0]
    host = {"dense": dense, "cat": cat, "label": label}
    want, m_want = builder.step(copy_state(state), {k: torch.from_numpy(v) for k, v in host.items()})
    sorted_batch = {k: torch.from_numpy(v) for k, v in {**host, **host_dedup_sorts(model, host)}.items()}

    class PerTable(TrainStepBuilder):
        def sparse_update(self, *args, **kw):
            return super().sparse_update(*args, **kw)

    plain = {k: torch.from_numpy(v) for k, v in host.items()}
    for cls, batch in ((PerTable, plain), (PerTable, sorted_batch), (TrainStepBuilder, sorted_batch)):
        other = cls(model, "logloss", OptimConfig(), device="cpu")
        got, m_got = other.step(copy_state(state), batch)
        assert torch.equal(m_got["loss"], m_want["loss"])
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got["tables"]), tree_leaves(want["tables"])))
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got["sparse_opt"]),
                                                     tree_leaves(want["sparse_opt"])))
