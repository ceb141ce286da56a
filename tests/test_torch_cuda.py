"""The CUDA kernels against their plain versions on the card.

These tests need an NVIDIA GPU with nvcc (they build csrc/*.cu for
sm_90a); elsewhere they skip. Run them on the H100 with
``python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest``
(``--noconftest``: tests/conftest.py imports jax, which that machine
need not have).
"""

import numpy as np
import pytest
import torch

from tfrec_tpu_torch.configs import ModelConfig, OptimConfig
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
from tfrec_tpu_torch.kernels.cross_v2_cuda import (
    _bwd_route,
    _fwd_route,
    cross_v2_bwd,
    cross_v2_bwd_ref,
    cross_v2_fwd,
    cross_v2_fwd_ref,
)
from tfrec_tpu_torch.kernels.gather_cuda import (
    gather_rows,
    gather_rows_multi,
    gather_rows_multi_ref,
    gather_rows_ref,
)
from tfrec_tpu_torch.models import DataSpec, build_model
from tfrec_tpu_torch.ops.embedding import combine_duplicate_ids
from tfrec_tpu_torch.train.step import TrainStepBuilder, copy_state, tree_leaves

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dim", [1, 8, 13, 32, 128])
def test_gather_rows_is_bitwise_the_plain_version(device, dim):
    rng = np.random.default_rng(dim)
    vocab = 1000
    table = torch.from_numpy(rng.normal(size=(vocab, dim)).astype(np.float32)).to(device)
    ids = rng.integers(-5, vocab + 5, 4099).astype(np.int32)
    ids[:6] = [vocab, -1, 0, vocab - 1, 7, 7]
    ids = torch.from_numpy(ids).to(device)
    before = gather_rows.launches
    got = gather_rows(table, ids)
    torch.cuda.synchronize()
    assert gather_rows.launches == before + 1
    assert torch.equal(got, gather_rows_ref(table, ids))
    # A table view that starts off a 16-byte boundary takes the scalar path.
    if dim % 4 == 0:
        shifted = torch.empty(vocab * dim + 1, device=device)[1:].view(vocab, dim)
        shifted.copy_(table)
        assert torch.equal(gather_rows(shifted, ids), gather_rows_ref(table, ids))


# (vocab, dim, ids) per field: dcn_criteo's 26 fields at a batch of 8192;
# mixed dims, with dims that are no multiple of 4 (13, 1) and a multi-hot
# bag (3 ids an example); more fields than one launch's descriptor holds
# (64: two launches); tables that start off a 16-byte boundary (the scalar
# path at D % 4 == 0).
MULTI_FIELDS = {
    "dcn_criteo": [(100_000, 32, 8192)] * 26,
    "mixed_dims": [(1000, 4, 4099), (777, 8, 4099), (5000, 12, 3 * 4099), (64, 13, 17), (300, 1, 4099),
                   (2000, 100, 1000)],
    "past_one_launch": [(500, 8, 1000)] * 70,
    "misaligned": [(1000, 4, 4099), (1000, 32, 4099)],
}


def _multi_tables(device, case):
    """Seeded tables and edge-case ids (negatives, sentinels, duplicates)."""
    rng = np.random.default_rng(len(case))
    tables, ids = [], []
    for vocab, dim, n in MULTI_FIELDS[case]:
        table = torch.from_numpy(rng.normal(size=(vocab, dim)).astype(np.float32)).to(device)
        if case == "misaligned":
            shifted = torch.empty(vocab * dim + 1, device=device)[1:].view(vocab, dim)
            table = shifted.copy_(table)
        field_ids = rng.integers(-5, vocab + 5, n).astype(np.int32)
        field_ids[:6] = [vocab, -1, 0, vocab - 1, 7, 7]
        tables.append(table)
        ids.append(torch.from_numpy(field_ids).to(device))
    return tables, ids


@pytest.mark.parametrize("case", sorted(MULTI_FIELDS))
def test_gather_rows_multi_is_bitwise_the_plain_version_and_per_table_launches(device, case):
    tables, ids = _multi_tables(device, case)
    before, before_one = gather_rows_multi.launches, gather_rows.launches
    got = gather_rows_multi(tables, ids)
    torch.cuda.synchronize()
    assert gather_rows_multi.launches == before + -(-len(tables) // 64)
    one = [gather_rows(t, i) for t, i in zip(tables, ids)]
    assert gather_rows.launches == before_one + len(tables)
    for g, w, o in zip(got, gather_rows_multi_ref(tables, ids), one):
        assert torch.equal(g, w) and torch.equal(g, o)


@pytest.mark.parametrize("case", sorted(MULTI_FIELDS))
def test_fused_rowwise_adagrad_multi_is_bitwise_the_per_table_launches(device, case):
    """Bit for bit the per-table launches and itself on repeat, within the
    tolerance of the plain version; slots are shuffled in odd tables, so
    sentinels lie among the real ids; rows no real id names stay."""
    tables, ids = _multi_tables(device, case)
    rng = np.random.default_rng(7)
    accs, uids, grads = [], [], []
    for f, (table, field_ids) in enumerate(zip(tables, ids)):
        vocab, dim = table.shape
        g = torch.from_numpy(rng.normal(size=(field_ids.shape[0], dim)).astype(np.float32)).to(device)
        u, c = combine_duplicate_ids(field_ids, g, sentinel=vocab)
        if f % 2:
            perm = torch.from_numpy(rng.permutation(u.shape[0])).to(device)
            u, c = u[perm].contiguous(), c[perm].contiguous()
        accs.append(torch.from_numpy(rng.uniform(0, 0.1, vocab).astype(np.float32)).to(device))
        uids.append(u)
        grads.append(c)

    def copies():
        return [t.clone() for t in tables], [a.clone() for a in accs]

    before, before_one = fused_rowwise_adagrad_multi.launches, fused_rowwise_adagrad.launches
    got_t, got_a = fused_rowwise_adagrad_multi(*copies(), uids, grads, 0.05)
    torch.cuda.synchronize()
    assert fused_rowwise_adagrad_multi.launches == before + -(-len(tables) // 64)
    again_t, again_a = fused_rowwise_adagrad_multi(*copies(), uids, grads, 0.05)
    one_t, one_a = copies()
    for t, a, u, g in zip(one_t, one_a, uids, grads):
        fused_rowwise_adagrad(t, a, u, g, 0.05)
    assert fused_rowwise_adagrad.launches == before_one + len(tables)
    ref_t, ref_a = fused_rowwise_adagrad_multi_ref(*copies(), uids, grads, 0.05)
    for f, table in enumerate(tables):
        assert torch.equal(got_t[f], one_t[f]) and torch.equal(got_a[f], one_a[f])
        assert torch.equal(got_t[f], again_t[f]) and torch.equal(got_a[f], again_a[f])
        _close(got_t[f], ref_t[f])
        _close(got_a[f], ref_a[f])
        touched = torch.zeros(table.shape[0], dtype=torch.bool, device=device)
        touched[uids[f][uids[f] < table.shape[0]].long()] = True
        assert torch.equal(got_t[f][~touched], table[~touched])
        assert torch.equal(got_a[f][~touched], accs[f][~touched])


# d = 2093 (dcn_criteo at embed_dim 80) and 4109 (past 4096: 32 elements a
# thread of 256) are wider than the flagship's 845; 8333 (embed_dim 320) is
# past the 8192 a block's registers hold, and streams its rows.
@pytest.mark.parametrize("batch,dim,layers", [(1000, 845, 3), (33, 31, 2), (257, 2048, 1), (300, 2093, 3),
                                              (70, 4109, 2), (65, 8333, 4)])
def test_cross_v1_fwd_matches_the_plain_version(device, batch, dim, layers):
    rng = np.random.default_rng(batch)
    x0 = torch.from_numpy(rng.normal(size=(batch, dim)).astype(np.float32)).to(device)
    w = torch.from_numpy((rng.normal(size=(layers, dim)) / dim**0.5).astype(np.float32)).to(device)
    b = torch.from_numpy(rng.normal(size=(layers, dim)).astype(np.float32) * 0.1).to(device)
    got = cross_v1_fwd(x0, w, b)
    want = cross_v1_fwd_ref(x0, w, b)
    # f32 row dots summed in another order: errors scale with the terms.
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * want.abs().max().item())
    assert torch.equal(got, cross_v1_fwd(x0, w, b))  # fixed order: bit for bit
    assert torch.equal(cross_stack(x0, {"w": w, "b": b}), got)


def _close(got, want, tol=1e-5):
    """f32 sums in another order: errors scale with the terms, so the
    absolute tolerance is relative to the largest value."""
    torch.testing.assert_close(got, want, rtol=tol, atol=tol * max(want.abs().max().item(), 1e-30))


@pytest.mark.parametrize("batch,dim,layers", [(1000, 845, 3), (33, 31, 2), (257, 2048, 1), (70, 2048, 6),
                                              (300, 2093, 3), (70, 4109, 2), (4096, 8192, 4), (300, 845, 40)])
def test_cross_v1_bwd_matches_the_plain_version(device, batch, dim, layers):
    """d <= 4096 with L <= 4 takes the fast route (d = 2093 keeps 16
    elements a thread and opts in to more than 48 KB of shared memory);
    (70, 2048, 6), (70, 4109, 2), (4096, 8192, 4) and (300, 845, 40), past
    the old 227 KB of [2, L, d] sums, take the general route."""
    rng = np.random.default_rng(batch + dim)
    x0, g = (torch.from_numpy(rng.normal(size=(batch, dim)).astype(np.float32)).to(device)
             for _ in range(2))
    w = torch.from_numpy((rng.normal(size=(layers, dim)) / dim**0.5).astype(np.float32)).to(device)
    b = torch.from_numpy(rng.normal(size=(layers, dim)).astype(np.float32) * 0.1).to(device)
    _, s = cross_v1_fwd(x0, w, b, want_s=True)
    before = cross_v1_bwd.launches
    got = cross_v1_bwd(x0, w, b, s, g)
    torch.cuda.synchronize()
    assert cross_v1_bwd.launches == before + 1
    for a, e in zip(got, cross_v1_bwd_ref(x0, w, b, g, s)):
        _close(a, e)
    for a, e in zip(got, cross_v1_bwd(x0, w, b, s, g)):
        assert torch.equal(a, e)  # fixed-order sums, no atomics: bit for bit
    # The autograd Function behind cross_stack runs both kernels.
    leaves = [t.clone().requires_grad_() for t in (x0, w, b)]
    y = cross_stack(leaves[0], {"w": leaves[1], "b": leaves[2]})
    for a, e in zip(torch.autograd.grad(y, leaves, g), got):
        assert torch.equal(a, e)


def _v2_inputs(device, batch, dim, rank, layers):
    rng = np.random.default_rng(batch + dim + rank)

    def normal(shape, scale):
        return torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32)).to(device)

    return (normal((batch, dim), 1.0), normal((layers, dim, rank), dim**-0.5),
            normal((layers, dim, rank), dim**-0.5), normal((layers, dim), 0.1))


# (batch, d, r, L): the flagship's shape on a ragged batch; odd small
# shapes; a rank past one 64-wide tile of the weight pass; a batch of one;
# a ragged last k-step of the weight pass (4099 rows in chunks of 257) with
# an r past one 64-wide tile, not a multiple of 16; dcn_criteo's widths at
# embed_dim 72 and 128 (d = 1885, 3341), where the forward holds 16 rows a
# block and the row pass keeps g in device memory; r larger than d. Then
# the general route: d = 3561 and 3565 (past the tiles' 3560 at r=64) and
# 4173 (dcn_criteo at embed_dim 160), 3497 at r=128 (past 3496), L = 48 at
# the flagship's width (past the weight pass's 47 layers of f), and r
# larger than d there; the benchmark's DCN-v2 width (d = 3341, r = 512),
# whole and on a ragged batch and rank; one past a 128-wide tile in every
# dimension.
V2_SHAPES = [(1000, 845, 64, 3), (33, 13, 7, 1), (257, 140, 16, 2), (300, 1500, 130, 2), (1, 8, 3, 2),
             (4099, 200, 72, 3), (300, 1885, 64, 2), (64, 3341, 64, 3), (40, 13, 70, 3),
             (70, 3561, 64, 2), (65, 3565, 64, 3), (300, 4173, 64, 3), (33, 3497, 128, 2),
             (100, 845, 64, 48), (17, 100, 120, 48), (300, 3341, 512, 3), (4099, 3341, 511, 2),
             (129, 4173, 129, 3)]


@pytest.mark.parametrize("batch,dim,rank,layers", V2_SHAPES)
def test_cross_v2_fwd_matches_the_plain_version(device, batch, dim, rank, layers):
    x0, u, v, b = _v2_inputs(device, batch, dim, rank, layers)
    before = cross_v2_fwd.launches, cross_v2_fwd.general_launches
    got = cross_v2_fwd(x0, u, v, b)
    torch.cuda.synchronize()
    general = _fwd_route(dim, rank) == "general"
    assert (cross_v2_fwd.launches, cross_v2_fwd.general_launches) == (before[0] + 1, before[1] + general)
    _close(got, cross_v2_fwd_ref(x0, u, v, b))
    assert torch.equal(got, cross_v2_fwd(x0, u, v, b))  # fixed order: bit for bit
    out, f, xv = cross_v2_fwd(x0, u, v, b, want_saved=True)
    assert torch.equal(out, got)
    _, f_ref, xv_ref = cross_v2_fwd_ref(x0, u, v, b, want_saved=True)
    _close(f, f_ref)
    _close(xv, xv_ref)
    assert torch.equal(cross_stack(x0, {"u": u, "v": v, "b": b}), got)


@pytest.mark.parametrize("batch,dim,rank,layers", V2_SHAPES)
def test_cross_v2_bwd_matches_the_plain_version(device, batch, dim, rank, layers):
    x0, u, v, b = _v2_inputs(device, batch, dim, rank, layers)
    g = torch.randn(x0.shape, generator=torch.Generator(device=device).manual_seed(batch),
                    device=device)
    _, f, xv = cross_v2_fwd(x0, u, v, b, want_saved=True)
    before = cross_v2_bwd.launches, cross_v2_bwd.general_launches
    got = cross_v2_bwd(x0, u, v, f, xv, g)
    torch.cuda.synchronize()
    general = _bwd_route(dim, rank, layers) == "general"
    assert (cross_v2_bwd.launches, cross_v2_bwd.general_launches) == (before[0] + 1, before[1] + general)
    for a, e in zip(got, cross_v2_bwd_ref(x0, u, v, f, xv, g)):
        _close(a, e)
    for a, e in zip(got, cross_v2_bwd(x0, u, v, f, xv, g)):
        assert torch.equal(a, e)  # fixed-order sums, no atomics: bit for bit
    # The autograd Function behind cross_stack runs both kernels.
    leaves = [t.clone().requires_grad_() for t in (x0, u, v, b)]
    y = cross_stack(leaves[0], {"u": leaves[1], "v": leaves[2], "b": leaves[3]})
    for a, e in zip(torch.autograd.grad(y, leaves, g), got):
        assert torch.equal(a, e)


def test_cross_v2_takes_rows_past_its_tiles(device):
    """d = 3561 at r=64 is the first width whose 16 rows of x and xv (or df
    and t) pass 227 KB: both kernels take the general route there, and
    match their plain versions."""
    x0, u, v, b = _v2_inputs(device, 4, 3561, 64, 1)
    before = cross_v2_fwd.general_launches, cross_v2_bwd.general_launches
    out, f, xv = cross_v2_fwd(x0, u, v, b, want_saved=True)
    _close(out, cross_v2_fwd_ref(x0, u, v, b))
    for a, e in zip(cross_v2_bwd(x0, u, v, f, xv, x0), cross_v2_bwd_ref(x0, u, v, f, xv, x0)):
        _close(a, e)
    assert (cross_v2_fwd.general_launches, cross_v2_bwd.general_launches) == (before[0] + 1, before[1] + 1)


def test_cross_v1_takes_rows_wider_than_its_registers(device):
    """d = 8193, one past what a block's registers hold: both kernels run
    their streaming routes and match their plain versions."""
    rng = np.random.default_rng(8193)
    x0, g = (torch.from_numpy(rng.normal(size=(40, 8193)).astype(np.float32)).to(device) for _ in range(2))
    w = torch.from_numpy((rng.normal(size=(2, 8193)) / 8193**0.5).astype(np.float32)).to(device)
    b = torch.from_numpy(rng.normal(size=(2, 8193)).astype(np.float32) * 0.1).to(device)
    before = cross_v1_fwd.launches, cross_v1_bwd.launches
    out, s = cross_v1_fwd(x0, w, b, want_s=True)
    want, s_ref = cross_v1_fwd_ref(x0, w, b, want_s=True)
    _close(out, want)
    _close(s, s_ref)
    for a, e in zip(cross_v1_bwd(x0, w, b, s, g), cross_v1_bwd_ref(x0, w, b, g, s)):
        _close(a, e)
    assert (cross_v1_fwd.launches, cross_v1_bwd.launches) == (before[0] + 1, before[1] + 1)


def test_cross_v1_takes_rows_at_the_32_bit_limit(device):
    """d = 2**31 - 1, the widest row the kernels index, through both
    streaming routes, whose column walks must not overflow (B = 1, L = 1:
    72 GiB with the backward's outputs and scratch, so an 80 GB card). x0 is
    zero but at a few columns, the last ones among them, with positive
    terms in the row dots, so those are short sums with no cancellation;
    each output is held, a chunk of columns at a time, to the plain
    version's formulas at L = 1 with the dots taken in float64."""
    dim = 2**31 - 1
    torch.cuda.empty_cache()
    gen = torch.Generator(device=device).manual_seed(0)
    cols = torch.tensor([0, 1, 255, 256, dim // 2, dim - 4097, dim - 2048, dim - 1025, dim - 256, dim - 2,
                         dim - 1], device=device)
    x0 = torch.zeros((1, dim), device=device)
    x0[0, cols] = torch.rand(len(cols), device=device, generator=gen) + 0.5
    w = torch.randn((1, dim), device=device, generator=gen)
    w[0, cols] = w[0, cols].abs()
    b = torch.randn((1, dim), device=device, generator=gen)
    chunks = [slice(i, min(i + 2**28, dim)) for i in range(0, dim, 2**28)]
    out, s = cross_v1_fwd(x0, w, b, want_s=True)
    _close(s[0, 0], (x0[0, cols].double() * w[0, cols].double()).sum().float())
    for c in chunks:
        _close(out[0, c], x0[0, c] * s[0, 0] + b[0, c] + x0[0, c])
    del out
    g = torch.randn((1, dim), device=device, generator=gen)
    g[0, cols] = g[0, cols].abs()
    dx0, dw, db = cross_v1_bwd(x0, w, b, s, g)
    ds = (x0[0, cols].double() * g[0, cols].double()).sum().float()
    for c in chunks:
        _close(dx0[0, c], g[0, c] * s[0, 0] + (g[0, c] + ds * w[0, c]))
        _close(dw[0, c], x0[0, c] * ds)
        assert torch.equal(db[0, c], g[0, c])


def test_cross_v2_takes_rows_at_the_32_bit_limit(device):
    """d = 2**31 - 1 through the forward's general route, whose k-walks,
    columns and tile counts must not wrap (B = 1, r = 1, L = 1: 48 GiB with
    f and xv, so an 80 GB card; the backward at this width takes 104 GiB,
    more than the card holds). x0 is zero but at a few columns, the last
    ones among them, where v is positive, so xv is a short sum with no
    cancellation, held to float64; f and out are held, a chunk of columns
    at a time, to the plain version's formulas at L = 1."""
    dim = 2**31 - 1
    torch.cuda.empty_cache()
    gen = torch.Generator(device=device).manual_seed(0)
    cols = torch.tensor([0, 1, 15, 16, 1023, 1024, dim // 2, dim - 1025, dim - 17, dim - 16, dim - 2,
                         dim - 1], device=device)
    x0 = torch.zeros((1, dim), device=device)
    x0[0, cols] = torch.rand(len(cols), device=device, generator=gen) + 0.5
    v = torch.randn((1, dim, 1), device=device, generator=gen)
    v[0, cols] = v[0, cols].abs()
    u = torch.randn((1, dim, 1), device=device, generator=gen)
    b = torch.randn((1, dim), device=device, generator=gen)
    before = cross_v2_fwd.general_launches
    out, f, xv = cross_v2_fwd(x0, u, v, b, want_saved=True)
    torch.cuda.synchronize()
    assert cross_v2_fwd.general_launches == before + 1
    _close(xv[0, 0, 0], (x0[0, cols].double() * v[0, cols, 0].double()).sum().float())
    for c in (slice(i, min(i + 2**28, dim)) for i in range(0, dim, 2**28)):
        f_c = xv[0, 0, 0] * u[0, c, 0] + b[0, c]
        _close(f[0, 0, c], f_c)
        _close(out[0, c], x0[0, c] * f_c + x0[0, c])


def test_cross_v2_takes_ranks_past_one_grid_dimension(device):
    """r = 65535 * 64 + 65: the backward's weight products have more
    64-wide tiles of r than a grid's y dimension holds (65535), so their
    tiles of d and r share its x dimension. U and V are zero but at a few
    ranks, the last ones among them, so each sum over r is short."""
    batch, dim, rank = 4, 2, 65535 * 64 + 65
    gen = torch.Generator(device=device).manual_seed(1)
    ranks = torch.tensor([0, 63, 64, rank // 2, rank - 65, rank - 17, rank - 1], device=device)
    x0, g = (torch.randn((batch, dim), device=device, generator=gen) for _ in range(2))
    u, v = (torch.zeros((1, dim, rank), device=device) for _ in range(2))
    for w in (u, v):
        w[:, :, ranks] = torch.randn((1, dim, len(ranks)), device=device, generator=gen)
    b = torch.randn((1, dim), device=device, generator=gen)
    before = cross_v2_fwd.general_launches, cross_v2_bwd.general_launches
    out, f, xv = cross_v2_fwd(x0, u, v, b, want_saved=True)
    got = cross_v2_bwd(x0, u, v, f, xv, g)
    torch.cuda.synchronize()
    assert (cross_v2_fwd.general_launches, cross_v2_bwd.general_launches) == (before[0] + 1, before[1] + 1)
    _close(out, cross_v2_fwd_ref(x0, u, v, b))
    for a, e in zip(got, cross_v2_bwd_ref(x0, u, v, f, xv, g)):
        _close(a, e)


@pytest.mark.parametrize("dim", [1, 8, 32, 100])
def test_fused_rowwise_adagrad_matches_the_plain_version(device, dim):
    rng = np.random.default_rng(dim)
    vocab, n = 5000, 3000
    table = torch.from_numpy(rng.normal(size=(vocab, dim)).astype(np.float32)).to(device)
    acc = torch.from_numpy(rng.uniform(0, 0.1, vocab).astype(np.float32)).to(device)
    ids = rng.integers(1, vocab - 1, n).astype(np.int32)
    ids[:6] = [vocab, vocab + 2, -1, -3, 7, 7]
    uids, g = combine_duplicate_ids(torch.from_numpy(ids).to(device),
                                    torch.from_numpy(rng.normal(size=(n, dim)).astype(np.float32)).to(device),
                                    sentinel=vocab)
    before = fused_rowwise_adagrad.launches
    t_k, a_k = fused_rowwise_adagrad(table.clone(), acc.clone(), uids, g, 0.05)
    torch.cuda.synchronize()
    assert fused_rowwise_adagrad.launches == before + 1
    t_r, a_r = fused_rowwise_adagrad_ref(table.clone(), acc.clone(), uids, g, 0.05)
    _close(t_k, t_r)
    _close(a_k, a_r)
    t_2, a_2 = fused_rowwise_adagrad(table.clone(), acc.clone(), uids, g, 0.05)
    assert torch.equal(t_k, t_2) and torch.equal(a_k, a_2)
    # Row 0 and row V-1, where a clamped negative id or sentinel would land,
    # are no real id here and stay as they were.
    for row in (0, vocab - 1):
        assert torch.equal(t_k[row], table[row]) and torch.equal(a_k[row], acc[row])


# (D, G): DCN's packs (128 at 4 groups, 64 at 2: d = 32), FM's (128 at 2: d =
# 64), a linear pack (6 at 6, 128 at 128: d = 1) and d = 16.
GROUPED = [(128, 4), (64, 2), (128, 2), (6, 6), (128, 128), (96, 6)]


def _grouped_inputs(device, vocab, dim, groups, n, seed):
    """A table, a [V, G] accumulator and combined Zipf-ish ids whose rows
    touch only some of their groups (zero gradient elsewhere), as a pack's
    do, with negatives and sentinels among them."""
    rng = np.random.default_rng(seed)
    table = torch.from_numpy(rng.normal(size=(vocab, dim)).astype(np.float32)).to(device)
    acc = torch.from_numpy(rng.uniform(0, 0.1, (vocab, groups)).astype(np.float32)).to(device)
    ids = np.clip(rng.zipf(1.2, n), 1, vocab - 2).astype(np.int32)
    ids[:6] = [vocab, vocab + 2, -1, -3, 7, 7]
    g = rng.normal(size=(n, groups, dim // groups)).astype(np.float32)
    g[rng.integers(0, groups, n)[:, None] != np.arange(groups)[None, :]] = 0.0
    return (table, acc) + combine_duplicate_ids(torch.from_numpy(ids).to(device),
                                                torch.from_numpy(g.reshape(n, dim)).to(device),
                                                sentinel=vocab)


@pytest.mark.parametrize("dim,groups", GROUPED)
def test_grouped_adagrad_is_bitwise_the_plain_version_and_each_groups_own_update(device, dim, groups):
    """A lane-grouped table (as [V*G, d] rows): bit for bit its plain
    version and itself on repeat, and each group bit for bit the one-group kernel on that group's
    lanes alone (the per-field update of a lane-packed field)."""
    vocab = 3000
    table, acc, uids, g = _grouped_inputs(device, vocab, dim, groups, 4099, dim + groups)
    before = fused_rowwise_adagrad.launches
    t_k, a_k = fused_rowwise_adagrad(table.clone(), acc.clone(), uids, g, 0.05)
    torch.cuda.synchronize()
    assert fused_rowwise_adagrad.launches == before + 1
    t_r, a_r = fused_rowwise_adagrad_ref(table.clone(), acc.clone(), uids, g, 0.05)
    t_2, a_2 = fused_rowwise_adagrad(table.clone(), acc.clone(), uids, g, 0.05)
    assert torch.equal(t_k, t_r) and torch.equal(a_k, a_r)
    assert torch.equal(t_k, t_2) and torch.equal(a_k, a_2)
    d = dim // groups
    for j in range(groups):
        lanes = slice(j * d, (j + 1) * d)
        t_j, a_j = fused_rowwise_adagrad(table[:, lanes].contiguous(), acc[:, j].contiguous(), uids,
                                         g[:, lanes].contiguous(), 0.05)
        assert torch.equal(t_k[:, lanes], t_j) and torch.equal(a_k[:, j], a_j)
    for row in (0, vocab - 1):
        assert torch.equal(t_k[row], table[row]) and torch.equal(a_k[row], acc[row])


def test_grouped_and_one_group_tables_share_a_launch(device):
    """One launch over tables of G = 1 and G > 1: each table's result is its
    own one-table launch's and its plain version's, bit for bit, whatever
    its launch-mates."""
    shapes = [(5000, 32, 1), (3000, 128, 4), (700, 6, 6), (4000, 64, 2), (900, 1, 1), (2000, 100, 1)]
    work = [_grouped_inputs(device, v, d, gr, 2049, i) for i, (v, d, gr) in enumerate(shapes)]
    tables, accs, uids, grads = (list(x) for x in zip(*work))
    for t in range(len(shapes)):  # the one-group tables with a [V] accumulator
        if accs[t].shape[1] == 1:
            accs[t] = accs[t][:, 0].contiguous()

    def copies():
        return [t.clone() for t in tables], [a.clone() for a in accs]

    before = fused_rowwise_adagrad_multi.launches
    got_t, got_a = fused_rowwise_adagrad_multi(*copies(), uids, grads, 0.02)
    torch.cuda.synchronize()
    assert fused_rowwise_adagrad_multi.launches == before + 1
    ref_t, ref_a = fused_rowwise_adagrad_multi_ref(*copies(), uids, grads, 0.02)
    for f in range(len(shapes)):
        one_t, one_a = fused_rowwise_adagrad(tables[f].clone(), accs[f].clone(), uids[f], grads[f], 0.02)
        assert torch.equal(got_t[f], one_t) and torch.equal(got_a[f], one_a)
        assert torch.equal(got_t[f], ref_t[f]) and torch.equal(got_a[f], ref_a[f])


@pytest.mark.parametrize("mode", ["lane_pack", "stack_tables", "per_table", "lane_pack_per_table",
                                  "host_dedup"])
def test_train_steps_of_every_layout_and_combine_are_bitwise_the_per_field_steps(device, mode):
    """Three DCN steps (rowwise Adagrad) on the card in each table layout
    and combine mode, from one state: losses, tables and accumulators bit
    for bit the per-field run's (its same-shaped tables combined in one
    batched sort; "per_table" overrides the per-table seam, so each table
    is combined and updated alone)."""
    from tfrec_tpu_torch.train.step import host_dedup_sorts

    vocabs, widths = (300, 120, 80, 50, 200, 64, 33), (1, 1, 3, 1, 1, 2, 1)
    spec = DataSpec.ctr(vocabs, 3, widths)
    optim = OptimConfig(learning_rate=0.01, sparse_optimizer="rowwise_adagrad", sparse_learning_rate=0.05)
    layout = {"lane_pack": {"lane_pack": True}, "stack_tables": {"stack_tables": True},
              "lane_pack_per_table": {"lane_pack": True}}.get(mode, {})

    class PerTable(TrainStepBuilder):
        def sparse_update(self, *args, **kw):
            return super().sparse_update(*args, **kw)
    runs = []
    for changed in (False, True):
        model = build_model(ModelConfig(name="dcn", embed_dim=32, num_cross_layers=2, mlp_dims=(16,),
                                        **(layout if changed else {})), spec)
        builder = (PerTable if changed and mode.endswith("per_table") else TrainStepBuilder)(
            model, "logloss", optim)
        state = builder.init_state(torch.Generator(device="cuda").manual_seed(0))
        losses = []
        for step in range(3):
            dense, cat, label = synthetic_ctr(256, 3, vocabs, seed=step, field_widths=widths)
            batch = {"dense": dense, "cat": cat, "label": label}
            if changed and mode == "host_dedup":
                batch.update(host_dedup_sorts(model, batch))
            state, m = builder.step(state, {k: torch.from_numpy(v).to(device) for k, v in batch.items()})
            losses.append(m["loss"])
        runs.append((torch.stack(losses), model.split_fields(state["tables"]),
                     model.split_fields({n: s["acc"] for n, s in state["sparse_opt"].items()}, stat=True)))
    (l0, t0, a0), (l1, t1, a1) = runs
    assert torch.equal(l0, l1)
    assert all(torch.equal(t0[k], t1[k]) for k in t0) and all(torch.equal(a0[k], a1[k]) for k in a0)


def test_combine_duplicate_ids_repeats_and_matches_the_cpu(device):
    rng = np.random.default_rng(5)
    ids = rng.zipf(1.2, 8192).clip(max=100_000).astype(np.int32) - 1
    ids[:4] = [-1, 100_000, 100_003, 3]
    grads = rng.normal(size=(8192, 32)).astype(np.float32)
    got = combine_duplicate_ids(torch.from_numpy(ids).to(device), torch.from_numpy(grads).to(device), 100_000)
    again = combine_duplicate_ids(torch.from_numpy(ids).to(device), torch.from_numpy(grads).to(device), 100_000)
    cpu = combine_duplicate_ids(torch.from_numpy(ids), torch.from_numpy(grads), 100_000)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    assert torch.equal(got[0].cpu(), cpu[0])
    _close(got[1].cpu(), cpu[1], 1e-6)


@pytest.mark.parametrize("name,rank", [("dcn", 0), ("dcnv2", 4)])
def test_train_step_on_the_card_matches_the_cpu(device, name, rank):
    """One DCN step, v1 or low-rank v2 (dense Adam, rowwise Adagrad), from
    the same state on the card and on the CPU: loss, tables and
    accumulators. Dense params are not compared after Adam's first update
    (its size is lr whatever the gradient)."""
    vocabs, widths = (37, 52, 45, 60), (1, 1, 3, 1)
    model = build_model(ModelConfig(name=name, embed_dim=8, num_cross_layers=2, mlp_dims=(16, 8),
                                    cross_rank=rank), DataSpec.ctr(vocabs, 3, widths))
    optim = OptimConfig(learning_rate=0.01, dense_optimizer="adam",
                        sparse_optimizer="rowwise_adagrad", sparse_learning_rate=0.05)
    card = TrainStepBuilder(model, "logloss", optim)
    cpu = TrainStepBuilder(model, "logloss", optim, device="cpu")
    state = card.init_state(torch.Generator(device="cuda").manual_seed(0))
    cpu_state = copy_state(state, "cpu")
    dense, cat, label = synthetic_ctr(64, 3, vocabs, seed=1, field_widths=widths)
    batch = {"dense": torch.from_numpy(dense), "cat": torch.from_numpy(cat), "label": torch.from_numpy(label)}
    new, m = card.step(state, {k: v.to(device) for k, v in batch.items()})
    want, m_cpu = cpu.step(cpu_state, batch)
    torch.testing.assert_close(m["loss"].cpu(), m_cpu["loss"], rtol=1e-5, atol=0)
    for name in want["tables"]:
        _close(new["tables"][name].cpu(), want["tables"][name], 1e-4)
        _close(new["sparse_opt"][name]["acc"].cpu(), want["sparse_opt"][name]["acc"], 1e-4)
    assert new["step"] == 1 and all(t.device.type == "cuda" for t in tree_leaves(new["tables"]))


# ---- retrieval (config 1, MF): the kernels at MF's shapes, the top-k ----

def test_gather_and_adagrad_multi_over_mf_tables_are_bitwise_the_plain_versions(device):
    """MF's three tables in one launch each: user_emb [U, 64] with B ids,
    item_emb [V, 64] and item_bias [V, 1] with the same 2B ids ([pos; neg],
    one id vector for both); the bias takes the gather's per-float route.
    Both kernels bit for bit their plain versions, and the update of the
    rows no real id names leaves them as they were."""
    rng = np.random.default_rng(21)
    bsz, users, items = 8192, 50_000, 200_000
    tables = [torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(device)
              for shape in ((users, 64), (items, 64), (items, 1))]
    user_ids = torch.from_numpy(rng.integers(0, users, bsz).astype(np.int32)).to(device)
    item_ids = torch.from_numpy(rng.integers(0, items, 2 * bsz).astype(np.int32)).to(device)
    ids = [user_ids, item_ids, item_ids]
    before = gather_rows_multi.launches
    rows = gather_rows_multi(tables, ids)
    torch.cuda.synchronize()
    assert gather_rows_multi.launches == before + 1
    for got, want in zip(rows, gather_rows_multi_ref(tables, ids)):
        assert torch.equal(got, want)
    assert [tuple(r.shape) for r in rows] == [(bsz, 64), (2 * bsz, 64), (2 * bsz, 1)]

    accs, uids, grads = [], [], []
    for table, field_ids in zip(tables, ids):
        vocab, dim = table.shape
        g = torch.from_numpy((1e-2 * rng.normal(size=(field_ids.shape[0], dim))).astype(np.float32)).to(device)
        u, c = combine_duplicate_ids(field_ids, g, sentinel=vocab)
        accs.append(torch.from_numpy(rng.uniform(0, 0.1, vocab).astype(np.float32)).to(device))
        uids.append(u)
        grads.append(c)
    copies = lambda: ([t.clone() for t in tables], [a.clone() for a in accs])  # noqa: E731
    before = fused_rowwise_adagrad_multi.launches
    got_t, got_a = fused_rowwise_adagrad_multi(*copies(), uids, grads, 0.05)
    torch.cuda.synchronize()
    assert fused_rowwise_adagrad_multi.launches == before + 1
    ref_t, ref_a = fused_rowwise_adagrad_multi_ref(*copies(), uids, grads, 0.05)
    again_t, again_a = fused_rowwise_adagrad_multi(*copies(), uids, grads, 0.05)
    for f, table in enumerate(tables):
        assert torch.equal(got_t[f], ref_t[f]) and torch.equal(got_a[f], ref_a[f]), f
        assert torch.equal(got_t[f], again_t[f]) and torch.equal(got_a[f], again_a[f]), f
        touched = torch.zeros(table.shape[0], dtype=torch.bool, device=device)
        touched[uids[f][uids[f] < table.shape[0]].long()] = True
        assert torch.equal(got_t[f][~touched], table[~touched])
        assert bool((got_t[f][touched] != table[touched]).any(dim=1).all())


def test_mask_items_and_chunked_topk_take_sentinels_on_the_card(device):
    """Exclusions with sentinels (a whole row of them), repeats and slots
    past the count on CUDA tensors: no device-side assert, and the CPU's
    results (the same scores, so values equal; ids where untied)."""
    from tfrec_tpu_torch.eval.retrieval import NEG_INF, chunked_topk, mask_items, topk_scores

    rng = np.random.default_rng(22)
    b, v, chunk, k = 64, 5000, 1536, 100
    scores = torch.from_numpy(rng.normal(size=(b, v)).astype(np.float32))
    padded = np.full((b, 40), v, np.int32)
    counts = rng.integers(0, 41, b).astype(np.int32)
    for r in range(b):
        padded[r, : counts[r]] = rng.choice(v, counts[r], replace=False)
    padded[0, :], counts[0] = v, 40        # every slot the sentinel
    padded[1, 1], counts[1] = padded[1, 0], max(counts[1], 2)
    padded, counts = torch.from_numpy(padded), torch.from_numpy(counts)
    want = mask_items(scores.clone(), padded, counts)
    got = mask_items(scores.to(device), padded.to(device), counts.to(device))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want) and torch.equal(want[0], scores[0])
    assert int((want == NEG_INF).sum()) > 0
    vals, ids = topk_scores(scores.to(device), k, padded.to(device), counts.to(device))
    want_v, _ = topk_scores(scores.clone(), k, padded, counts)
    assert torch.equal(vals.cpu(), want_v) and ids.dtype == torch.int32
    assert torch.equal(torch.gather(want, 1, ids.cpu().long()), vals.cpu())

    def chunk_fn(on):
        padded_scores = torch.full((b, -(-v // chunk) * chunk), 0.0)
        padded_scores[:, :v] = scores
        padded_scores = padded_scores.to(on)
        return lambda users, start: padded_scores[users.long(), start : start + chunk]

    users = torch.arange(b, dtype=torch.int32)
    got_v, got_i = chunked_topk(chunk_fn(device), users.to(device), v, k, chunk, padded.to(device),
                                counts.to(device))
    cpu_v, cpu_i = chunked_topk(chunk_fn("cpu"), users, v, k, chunk, padded, counts)
    torch.cuda.synchronize()
    assert torch.equal(got_v.cpu(), cpu_v) and torch.equal(got_v.cpu(), want_v)
    assert torch.equal(torch.gather(want, 1, got_i.cpu().long()), cpu_v)
    assert not bool((got_i == v).any())  # k fits every row's unmasked items


def test_mf_train_step_and_recommend_on_the_card_match_the_cpu(device):
    """One MF step under bpr at config 1's l2_reg (dense Adagrad on an empty
    tree, rowwise Adagrad) on the card against the CPU, with the kernels'
    launches counted; then the top-k of the trained tables, the card's
    against the CPU's."""
    from tfrec_tpu_torch.serve import Recommender

    users, items, bsz = 943, 1682, 2048
    model = build_model(ModelConfig(name="mf", embed_dim=64), DataSpec.interaction(users, items))
    optim = OptimConfig(learning_rate=0.1, dense_optimizer="adagrad", sparse_optimizer="rowwise_adagrad")
    card = TrainStepBuilder(model, "bpr", optim, l2_reg=0.03)
    cpu = TrainStepBuilder(model, "bpr", optim, l2_reg=0.03, device="cpu")
    state = card.init_state(torch.Generator(device="cuda").manual_seed(0))
    cpu_state = copy_state(state, "cpu")
    rng = np.random.default_rng(23)
    batch = {"user": rng.integers(0, users, bsz), "pos": rng.integers(0, items, bsz),
             "neg": rng.integers(0, items, bsz)}
    batch = {k: torch.from_numpy(v.astype(np.int32)) for k, v in batch.items()}
    before = gather_rows_multi.launches, fused_rowwise_adagrad_multi.launches
    new, m = card.step(state, {k: v.to(device) for k, v in batch.items()})
    torch.cuda.synchronize()
    assert (gather_rows_multi.launches, fused_rowwise_adagrad_multi.launches) == (before[0] + 1, before[1] + 1)
    want, m_cpu = cpu.step(cpu_state, batch)
    torch.testing.assert_close(m["loss"].cpu(), m_cpu["loss"], rtol=1e-5, atol=0)
    for name in want["tables"]:
        _close(new["tables"][name].cpu(), want["tables"][name], 1e-5)
    rec = Recommender(model, {"tables": new["tables"], "dense": {}})
    cpu_rec = Recommender(model, {"tables": want["tables"], "dense": {}}, device="cpu")
    ids, vals = rec.recommend(np.arange(64), 20)
    cpu_ids, cpu_vals = cpu_rec.recommend(np.arange(64), 20)
    np.testing.assert_allclose(vals, cpu_vals, rtol=1e-5, atol=1e-5)
    assert (ids == cpu_ids).mean() > 0.95  # products summed in other orders may swap near-ties


def test_lightgcn_propagation_and_step_repeat_bit_for_bit(device):
    """LightGCN at ML-100K's shape (943 x 1682, 64 items a user, d=64, 3
    layers): the propagation's sorted sums repeat bit for bit, forward and
    backward (no float atomics), and match the CPU's to rounding."""
    rng = np.random.default_rng(3)
    nu, ni = 943, 1682
    users = np.repeat(np.arange(nu), 64).astype(np.int32)
    items = rng.integers(0, ni, len(users)).astype(np.int32)
    model = build_model(ModelConfig(name="lightgcn", embed_dim=64), DataSpec.interaction(nu, ni))
    model.attach_graph(users, items)
    builder = TrainStepBuilder(model, "bpr", OptimConfig(learning_rate=0.1, dense_optimizer="adagrad"),
                               l2_reg=0.03, device=device)
    state = builder.init_state(torch.Generator(device=device).manual_seed(0))
    first = model.propagate(state["dense"])
    again = model.propagate(state["dense"])
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    cpu = model.propagate({k: v.cpu() for k, v in state["dense"].items()})
    for a, b in zip(first, cpu):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-6)
    batch = {k: torch.from_numpy(rng.integers(0, n, 2048).astype(np.int32)).to(device)
             for k, n in (("user", nu), ("pos", ni), ("neg", ni))}
    one, _ = builder.step(copy_state(state), batch)
    two, _ = builder.step(copy_state(state), batch)
    assert all(torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
               for a, b in zip(tree_leaves(one), tree_leaves(two)))


def test_fism_step_adagrad_launch_is_bitwise_the_plain_version(device):
    """The Adagrad kernel at a FISM step's shape (item_p: 1024 x 64 history
    slots of [1682, 64], sentinel pads among them; item_q and item_bias:
    2048 item slots) from the step's own combined gradients: one launch,
    bit for bit its plain version."""
    rng = np.random.default_rng(4)
    nu, ni, h, b = 943, 1682, 64, 1024
    model = build_model(ModelConfig(name="fism", embed_dim=64, max_history=h), DataSpec.interaction(nu, ni))
    builder = TrainStepBuilder(model, "bpr", OptimConfig(learning_rate=0.05, dense_optimizer="adagrad"),
                               l2_reg=0.01, device=device)
    state = builder.init_state(torch.Generator(device=device).manual_seed(0))
    hist = rng.integers(0, ni, (b, h)).astype(np.int32)
    hist[np.arange(h)[None, :] >= rng.integers(1, h + 1, b)[:, None]] = ni
    batch = {"user": rng.integers(0, nu, b), "hist": hist, "pos": rng.integers(0, ni, b),
             "neg": rng.integers(0, ni, b)}
    batch = {k: torch.from_numpy(np.asarray(v, np.int32)).to(device) for k, v in batch.items()}
    _, _, row_grads, ids = builder.loss_and_grads(state, batch)
    assert ids["item_p"].shape == (b * h,) and bool((ids["item_p"] == ni).any())
    uids, grads = zip(*(combine_duplicate_ids(ids[n], row_grads[n], sentinel=ni) for n in ids))
    tables = [state["tables"][n] for n in ids]
    accs = [state["sparse_opt"][n]["acc"] for n in ids]
    before = fused_rowwise_adagrad_multi.launches
    got_t, got_a = fused_rowwise_adagrad_multi([t.clone() for t in tables], [a.clone() for a in accs],
                                               list(uids), list(grads), 0.05, 1e-8)
    want_t, want_a = fused_rowwise_adagrad_multi_ref([t.clone() for t in tables], [a.clone() for a in accs],
                                                     list(uids), list(grads), 0.05, 1e-8)
    torch.cuda.synchronize()
    assert fused_rowwise_adagrad_multi.launches == before + 1
    assert all(torch.equal(a, e) for a, e in zip(got_t + got_a, want_t + want_a))
    # The sentinel slots were dropped: the last row moves only through real ids.
    assert (uids[0] < ni).sum() < b * h
