"""Byte and FLOP counts on small shapes, worked by hand."""

import pytest
import torch

from portbench import gen, harness, roofline
from portbench.runners.common import distinct_per_column


def test_bound_picks_the_larger():
    t, by = roofline.bound_s(3.35e12, 0)
    assert t == pytest.approx(1.0) and by == "bytes"
    t, by = roofline.bound_s(0, 495e12 * 2)
    assert t == pytest.approx(2.0) and by == "operations"
    assert roofline.share_percent(1.0, 4.0) == 25.0 and roofline.share_percent(1.0, 0.0) is None


def test_gather_and_adagrad_bytes():
    # 2 tables, d = 4 (16 B rows): distinct 3 and 1 of 5 ids each.
    assert roofline.gather_bytes([3, 1], [5, 5], 4) == 3 * 16 + 5 * 20 + 1 * 16 + 5 * 20
    assert roofline.adagrad_bytes([3, 1], [5, 5], 4) == 3 * (48 + 8) + 20 + 1 * (48 + 8) + 20
    assert roofline.adagrad_flops([3, 1], 4) == 64


def test_cross_v2_counts():
    b, d, r, l = 2, 3, 5, 1
    assert roofline.cross_v2_flops(b, d, r, l, train=False) == 4 * b * d * r * l
    assert roofline.cross_v2_flops(b, d, r, l, train=True) == 12 * b * d * r * l
    fwd = (2 * b * d + 2 * l * d * r + l * d) * 4
    assert roofline.cross_v2_bytes(b, d, r, l, train=False) == fwd
    saved = l * (b * d + b * r) * 4
    bwd = ((2 + l) * b * d + l * b * r + 2 * l * d * r + b * d + 2 * l * d * r + l * d) * 4
    assert roofline.cross_v2_bytes(b, d, r, l, train=True) == fwd + saved + bwd


def test_model_flops_of_the_configurations():
    dlrm = harness.load_cell("dlrm_criteo_tb.train_zipf")
    dcn = harness.load_cell("dcnv2_criteo_tb.train_zipf")
    # DLRM: 13-512-256-128, 27 x 27 x 128 products, 479-1024-1024-512-256-1.
    fwd = 2 * (13 * 512 + 512 * 256 + 256 * 128) + 2 * 27 * 27 * 128 + 2 * (
        479 * 1024 + 1024 * 1024 + 1024 * 512 + 512 * 256 + 256)
    assert dlrm.family.forward_flops(dlrm.config, 1) == fwd
    assert roofline.model_flops(fwd, True) == pytest.approx(14.75e6, rel=1e-3)
    # DCN-v2: cross 4 d0 r L, deep 3341-1024-1024-512-256, head.
    fwd = 4 * 3341 * 512 * 3 + 2 * (3341 * 1024 + 1024 * 1024 + 1024 * 512 + 512 * 256) + 2 * (3341 + 256)
    assert dcn.family.forward_flops(dcn.config, 1) == fwd
    assert roofline.model_flops(fwd, True) == pytest.approx(92.4e6, rel=1e-3)
    assert dcn.family.cross_shape(dcn.config) == (3341, 512, 3)


def test_distinct_per_column():
    cat = torch.tensor([[1, 2], [1, 3], [4, 3]])
    assert distinct_per_column(cat) == [2, 2]


def test_table_rows_repeat_the_filled_table():
    out = gen.fill_table(7, 3, torch.empty(1000, 8))
    rows = torch.tensor([0, 5, 999, 5])
    assert torch.equal(gen.table_rows(7, 3, rows, 8), out[rows])
    a = gen.table_scale(8)
    assert out.abs().max() < a and abs(out.std().item() - 8 ** -0.5) < 0.01
    assert not torch.equal(out, gen.fill_table(8, 3, torch.empty(1000, 8)))
    assert not torch.equal(out, gen.fill_table(7, 4, torch.empty(1000, 8)))


def test_zipf_ranks_and_their_scatter():
    z = gen.ZipfSampler(1.2, 1000, "cpu")
    r = z.ranks(torch.rand(20000, dtype=torch.float64, generator=torch.Generator().manual_seed(0)), 100)
    assert 0 <= r.min() and r.max() < 100
    # P(rank 0) = 1 / H(100, 1.2).
    h = sum((k + 1) ** -1.2 for k in range(100))
    assert (r == 0).double().mean().item() == pytest.approx(1 / h, abs=0.01)
    rows = gen.scatter_ranks(torch.arange(97), 2**31 + 5, 0, 97)
    assert sorted(rows.tolist()) == list(range(97))
