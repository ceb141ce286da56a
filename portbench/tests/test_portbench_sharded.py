"""The four-card DLRM-DCNv2 cell's pieces on the CPU: the row blocks and the
bags it makes from the seed, a whole run of its runner at a tiny size on 4
gloo ranks (correct, and not correct under the TF32 control or with the
last id of the widest bags dropped), and its metric readers on stand-ins of
rank 0's trace."""

import dataclasses
from types import SimpleNamespace

import pytest
import torch

from portbench import bags, exchange, gen, harness, readers, roofline, spans, trace
from portbench.runners import train_sharded
from portbench.tests.test_portbench_spans import _Event, _host, _kernel, _prof

WORKLOAD = "dlrm_dcnv2_mlperf.train_multihot_rowshard4"


def tiny_cell():
    cell = harness.load_cell(WORKLOAD)
    cfg = dict(cell.config, num_embeddings_per_feature=[50, 7, 300, 3], multi_hot_sizes=[3, 1, 5, 2],
               embedding_dim=8, dense_in_features=3, bottom_mlp=[16, 8], over_arch=[32, 16, 1],
               dcn_num_layers=2, dcn_low_rank_dim=4)
    return dataclasses.replace(cell, config=cfg, traffic=dict(cell.traffic, global_batch=64, pool=8))


def test_the_cell_is_four_cards_of_the_published_widths():
    cell = harness.load_cell(WORKLOAD)
    cfg = cell.config
    assert cell.chips == 4 and cfg["mesh"]["a2a_dtype"] == "float32" and not cfg["mesh"]["row_permute"]
    assert sum(cfg["multi_hot_sizes"]) == 214 and sum(cfg["num_embeddings_per_feature"]) == 204184588
    assert cell.family.input_dim(cfg) == 3456 and cell.family.cross_shape(cfg) == (3456, 512, 3)
    assert cfg["over_arch"] == [1024, 1024, 512, 256, 1] and cfg["bottom_mlp"] == [512, 256, 128]
    assert cell.traffic["global_batch"] % cell.chips == 0 and cell.traffic["runner"] == "train_sharded"


@pytest.mark.parametrize("world", [1, 4])
def test_row_blocks_are_slices_of_the_whole_tables(world):
    seed, vocabs, dim = 2**31 + 5, [37, 5, 130], 8
    whole = gen.make_tables(seed, vocabs, dim, "cpu")
    for t, v in enumerate(vocabs):
        rps = -(-v // (world * 8)) * 8
        for r in range(world):
            block = bags.fill_block(seed, t, v, r * rps, torch.full((rps, dim), 7.0))
            real = max(0, min(rps, v - r * rps))
            assert torch.equal(block[:real], whole[f"field_{t}"][r * rps:r * rps + real])
            assert not block[real:].any()


def test_bags_are_full_and_any_rank_remakes_any_batch():
    seed, tr = 3 * 2**31 + 1, harness.load_cell(WORKLOAD).traffic
    vocabs, widths = [50, 7, 300, 3], [3, 1, 5, 2]
    zipf = bags.sampler(tr, vocabs, "cpu")
    one = bags.batch(seed, tr, vocabs, widths, 3, 16, 2, 5, zipf, "cpu")
    assert one["cat"].shape == (16, 11) and one["cat"].dtype == torch.int32
    limits = torch.tensor([v for v, w in zip(vocabs, widths) for _ in range(w)])
    assert bool((one["cat"] >= 0).all() and (one["cat"] < limits).all())
    g = bags.global_batch(seed, tr, vocabs, widths, 3, 16, 4, 5, zipf, "cpu")
    for k in ("cat", "dense", "label"):
        assert torch.equal(g[k][32:48], one[k])
    assert not torch.equal(bags.batch(seed, tr, vocabs, widths, 3, 16, 2, 6, zipf, "cpu")["cat"], one["cat"])


def test_a_tiny_run_is_correct_and_both_controls_fail():
    torch.set_num_threads(2)
    cell = tiny_cell()
    out = train_sharded.run(cell, 2**32 + 9, 0.3, False, "cpu", 0.0, controls=True)
    correct, _ = harness.judge(out.numbers, cell.limits)
    assert correct and out.failed == 0 and out.attempted > 0
    assert out.ctx.exchange_per_step["lookup_overflow"] == 0
    for role in ("control_tf32", "fault_dropped_id"):
        assert not harness.judge(out.readings[role], cell.limits)[0], (role, out.readings[role])
    e2e = harness.read_metrics(cell.end_to_end, out.ctx)
    assert set(e2e) == {"train_examples_per_s", "setup_s"}
    assert e2e["train_examples_per_s"]["value"] == pytest.approx(out.ctx.units * 64 / out.ctx.window_s)


def test_exposed_communication_is_nccl_time_no_other_op_covers():
    events = [_host(trace.WINDOW_RANGE, 0, 10000),
              _Event("ncclDevKernel_SendRecv(ncclDevComm*)", True, 1000, 3000),
              _kernel(2500, 4000),  # covers 500 ns of it
              _Event("ncclDevKernel_AllReduce_Sum_f32", True, 5000, 5600),
              _kernel(9000, 11000)]
    assert exchange.exposed_comm_s(_prof(events)) == pytest.approx(2100e-9)


def _ctx(world=4, **trace_kw):
    cell = harness.load_cell(WORKLOAD)
    t = trace.TraceSummary(window_s=0.5, busy_s=0.45, device_ops=[
        ("ncclDevKernel_SendRecv(ncclDevComm*, unsigned long, ncclWork*)", 0.09, 20),
        ("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevComm*)", 0.002, 10),
        ("general_rows_kernel<0, true, 1>", 0.2, 30)], idle_gaps=[], units=list(range(10)),
        distinct={}, ids={})
    for k, v in trace_kw.items():
        setattr(t, k, v)
    return train_sharded.ShardedContext(kind="train", cfg=cell.config, traffic=cell.traffic, family=cell.family,
                                        setup_s=1.0, window_s=10.0, units=100, rows_per_unit=65536,
                                        enqueue_s=[0.06] * 100, window_peak_bytes=45 * 2**30, trace=t, world=world)


def test_exchange_readers_read_rank_0s_trace():
    table = spans.SpanTable(units=10, rows={
        "tfrec.step": spans.Row(parent="", self_ns=0),
        "tfrec.exchange.lookup": spans.Row(parent="tfrec.lookup", self_ns=80_000_000),
        "tfrec.exchange.update": spans.Row(parent="tfrec.sparse_update", self_ns=120_000_000),
        "tfrec.bag_pool": spans.Row(parent="tfrec.forward", self_ns=15_000_000)}, sync_ops={})
    # 10 steps, each 3.6 GB sent in all: 2.7 GB of it to the other 3 cards.
    ctx = _ctx(spans=table, exposed_comm_s=0.05, a2a_bytes={"a2a_bytes.ids": 10 * 0.1e9,
                                                            "a2a_bytes.lookup": 10 * 1.75e9,
                                                            "a2a_bytes.update": 10 * 1.75e9})
    read = {m["name"]: harness.metric_reader(m["name"]).read(ctx) for m in harness.load_cell(WORKLOAD).per_layer}
    assert read["exchange_device_ms.train"] == pytest.approx(20.0)
    assert read["bag_pool_device_ms.train"] == pytest.approx(1.5)
    assert read["comm_exposed_share.train"] == pytest.approx(10.0)
    assert read["a2a_roofline.train"] == pytest.approx(100.0 * (27e9 / 450e9) / 0.09)
    # The accepted readers take rank 0's per-card figures as they are.
    assert read["device_idle_share.train"] == pytest.approx(10.0)
    assert read["peak_mem_gib.train"] == pytest.approx(45.0)
    assert read["host_enqueue_ms.train"] == pytest.approx(60.0)
    # The cross's roofline and the MFU at one card's 16 384 rows a step, as
    # the one-card readers count a one-card cell of that batch.
    card = dataclasses.replace(ctx, rows_per_unit=16384)
    bound, _ = roofline.bound_s(*(10 * f(16384, 3456, 512, 3, True)
                                  for f in (roofline.cross_v2_bytes, roofline.cross_v2_flops)))
    assert read["cross_v2_roofline.train_card"] == pytest.approx(100.0 * bound / 0.2)
    assert read["cross_v2_roofline.train_card"] == pytest.approx(readers.cross_v2_share(card, "train"))
    assert read["mfu.train_card"] == pytest.approx(readers.mfu(card, "train"))
    assert read["mfu.train_card"] == pytest.approx(
        100.0 * 3 * ctx.family.forward_flops(ctx.cfg, 16384) * 100 / (10.0 * roofline.PEAK_FLOPS))


def test_exchange_readers_find_nothing_in_a_program_without_them():
    ctx = _ctx()
    for name in ("exchange_device_ms.train", "bag_pool_device_ms.train", "comm_exposed_share.train",
                 "a2a_roofline.train"):
        assert harness.metric_reader(name).read(ctx) is None
    assert harness.metric_reader("a2a_roofline.train").read(SimpleNamespace(kind="serve", trace=None)) is None
    # Off a mesh (one card, or a one-card cell's context) the per-card
    # readers read nothing; on one with no cross kernel traced, no share.
    one = _ctx(world=1)
    for name in ("cross_v2_roofline.train_card", "mfu.train_card"):
        assert harness.metric_reader(name).read(one) is None
        assert harness.metric_reader(name).read(SimpleNamespace(kind="train", trace=None)) is None
    ctx.trace.device_ops = [op for op in ctx.trace.device_ops if "general" not in op[0]]
    assert harness.metric_reader("cross_v2_roofline.train_card").read(ctx) is None
