"""Tiny stand-ins of the benchmark's cells for CPU tests: the cell's own
files, runner, family and limits, at a few rows and narrow widths."""

from __future__ import annotations

import dataclasses

from portbench import harness

VOCABS = [50, 7, 300, 3]


def tiny_cell(workload: str, **limits):
    cell = harness.load_cell(workload)
    cfg = dict(cell.config, num_embeddings_per_feature=VOCABS, embedding_dim=8, dense_in_features=3)
    if cfg["family"] == "dlrm":
        cfg.update(bottom_mlp=[16, 8], top_mlp=[32, 16, 1])
    else:
        cfg.update(dcn_num_layers=2, dcn_low_rank_dim=4, deep_mlp=[16, 8])
    tr = dict(cell.traffic, pool=8)
    if tr["runner"] == "train":
        tr["batch"] = 64
    else:
        tr["rows_per_call"] = 64
    return dataclasses.replace(cell, config=cfg, traffic=tr, limits=dict(cell.limits or {}, **limits))


def cpu_device(peak: int) -> dict:
    return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": peak}
