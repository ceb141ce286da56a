"""Serving cells: ``tfrec_tpu_torch.serve.Recommender.predict_ctr``, a
closed loop of one caller, each call scoring a batch of candidate rows.

Set-up fills the tables on the card from the seed, makes the dense weights,
builds the ``Recommender`` over them and a pool of distinct requests on the
host (numpy, as a caller hands them), and warms up with a few calls. In the
window the caller sends each call as soon as the one before has returned its
logits, so the rows scored over the window's time are the capacity of one
caller and each latency, call to logits on the host, is the service time.
The answers of a sample of the pool's requests, drawn from the seed, are
kept as served in the window; after it the program is freed and the plain
reference scores the same requests from the same weights.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List

import numpy as np
import torch

from portbench import gen
from portbench.runners.common import (
    MIN_TRACE_UNITS, TRACE_SECONDS, Context, Outcome, Phases, distinct_per_column, now, peak_bytes,
    release, reset_peak, sync)
from portbench.reference.common import matmul_for
from portbench.trace import WINDOW_RANGE, profiled, summarize

SAMPLE_STREAM = 5  # ... of the requests whose answers are compared


class Program:
    """The port's ``Recommender`` over the seed's weights, and the requests."""

    def __init__(self, cell, seed: int, device: str):
        from tfrec_tpu_torch.serve import Recommender

        cfg, tr = cell.config, cell.traffic
        self.device = device
        self.phases = Phases(device)
        if device == "cuda":
            from tfrec_tpu_torch.kernels import _build

            _build.build()
        self.phases.mark("kernel build")
        vocabs, dim = cfg["num_embeddings_per_feature"], cfg["embedding_dim"]
        params = {"tables": gen.make_tables(seed, vocabs, dim, device),
                  "dense": cell.family.dense_init(cfg, gen.generator(seed, gen.DENSE_STREAM, device), device)}
        self.rec = Recommender(cell.family.build(cfg), params, device=device)
        self.phases.mark("weights")
        self.rows, self.pool_size = tr["rows_per_call"], tr["pool"]
        pool = gen.ctr_pool(seed, tr, vocabs, cfg["dense_in_features"], self.pool_size, self.rows, device)
        self.cat = pool["cat"].cpu().numpy()
        self.dense = pool["dense"].cpu().numpy()
        self.phases.mark("traffic pool")

    def call(self, k: int) -> np.ndarray:
        k %= self.pool_size
        return self.rec.predict_ctr(self.dense[k], self.cat[k])


def sample(seed: int, pool: int, count: int) -> List[int]:
    g = torch.Generator().manual_seed(gen.stream_seed(seed, SAMPLE_STREAM))
    return sorted(torch.randperm(pool, generator=g)[:count].tolist())


def window(prog: Program, start: int, seconds: float, keep: Dict[int, np.ndarray] | None, ranged: bool):
    """Calls back to back from pool entry ``start`` until ``seconds`` have
    passed. -> (next entry, each call's latency, window seconds)."""
    latency: List[float] = []
    k = start
    sync(prog.device)
    t0 = now()
    with torch.profiler.record_function(WINDOW_RANGE) if ranged else contextlib.nullcontext():
        while True:
            began = now()
            if began - t0 >= seconds and (not ranged or len(latency) >= MIN_TRACE_UNITS):
                break
            if ranged:
                with torch.profiler.record_function("portbench.call"):
                    out = prog.call(k)
            else:
                out = prog.call(k)
            latency.append(now() - began)
            j = k % prog.pool_size
            if keep is not None and j in keep and keep[j] is None:  # its first answer in the window
                keep[j] = out
            k += 1
    return k, latency, now() - t0


def reference_logits(cell, seed: int, requests: Dict[int, tuple], device: str,
                     precision: str = "float32") -> Dict[int, torch.Tensor]:
    """The reference's logits of each request (cat, dense), its rows and
    weights made again from the seed."""
    cfg = cell.config
    weights = cell.family.dense_init(cfg, gen.generator(seed, gen.DENSE_STREAM, device), device)
    out = {}
    for k, (cat, dense) in requests.items():
        ids = torch.from_numpy(cat).to(device).long()
        emb = torch.stack([gen.table_rows(seed, t, ids[:, t], cfg["embedding_dim"])
                           for t in range(ids.shape[1])], dim=1)
        with torch.no_grad():
            out[k] = cell.reference.logits(weights, emb, torch.from_numpy(dense).to(device),
                                           matmul_for(precision))
    return out


def logit_gap(served: Dict[int, np.ndarray], ref: Dict[int, torch.Tensor]) -> float:
    """The widest gap of a served logit from the reference's, over the RMS
    of the reference's logits of the compared requests."""
    keys = sorted(served)
    got = torch.cat([torch.as_tensor(served[k], dtype=torch.float32).reshape(-1) for k in keys])
    want = torch.cat([ref[k].float().cpu().reshape(-1) for k in keys])
    if got.shape != want.shape:
        return float("inf")
    return float((got - want).abs().max() / want.pow(2).mean().sqrt())


def run(cell, seed: int, seconds: float, trace: bool, device: str, t_start: float) -> Outcome:
    tr = cell.traffic
    prog = Program(cell, seed, device)
    for k in range(tr["warm_calls"]):
        prog.call(k)
    prog.phases.mark("warm-up")
    setup_s = now() - t_start
    prog.phases.report(t_start)
    setup_peak = peak_bytes(device)

    keep = {k: None for k in sample(seed, prog.pool_size, tr["compared_calls"])}
    reset_peak(device)
    k, latency, window_s = window(prog, tr["warm_calls"], seconds, keep, False)
    ctx = Context(kind="serve", cfg=cell.config, traffic=tr, family=cell.family, setup_s=setup_s,
                  window_s=window_s, units=len(latency), rows_per_unit=prog.rows, latency_s=latency,
                  window_peak_bytes=peak_bytes(device))
    if trace:
        start = k
        with profiled(torch) as p:
            k, *_ = window(prog, k, TRACE_SECONDS, None, True)
        ctx.trace = summarize(p, [u % prog.pool_size for u in range(start, k)])
        for u in sorted(set(ctx.trace.units)):
            ctx.trace.distinct[u] = distinct_per_column(torch.from_numpy(prog.cat[u]))
            ctx.trace.ids[u] = [prog.rows] * prog.cat.shape[2]
    memory_peak = max(setup_peak, peak_bytes(device))
    served = {k: v for k, v in keep.items() if v is not None}
    requests = {k: (prog.cat[k], prog.dense[k]) for k in served}

    del prog
    release(device)
    ref = reference_logits(cell, seed, requests, device)
    numbers = {"logit_gap": logit_gap(served, ref) if served else float("inf")}
    return Outcome(ctx=ctx, numbers=numbers, attempted=ctx.units, failed=0, memory_peak_bytes=memory_peak)
