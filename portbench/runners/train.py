"""Training cells: ``TrainStepBuilder.step``, one batch a call, as
``Trainer.run`` dispatches it at ``steps_per_dispatch = 1``.

Set-up builds one train state from the seed (tables filled on the card by
the counter hash, dense weights from a seeded generator, the port's own
optimizer state), a pool of distinct batches on the card, and drives the
state through its first ``FIRST_STEPS`` steps by the window's own call and
feed, on the pool's first batches. Their readings (each step's loss, the
first gradient's norm a leaf as the optimizer state holds it, the change of
every leaf after the last of them) are kept; the same state then warms up
and runs the window. After the window the state is freed and the plain
reference follows the same steps from the same weights.
"""

from __future__ import annotations

import contextlib
import statistics
from typing import Dict, List

import torch

from portbench import gen
from portbench.runners.common import (
    MIN_TRACE_UNITS, TRACE_SECONDS, Context, Outcome, Phases, distinct_per_column,
    leaf_gaps, now, peak_bytes, release, reset_peak, sync)
from portbench.reference.common import leaves
from portbench.reference.train import train_steps
from portbench.trace import WINDOW_RANGE, profiled, summarize

FIRST_STEPS = 3  # the steps the reference follows
WARM_STEPS = 2  # after the first steps, before the window
# Leaves whose reference gradient is this far under the median leaf's move
# under Adam by round-off alone: their change is not compared.
STILL_LEAF = 1e-3


def optim_config(cfg: dict):
    from tfrec_tpu_torch.configs import OptimConfig

    o = cfg["optimizer"]
    if (o["dense"], o["sparse"]) != ("adam", "rowwise_adagrad"):
        raise ValueError("the training runner reads Adam and rowwise-Adagrad state")
    return OptimConfig(dense_optimizer="adam", sparse_optimizer="rowwise_adagrad",
                       learning_rate=o["learning_rate"], adam_b1=o["adam_b1"], adam_b2=o["adam_b2"],
                       eps=o["eps"], adagrad_init=0.0)


class Program:
    """The port's train state, its step and the pool of batches it eats."""

    def __init__(self, cell, seed: int, device: str):
        from tfrec_tpu_torch.train.step import TrainStepBuilder

        cfg, self.device = cell.config, device
        self.phases = Phases(device)
        if device == "cuda":
            from tfrec_tpu_torch.kernels import _build

            _build.build()  # the first run in a checkout compiles the kernels
        self.phases.mark("kernel build")
        self.vocabs, self.dim = cfg["num_embeddings_per_feature"], cfg["embedding_dim"]
        self.b1 = cfg["optimizer"]["adam_b1"]
        model = cell.family.build(cfg)
        self.builder = TrainStepBuilder(model, "logloss", optim_config(cfg), seed=seed, device=device)
        tables = gen.make_tables(seed, self.vocabs, self.dim, device)
        dense = cell.family.dense_init(cfg, gen.generator(seed, gen.DENSE_STREAM, device), device)
        self.phases.mark("weights")
        self.state = {
            "step": 0,
            "tables": tables,
            "dense": dense,
            "sparse_opt": {n: self.builder.sparse_opt.init(t) for n, t in tables.items()},
            "dense_opt": self.builder.dense_tx.init(dense),
        }
        tr = cell.traffic
        self.rows, self.pool_size = tr["batch"], tr["pool"]
        self.pool = gen.ctr_pool(seed, tr, self.vocabs, cfg["dense_in_features"], self.pool_size,
                                 self.rows, device)
        self.phases.mark("traffic pool")

    def batch(self, k: int) -> Dict[str, torch.Tensor]:
        k %= self.pool_size
        return {"dense": self.pool["dense"][k], "cat": self.pool["cat"][k], "label": self.pool["label"][k]}

    def step(self, k: int) -> torch.Tensor:
        self.state, metrics = self.builder.step(self.state, self.batch(k))
        return metrics["loss"]


def first_steps(prog: Program, cell, seed: int) -> dict:
    """The first steps on pool entries 0.. and the program's readings."""
    losses, grad_norms = [], {}
    for s in range(FIRST_STEPS):
        losses.append(prog.step(s))
        if s == 0:
            # Adam's first moment after one step is (1 - b1) g; rowwise
            # Adagrad's accumulator (from 0) the mean of g^2 over each row.
            mu = leaves(prog.state["dense_opt"]["mu"])
            grad_norms = {f"dense.{k}": (v / (1.0 - prog.b1)).norm() for k, v in mu.items()}
            grad_norms.update({n: (s_["acc"].sum() * prog.dim).sqrt()
                               for n, s_ in prog.state["sparse_opt"].items()})
    dense0 = leaves(cell.family.dense_init(cell.config, gen.generator(seed, gen.DENSE_STREAM, prog.device),
                                           prog.device))
    change = {f"dense.{k}": (v - dense0[k]).norm() for k, v in leaves(prog.state["dense"]).items()}
    cats = prog.pool["cat"][:FIRST_STEPS]
    touched = [torch.unique(cats[:, :, t]).long() for t in range(len(prog.vocabs))]
    for t, rows in enumerate(touched):
        now_rows = prog.state["tables"][f"field_{t}"][rows]
        change[f"field_{t}"] = (now_rows - gen.table_rows(seed, t, rows, prog.dim)).norm()
    batches = [{"cat": torch.stack([torch.searchsorted(touched[t], cats[s, :, t].long())
                                    for t in range(len(touched))], dim=1),
                "dense": prog.pool["dense"][s].clone(), "label": prog.pool["label"][s].clone()}
               for s in range(FIRST_STEPS)]
    prog.phases.mark("first steps and their readings")
    return {"losses": [float(x) for x in losses],
            "grad_norms": {k: float(v) for k, v in grad_norms.items()},
            "change_norms": {k: float(v) for k, v in change.items()},
            "touched": touched, "batches": batches}


def reference_readings(cell, seed: int, first: dict, device: str, precision: str = "float32",
                       keep_rows: int | None = None) -> dict:
    cfg = cell.config
    dense0 = cell.family.dense_init(cfg, gen.generator(seed, gen.DENSE_STREAM, device), device)
    rows0 = [gen.table_rows(seed, t, rows, cfg["embedding_dim"]) for t, rows in enumerate(first["touched"])]
    return train_steps(cell.reference.logits, dense0, rows0, first["batches"], cfg["optimizer"],
                       precision=precision, keep_rows=keep_rows)


def change_gaps(prog: dict, ref: dict) -> Dict[str, float]:
    """Each moving leaf's gap of the change's norm after the first steps."""
    grads = ref["grad_norms"]
    floor = STILL_LEAF * statistics.median(grads.values())
    return leaf_gaps(prog["change_norms"], ref["change_norms"], [k for k, g in grads.items() if g >= floor])


def compare(prog: dict, ref: dict) -> Dict[str, float]:
    """The compared numbers: the worst step's loss gap, relative; the worst
    leaf's gap of the first gradient's norm; the median and the worst moving
    leaf's gap of the change's norm after the first steps. The worst leaf's
    change swings from seed to seed (rows that one example touches in the
    last step update in Adagrad's eps regime and follow their gradient's
    size, which a ReLU that rounding tips moves by percents), so its limit
    sits further above the program's readings than the median's; it still
    catches a fault confined to a few tables, which the median passes."""
    loss = max(abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"]))
    change = change_gaps(prog, ref).values()
    return {"loss_gap": loss,
            "grad_norm_gap": max(leaf_gaps(prog["grad_norms"], ref["grad_norms"]).values()),
            "change_norm_gap": statistics.median(change),
            "worst_change_norm_gap": max(change)}


def _window(prog: Program, start: int, seconds: float, ranged: bool):
    """Steps from pool entry ``start`` until ``seconds`` have passed on the
    host, then a synchronize. -> (next entry, host seconds of each call,
    window seconds)."""
    enqueue: List[float] = []
    k = start
    sync(prog.device)
    t0 = now()
    with torch.profiler.record_function(WINDOW_RANGE) if ranged else contextlib.nullcontext():
        while True:
            a = now()
            if a - t0 >= seconds and (not ranged or len(enqueue) >= MIN_TRACE_UNITS):
                break
            if ranged:
                with torch.profiler.record_function("portbench.step"):
                    prog.step(k)
            else:
                prog.step(k)
            enqueue.append(now() - a)
            k += 1
        sync(prog.device)
    return k, enqueue, now() - t0


def run(cell, seed: int, seconds: float, trace: bool, device: str, t_start: float) -> Outcome:
    prog = Program(cell, seed, device)
    first = first_steps(prog, cell, seed)
    k = FIRST_STEPS
    for _ in range(WARM_STEPS):
        prog.step(k)
        k += 1
    prog.phases.mark("warm-up")
    setup_s = now() - t_start
    prog.phases.report(t_start)
    setup_peak = peak_bytes(device)

    reset_peak(device)
    k, enqueue, window_s = _window(prog, k, seconds, ranged=False)
    ctx = Context(kind="train", cfg=cell.config, traffic=cell.traffic, family=cell.family,
                  setup_s=setup_s, window_s=window_s, units=len(enqueue), rows_per_unit=prog.rows,
                  enqueue_s=enqueue, window_peak_bytes=peak_bytes(device))
    if trace:
        start = k
        with profiled(torch) as p:
            k, _, _ = _window(prog, k, TRACE_SECONDS, ranged=True)
        ctx.trace = summarize(p, [u % prog.pool_size for u in range(start, k)])
        for u in sorted(set(ctx.trace.units)):
            ctx.trace.distinct[u] = distinct_per_column(prog.pool["cat"][u])
            ctx.trace.ids[u] = [prog.rows] * len(prog.vocabs)
    memory_peak = max(setup_peak, peak_bytes(device))

    del prog
    release(device)
    ref = reference_readings(cell, seed, first, device)
    return Outcome(ctx=ctx, numbers=compare(first, ref), attempted=ctx.units, failed=0,
                   memory_peak_bytes=memory_peak)
