"""Training cells on several cards: ``parallel/step.ShardedTrainStepBuilder``,
one process and one card a rank, driven as the port's sharded ``Trainer``
drives it: one batch a call, every table row-sharded over the mesh's data
axis, the dense params replicated.

``run`` is rank 0, in ``run.py``'s own process. It starts ranks 1 .. N-1
(``python -m portbench.runners.train_sharded``, each handed the cell as
JSON), all join one process group (NCCL on cards, gloo on the CPU, at a
free port of this host) and a gloo group of their own for the window's
control. A rank that fails ends the run: rank 0 watches its ranks and a rank
watches rank 0, and a collective that waits longer than ``TIMEOUT_S`` fails.

Each rank fills only its own block of each table (``bags.fill_block``), its
optimizer state, the dense params from the seed, and a pool of its rows of
the global batches (``bags.pool``). The first ``FIRST_STEPS`` steps are read
as in the one-card runner (the loss of each, the first gradient's norm a
leaf, the change's norm a leaf after them), a table's norms summed over the
ranks' blocks, every norm taken in float64; warm-up follows. The window is rank 0's: after a barrier it
steps until ``--seconds`` have passed on its clock, each step's go or stop
broadcast to the others, then synchronizes. Rank 0 alone is traced. What
each exchange moved comes from ``Mesh.counters``; the memory peak is the
fullest card's; every step's ``lookup_overflow`` is kept, and a window step
that dropped ids counts as failed. After the last collective rank 0 frees
the program and runs the plain reference over the global batch in blocks;
the compared numbers are the one-card runner's.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import importlib
import json
import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Dict, List

import torch

from portbench import bags, exchange, gen, spans
from portbench.reference.common import leaves
from portbench.reference.train_bags import train_steps_bags
from portbench.runners.common import (
    MIN_TRACE_UNITS, TRACE_SECONDS, Context, Outcome, Phases, leaf_gaps, now, peak_bytes, release,
    reset_peak, sync)
from portbench.runners.train import FIRST_STEPS, WARM_STEPS, change_gaps, compare, optim_config
from portbench.trace import WINDOW_RANGE, profiled, summarize

ROOT = Path(__file__).resolve().parents[2]
TIMEOUT_S = 300.0  # the longest a collective may wait for a rank
WATCH_S = 0.5


@dataclasses.dataclass
class ShardedContext(Context):
    """``Context`` with the mesh's size and, per step of the measured
    window, what rank 0's exchange moved."""

    world: int = 1
    exchange_per_step: Dict[str, float] = dataclasses.field(default_factory=dict)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _cell_doc(cell) -> str:
    return json.dumps({"name": cell.name, "chips": cell.chips, "config": cell.config,
                       "traffic": cell.traffic})


def _mesh_config(cfg: dict):
    from tfrec_tpu_torch.configs import MeshConfig

    return MeshConfig(data_axis_size=-1, **cfg["mesh"])


def _counters(mesh) -> dict:
    return dict(getattr(mesh, "counters", {}))


def _delta(after: dict, before: dict) -> Dict[str, float]:
    return {k: float(v - before.get(k, 0)) for k, v in after.items()}


class _Rank:
    """One rank's train state, step and pool."""

    def __init__(self, doc: dict, seed: int, device: str, rank: int, world: int, init_method: str):
        import torch.distributed as dist

        from tfrec_tpu_torch.parallel.mesh import init_distributed, make_mesh
        from tfrec_tpu_torch.parallel.step import ShardedTrainStepBuilder

        cfg, tr = doc["config"], doc["traffic"]
        self.cfg, self.traffic, self.seed, self.rank, self.world = cfg, tr, seed, rank, world
        self.family = importlib.import_module(f"portbench.families.{cfg['family']}")
        dev = init_distributed(init_method, world, rank, device=device, timeout_s=TIMEOUT_S)
        self.device = "cuda" if dev.type == "cuda" else "cpu"
        self.phases = Phases(self.device)
        self.mesh = make_mesh(device=dev)
        self.dev = self.mesh.device
        self.control = dist.new_group(backend="gloo", timeout=datetime.timedelta(seconds=TIMEOUT_S))
        self.phases.mark("process group")
        self.vocabs, self.widths = cfg["num_embeddings_per_feature"], cfg["multi_hot_sizes"]
        self.dim, self.num_dense = cfg["embedding_dim"], cfg["dense_in_features"]
        self.b1 = cfg["optimizer"]["adam_b1"]
        model = self.family.build(cfg)
        self.builder = ShardedTrainStepBuilder(model, "logloss", optim_config(cfg), self.mesh,
                                               _mesh_config(cfg), seed=seed)
        tables = {}
        for t, spec in enumerate(model.table_specs()):
            plan = self.builder.plans[spec.name]
            block = torch.empty((plan.rows_per_shard, spec.dim), dtype=torch.float32, device=self.dev)
            tables[spec.name] = bags.fill_block(seed, t, plan.vocab, plan.base, block)
        self.names = list(tables)
        dense = self.family.dense_init(cfg, gen.generator(seed, gen.DENSE_STREAM, self.dev), self.dev)
        self.state = {
            "step": 0,
            "tables": tables,
            "dense": dense,
            "sparse_opt": {n: self.builder.sparse_opt.init(t) for n, t in tables.items()},
            "dense_opt": self.builder.dense_tx.init(dense),
        }
        self.phases.mark("weights")
        self.rows = tr["global_batch"] // world
        self.zipf = bags.sampler(tr, self.vocabs, self.dev)
        self.pool_size = tr["pool"]
        self.pool = bags.pool(seed, tr, self.vocabs, self.widths, self.num_dense, self.pool_size,
                              self.rows, rank, self.zipf, self.dev)
        self.overflow: List[torch.Tensor] = []
        self.phases.mark("traffic pool")

    def step(self, k: int) -> torch.Tensor:
        self.state, metrics = self.builder.step(self.state, self.pool[k % self.pool_size])
        self.overflow.append(metrics["lookup_overflow"])
        return metrics["loss"]

    def all_sum(self, t: torch.Tensor) -> torch.Tensor:
        return self.mesh.all_sum(t)

    def global_batch(self, k: int) -> Dict[str, torch.Tensor]:
        return bags.global_batch(self.seed, self.traffic, self.vocabs, self.widths, self.num_dense,
                                 self.rows, self.world, k, self.zipf, self.dev)

    def first_steps(self) -> dict:
        """The first steps on pool entries 0.. and the program's readings
        (a table's summed over the ranks' blocks); every rank returns them,
        with the global batches and touched rows the reference needs."""
        losses, grad_norms = [], {}
        for s in range(FIRST_STEPS):
            losses.append(self.step(s))
            if s == 0:
                # Adam's first moment after one step is (1 - b1) g; rowwise
                # Adagrad's accumulator (from 0) the mean of g^2 over each row.
                mu = leaves(self.state["dense_opt"]["mu"])
                grad_norms = {f"dense.{k}": (v.double() / (1.0 - self.b1)).norm() for k, v in mu.items()}
                sq = self.all_sum(torch.stack([st["acc"].double().sum() * self.dim
                                               for st in self.state["sparse_opt"].values()]))
                grad_norms.update({n: x.sqrt() for n, x in zip(self.names, sq)})
        dense0 = leaves(self.family.dense_init(self.cfg, gen.generator(self.seed, gen.DENSE_STREAM, self.dev),
                                               self.dev))
        change = {f"dense.{k}": (v.double() - dense0[k].double()).norm()
                  for k, v in leaves(self.state["dense"]).items()}
        batches = [self.global_batch(s) for s in range(FIRST_STEPS)]
        cats = torch.stack([b["cat"] for b in batches])  # [S, B, sum W]
        offsets = [sum(self.widths[:f]) for f in range(len(self.widths))]
        touched, sq = [], []
        for t, (name, off, w) in enumerate(zip(self.names, offsets, self.widths)):
            rows = torch.unique(cats[:, :, off:off + w]).long()
            touched.append(rows)
            plan = self.builder.plans[name]
            mine = rows[(rows >= plan.base) & (rows < plan.base + plan.rows_per_shard)]
            now_rows = self.state["tables"][name][mine - plan.base]
            sq.append(((now_rows.double() - gen.table_rows(self.seed, t, mine, self.dim).double()) ** 2).sum())
        change.update({n: x.sqrt() for n, x in zip(self.names, self.all_sum(torch.stack(sq)))})
        compact = []
        for s, b in enumerate(batches):
            cols = [torch.searchsorted(touched[t], cats[s, :, off:off + w].long())
                    for t, (off, w) in enumerate(zip(offsets, self.widths))]
            compact.append({"cat": torch.cat(cols, dim=1), "dense": b["dense"], "label": b["label"]})
        self.phases.mark("first steps and their readings")
        return {"losses": [float(x) for x in losses],
                "grad_norms": {k: float(v) for k, v in grad_norms.items()},
                "change_norms": {k: float(v) for k, v in change.items()},
                "touched": touched, "batches": compact}

    def window(self, start: int, seconds: float, ranged: bool):
        """Steps from pool entry ``start`` until ``seconds`` have passed on
        rank 0's host, after a barrier, then a synchronize. -> (next entry,
        host seconds of each call, window seconds)."""
        import torch.distributed as dist

        enqueue: List[float] = []
        k = start
        go = torch.zeros(1, dtype=torch.int32)
        sync(self.device)
        self.mesh.barrier()
        sync(self.device)
        t0 = now()
        with torch.profiler.record_function(WINDOW_RANGE) if ranged else contextlib.nullcontext():
            while True:
                a = now()
                go[0] = int(a - t0 < seconds or (ranged and len(enqueue) < MIN_TRACE_UNITS))
                dist.broadcast(go, src=0, group=self.control)
                if not go[0]:
                    break
                if ranged:
                    with torch.profiler.record_function("portbench.step"):
                        self.step(k)
                else:
                    self.step(k)
                enqueue.append(now() - a)
                k += 1
            sync(self.device)
        return k, enqueue, now() - t0

    def gathered_max(self, values: List[int]) -> List[int]:
        """Each value's largest over the ranks."""
        x = self.mesh.all_gather(torch.tensor(values, dtype=torch.int64, device=self.dev)[None])
        return [int(v) for v in x.max(dim=0).values]


def rank_main(doc: dict, seed: int, seconds: float, trace: bool, device: str, rank: int, world: int,
              init_method: str, t_start: float, controls: bool = False):
    """Everything a rank does; rank 0 returns the run's ``Outcome``."""
    import torch.distributed as dist

    r = _Rank(doc, seed, device, rank, world, init_method)
    first = r.first_steps()
    k = FIRST_STEPS
    for _ in range(WARM_STEPS):
        r.step(k)
        k += 1
    r.phases.mark("warm-up")
    setup_s = now() - t_start
    if rank == 0:
        r.phases.report(t_start)
    setup_peak = peak_bytes(r.device)

    reset_peak(r.device)
    before = _counters(r.mesh)
    window_from = len(r.overflow)
    k, enqueue, window_s = r.window(k, seconds, ranged=False)
    window_to = len(r.overflow)
    per_step = _delta(_counters(r.mesh), before)
    units = len(enqueue)
    window_peak = peak_bytes(r.device)
    host = torch.tensor(enqueue or [0.0], dtype=torch.float64)
    host_by_rank = r.mesh.all_gather(torch.tensor(
        [[float(host.median()) * 1e3, float(host.max()) * 1e3, window_s]], dtype=torch.float64, device=r.dev))
    ctx = None
    if rank == 0:
        ctx = ShardedContext(kind="train", cfg=r.cfg, traffic=r.traffic, family=r.family, setup_s=setup_s,
                             window_s=window_s, units=units, rows_per_unit=r.traffic["global_batch"],
                             enqueue_s=enqueue, world=world,
                             exchange_per_step={n: v / max(units, 1) for n, v in per_step.items()})
    if trace:
        start, before = k, _counters(r.mesh)
        if rank == 0:
            with profiled(torch) as p:
                k, _, _ = r.window(k, TRACE_SECONDS, ranged=True)
            steps = [u % r.pool_size for u in range(start, k)]
            ctx.trace = summarize(p, steps)
            ctx.trace.spans = spans.reduce(p, len(steps))
            print(spans.format_table(ctx.trace.spans), file=sys.stderr)
            ctx.trace.exposed_comm_s = exchange.exposed_comm_s(p)
            ctx.trace.a2a_bytes = {t: v for t, v in _delta(_counters(r.mesh), before).items()
                                   if t.startswith("a2a_bytes.")}
        else:
            k, _, _ = r.window(k, TRACE_SECONDS, ranged=True)
    overflow = torch.stack(r.overflow).cpu()  # each step's, summed over ranks
    setup_max, window_max, total_max = r.gathered_max(
        [setup_peak, window_peak, max(setup_peak, peak_bytes(r.device))])
    sent_by_rank = r.mesh.all_gather(torch.tensor([per_step.get("distinct_sent", 0.0)], dtype=torch.float64,
                                                  device=r.dev))
    del r.state, r.pool
    dist.destroy_process_group()
    if rank != 0:
        return None
    ctx.window_peak_bytes = window_max
    print("host ms a step of the window by rank (median, max; window s): "
          f"{[[round(float(x), 3) for x in row] for row in host_by_rank]}", file=sys.stderr)
    print(f"exchange: rank 0 a step of the window: {json.dumps(ctx.exchange_per_step)}; distinct ids sent "
          f"a step by rank: {[round(float(x) / max(units, 1)) for x in sent_by_rank]}; lookup_overflow "
          f"over all {len(overflow)} steps: {int(overflow.sum())}; memory peak by the fullest card: set-up "
          f"{setup_max}, window {window_max}", file=sys.stderr)
    failed = int((overflow[window_from:window_to] > 0).sum())
    cfg = r.cfg
    family, model_ref = r.family, importlib.import_module(f"portbench.reference.{cfg['family']}")
    dev = r.dev
    del r
    release(device)
    dense0 = family.dense_init(cfg, gen.generator(seed, gen.DENSE_STREAM, dev), dev)
    rows0 = [gen.table_rows(seed, t, rows, cfg["embedding_dim"]) for t, rows in enumerate(first["touched"])]

    def reference(**kw):
        return train_steps_bags(model_ref.logits, dense0, rows0, first["batches"], cfg["multi_hot_sizes"],
                                cfg["optimizer"], **kw)

    ref = reference()
    numbers = compare(first, ref)
    print(f"loss gap a step: {[abs(g - w) / abs(w) for g, w in zip(first['losses'], ref['losses'])]}",
          file=sys.stderr)
    outcome = Outcome(ctx=ctx, numbers=numbers, attempted=units, failed=failed, memory_peak_bytes=total_max)
    if controls:
        tf32 = reference(precision="tf32")
        f64 = reference(precision="float64")
        outcome.readings = {
            "against_float64": {role: compare(got, f64) for role, got in
                                (("program", first), ("reference", ref), ("control_tf32", tf32))},
            "program": numbers,
            "control_tf32": compare(tf32, ref),
            "fault_dropped_id": compare(reference(drop_last_of=max(cfg["multi_hot_sizes"])), ref),
            "losses": first["losses"],
            "loss_gaps": [abs(got - want) / abs(want) for got, want in zip(first["losses"], ref["losses"])],
            "worst_leaves": {role: _worst_leaves(got, ref) for role, got in (("program", first),
                                                                              ("control_tf32", tf32))}}
    return outcome


def _worst_leaves(got: dict, ref: dict, top: int = 3) -> dict:
    """The leaves of the largest gaps of the first gradient's and of the
    change's norm, for the calibration's record."""
    grads = leaf_gaps(got["grad_norms"], ref["grad_norms"])
    changes = change_gaps(got, ref)
    return {name: sorted(((k, v) for k, v in gaps.items()), key=lambda kv: -kv[1])[:top]
            for name, gaps in (("grad", grads), ("change", changes))}


# ---- rank 0 starts and watches the others ----


def _watch(procs, done: threading.Event) -> None:
    """Ends this process as soon as a rank fails."""
    while not done.wait(WATCH_S):
        for rank, p in enumerate(procs, start=1):
            code = p.poll()
            if code not in (None, 0):
                print(f"portbench: rank {rank} exited {code}; ending the run", file=sys.stderr, flush=True)
                for q in procs:
                    if q.poll() is None:
                        q.kill()
                os._exit(1)


def run(cell, seed: int, seconds: float, trace: bool, device: str, t_start: float,
        controls: bool = False) -> Outcome:
    world = cell.chips
    cell.family.build(cell.config)  # a program without this model fails here, before any rank starts
    if device == "cuda":
        from tfrec_tpu_torch.kernels import _build

        _build.build()  # once, before the ranks load the kernels
    init_method = f"tcp://127.0.0.1:{_free_port()}"
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    doc = _cell_doc(cell)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "portbench.runners.train_sharded", doc, str(seed), repr(float(seconds)),
         str(int(trace)), device, str(rank), str(world), init_method, str(os.getpid())],
        cwd=str(ROOT), env=env, stdout=sys.stderr.fileno()) for rank in range(1, world)]
    done = threading.Event()
    threading.Thread(target=_watch, args=(procs, done), daemon=True).start()
    try:
        outcome = rank_main(json.loads(doc), seed, seconds, trace, device, 0, world, init_method, t_start,
                            controls=controls)
        done.set()
        for rank, p in enumerate(procs, start=1):
            code = p.wait(timeout=TIMEOUT_S)
            if code != 0:
                raise RuntimeError(f"rank {rank} exited {code}")
    except BaseException:
        done.set()
        for p in procs:
            if p.poll() is None:
                p.kill()
        raise
    return outcome


def _watch_parent(parent: int) -> None:
    """Ends this rank as soon as rank 0's process is gone."""
    while True:
        time.sleep(WATCH_S)
        if os.getppid() != parent:
            os._exit(1)


def worker(argv: List[str]) -> int:
    doc, seed, seconds, trace, device, rank, world, init_method, parent = argv
    threading.Thread(target=_watch_parent, args=(int(parent),), daemon=True).start()
    if device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    else:
        torch.set_num_threads(1)
    rank_main(json.loads(doc), int(seed), float(seconds), bool(int(trace)), device, int(rank), int(world),
              init_method, now())
    from portbench import harness

    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: rank {rank}: modules of JAX or of the JAX package are loaded: {bad}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(worker(sys.argv[1:]))
