"""Rank processes for the port's sharded tests (tests/test_torch_parallel.py,
tests/test_torch_sharded_trainer.py, tests/test_torch_colshard.py,
tests/test_torch_mesh_retrieval.py): ``run_ranks`` starts N processes of
this file on the CPU, joined in one gloo group, each running one job (a
function below) on a pickled spec, and returns rank 0's pickled result. A
job gets the mesh of the spec's ``table_axis`` (default 1) over the N
ranks and may make others. A hard time limit kills every rank. Only torch
and the port are imported here: the processes never load JAX."""

from __future__ import annotations

import os
import pickle
import socket
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(job: str, world: int, spec: dict, work: Path, timeout: float = 120.0):
    """Run ``job`` on ``world`` ranks over gloo -> rank 0's result. Raises
    with every rank's output if a rank fails or the time limit passes."""
    work = Path(work)
    work.mkdir(parents=True, exist_ok=True)
    spec_path = work / f"{job}_{world}.spec.pkl"
    out_path = work / f"{job}_{world}.out.pkl"
    with open(spec_path, "wb") as f:
        pickle.dump(spec, f)
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, __file__, job, str(rank), str(world), str(port), str(spec_path),
         str(out_path)],
        cwd=str(work), env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(world)]
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(deadline - time.monotonic(), 1.0))[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.wait()
        raise RuntimeError(f"{job} on {world} ranks passed its {timeout} s limit")
    if any(p.returncode for p in procs):
        raise RuntimeError(f"{job} on {world} ranks failed:\n" + "\n".join(
            f"--- rank {r} (exit {p.returncode}):\n{out[-4000:]}"
            for r, (p, out) in enumerate(zip(procs, outs))))
    with open(out_path, "rb") as f:
        return pickle.load(f)


# ---- inside a rank ----


def _np(tree):
    import torch

    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_np(v) for v in tree)
    # A copy: a CPU tensor's numpy view would follow its in-place updates.
    return tree.detach().cpu().numpy().copy() if isinstance(tree, torch.Tensor) else tree


def _tensors(tree):
    import numpy as np
    import torch

    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tensors(v) for v in tree)
    return torch.from_numpy(np.array(tree)) if isinstance(tree, np.ndarray) else tree


def _rows(x, rank, world):
    """This rank's contiguous block of a global batch's leading axis."""
    n = x.shape[0] // world
    return x[rank * n:(rank + 1) * n]


def _unshard(state, plans):
    """The global logical state, as numpy, from every rank's blocks of a
    sharded state (a collective: every rank calls it)."""
    out = dict(state, tables={}, sparse_opt={})
    for name, table in state["tables"].items():
        plan = plans.get(name)

        def whole(x):
            return plan.unshard(x) if plan is not None else x

        out["tables"][name] = whole(table)
        out["sparse_opt"][name] = {k: whole(v) for k, v in state["sparse_opt"][name].items()}
    return _np(out)


def _model(spec):
    from tfrec_tpu_torch.configs import ModelConfig
    from tfrec_tpu_torch.models import DataSpec, build_model

    kind, args = spec["data_spec"]
    data_spec = DataSpec.ctr(*args) if kind == "ctr" else DataSpec.interaction(*args)
    return build_model(ModelConfig(**spec["model"]), data_spec)


def job_parallel(spec, mesh):
    """Every sharded check at this world size: lookups, updates under each
    optimizer, the bf16 wire, skewed ids' overflow, and 3 steps of the
    sharded builder under each exchange option."""
    import torch

    from tfrec_tpu_torch import convert
    from tfrec_tpu_torch.configs import MeshConfig, OptimConfig
    from tfrec_tpu_torch.ops.sparse_optim import make_sparse_optimizer
    from tfrec_tpu_torch.parallel.embedding import RowShardedTable, exchange_lookup, exchange_update
    from tfrec_tpu_torch.parallel.step import ShardedTrainStepBuilder

    def lookup(plan, table, ids):
        rows, ovf, _ = exchange_lookup(mesh, [plan], [plan.shard_rows(torch.from_numpy(table))],
                                       [torch.from_numpy(_rows(ids, r, n))])
        return _np(mesh.all_gather(rows[0])), int(ovf)

    r, n = mesh.rank, mesh.size
    out = {}
    t = spec["table"]
    for wire in ("float32", "bfloat16"):
        plan = RowShardedTable(mesh, t["vocab"], t["dim"],
                               wire_dtype=torch.bfloat16 if wire == "bfloat16" else None)
        out[f"lookup_{wire}"] = lookup(plan, t["table"], t["ids"])
        for opt_name in t["optimizers"] if wire == "float32" else ("rowwise_adagrad",):
            opt = make_sparse_optimizer(opt_name, adagrad_init=0.05)
            table = torch.from_numpy(t["table"])
            state = opt.init(table.clone())
            block, sblock = plan.shard_rows(table), {k: plan.shard_rows(v) for k, v in state.items()}
            new_t, new_s, ovf = exchange_update(
                mesh, [plan], [block], [sblock], [torch.from_numpy(_rows(t["ids"], r, n))],
                [torch.from_numpy(_rows(t["grads"], r, n))], opt, 0.1)
            out[f"update_{opt_name}_{wire}"] = (
                _np(plan.unshard_rows(new_t[0])),
                _np({k: plan.unshard_rows(v) for k, v in new_s[0].items()}), int(ovf))
    skew = spec["skew"]
    for permute in (False, True):
        plan = RowShardedTable(mesh, skew["vocab"], skew["dim"], permute=permute,
                               capacity_factor=skew["factor"])
        out[f"skew_{permute}"] = lookup(plan, skew["table"], skew["ids"])
    for name, steps in spec["steps"].items():
        model = _model(steps)
        ocfg = OptimConfig(**steps["optim"])
        for variant, mesh_kw in steps["variants"].items():
            if mesh_kw.get("row_permute") and model.dot_decomposition() is not None:
                continue  # refused for retrieval models (the test checks it)
            builder = ShardedTrainStepBuilder(model, steps["loss"], ocfg, mesh, MeshConfig(**mesh_kw),
                                              l2_reg=steps.get("l2_reg", 0.0))
            state = convert.shard_state(_tensors(steps["state"]), mesh, builder.plans)
            losses, overflow = [], []
            for batch in steps["batches"]:
                local = {k: torch.from_numpy(_rows(v, r, n)) for k, v in batch.items()}
                state, metrics = builder.step(state, local)
                losses.append(float(metrics["loss"]))
                overflow.append(int(metrics["lookup_overflow"]))
            # Every rank's copy of each replicated table, equal to this one's.
            replicas_equal = all(
                bool((mesh.all_gather(tb).view((n,) + tuple(tb.shape)) == tb).all())
                for k, tb in state["tables"].items() if builder.plans[k] is None)
            out[f"{name}_{variant}"] = {"state": _unshard(state, builder.plans),
                                        "losses": losses, "overflow": overflow,
                                        "replicas_equal": replicas_equal}
    return out


def job_trainer(spec, mesh):
    """A ``Trainer`` on the ranks for each run of the spec, in order, after
    rank 0 copies the run's checkpoints in (``copy``: (source, target)
    directories) -> {run: {"history", "start_epoch", "restored" and
    "state", global and logical}}; for each config of ``refused``, the
    ValueError that building its Trainer raised on this rank."""
    import shutil

    from tfrec_tpu_torch.train.trainer import Trainer

    out = {}
    for name, cfg, copy in spec["runs"]:
        if copy and mesh.rank == 0:
            shutil.copytree(*copy)
        mesh.barrier()
        trainer = Trainer(cfg, quiet=True, device="cpu")
        restored = _unshard(trainer.state, trainer.builder.plans)
        history = trainer.train()
        out[name] = {"history": history, "start_epoch": trainer.start_epoch, "restored": restored,
                     "state": _unshard(trainer.state, trainer.builder.plans),
                     "mesh": dict(trainer.mesh.shape)}
        if name in spec.get("serve", {}):  # the params and recommend of the live mesh
            from tfrec_tpu_torch.serve import Recommender

            users, k = spec["serve"][name]
            out[name]["params"] = _np(trainer.params)
            out[name]["recommend"] = Recommender.from_trainer(trainer).recommend(users, k)
    for name, cfg in spec.get("refused", ()):
        try:
            Trainer(cfg, quiet=True, device="cpu")
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


def _col_steps(spec, mesh, mesh_kw):
    """3 steps of each case of ``spec["steps"]`` on the sharded builder
    with ``mesh_kw`` -> {case: {"state" (global, logical), "losses",
    "overflow"}}."""
    import torch

    from tfrec_tpu_torch import convert
    from tfrec_tpu_torch.configs import MeshConfig, OptimConfig
    from tfrec_tpu_torch.parallel.step import ShardedTrainStepBuilder

    out = {}
    r, n = mesh.data_index, mesh.size
    for name, steps in spec["steps"].items():
        builder = ShardedTrainStepBuilder(_model(steps), steps["loss"], OptimConfig(**steps["optim"]),
                                          mesh, MeshConfig(**mesh_kw), l2_reg=steps.get("l2_reg", 0.0))
        state = convert.shard_state(_tensors(steps["state"]), mesh, builder.plans)
        losses, overflow = [], []
        for batch in steps["batches"]:
            local = {k: torch.from_numpy(_rows(v, r, n)) for k, v in batch.items()}
            state, metrics = builder.step(state, local)
            losses.append(float(metrics["loss"]))
            overflow.append(int(metrics["lookup_overflow"]))
        out[name] = {"state": _np(builder.logical_state(state)), "losses": losses,
                     "overflow": overflow,
                     "kinds": {k: type(p).__name__ for k, p in builder.plans.items()}}
    return out


def job_colshard(spec, mesh):
    """Column-sharded tables on the spec's (D, T) mesh: the lookup, the
    update under each optimizer, a small capacity's overflow, and 3 col
    steps of each case -> rank 0's global results."""
    import torch

    from tfrec_tpu_torch.ops.sparse_optim import make_sparse_optimizer
    from tfrec_tpu_torch.parallel.embedding import ColShardedTable, col_lookup, col_update

    r, n = mesh.data_index, mesh.size
    t = spec["table"]
    table = torch.from_numpy(t["table"])
    ids, grads = torch.from_numpy(_rows(t["ids"], r, n)), torch.from_numpy(_rows(t["grads"], r, n))
    out = {"shape": dict(mesh.shape)}
    plan = ColShardedTable(mesh, t["vocab"], t["dim"])
    rows, ovf = col_lookup(mesh, [plan], [plan.shard(table)], [ids])
    out["lookup"] = (_np(mesh.all_gather(rows[0])), int(ovf))
    for opt_name in t["optimizers"]:
        for factor in (2.0, t["small_factor"]):
            opt = make_sparse_optimizer(opt_name, adagrad_init=0.05)
            p = ColShardedTable(mesh, t["vocab"], t["dim"], capacity_factor=factor)
            state = opt.init(table.clone())
            new_t, new_s, ovf = col_update(
                mesh, [p], [p.shard(table)], [{k: p.shard(v) for k, v in state.items()}], [ids],
                [grads], opt, 0.1)
            out[f"update_{opt_name}_{factor}"] = (
                _np(p.unshard(new_t[0])), {k: _np(p.unshard(v)) for k, v in new_s[0].items()},
                int(mesh.all_sum(ovf)))
    # Two tables of one shape in one call: each bit for bit its own call.
    opt = make_sparse_optimizer("rowwise_adagrad", adagrad_init=0.05)
    pair = [ColShardedTable(mesh, t["vocab"], t["dim"]) for _ in range(2)]
    tabs = [table, table.flip(0).contiguous()]
    pair_ids = [ids, ids.flip(0).contiguous()]
    pair_grads = [grads, 2.0 * grads]
    alone = [col_update(mesh, [p], [p.shard(tb)], [{k: p.shard(v) for k, v in opt.init(tb).items()}],
                        [i], [g], opt, 0.1) for p, tb, i, g in zip(pair, tabs, pair_ids, pair_grads)]
    both = col_update(mesh, pair, [p.shard(tb) for p, tb in zip(pair, tabs)],
                      [{k: p.shard(v) for k, v in opt.init(tb).items()} for p, tb in zip(pair, tabs)],
                      pair_ids, pair_grads, opt, 0.1)
    out["pair_bitwise"] = all(
        torch.equal(both[0][j], alone[j][0][0]) and torch.equal(both[1][j]["acc"], alone[j][1][0]["acc"])
        for j in range(2)) and int(both[2]) == sum(int(a[2]) for a in alone)
    out["steps"] = _col_steps(spec, mesh, dict(a2a_dtype="float32", table_sharding="col"))
    return out


def job_retrieval(spec, mesh):
    """The retrieval parts on the meshes of ``spec["meshes"]`` (table axes
    over these ranks): ``sharded_topk_dot`` (bias, exclusions, a small
    catalog), ``sharded_row_gather`` and ``ShardedRetrievalEvaluator`` of
    each model under each table sharding; then the trainer runs of
    ``spec["trainer"]``, if any."""
    import torch

    from tfrec_tpu_torch import convert
    from tfrec_tpu_torch.configs import DataConfig, MeshConfig, OptimConfig
    from tfrec_tpu_torch.data.dataset import build_dataset
    from tfrec_tpu_torch.parallel.eval import ShardedRetrievalEvaluator, sharded_row_gather
    from tfrec_tpu_torch.parallel.mesh import make_mesh
    from tfrec_tpu_torch.parallel.step import ShardedTrainStepBuilder
    from tfrec_tpu_torch.parallel.topk import sharded_topk_dot

    out = {}
    dataset = build_dataset(DataConfig(**spec["data"]))
    for t_axis in spec["meshes"]:
        m = mesh if t_axis == mesh.shape["table"] else make_mesh(-1, t_axis, device="cpu")
        key = f"{m.size}x{t_axis}"
        rps = spec["topk"]["table"].shape[0] // m.size

        def block(x):
            return torch.from_numpy(x[m.data_index * rps:(m.data_index + 1) * rps])

        tk = spec["topk"]
        res = {}
        for case, (k, num_items, with_bias, excl) in tk["cases"].items():
            if excl:
                kw = {"exclude_padded": torch.from_numpy(tk["exc_p"]),
                      "exclude_counts": torch.from_numpy(tk["exc_c"])}
            else:
                kw = {}
            res[case] = _np(sharded_topk_dot(m, torch.from_numpy(tk["users"]), block(tk["table"]), k,
                                             num_items, item_bias=block(tk["bias"]) if with_bias else None,
                                             **kw))
        res["row_gather"] = _np(sharded_row_gather(m, block(tk["table"]), torch.from_numpy(tk["ids"])))
        for name, ev in spec["evals"].items():
            for mode in ev["modes"]:
                if (mode == "col") != (t_axis > 1):
                    continue
                model = _model(ev)
                builder = ShardedTrainStepBuilder(model, "bpr", OptimConfig(), m,
                                                  MeshConfig(table_sharding=mode))
                state = convert.shard_state(_tensors(ev["state"]), m, builder.plans)
                evaluator = ShardedRetrievalEvaluator(builder, model, dataset, ks=ev["ks"],
                                                      user_batch=ev["user_batch"])
                res[f"eval_{name}_{mode}"] = evaluator(state)
        out[key] = res
    if "trainer" in spec:
        out["trainer"] = job_trainer(spec["trainer"], mesh)
    return out


JOBS = {"parallel": job_parallel, "trainer": job_trainer, "colshard": job_colshard,
        "retrieval": job_retrieval}


def main(job, rank, world, port, spec_path, out_path) -> None:
    import torch

    torch.set_num_threads(1)
    from tfrec_tpu_torch.parallel.mesh import init_distributed, make_mesh

    init_distributed(f"tcp://127.0.0.1:{port}", int(world), int(rank), device="cpu",
                     timeout_s=90.0)
    try:
        with open(spec_path, "rb") as f:
            spec = pickle.load(f)
        result = JOBS[job](spec, make_mesh(-1, spec.get("table_axis", 1), device="cpu"))
        if int(rank) == 0:
            with open(out_path, "wb") as f:
                pickle.dump(result, f)
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:])
