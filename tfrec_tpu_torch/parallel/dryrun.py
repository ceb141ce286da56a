"""The port's multi-rank dry run: the counterpart of the reference's
``__graft_entry__.dryrun_multichip``.

``dryrun_multichip(n)`` starts n rank processes of this module itself
(``torch.distributed``: on the card by default, NCCL with a card a rank or
gloo where the n ranks share fewer cards; gloo on the CPU with
``device="cpu"``) and runs, on a ``data`` x
``table`` mesh (a table axis of 2 where n is even and above 2), ONE full
sharded train step of the reference's tiny DCN (4 fields of vocabs 64, 64,
32, 32, 4 dense features, embed_dim 8, 2 cross layers, an MLP of 16, a
global batch of 8 a data index) for every multi-rank mode the reference
witnesses (``MULTICHIP_r05.json``):

    row+bf16wire, row+lanepack, row+auto (per-field tables expected),
    row+f32wire, row+lanepack+adam, row+multihot (bag widths 3, 1, 2, 1
    with sentinel pads), row+permute, row+merge, col (on the table axis;
    skipped without one), and one ``sharded_topk_dot``.

``gspmd`` is not ported (an A/B of XLA's partitioner, with no PyTorch
counterpart) and is printed as such, never as ok. Rank 0 prints one line
in the reference's format; any failure exits non-zero with every rank's
output. The global batch is the reference's (numpy's generator at seed 0);
each data index takes its contiguous rows. The initial state is the
single-device ``init_state`` from a generator at seed 0, or one given a
mode (``states``: a logical state a tag, such as a converted JAX state).

    python -m tfrec_tpu_torch.parallel.dryrun --n 4               # the card(s)
    python -m tfrec_tpu_torch.parallel.dryrun --n 4 --device cpu
"""

from __future__ import annotations

import argparse
import os
import pickle
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

VOCABS = (64, 64, 32, 32)
NUM_DENSE = 4
MULTIHOT_WIDTHS = (3, 1, 2, 1)
GSPMD_REASON = ("gspmd not ported (an A/B of XLA's SPMD partitioner against the explicit "
                "exchange, with no PyTorch counterpart)")


def _model_cfg(lane_pack):
    from tfrec_tpu_torch.configs import ModelConfig

    return ModelConfig(name="dcn", embed_dim=8, num_cross_layers=2, mlp_dims=(16,), lane_pack=lane_pack)


def modes(table_axis: int):
    """(tag, mesh options, lane_pack, lane_pack expected, sparse optimizer,
    field widths) of each mode, in the reference's order."""
    from tfrec_tpu_torch.configs import MeshConfig

    out = [
        ("row+bf16wire", MeshConfig(table_sharding="row"), False, None, "rowwise_adagrad", None),
        ("row+lanepack", MeshConfig(table_sharding="row"), True, True, "rowwise_adagrad", None),
        ("row+auto", MeshConfig(table_sharding="row"), None, False, "rowwise_adagrad", None),
        ("row+f32wire", MeshConfig(table_sharding="row", a2a_dtype="float32"), False, None,
         "rowwise_adagrad", None),
        ("row+lanepack+adam", MeshConfig(table_sharding="row"), True, True, "rowwise_adam", None),
        ("row+multihot", MeshConfig(table_sharding="row"), False, None, "rowwise_adagrad",
         MULTIHOT_WIDTHS),
        ("row+permute", MeshConfig(table_sharding="row", row_permute=True), False, None,
         "rowwise_adagrad", None),
        ("row+merge", MeshConfig(table_sharding="row", recv_combine="merge", route_reuse=False), False,
         None, "rowwise_adagrad", None),
    ]
    if table_axis > 1:
        out.append(("col", MeshConfig(table_sharding="col"), False, False, "rowwise_adagrad", None))
    return out


def global_batch(batch_size: int, widths=None):
    """The reference's batch of ``_one_step`` (numpy at seed 0): a bag's
    last slot is the sentinel (the field's vocab) on every other row."""
    rng = np.random.default_rng(0)
    widths = widths or (1,) * len(VOCABS)
    cols = []
    for v, w in zip(VOCABS, widths):
        for j in range(w):
            col = rng.integers(0, v, batch_size).astype(np.int32)
            if j == w - 1 and w > 1:
                col[::2] = v
            cols.append(col)
    return {"dense": rng.normal(size=(batch_size, NUM_DENSE)).astype(np.float32),
            "cat": np.stack(cols, 1).astype(np.int32),
            "label": rng.integers(0, 2, batch_size).astype(np.float32)}


def one_step(mesh, mesh_cfg, lane_pack, lane_pack_expected, sparse_optimizer, widths,
             state=None) -> float:
    """One sharded step of the tiny DCN from ``state`` (logical; default
    the seed-0 init) on this rank -> the global loss."""
    from tfrec_tpu_torch.configs import OptimConfig
    from tfrec_tpu_torch.models import DataSpec, build_model
    from tfrec_tpu_torch.parallel.step import ShardedTrainStepBuilder

    model = build_model(_model_cfg(lane_pack), DataSpec.ctr(VOCABS, NUM_DENSE, field_widths=widths))
    if lane_pack_expected is not None and bool(model.lane_pack) != lane_pack_expected:
        raise AssertionError(f"lane_pack is {model.lane_pack}, expected {lane_pack_expected}")
    builder = ShardedTrainStepBuilder(
        model, "logloss", OptimConfig(learning_rate=0.01, sparse_optimizer=sparse_optimizer), mesh,
        mesh_cfg)
    if state is None:
        state = builder.init_state(torch.Generator(device=mesh.device).manual_seed(0))
    else:
        state = builder.shard_state(state)
    b = 8
    batch = global_batch(b * mesh.size, widths)
    lo = mesh.data_index * b
    local = {k: torch.from_numpy(v[lo:lo + b]).to(mesh.device) for k, v in batch.items()}
    new_state, metrics = builder.step(state, local)
    loss = float(metrics["loss"])
    if not np.isfinite(loss):
        raise AssertionError(f"loss {loss}")
    if new_state["step"] != 1:
        raise AssertionError(f"step {new_state['step']}")
    return loss


def topk_check(mesh) -> None:
    """One ``sharded_topk_dot`` over the data axis: 64 items of width 8, 4
    users, k = 5; held against a plain top-k of the whole catalog."""
    from tfrec_tpu_torch.parallel.topk import sharded_topk_dot

    rng = np.random.default_rng(1)
    v, d, k, n = 64, 8, 5, mesh.size
    rps = -(-v // n)
    items = np.pad(rng.normal(size=(v, d)).astype(np.float32), ((0, rps * n - v), (0, 0)))
    users = rng.normal(size=(4, d)).astype(np.float32)
    block = torch.from_numpy(items[mesh.data_index * rps:(mesh.data_index + 1) * rps]).to(mesh.device)
    vals, ids = sharded_topk_dot(mesh, torch.from_numpy(users).to(mesh.device), block, k, v)
    vals, ids = vals.cpu().numpy(), ids.cpu().numpy()
    if vals.shape != (4, k) or ids.shape != (4, k) or not np.isfinite(vals).all():
        raise AssertionError(f"top-k shapes {vals.shape} {ids.shape}")
    if not ((ids >= 0) & (ids < v)).all():
        raise AssertionError(f"top-k ids out of range: {ids}")
    want = np.sort(users @ items[:v].T, axis=1)[:, ::-1][:, :k]
    if not np.allclose(vals, want, rtol=1e-5, atol=1e-6):
        raise AssertionError("top-k values differ from the whole catalog's")


def run_modes(n: int, device, states=None):
    """Every mode on this rank (inside a process group of n ranks) ->
    (checks as printed, {tag: loss})."""
    from tfrec_tpu_torch.parallel.mesh import make_mesh

    table_axis = 2 if n % 2 == 0 and n > 2 else 1
    mesh = make_mesh(n // table_axis, table_axis, device=device)
    checks, losses = [], {}
    states = states or {}
    for tag, mesh_cfg, lane_pack, expected, opt, widths in modes(table_axis):
        losses[tag] = one_step(mesh, mesh_cfg, lane_pack, expected, opt, widths, states.get(tag))
        checks.append(f"{tag} ok loss={losses[tag]:.4f}")
        if tag == "row+merge":
            checks.append(GSPMD_REASON)
    if table_axis == 1:
        checks.append("col skipped (no table axis at this device count)")
    topk_check(mesh)
    checks.append("sharded_topk ok")
    return checks, losses


def _tensors(tree):
    """numpy arrays of a (state) tree as tensors."""
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tensors(v) for v in tree)
    return torch.from_numpy(np.array(tree)) if isinstance(tree, np.ndarray) else tree


def _rank_main(args) -> None:
    from tfrec_tpu_torch.parallel.mesh import init_distributed

    if args.device == "cpu":
        torch.set_num_threads(1)
    init_distributed(f"tcp://127.0.0.1:{args.port}", args.n, args.rank, backend=args.backend,
                     device=args.device, timeout_s=args.timeout)
    try:
        states = None
        if args.states:
            with open(args.states, "rb") as f:
                states = _tensors(pickle.load(f))
        checks, losses = run_modes(args.n, args.device, states)
        if args.rank == 0:
            print(f"dryrun_multichip({args.n}): " + "; ".join(checks), flush=True)
            if args.out:
                with open(args.out, "wb") as f:
                    pickle.dump({"checks": checks, "losses": losses}, f)
    finally:
        torch.distributed.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def resolve_backend(n: int, device: str, backend: str) -> str:
    """``backend="auto"``: gloo on the CPU; on the card NCCL where every rank
    has a card of its own, else gloo over the shared card(s). Raises where
    the card is asked for and there is none."""
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("dryrun_multichip runs on the card by default, but CUDA is not "
                           "available; pass device='cpu' (--device cpu) to run on the CPU")
    if backend != "auto":
        return backend
    if device == "cpu":
        return "gloo"
    return "nccl" if n <= torch.cuda.device_count() else "gloo"


def dryrun_multichip(n: int, device: str = "cuda", backend: str = "auto", states=None,
                     timeout: float = 300.0, quiet: bool = False):
    """Run every mode on n rank processes -> {"line": the printed line,
    "checks", "losses": {tag: loss}}. Raises with every rank's output if a
    rank fails or the time limit passes (all ranks are then killed).
    ``backend``: see ``resolve_backend``. ``states``: a logical initial
    state for any mode's tag."""
    backend = resolve_backend(n, device, backend)
    root = Path(__file__).resolve().parents[2]
    env = dict(os.environ, PYTHONPATH=str(root) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    if device == "cpu":
        env["OMP_NUM_THREADS"] = "1"
    with tempfile.TemporaryDirectory(prefix="tfrec_dryrun_") as work:
        out_path = os.path.join(work, "out.pkl")
        cmd = [sys.executable, "-m", "tfrec_tpu_torch.parallel.dryrun", "--n", str(n),
               "--device", device, "--backend", backend, "--port", str(_free_port()),
               "--timeout", str(timeout), "--out", out_path]
        if states:
            states_path = os.path.join(work, "states.pkl")
            with open(states_path, "wb") as f:
                pickle.dump(states, f)
            cmd += ["--states", states_path]
        procs = [subprocess.Popen(cmd + ["--rank", str(r)], env=env, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True) for r in range(n)]
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
            raise RuntimeError(f"dryrun_multichip({n}) passed its {timeout} s limit")
        if any(p.returncode for p in procs) or not os.path.exists(out_path):
            raise RuntimeError(f"dryrun_multichip({n}) failed:\n" + "\n".join(
                f"--- rank {r} (exit {p.returncode}):\n{out[-4000:]}"
                for r, (p, out) in enumerate(zip(procs, outs))))
        with open(out_path, "rb") as f:
            result = pickle.load(f)
    result["line"] = f"dryrun_multichip({n}): " + "; ".join(result["checks"])
    if not quiet:
        print(result["line"], flush=True)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=4, help="rank processes")
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    ap.add_argument("--backend", default="auto", choices=("auto", "nccl", "gloo"))
    ap.add_argument("--timeout", type=float, default=300.0)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--states", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--out", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:
        _rank_main(args)
        return 0
    try:
        dryrun_multichip(args.n, args.device, args.backend, timeout=args.timeout)
    except RuntimeError as e:
        print(e, file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
