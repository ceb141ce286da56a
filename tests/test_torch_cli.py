"""The port's command line and config overrides against the JAX package's,
on the CPU.

``parse_overrides`` and ``with_overrides`` give the reference's results on
the same inputs (its refusals too); ``python -m tfrec_tpu_torch.cli`` runs
as a real process with ``--device cpu``: it lists its configs, refuses an
unknown or unported config by name, starts 2 ranks from the reference's
``JAX_*`` variables (``dcn_multihost`` on the mesh path over gloo), and
trains ``dcn_criteo`` from a small Criteo file and ``mf_bpr_ml100k`` from a
small MovieLens file, its last line one JSON record (after
tests/test_utils.py's CLI tests).
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import tfrec_tpu.cli as jax_cli
import tfrec_tpu.configs as jax_configs
from tfrec_tpu_torch import cli, configs, zoo_configs
from test_torch_loaders import write_criteo

from torch_dist_worker import _free_port

ROOT = Path(__file__).resolve().parents[1]

OVERRIDES = {
    "typed": ["train.batch_size=512", "model.name='fm'", "train.eval_topk=(5,10)",
              "data.path=/x/y.tsv", "optim.learning_rate=1e-3"],
    "bools in any case": ["mesh.route_reuse=false", "train.host_dedup=TRUE",
                          "mesh.fused_tables=True", "model.lane_pack=False"],
    "bare strings and none": ["data.source=criteo", "train.init_from=None", "run_name=x"],
    "nested and empty": ["model.field_dims=()", "data.categorical_vocab_sizes=(7,)"],
}


@pytest.mark.parametrize("case", sorted(OVERRIDES))
def test_parse_and_with_overrides_match_jax(case):
    pairs = OVERRIDES[case]
    got, want = cli.parse_overrides(pairs), jax_cli.parse_overrides(pairs)
    assert got == want and [type(v) for v in got.values()] == [type(v) for v in want.values()]
    ours = configs.with_overrides(configs.Config(), got)
    ref = jax_configs.with_overrides(jax_configs.Config(), want)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    base = zoo_configs.dcn_criteo("criteo.tsv")
    assert configs.with_overrides(base, {}) == base


@pytest.mark.parametrize("override,error", [
    ({"mesh.route_reuse": "false"}, ValueError),
    ({"model.lane_pack": "false"}, ValueError),
    ({"train.nope": 1}, KeyError),
    ({"nope.field": 1}, AttributeError),
])
def test_with_overrides_refuses_as_jax(override, error):
    with pytest.raises(error) as ours:
        configs.with_overrides(configs.Config(), override)
    with pytest.raises(error) as ref:
        jax_configs.with_overrides(jax_configs.Config(), override)
    assert str(ours.value) == str(ref.value)
    with pytest.raises(SystemExit):
        cli.parse_overrides(["noequals"])


def _cli(*args, env=None, timeout=240):
    full_env = {k: v for k, v in os.environ.items() if k != "JAX_COORDINATOR"}
    full_env.update(env or {})
    return subprocess.run([sys.executable, "-m", "tfrec_tpu_torch.cli", *args], cwd=ROOT,
                          capture_output=True, text=True, timeout=timeout, env=full_env)


def test_cli_lists_and_refuses_configs():
    out = _cli("--list_configs")
    assert out.returncode == 0
    assert out.stdout.split() == list(zoo_configs.ZOO) == \
        ["mf_bpr_ml100k", "fm_ctr_ml1m", "neumf_ml20m", "dcn_criteo", "dcn_multihost", "sasrec_ml1m",
         "gru4rec_ml1m", "caser_ml1m", "fism_ml100k", "nais_ml100k", "multvae_ml100k", "cdae_ml100k",
         "sbpr_ml100k", "apr_ml100k", "irgan_ml100k", "wrmf_ml100k", "ease_ml100k"]
    bad = _cli("--config", "nope")
    assert bad.returncode != 0 and "unknown config 'nope'" in bad.stderr
    # The long tail's configs run (wrmf_ml100k's ALS sweeps at a small size).
    tail = _cli("--config", "wrmf_ml100k", "--device", "cpu", "data.num_users=60", "data.num_items=80",
                "data.interactions_per_user=8", "train.epochs=2", "train.eval_every_epochs=2")
    assert tail.returncode == 0, tail.stderr
    last = json.loads(tail.stdout.strip().splitlines()[-1])
    assert last["epoch"] == 1 and np.isfinite(last["loss"]) and "recall@20" in last
    # Under the JAX_* variables a process joins a group; a table axis of 2
    # needs 2 ranks a data index, and one process is refused by that rule.
    col = _cli("--config", "dcn_multihost", "--device", "cpu", "mesh.table_axis_size=2",
               env={"JAX_COORDINATOR": f"127.0.0.1:{_free_port()}", "JAX_NUM_PROCESSES": "1",
                    "JAX_PROCESS_ID": "0"})
    assert col.returncode != 0 and "needs a multiple of as many ranks" in col.stderr


def _two_cli_ranks(tmp_path, *mesh):
    """Two processes started with the reference's JAX_COORDINATOR,
    JAX_NUM_PROCESSES and JAX_PROCESS_ID join one gloo group, train a tiny
    dcn_multihost on the mesh path with the ``mesh`` overrides and print
    the same last record -> the process count of its checkpoint."""
    coordinator = f"127.0.0.1:{_free_port()}"
    args = ["--config", "dcn_multihost", "--device", "cpu", "train.epochs=1",
            "train.batch_size=256", "train.steps_per_dispatch=2", "data.num_examples=3000",
            "data.categorical_vocab_sizes=(50,)", "model.mlp_dims=(16,)", "model.embed_dim=4",
            f"train.checkpoint_dir={tmp_path}", "train.checkpoint_every_epochs=1", *mesh]
    env = {k: v for k, v in os.environ.items() if k != "JAX_COORDINATOR"}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tfrec_tpu_torch.cli", *args], cwd=ROOT, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        env={**env, "OMP_NUM_THREADS": "1", "JAX_COORDINATOR": coordinator,
             "JAX_NUM_PROCESSES": "2", "JAX_PROCESS_ID": str(rank)}) for rank in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=180))
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), outs
    recs = [json.loads(out.strip().splitlines()[-1]) for out, _ in outs]
    for rec in recs:
        rec.pop("examples_per_s")
    assert recs[0] == recs[1] and recs[0]["epoch"] == 0 and np.isfinite(recs[0]["auc"])
    tree = json.loads((tmp_path / "step_0000000001" / "tree.json").read_text())
    return tree["process_count"]


def test_cli_starts_ranks_from_the_jax_variables(tmp_path):
    """A (2, 1) mesh of row-sharded tables: each rank writes its blocks."""
    assert _two_cli_ranks(tmp_path) == 2


def test_cli_starts_col_ranks_from_the_dotted_overrides(tmp_path):
    """A (1, 2) mesh of column-sharded tables through the dotted
    overrides: rank 0 writes the logical state."""
    assert _two_cli_ranks(tmp_path, "mesh.table_axis_size=2", "mesh.table_sharding=col") == 1


def test_cli_trains_dcn_criteo_from_a_criteo_file(tmp_path):
    path = write_criteo(tmp_path / "criteo.tsv", 1500, malformed_every=101)
    out = _cli("--config", "dcn_criteo", "--data_path", path, "--device", "cpu",
               "train.epochs=1", "train.batch_size=128", "train.steps_per_dispatch=2",
               "data.categorical_vocab_sizes=(50,)", "data.test_fraction=0.2",
               "model.mlp_dims=(16,)", "model.embed_dim=4", "data.streaming=false")
    assert out.returncode == 0, out.stderr
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["epoch"] == 0 and {"auc", "logloss", "loss"} <= set(rec)
    assert all(np.isfinite(v) for v in rec.values())


def test_cli_trains_mf_from_a_movielens_file(tmp_path):
    rng = np.random.default_rng(4)
    path = tmp_path / "u.data"
    path.write_text("".join(f"{u}\t{i}\t{r}\t{t}\n" for u, i, r, t in zip(
        rng.integers(1, 60, 3000), rng.integers(1, 120, 3000), rng.integers(1, 6, 3000),
        rng.integers(0, 10**9, 3000))))
    out = _cli("--config", "mf_bpr_ml100k", "--data_path", str(path), "--device", "cpu",
               "train.epochs=2", "train.eval_every_epochs=2", "train.batch_size=256",
               "train.eval_topk=(10,)")
    assert out.returncode == 0, out.stderr
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["epoch"] == 1 and 0.0 <= rec["recall@10"] <= 1.0
