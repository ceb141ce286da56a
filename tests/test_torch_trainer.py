"""The port's CTR trainer and its eval against the JAX package, on the CPU.

The same seeded inputs go through the JAX function and its counterpart in
the port: the run-index helpers, ``auc`` and ``logloss``; the copies of
``CTRBatcher``, ``MetricLogger`` and ``prefetch`` (held equal to the
originals); and the whole ``Trainer`` (``device="cpu"``: the kernels' plain
versions) against ``tfrec_tpu.train.trainer.Trainer`` from the JAX
trainer's own initial state, as DCN-v1 and as low-rank DCN-v2. The card
runs the same trainer in ``chip_smoke.py``.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

import tfrec_tpu.configs as jax_configs
from tfrec_tpu.data.samplers import CTRBatcher as JaxCTRBatcher
from tfrec_tpu.eval.metrics import auc as jax_auc
from tfrec_tpu.eval.metrics import logloss as jax_logloss
from tfrec_tpu.ops.embedding import run_first_index as jax_run_first_index
from tfrec_tpu.ops.embedding import run_last_index_plus1 as jax_run_last_index_plus1
from tfrec_tpu.train.trainer import Trainer as JaxTrainer
from tfrec_tpu.utils.logging import MetricLogger as JaxMetricLogger
from tfrec_tpu.utils.prefetch import prefetch as jax_prefetch
from tfrec_tpu_torch import configs
from tfrec_tpu_torch.convert import train_state_from_jax
from tfrec_tpu_torch.data.samplers import CTRBatcher
from tfrec_tpu_torch.eval.metrics import auc, logloss
from tfrec_tpu_torch.ops.embedding import run_first_index, run_last_index_plus1
from tfrec_tpu_torch.train import trainer as trainer_mod
from tfrec_tpu_torch.train.trainer import Trainer, run
from tfrec_tpu_torch.utils.logging import MetricLogger
from tfrec_tpu_torch.utils.prefetch import prefetch

torch.set_num_threads(1)

# auc: float32 rank sums in another order (torch's against XLA's), of ranks
# up to n = 1000 here: a few ulps of the sum, far under 1e-6 of the AUC.
AUC_ATOL = 1e-6
LOGLOSS_RTOL = 1e-6
# The trainers: 12 steps of two implementations of the same arithmetic (sums
# in another order, through Adam's and Adagrad's normalised updates), as
# tests/test_torch_train.py holds three steps; AUC over 9000 held-out rows
# moves by 1/(positives x negatives) ~ 5e-8 a swapped pair of near-equal
# logits.
TRAIN_RTOL = 1e-4
TRAIN_AUC_ATOL = 1e-4


def _run_cases():
    rng = np.random.default_rng(0)
    return {
        "ties": np.round(rng.normal(size=1000), 1).astype(np.float32),
        "distinct": rng.normal(size=257).astype(np.float32),
        "all equal": np.full(64, 0.25, np.float32),
        "one": np.array([3.0], np.float32),
        "contiguous runs, unsorted": np.array([5, 5, 1, 1, 1, 9, 2, 2], np.float32),
    }


@pytest.mark.parametrize("case", sorted(_run_cases()))
def test_run_index_helpers_match_jax(case):
    x = _run_cases()[case]
    if "unsorted" not in case:
        x = np.sort(x)
    got_lo, got_hi = run_first_index(torch.from_numpy(x)), run_last_index_plus1(torch.from_numpy(x))
    assert got_lo.dtype == got_hi.dtype == torch.int32
    np.testing.assert_array_equal(got_lo.numpy(), np.asarray(jax_run_first_index(jax.numpy.asarray(x))))
    np.testing.assert_array_equal(got_hi.numpy(), np.asarray(jax_run_last_index_plus1(jax.numpy.asarray(x))))


def _metric_cases():
    rng = np.random.default_rng(1)
    logits = rng.normal(size=1000).astype(np.float32)
    labels = (rng.random(1000) < 1 / (1 + np.exp(-2 * logits))).astype(np.float32)
    return {
        "random": (logits, labels),
        "ties": (np.round(logits, 1), labels),
        "all tied": (np.zeros(50, np.float32), labels[:50]),
        "positives only": (logits[:100], np.ones(100, np.float32)),
        "negatives only": (logits[:100], np.zeros(100, np.float32)),
        "one example": (logits[:1], labels[:1]),
    }


@pytest.mark.parametrize("case", sorted(_metric_cases()))
def test_auc_and_logloss_match_jax(case):
    logits, labels = _metric_cases()[case]
    got_auc = auc(torch.from_numpy(logits), torch.from_numpy(labels))
    got_ll = logloss(torch.from_numpy(logits), torch.from_numpy(labels))
    assert got_auc.dtype == got_ll.dtype == torch.float32 and got_auc.dim() == 0
    want_auc = float(jax_auc(jax.numpy.asarray(logits), jax.numpy.asarray(labels)))
    np.testing.assert_allclose(got_auc.item(), want_auc, rtol=0, atol=AUC_ATOL)
    np.testing.assert_allclose(got_ll.item(), float(jax_logloss(jax.numpy.asarray(logits),
                                                                jax.numpy.asarray(labels))),
                               rtol=LOGLOSS_RTOL)
    if labels.min() == labels.max():
        assert got_auc.item() == 0.5  # a class is absent


def test_ctr_batcher_copy_matches_the_reference():
    rng = np.random.default_rng(2)
    dense = rng.normal(size=(1000, 3)).astype(np.float32)
    cat = rng.integers(0, 50, (1000, 4)).astype(np.int32)
    label = (rng.random(1000) < 0.5).astype(np.float32)
    ours, ref = CTRBatcher(dense, cat, label, 96, seed=7), JaxCTRBatcher(dense, cat, label, 96, seed=7)
    assert ours.num_batches() == ref.num_batches() == 10
    for epoch in range(2):
        got, want = list(ours.epoch(epoch)), list(ref.epoch(epoch))
        assert len(got) == len(want) == 10
        for a, b in zip(got, want):
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])


def _records(path):
    out = []
    for line in path.read_text().splitlines():
        rec = json.loads(line)
        rec.pop("wall_s")
        out.append(rec)
    return out


def test_metric_logger_copy_matches_the_reference(tmp_path, capsys):
    records = [{"event": "run_config", "config": {"a": [1, 2], "b": None}},
               {"step": 4, "epoch": 0, "loss": np.float32(0.5)},
               {"epoch": 0, "loss": 0.25, "auc": 0.75, "eval_rows": 9000.0},
               {"event": "early_stopped", "epoch": 1, "wall_s": 3.0}]
    for cls, name in ((MetricLogger, "ours"), (JaxMetricLogger, "ref")):
        logger = cls("run", out_dir=str(tmp_path / name), quiet=name == "ref", tensorboard=False)
        for rec in records:
            logger.log(rec)
        logger.close()
    ours, ref = (_records(tmp_path / name / "run.metrics.jsonl") for name in ("ours", "ref"))
    assert ours == ref
    printed = capsys.readouterr().err.splitlines()
    assert len(printed) == len(records) and printed[0].startswith("[run] {")


def test_prefetch_copy_matches_the_reference():
    for fn in (prefetch, jax_prefetch):
        assert list(fn(range(7), lambda x: x * x)) == [x * x for x in range(7)]

    def boom(x):
        if x == 3:
            raise KeyError(x)
        return x

    for fn in (prefetch, jax_prefetch):
        got = []
        with pytest.raises(KeyError):
            for item in fn(range(10), boom):
                got.append(item)
        assert got == [0, 1, 2]  # the worker's exception re-raises where the batch is used


def _config(mod, name: str, **train):
    """A tiny synthetic_ctr run: 4 fields of 500 rows, d=8, 2 cross layers,
    MLP (32, 16), batch 256, no dropout; 12 000 examples of which 9600 held
    out (two eval batches, the second zero-padded, once truncated to 9000
    rows); 6 steps an epoch in dispatches of 2; early stopping after one
    eval without a gain of 1.0; one device."""
    kw = dict(batch_size=256, epochs=3, loss="logloss", steps_per_dispatch=2, steps_per_epoch=6,
              eval_ctr_max_rows=9000, early_stop_patience=1, early_stop_min_delta=1.0,
              log_every_steps=4)
    kw.update(train)
    return mod.Config(
        run_name=f"tiny_{name}",
        data=mod.DataConfig(source="synthetic_ctr", num_examples=12_000, num_dense_features=13,
                            categorical_vocab_sizes=(500,) * 4, test_fraction=0.8, seed=3),
        model=mod.ModelConfig(name=name, embed_dim=8, num_cross_layers=2, mlp_dims=(32, 16),
                              cross_rank=4 if name == "dcnv2" else 0, lane_pack=False),
        optim=mod.OptimConfig(learning_rate=0.01, dense_optimizer="adam",
                              sparse_optimizer="rowwise_adagrad", sparse_learning_rate=0.05),
        train=mod.TrainConfig(**kw),
        # The single-device path: tests/conftest.py gives JAX 8 virtual CPU
        # devices, where the default would take the mesh path.
        mesh=mod.MeshConfig(data_axis_size=0),
    )


def _same_stream(got, want):
    """Records equal key for key; losses, AUC and logloss within the
    trainers' tolerances; examples_per_s (a host clock) left out."""
    assert len(got) == len(want), (got, want)
    for g, w in zip(got, want):
        g.pop("examples_per_s", None)
        w.pop("examples_per_s", None)
        assert g.keys() == w.keys(), (g, w)
        for k in g:
            if k in ("loss", "logloss"):
                np.testing.assert_allclose(g[k], w[k], rtol=TRAIN_RTOL, err_msg=k)
            elif k in ("auc", "best", "last"):
                np.testing.assert_allclose(g[k], w[k], rtol=0, atol=TRAIN_AUC_ATOL, err_msg=k)
            else:
                assert g[k] == w[k], (k, g, w)


@pytest.mark.parametrize("name", ["dcn", "dcnv2"])
def test_trainer_matches_jax(tmp_path, name):
    """The port's Trainer on the CPU against the JAX Trainer, from the JAX
    trainer's initial state (``convert.train_state_from_jax``): the history
    and the whole metric stream (run_config first, step losses, the
    eval_truncated events, the eval records with eval_rows, early stopping
    at the same epoch)."""
    jt = JaxTrainer(_config(jax_configs, name, checkpoint_dir=str(tmp_path / "jax")), quiet=True)
    pt = Trainer(_config(configs, name, checkpoint_dir=str(tmp_path / "port")), quiet=True, device="cpu")
    pt.state = train_state_from_jax(jax.tree_util.tree_map(np.asarray, jt.state), pt.model)
    want, got = jt.train(), pt.train()
    jt.logger.close()
    pt.logger.close()
    assert [r["epoch"] for r in got] == [0, 1]  # stopped early, after epoch 1
    assert all(r["eval_rows"] == 9000.0 for r in got)
    assert pt.global_step == jt.global_step == 12
    _same_stream([dict(r) for r in got], [dict(r) for r in want])
    stream = _records(tmp_path / "port" / f"tiny_{name}.metrics.jsonl")
    jax_stream = _records(tmp_path / "jax" / f"tiny_{name}.metrics.jsonl")
    for records, where in ((stream, "port"), (jax_stream, "jax")):
        assert records[0]["config"]["train"]["checkpoint_dir"] == str(tmp_path / where)
        records[0]["config"]["train"]["checkpoint_dir"] = None  # the two runs' own directories
    _same_stream(stream, jax_stream)
    events = [r.get("event") for r in stream]
    assert events[0] == "run_config" and events.count("eval_truncated") == 2
    assert events[-1] == "early_stopped" and stream[-1]["epoch"] == 1


def test_trainer_logs_an_empty_epoch_and_a_dispatch_past_the_step_cap():
    """K=4 steps a dispatch with a cap of 2 steps: one dispatch still runs,
    and the log says so; fewer batches than a dispatch: an empty epoch, as
    the JAX trainer records it."""
    cfg = _config(configs, "dcn", steps_per_epoch=2, steps_per_dispatch=4, epochs=1,
                  early_stop_patience=0, eval_every_epochs=0)
    pt = Trainer(cfg, quiet=True, device="cpu")
    seen = []
    pt.logger.log = seen.append
    hist = pt.train()
    assert seen[0] == {"event": "dispatch_exceeds_step_cap", "steps_per_dispatch": 4, "step_cap": 2}
    assert pt.global_step == 4 and hist[0]["epoch"] == 0 and np.isfinite(hist[0]["loss"])
    # 2400 training rows are 9 batches of 256: no whole dispatch of 16.
    empty = dict(steps_per_epoch=-1, steps_per_dispatch=16, epochs=1, early_stop_patience=0)
    pt = Trainer(_config(configs, "dcn", **empty), quiet=True, device="cpu")
    jt = JaxTrainer(_config(jax_configs, "dcn", **empty), quiet=True)
    got, want = pt.train(), jt.train()
    assert got[0]["epoch"] == want[0]["epoch"] == 0 and got[0]["examples_per_s"] == 0.0
    assert np.isnan(got[0]["loss"]) and np.isnan(want[0]["loss"]) and got[0].keys() == want[0].keys()
    with pytest.raises(ValueError, match="0 train batches"):
        Trainer(_config(configs, "dcn", batch_size=4096), quiet=True, device="cpu").train()


@pytest.mark.parametrize("section,override,match", [
    ("model", {"name": "deepfm"}, "item 12"),
    ("train", {"profile_steps": (1, 2)}, "item 10"),
    ("train", {"matmul_precision": "bfloat16"}, "item 5"),
    ("train", {"matmul_precision": "highest"}, "item 5"),
])
def test_trainer_refuses_what_is_not_ported_by_naming_its_item(section, override, match):
    cfg = _config(configs, "dcn")
    override = dict(override)
    for other in ("data", "model"):  # the sections of another data path, where given
        if other in override:
            cfg = cfg.replace(**{other: dataclasses.replace(getattr(cfg, other), **override.pop(other))})
    cfg = cfg.replace(**{section: dataclasses.replace(getattr(cfg, section), **override)})
    with pytest.raises(NotImplementedError, match=f"ROADMAP Queue 1 {match}"):
        Trainer(cfg, quiet=True, device="cpu")


def test_trainer_and_run_default_to_cuda(monkeypatch):
    monkeypatch.setattr(trainer_mod.torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run(_config(configs, "dcn"), quiet=True)
