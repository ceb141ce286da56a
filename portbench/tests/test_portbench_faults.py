"""A whole run (past the look for a card) on the CPU at a tiny size, with
the timed path broken underneath: ``correct`` must come out false for each
fault a cell can have, and true without one."""

import json

import numpy as np
import pytest
import torch

from portbench.run import execute
from portbench.tests.tiny import cpu_device, tiny_cell


def _run(workload, capsys, seed=2**31 + 7):
    torch.set_num_threads(2)
    assert execute(tiny_cell(workload), seed, 0.2, False, "cpu", cpu_device, 0.0) == 0
    out = capsys.readouterr().out.strip().splitlines()[-1]
    return json.loads(out)


@pytest.mark.parametrize("workload", ["dlrm_criteo_tb.train_zipf", "dcnv2_criteo_tb.train_zipf",
                                      "dcnv2_criteo_tb.serve_rank4k"])
def test_sound_run_is_correct(workload, capsys):
    result = _run(workload, capsys)
    assert result["correct"] and result["failed"] == 0 and result["attempted"] > 0
    assert list(result)[-1] == "compared"
    assert set(result["metrics"]) >= {"setup_s"}


@pytest.mark.parametrize("workload", ["dlrm_criteo_tb.train_zipf", "dcnv2_criteo_tb.train_zipf"])
def test_step_that_returns_its_state_unchanged(workload, capsys, monkeypatch):
    from tfrec_tpu_torch.train.step import TrainStepBuilder

    def unchanged(self, state, batch):
        return state, {"loss": torch.tensor(0.69)}

    monkeypatch.setattr(TrainStepBuilder, "step", unchanged)
    assert not _run(workload, capsys)["correct"]


@pytest.mark.parametrize("workload", ["dlrm_criteo_tb.train_zipf", "dcnv2_criteo_tb.train_zipf"])
def test_half_of_the_batch_left_out(workload, capsys, monkeypatch):
    from tfrec_tpu_torch.train.step import TrainStepBuilder

    step = TrainStepBuilder.step

    def half(self, state, batch):
        n = batch["label"].shape[0] // 2
        return step(self, state, {k: v[:n] for k, v in batch.items()})

    monkeypatch.setattr(TrainStepBuilder, "step", half)
    assert not _run(workload, capsys)["correct"]


def test_an_answer_altered_where_it_is_produced(capsys, monkeypatch):
    from tfrec_tpu_torch.serve import Recommender

    predict = Recommender.predict_ctr

    def altered(self, dense, cat):
        out = np.array(predict(self, dense, cat))
        out[len(out) // 2] += 0.01 * (np.abs(out).max() + 1.0)
        return out

    monkeypatch.setattr(Recommender, "predict_ctr", altered)
    assert not _run("dcnv2_criteo_tb.serve_rank4k", capsys)["correct"]
