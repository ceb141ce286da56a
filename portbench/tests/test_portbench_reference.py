"""The plain reference against the port's step and ``predict_ctr`` on the
CPU at a tiny size (this test imports both), and the control: the
reference with TF32 products in the program's place fails the cell's
limits. The port on the CPU runs its kernels' plain versions."""

import pytest
import torch

from portbench.calibrate import serve_readings, train_readings
from portbench.tests.tiny import tiny_cell

TRAIN = ["dlrm_criteo_tb.train_zipf", "dcnv2_criteo_tb.train_zipf", "dlrm_criteo_tb.train_uniform"]
SEEDS = [3, 2**31 + 11, 987654321]


def _over(numbers, limits):
    return [k for k, v in numbers.items() if v > limits[k]]


@pytest.mark.parametrize("workload", TRAIN)
@pytest.mark.parametrize("seed", SEEDS)
def test_train_steps_match_and_the_control_fails(workload, seed):
    torch.set_num_threads(2)
    cell = tiny_cell(workload)
    rows = {r["role"]: r["numbers"] for r in train_readings(cell, seed, "cpu", True)}
    assert not _over(rows["program"], cell.limits), rows["program"]
    assert _over(rows["control_tf32"], cell.limits), rows["control_tf32"]
    assert _over(rows["fault_half_batch"], cell.limits), rows["fault_half_batch"]


@pytest.mark.parametrize("seed", SEEDS)
def test_served_logits_match_and_the_control_fails(seed):
    torch.set_num_threads(2)
    cell = tiny_cell("dcnv2_criteo_tb.serve_rank4k")
    rows = {r["role"]: r["numbers"] for r in serve_readings(cell, seed, "cpu", True)}
    assert not _over(rows["program"], cell.limits), rows["program"]
    assert _over(rows["control_tf32"], cell.limits), rows["control_tf32"]
