"""The control fails the limits: the reference one precision step below the
configuration's (fp8 operands where the configuration computes in bf16, bf16
where in f32) in the program's place, at the tiny preset on the CPU, held to
the tiny limits (conftest.py). At tiny_moe's size routing flips blur the
control (conftest.py), so the MoE cell's control is read on the card at the
cell's own size (portbench/control.py, PERF.md); here tiny_moe is held to its
faults."""

import pytest
import torch

from conftest import tiny_cell
from portbench import control


@pytest.mark.parametrize("seed", [1, 2**31 + 5, 2**31 + 77])
def test_training_control_fails(seed):
    cell = tiny_cell("train", "tiny")
    found = control.train_readings(cell, seed, torch.device("cpu"))
    numbers = list(cell.limits)
    assert all(found["program"][k] <= cell.limits[k] for k in numbers), found["program"]
    assert any(found["control"][k] > cell.limits[k] for k in numbers), found["control"]
    assert any(found["half_batch"][k] > cell.limits[k] for k in numbers), found["half_batch"]


@pytest.mark.parametrize("seed", [1, 2**31 + 5, 2**31 + 77])
def test_moe_faults_fail(seed):
    cell = tiny_cell("train_moe", "tiny_moe")
    found = control.train_readings(cell, seed, torch.device("cpu"), ("half_batch", "unchanged"))
    numbers = list(cell.limits)
    assert all(found["program"][k] <= cell.limits[k] for k in numbers), found["program"]
    for fault in ("half_batch", "unchanged"):
        assert any(found[fault][k] > cell.limits[k] for k in numbers), found[fault]


@pytest.mark.parametrize("seed", [1, 2**31 + 5, 2**31 + 77])
def test_extraction_control_fails(seed):
    cell = tiny_cell("extract")
    found = control.extract_readings(cell, seed, torch.device("cpu"))
    limit = cell.limits["logit_gap"]
    assert found["program"]["logit_gap"] <= limit < found["control"]["logit_gap"]
    assert found["altered_token"]["logit_gap"] > limit
