"""The harness on the card: a short traced run of each cell of
BENCHMARK.json reads every per-layer metric it lists, and is correct.
Run on the card: `python -m pytest -m gpu portbench/tests/test_portbench_gpu.py`."""

import pytest

from portbench import harness, spec

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reads_every_metric(cuda_device, name):
    cell = spec.find_cell(name)
    result = harness.run_cell(cell, 2**31 + 99, 1.0, True, "cuda")
    assert result["correct"] is True
    assert set(result["metrics"]) == {m["name"] for m in cell.per_layer}
    dev = result["device"]
    assert dev["platform"] == "gpu" and 0 < dev["busy_s"] <= dev["window_s"]
    for m in result["metrics"].values():
        if m["unit"] == "%":
            assert 0 < m["value"] <= 105
