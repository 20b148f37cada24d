"""One run of each kind of cell on the CPU at the tiny presets: the last
line's keys, the metrics of each mode, and the decode-step count."""

import json

import pytest

from conftest import tiny_cell
from portbench import harness
from portbench.drivers.extract import decode_steps

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("which", ["train", "extract"])
@pytest.mark.parametrize("trace", [False, True])
def test_last_line_keys(which, trace):
    cell = tiny_cell(which)
    result = harness.run_cell(cell, 2**31 + 3, 0.2, trace, "cpu")
    line = json.loads(json.dumps(result))
    assert all(k in line for k in KEYS) and list(line)[-1] == "checks"
    assert ("breakdown" in line) == trace
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    for name, c in line["checks"].items():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"], name
    want = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    got = set(line["metrics"])
    if trace:
        # On the CPU nothing runs on a device: readers of device time find nothing and are left out.
        assert got <= want and got
    else:
        assert got == want
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    dev = line["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)


def test_decode_steps():
    eos = 258
    assert decode_steps([[5, eos], [5, 6, 7, eos]], 10) == 3
    assert decode_steps([[5, 6, 7], [eos]], 3) == 2
