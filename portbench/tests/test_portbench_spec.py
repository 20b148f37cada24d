"""BENCHMARK.json against the benchmark's contract, and every cell found by
its name with its files."""

import json
import re

import pytest

from portbench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
WIDTH = re.compile(r"(^|_)(dim|hidden|intermediate|latent|state|proj|head|heads|ratio|rank)(_|$)|_dim$|_rank$")

BENCH = spec.load_benchmark()
CELL_NAMES = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"][:2] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith("portbench/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names)) and len(CELL_NAMES) == len(set(CELL_NAMES))
    assert "setup_s" in names


def test_reduced_names_no_width():
    for c in BENCH["configs"]:
        assert not any(WIDTH.search(k) for k in c["reduced"]), c["reduced"]


@pytest.mark.parametrize("name", CELL_NAMES)
def test_cell_found_by_name(name):
    cell = spec.find_cell(name)
    assert cell.name == name and cell.traffic["kind"] in ("train", "extract")
    e2e = [m["name"] for m in cell.end_to_end]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer, "every cell reports a per-layer metric"
    for m in cell.per_layer:
        assert m["moves"] in e2e, (m["name"], "moves a metric the cell does not report")
        assert callable(spec.metric_reader(m["name"]))
    assert set(cell.limits) and all(v > 0 for v in cell.limits.values())
    assert set(cell.config) >= {"vision", "decoder"}


def test_unknown_cell_raises():
    with pytest.raises(KeyError):
        spec.find_cell("no.such_cell")


def test_every_metric_has_a_reader_and_every_config_a_cell():
    for m in BENCH["per_layer"]:
        assert (spec.HERE / "metrics" / f"{m['name']}.py").exists()
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
