"""Every configuration, traffic mix, limit and metric file that
``BENCHMARK.json`` names loads and is found by name; the names and units
keep to the benchmark's characters."""
import json
import re

import pytest

import gb_check
import gb_harness
from gb_testing import CELLS, one_torch_thread  # noqa: F401

BENCH = json.loads((gb_harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["gpubench"]
    assert BENCH["command"] == ["python3", "gpubench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert {m["name"] for m in BENCH["end_to_end"]} >= {"setup_s"}
    assert all(m["bound"] <= 0.25 for m in BENCH["end_to_end"])
    assert [w["name"] for w in BENCH["workloads"]] == list(CELLS)


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_and_units(kind):
    names = [e["name"] for e in BENCH[kind]]
    assert len(set(names)) == len(names)
    assert all(NAME.match(n) for n in names)
    for e in BENCH[kind]:
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                             "higher")
        for k in e.get("reduced", []):
            assert NAME.match(k)


@pytest.mark.parametrize("conf", [c["name"] for c in BENCH["configs"]])
def test_config_files(conf):
    entry = {c["name"]: c for c in BENCH["configs"]}[conf]
    cfg = json.loads((gb_harness.ROOT / entry["file"]).read_text())
    assert cfg["name"] == conf and cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"]
    family = gb_harness.family_name(cfg)
    gb_harness.family(family).check_config(cfg)
    if family == "gnn":
        gb_harness.family("gnn").model_cfg(cfg)   # every key the run takes
        assert cfg["published"]["nodes"] > cfg["nodes"]


@pytest.mark.parametrize("name", CELLS)
def test_cells_load(name):
    cell = gb_harness.load_cell(name)
    family = gb_harness.family_of(cell)
    assert cell["workload"]["chips"] == 1
    assert cell["limits"] and set(cell["limits"]) <= set(family.NAMES)
    if cell["family"] == "gnn":
        assert set(cell["limits"]) <= set(gb_check.NAMES)
        if cell["traffic"]["rsc"]:
            assert cell["limits"]["plan"] == 0, "an exact count"
    e2e = {m["name"] for m in cell["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell["per_layer"], "every cell reports a per-layer metric"
    for m in cell["per_layer"]:
        assert m["moves"] in {e["name"] for e in cell["end_to_end"]}


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_found_by_name(metric):
    read = gb_harness.metric_reader(metric)
    assert callable(read)
