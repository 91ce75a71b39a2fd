"""A model family is new files only: a toy family (``fixtures/
toy_family.py``) with its configuration, traffic mix, limits and a metric
reader in a temporary benchmark runs through ``load_cell``, ``run_cell``,
``metrics_line`` and the readings, with no file of the harness edited;
and a cell the driver cannot run is refused when it is loaded, by a
message that names the fault."""
import hashlib
import json
import shutil

import pytest

import gb_harness
import readings
from gb_testing import one_torch_thread  # noqa: F401

CELL = "toy-lsq-steps"


def _write(path, obj):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(obj if isinstance(obj, str) else json.dumps(obj))


def toy_benchmark(root, config=None, traffic=None, limits=None):
    """A benchmark of one toy cell under ``root``; its BENCHMARK.json."""
    home = root / "bench"
    (home / "families").mkdir(parents=True)
    shutil.copy(gb_harness.HERE / "fixtures" / "toy_family.py",
                home / "families" / "toy.py")
    _write(home / "configs" / "toy-lsq.json", {
        "name": "toy-lsq", "family": "toy", "source": "a test",
        "reduced": [], "rows": 64, "dim": 4, **(config or {})})
    _write(home / "traffic" / "steps.json",
           {"family": "toy", "steps": 40, "lr": 0.1, **(traffic or {})})
    _write(home / "limits" / f"{CELL}.json",
           limits or {"loss": 1e-4, "change": 1e-4})
    _write(home / "metrics" / "toy.jobs.py",
           "def read(out):\n    return float(len(out['trainings']))\n")
    bench = {
        "command": ["python3", "bench/run.py"], "paths": ["bench"],
        "run_seconds": 1,
        "configs": [{"name": "toy-lsq", "source": "a test",
                     "file": "bench/configs/toy-lsq.json", "reduced": [],
                     "why": "a toy"}],
        "workloads": [{"name": CELL, "config": "toy-lsq",
                       "traffic": "steps", "chips": 1, "why": "a toy"}],
        "end_to_end": [
            {"name": "epoch_ms", "unit": "ms", "better": "lower",
             "bound": 0.05, "source": "host_clock"},
            {"name": "final_loss", "unit": "1", "better": "lower",
             "bound": 0.01, "source": "host_clock"},
            {"name": "setup_s", "unit": "s", "better": "lower",
             "bound": 0.25, "source": "host_clock"}],
        "per_layer": [{"name": "toy.jobs", "unit": "1", "better": "higher",
                       "source": "program_counter", "layer": "jobs",
                       "moves": "epoch_ms"}]}
    _write(root / "BENCHMARK.json", bench)
    return root / "BENCHMARK.json"


def _harness_files():
    return {p.relative_to(gb_harness.HERE): hashlib.sha256(
        p.read_bytes()).hexdigest()
        for p in gb_harness.HERE.rglob("*")
        if p.is_file() and "__pycache__" not in p.parts}


def test_toy_family_runs_from_new_files_only(tmp_path):
    before = _harness_files()
    cell = gb_harness.load_cell(CELL, toy_benchmark(tmp_path))
    assert cell["family"] == "toy"
    out = gb_harness.run_cell(cell, 2**31 + 9, 0.3, trace=False,
                              device="cpu")
    assert out["correct"], out["checks"]
    assert set(out["checks"]) == {"loss", "change"}
    line = gb_harness.metrics_line(out, trace=False)
    assert set(line) == {"epoch_ms", "final_loss", "setup_s"}
    assert all(v["value"] > 0 for v in line.values())
    assert out["detail"]["reference_loss"] and "setup_parts" in out["detail"]
    out = gb_harness.run_cell(cell, 2**31 + 9, 0.3, trace=True,
                              device="cpu")
    assert out["correct"], out["checks"]
    line = gb_harness.metrics_line(out, trace=True)
    assert line["toy.jobs"]["value"] == len(out["trainings"]) >= 1
    assert _harness_files() == before


def test_toy_fault_is_not_correct(tmp_path):
    cell = gb_harness.load_cell(CELL, toy_benchmark(tmp_path))
    out = gb_harness.run_cell(cell, 5, 0.2, trace=False, device="cpu",
                              fault="frozen")
    assert not out["correct"], out["checks"]


def test_toy_readings_go_through_its_family(tmp_path):
    cell = gb_harness.load_cell(CELL, toy_benchmark(tmp_path))
    rows = {r["reading"]: r["numbers"]
            for r in readings.read_seed(cell, 11, "cpu")}
    assert set(rows) == {"sound", "frozen", "control_fp16"}
    limits = cell["limits"]
    assert all(v <= limits[k] for k, v in rows["sound"].items())
    for bad in ("frozen", "control_fp16"):
        assert any(v > limits[k] for k, v in rows[bad].items()), rows[bad]


@pytest.mark.parametrize("change,error,word", [
    ({"config": {"family": "nosuch"}}, KeyError, "nosuch"),
    ({"traffic": {"family": "gnn"}}, ValueError, "'gnn'"),
    ({"limits": {"loss": 1e-4, "logits": 1e-4}}, ValueError, "logits"),
    ({"config": {"rows": 0}}, ValueError, "rows"),
], ids=["unknown-family", "traffic-of-another-family",
        "limit-the-family-does-not-compare", "config-the-family-refuses"])
def test_bad_cell_is_refused_at_load(tmp_path, change, error, word):
    bench = toy_benchmark(tmp_path, **change)
    with pytest.raises(error, match=word):
        gb_harness.load_cell(CELL, bench)
