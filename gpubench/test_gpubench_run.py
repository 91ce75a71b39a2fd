"""The whole run path at a tiny size on the CPU, through the kernels'
plain versions: set-up, window, the traced reading and the check; and the
entry point's refusals (no card, no program)."""
import json
import shutil
import subprocess
import sys

import pytest

import gb_harness
import run as run_entry
from gb_testing import of_family, one_torch_thread, tiny_cell  # noqa: F401

GNN = gb_harness.family("gnn")


@pytest.mark.parametrize("name", of_family("gnn"))
def test_tiny_run_is_correct(name):
    cell = tiny_cell(name)
    out = gb_harness.run_cell(cell, 2**31 + 77, 1.5, trace=False,
                              device="cpu")
    assert out["correct"], out["checks"]
    assert out["trainings"][0]["steps"] >= GNN.follow_steps(
        cell["traffic"])[0]
    line = gb_harness.metrics_line(out, trace=False)
    # no device, no peak memory: only host-clock metrics
    assert set(line) == {m["name"] for m in cell["end_to_end"]} - {
        "peak_mem_gib"}
    assert all(v["value"] > 0 for v in line.values())
    if cell["traffic"]["rsc"]:
        refreshes = out["detail"]["plan_refreshes"]
        assert refreshes, "the followed steps hold a refresh"
        assert all(r["ok"] for r in refreshes.values())


def test_cpu_trace_reports_no_device_metric():
    cell = tiny_cell("gcn-reddit-rsc")
    out = gb_harness.run_cell(cell, 5, 1.0, trace=True, device="cpu")
    assert out["correct"], out["checks"]
    assert "profile" not in out
    line = gb_harness.metrics_line(out, trace=True)
    device_metrics = {m["name"] for m in cell["per_layer"]
                      if m["source"] == "device_trace"}
    assert device_metrics and not device_metrics & set(line)
    assert {"engine.step_p50_ms", "planner.plan_share",
            "planner.flops_fraction", "setup.operands_s"} <= set(line)
    assert 0 < line["planner.flops_fraction"]["value"] <= 0.1 + 1e-9


def test_entry_point_refuses_without_a_card(capsys, monkeypatch):
    monkeypatch.setattr(sys, "path", list(sys.path))
    for k in ("TRITON_CACHE_DIR", "TORCH_EXTENSIONS_DIR",
              "RSC_TORCH_AUTOTUNE_CACHE"):
        monkeypatch.setenv(k, "unset")     # restored after the test
    rc = run_entry.main(["--workload", "gcn-reddit-rsc", "--seed", "1",
                         "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_entry_point_refuses_without_the_program(tmp_path):
    """A checkout of BENCHMARK.json and gpubench/ alone prints no
    result."""
    shutil.copy(gb_harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(gb_harness.HERE, tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run(
        [sys.executable, "gpubench/run.py", "--workload", "gcn-reddit-rsc",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
        capture_output=True, text=True, timeout=120,
        env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    with pytest.raises(json.JSONDecodeError):
        json.loads(p.stdout or "x")
