"""The readers of the program's spans: known spans give the known value,
no span of the name gives None (the CPU, the profiled training, and a
program that records no such span), and a tiny traced run on the CPU
reads the host spans and no device span."""
import statistics

import pytest

import gb_harness
import gb_spans
from gb_testing import one_torch_thread, tiny_cell  # noqa: F401


def _steps(n=3):
    """``n`` steps of 1 s: each with a device step (0.7 s, 0.2 s of it the
    loss read), the device spans of a step, and an evaluation's forward
    SpMM after it (outside the step)."""
    spans = []
    for i in range(n):
        t = float(i)
        spans += [("step", t, t + 0.9), ("plan", t, t + 0.1),
                  ("device_step", t + 0.1, t + 0.8),
                  ("forward", t + 0.1, t + 0.3),
                  ("loss_read", t + 0.6, t + 0.8),
                  ("gpu.forward", t + 0.15, t + 0.35),
                  ("gpu.spmm.forward", t + 0.16, t + 0.21),
                  ("gpu.spmm.forward", t + 0.22, t + 0.28),
                  ("gpu.backward", t + 0.4, t + 0.4 + 0.1 * (i + 1)),
                  ("gpu.spmm.backward", t + 0.41, t + 0.41 + 0.01 * (i + 1)),
                  ("gpu.optimizer", t + 0.55, t + 0.6),
                  ("gpu.spmm.forward", t + 0.92, t + 0.98)]
    spans += [("eval", 3.0, 4.0), ("eval.score", 3.5, 3.75),
              ("eval.score", 5.0, 5.25)]
    return {"spans": spans, "trained_s": 10.0}


EXPECTED = {
    "step.forward_gpu_p50_ms": 200.0,
    "step.backward_gpu_p50_ms": 200.0,
    "step.optimizer_gpu_p50_ms": 50.0,
    "rsc_spmm.forward_gpu_p50_ms": 110.0,
    "rsc_spmm.backward_gpu_p50_ms": 20.0,
    "step.host_issue_p50_ms": 500.0,
    "engine.eval_score_share": 5.0,
}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_reads_known_spans(name):
    got = gb_harness.metric_reader(name)(_steps())
    assert got == pytest.approx(EXPECTED[name], rel=1e-9)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_without_its_spans_gives_none(name):
    """No spans; and a program whose tracer records only the host spans
    ``step`` ⊃ ``plan``, ``device_step`` and ``eval``."""
    read = gb_harness.metric_reader(name)
    assert read({"spans": [], "trained_s": 1.0}) is None
    old = [s for s in _steps()["spans"] if s[0] in
           ("step", "plan", "device_step", "eval")]
    assert read({"spans": old, "trained_s": 10.0}) is None


def test_tiny_traced_run_reads_host_spans_only():
    cell = tiny_cell("gcn-reddit-rsc")
    out = gb_harness.run_cell(cell, 2**31 + 5, 1.0, trace=True,
                              device="cpu")
    assert out["correct"], out["checks"]
    names = {n for n, _, _ in out["spans"]}
    assert {"forward", "backward", "optimizer", "loss_read", "eval.logits",
            "eval.score", "plan.refresh"} <= names
    assert not any(n.startswith("gpu.") for n in names)
    line = gb_harness.metrics_line(out, trace=True)
    assert {"step.host_issue_p50_ms", "engine.eval_score_share"} <= set(line)
    assert not {n for n in EXPECTED if "_gpu_" in n} & set(line)
    steps = [d for d, _ in gb_spans.inside(out, "device_step", "loss_read")]
    assert 0 < line["step.host_issue_p50_ms"]["value"] <= \
        statistics.median(steps)
