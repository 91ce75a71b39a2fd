"""The tracer's device spans on the card: a full-batch GCN RSC training
with tracing on records ``gpu.forward``, ``gpu.backward``,
``gpu.optimizer``, ``gpu.spmm.*`` and ``gpu.eval`` on the ``device``
track, each inside the host span it times (a ``step`` or an ``eval``);
none under ``torch.profiler``; and the summed ``gpu.spmm.*`` time of one
training is within 0.95-1.15x of the ``bcoo_spmm`` kernel time that the
profiler reads in the same training run again.

Every test here needs a CUDA device and skips without one; the file
imports neither JAX nor ``repro``. From the repository root on a machine
with a card:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \\
        tests/test_torch_trace_cuda.py
"""
import pytest
import torch

from repro_torch import obs
from repro_torch.graphs.synthetic import sbm_graph
from repro_torch.models.gnn import MODELS
from repro_torch.train.engine import (Engine, FullGraphPlanner,
                                      FullGraphSource, TrainConfig)

pytestmark = pytest.mark.cuda

# The bcoo_spmm kernels' names (csrc/bcoo_spmm.cu).
BCOO_SPMM = ("spmm", "reduce_chunks")
# A graph whose tiles are nearly all present (~15k of 125 x 125), so an
# SpMM takes milliseconds and an event's own cost is small beside it.
GRAPH = dict(n_nodes=16000, n_clusters=8, avg_degree=60, feat_dim=128,
             seed=0)


def _cfg(epochs: int) -> TrainConfig:
    return TrainConfig(model="gcn", n_layers=3, hidden=256, block=128,
                       dropout=0.5, rsc=True, budget=0.1, epochs=epochs,
                       refresh_every=5, probe_every=0, device="cuda")


def _train(source, epochs: int) -> dict:
    cfg = _cfg(epochs)
    at, meta, fro = source.planner_operand()
    planner = FullGraphPlanner(cfg, MODELS["gcn"], at, meta, fro,
                               source.num_classes, source.device)
    res = Engine(cfg, source, planner=planner).train(eval_every=5)
    torch.cuda.synchronize()
    return res


@pytest.fixture(scope="module")
def runs():
    """One training traced, then the same training traced under the
    profiler (after a warm-up that builds the kernel)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    graph = sbm_graph(**GRAPH)
    source = FullGraphSource(graph, _cfg(20), MODELS["gcn"])
    try:
        obs.reset()
        _train(source, 6)
        ob = obs.reset(trace=True)
        res = _train(source, 20)
        traced = ob.tracer.snapshot()
        ob = obs.reset(trace=True)
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            res_p = _train(source, 20)
        profiled = ob.tracer.snapshot()
    finally:
        obs.reset()
    kernel_s = sum(
        (e.time_range.end - e.time_range.start) / 1e6
        for e in prof.events()
        if str(getattr(e, "device_type", "")).endswith("CUDA")
        and any(w in e.name for w in BCOO_SPMM))
    return {"res": res, "traced": traced, "res_p": res_p,
            "profiled": profiled, "kernel_s": kernel_s}


def _within(e, outers, slack_us=1.0) -> bool:
    a, b = e["ts_us"], e["ts_us"] + e["dur_us"]
    return any(o["ts_us"] - slack_us <= a and b <= o["ts_us"] + o["dur_us"]
               + slack_us for o in outers)


def test_device_spans_lie_inside_their_host_spans(runs):
    ev = runs["traced"]
    steps = [e for e in ev if e["name"] == "step"]
    evals = [e for e in ev if e["name"] == "eval"]
    gpu = [e for e in ev if e["name"].startswith("gpu.")]
    n = len(runs["res"]["history"]["loss"])
    assert len(steps) == n == 20
    for name in ("gpu.forward", "gpu.backward", "gpu.optimizer"):
        mine = [e for e in gpu if e["name"] == name]
        assert len(mine) == n, name
        assert all(_within(e, steps) for e in mine), name
    assert len([e for e in gpu if e["name"] == "gpu.eval"]) == len(evals)
    assert all(_within(e, evals) for e in gpu if e["name"] == "gpu.eval")
    spmm = [e for e in gpu if e["name"].startswith("gpu.spmm.")]
    # 3 forward + 3 backward SpMMs a step, 3 forward an evaluation
    assert len(spmm) == 6 * n + 3 * len(evals)
    assert all(_within(e, steps + evals) for e in spmm)
    assert all(set(e["args"]) == {"d", "n_active", "s_pad"}
               and 0 <= e["args"]["n_active"] <= e["args"]["s_pad"]
               for e in spmm)
    tids = {e["tid"] for e in gpu}
    assert len(tids) == 1 and tids.isdisjoint(e["tid"] for e in steps)
    assert runs["res"]["history"]["loss"] == runs["res_p"]["history"]["loss"]


def test_no_device_span_while_the_profiler_records(runs):
    names = [e["name"] for e in runs["profiled"]]
    assert names.count("step") == 20 and names.count("forward") == 20
    assert not [n for n in names if n.startswith("gpu.")]


def test_spmm_device_time_matches_the_profiled_kernels(runs):
    spmm_s = sum(e["dur_us"] for e in runs["traced"]
                 if e["name"].startswith("gpu.spmm.")) / 1e6
    ratio = spmm_s / runs["kernel_s"]
    print(f"gpu.spmm.* {spmm_s * 1e3:.3f} ms, bcoo_spmm kernels "
          f"{runs['kernel_s'] * 1e3:.3f} ms, ratio {ratio:.4f}")
    assert 0.95 <= ratio <= 1.15
