"""One run of one cell: set-up, the measured window, the traced reading,
and the comparison with the plain reference; the same for every model
family.

A cell (an entry of ``BENCHMARK.json``'s ``workloads``) names a
configuration (``configs/<config>.json``) and a traffic mix
(``traffic/<traffic>.json``). Its limits are in
``limits/<workload>.json``; each per-layer metric is read by
``metrics/<name>.py``; the configuration's ``family`` key (``gnn`` where
it has none) names the module that runs it, ``families/<family>.py``. A
traffic mix carries the same key. Everything is found by name, so a new
family's cell is new files only.

A family module supplies:

* ``NAMES``: the numbers its check returns, which its limits may use;
* ``check_config(config)``: raises on a configuration it cannot run;
* ``tiny(cell, **traffic)``: the cell cut to the size of the CPU tests;
* ``faults(cell)``: the faults the cell can have, for the tests;
* ``end_to_end(out)``: its own end-to-end values by metric name;
* ``Run(cell, seed, device)``: set-up (inputs from the seed, the
  program's source of work), with ``parts``, the named seconds of set-up
  (``operands_s`` among them where the family builds operands), and:

  - ``warm_up()``: every shape the window uses;
  - ``planted(fault)``: a context in which the program runs with the
    fault planted (none: as it is);
  - ``job(index, deadline=, follow=, profiled=, fault=,
    followed_only=False)``: one job of the window, set up; calling it
    runs it until it ends or, before its next step, the deadline has
    passed; ``record()`` then holds ``steps`` done, ``nonfinite`` losses,
    ``done`` and what its readers need; where ``follow``, ``kept()`` is
    what the check judges;
  - ``work(record)``: the counted work of the profiled job;
  - ``release()``: frees the program's state before the check;
  - ``check(kept, every_leaf=False)``: ``({name: value}, notes)``;
  - ``control()``: the control's name and the control in the program's
    place, as ``kept``;
  - ``detail(out, notes)``: the family's part of the result's detail.

The driver keeps TF32 off on the card, runs the window's jobs back to
back until its time is up (the first is the one the check follows, and
with ``--trace 1`` the one ``torch.profiler`` records), reads the peak
memory, frees the program's state and judges the check's numbers against
the cell's limits.
"""
from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import sys
import time
from pathlib import Path

import torch

import gb_check
import gb_devtrace

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
DEFAULT_FAMILY = "gnn"


# ------------------------------------------------------------- the cell

def family_name(entry: dict) -> str:
    """The family a configuration or a traffic mix belongs to."""
    return entry.get("family", DEFAULT_FAMILY)


_FAMILIES: dict[Path, object] = {}


def family(name: str, home: Path = HERE):
    """``families/<name>.py`` of the benchmark directory ``home``."""
    path = (home / "families" / f"{name}.py").resolve()
    if path not in _FAMILIES:
        if not path.is_file():
            have = sorted(p.stem for p in (home / "families").glob("*.py"))
            raise KeyError(f"no model family {name!r}: {path} is missing "
                           f"(have {have})")
        spec = importlib.util.spec_from_file_location(
            f"gb_family_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = mod
        spec.loader.exec_module(mod)
        _FAMILIES[path] = mod
    return _FAMILIES[path]


def family_of(cell: dict):
    return family(cell["family"], cell["home"])


def load_cell(name: str, bench_path: Path | None = None) -> dict:
    """The cell's entry, configuration, traffic, limits and metrics, as
    ``BENCHMARK.json`` names them, checked by the configuration's family.
    The benchmark's files lie under the first of its ``paths``."""
    bench_path = Path(bench_path or ROOT / "BENCHMARK.json")
    root = bench_path.parent
    bench = json.loads(bench_path.read_text())
    home = root / bench["paths"][0]
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(work)})")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((home / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    limits = json.loads((home / "limits" / f"{name}.json").read_text())
    fam_name = family_name(config)
    fam = family(fam_name, home)
    if family_name(traffic) != fam_name:
        raise ValueError(f"cell {name!r}: traffic {w['traffic']!r} is of "
                         f"family {family_name(traffic)!r}, its "
                         f"configuration of {fam_name!r}")
    fam.check_config(config)
    unknown = set(limits) - set(fam.NAMES)
    if unknown:
        raise ValueError(f"cell {name!r}: limits {sorted(unknown)} are no "
                         f"number of family {fam_name!r} ({fam.NAMES})")

    def applies(m):
        return "workloads" not in m or name in m["workloads"]
    return {"name": name, "workload": w, "config": config,
            "traffic": traffic, "limits": limits, "family": fam_name,
            "home": home,
            "end_to_end": [m for m in bench["end_to_end"] if applies(m)],
            "per_layer": [m for m in bench["per_layer"] if applies(m)]}


def metric_reader(name: str, home: Path = HERE):
    """``metrics/<name>.py``'s ``read`` function."""
    path = home / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "gpubench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# ------------------------------------------------------------- the run

def _sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def run_cell(cell: dict, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_process: float | None = None,
             fault: str | None = None) -> dict:
    """Set-up, window and check of one cell; the result before printing.

    ``fault`` (tests only) plants one fault in the timed path."""
    from repro_torch import obs
    t_process = time.perf_counter() if t_process is None else t_process
    if device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    run = family_of(cell).Run(cell, seed, device)
    t_warm = time.perf_counter()
    run.warm_up()
    t_warm = time.perf_counter() - t_warm

    if trace:
        ob = obs.reset(metrics=True, trace=True)
        ob.tracer.reset()
        t_origin = time.perf_counter()
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    jobs, setups = [], []
    prof = t_mark = None
    first = None
    t_start = time.perf_counter()
    deadline = t_start + seconds
    index = 0
    with run.planted(fault):
        while time.perf_counter() < deadline:
            profiled = trace and index == 0
            ctx = (torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
                if profiled and device == "cuda" else contextlib.nullcontext())
            with ctx as p:
                t0 = time.perf_counter()
                if profiled and device == "cuda":
                    prof, t_mark = p, gb_devtrace.mark()
                job = run.job(index, deadline=None if profiled else deadline,
                              follow=index == 0, profiled=profiled,
                              fault=fault)
                setups.append((t0, time.perf_counter()))
                job()
                _sync(device)
                t1 = time.perf_counter()
            jobs.append({**job.record(), "t0": t0, "t1": t1})
            if index == 0:
                first = job
            del job
            index += 1
    t_end = time.perf_counter()
    window_s = t_end - t_start
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else None

    parts = {**run.parts, "warm_up_s": t_warm}
    out = {"t_process": t_process, "t_start": t_start, "window_s": window_s,
           "trained_s": sum(t["t1"] - t["t0"] for t in jobs),
           "setup_s": t_start - t_process,
           "operands_s": parts.get("operands_s"), "setup_parts": parts,
           "trainings": jobs, "peak_bytes": peak, "device": device,
           "cell": cell, "seconds": seconds}
    if trace:
        out["spans"] = _spans(ob.tracer, t_origin) + [
            ("engine_setup", a, b) for a, b in setups]
        out["work"] = run.work(jobs[0])
        if prof is not None:
            tr = jobs[0]
            out["profile"] = _profile(prof, t_mark, tr["t0"], tr["t1"],
                                      out["spans"])
        obs.reset()

    # The check: once the window has closed and the peak is read, with
    # the program's state freed.
    kept = first.kept()
    del first
    run.release()
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers, notes = run.check(kept)
    out["correct"], out["checks"] = gb_check.judge(numbers, cell["limits"])
    out["check_s"] = time.perf_counter() - t_check
    out["detail"] = {"window_s": window_s, "check_s": out["check_s"],
                     "setup_parts": parts, **run.detail(out, notes)}
    return out


def _spans(tracer, t_origin: float) -> list[tuple[str, float, float]]:
    """The program's spans on the host clock."""
    return [(e["name"], t_origin + e["ts_us"] / 1e6,
             t_origin + (e["ts_us"] + e["dur_us"]) / 1e6)
            for e in tracer.snapshot() if e.get("kind") == "span"]


def _profile(prof, t_mark, t0, t1, spans) -> dict:
    tr = gb_devtrace.read(prof, t_mark)
    busy = gb_devtrace.union(tr["kernels"], t0, t1)
    names = gb_devtrace.by_name(tr["kernels"], t0, t1)
    idle = gb_devtrace.idle_by_span(busy, spans, t0, t1)
    return {"t0": t0, "t1": t1, "wall_s": t1 - t0,
            "busy_s": sum(b - a for a, b in busy),
            "by_name": names, "idle_by_span": idle}


# ------------------------------------------------------------- the report

def end_to_end(out: dict) -> dict:
    """The end-to-end metrics, by name: ``epoch_ms`` is the window's wall
    time over the optimizer steps its jobs completed (one full-batch GNN
    step is one epoch), and the family adds its own."""
    steps = sum(t["steps"] for t in out["trainings"])
    vals = {"epoch_ms": out["window_s"] * 1e3 / max(steps, 1),
            "setup_s": out["setup_s"]}
    if out["peak_bytes"] is not None:
        vals["peak_mem_gib"] = out["peak_bytes"] / 2**30
    return {**vals, **family_of(out["cell"]).end_to_end(out)}


def metrics_line(out: dict, trace: bool) -> dict:
    """``{name: {"value", "unit"}}`` of the cell's metrics for this kind
    of run; a metric its reader finds nothing for is left out."""
    cell = out["cell"]
    if not trace:
        vals = end_to_end(out)
        return {m["name"]: {"value": vals[m["name"]], "unit": m["unit"]}
                for m in cell["end_to_end"]
                if vals.get(m["name"]) is not None}
    line = {}
    for m in cell["per_layer"]:
        v = metric_reader(m["name"], cell["home"])(out)
        if v is not None:
            line[m["name"]] = {"value": v, "unit": m["unit"]}
    return line
