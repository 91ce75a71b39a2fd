"""Run one cell of the benchmark once and print its result line.

    python3 gpubench/run.py --workload gcn-reddit-rsc --seed 7 \\
        --seconds 51 --trace 0

From the root of a checkout. ``--trace 0`` prints the cell's end-to-end
metrics, ``--trace 1`` its per-layer ones (the program's spans and
counters on, ``torch.profiler`` over the window's first training). Every
run judges what its window produced against the plain reference and
prints each compared number beside its limit, last on standard error and
last in the result line. The result is the last line of standard output.

It needs a CUDA device (it exits with code 3 and prints no result
otherwise) and the program (``<checkout>/src/repro_torch``). The program's
kernels build into ``<checkout>/build/kernels``.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# Modules of the JAX package and its stack, by top-level name: none may be
# loaded in the process that prints a result.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _environment() -> None:
    """Paths before anything is imported: the program and the harness on
    ``sys.path``; build and kernel caches inside the checkout, at fixed
    places; the SpMM autotune cache pointed at a file nothing writes, so
    every run dispatches the program's default tiles."""
    sys.path[:0] = [str(HERE), str(ROOT / "src")]
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["RSC_TORCH_AUTOTUNE_CACHE"] = str(build / "gpubench"
                                                 / "no-autotune.json")


def loaded_forbidden() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def _power_limit() -> str | None:
    try:
        p = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return p.stdout.strip().splitlines()[0] if p.stdout.strip() else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    import torch
    try:
        import gb_harness
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"gpubench: cannot import the program or the harness: {e}",
              file=sys.stderr)
        return 2
    cell = gb_harness.load_cell(args.workload)
    chips = int(cell["workload"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"gpubench: the cell needs {chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    power = _power_limit()
    out = gb_harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                              device="cuda", t_process=T_PROCESS)
    bad = loaded_forbidden()
    if bad:
        print(f"gpubench: the process loaded {bad}", file=sys.stderr)
        return 4
    result = {
        "correct": bool(out["correct"]),
        "attempted": sum(t["steps"] for t in out["trainings"]),
        "failed": sum(t["nonfinite"] for t in out["trainings"]),
        "metrics": gb_harness.metrics_line(out, bool(args.trace)),
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": chips, "memory_peak_bytes": out["peak_bytes"]},
    }
    if power:
        result["device"]["power"] = power
    if args.trace:
        prof = out.get("profile")
        if not prof or prof["busy_s"] <= 0:
            print("gpubench: the profiler saw no device activity",
                  file=sys.stderr)
            return 5
        result["device"]["busy_s"] = prof["busy_s"]
        result["device"]["window_s"] = prof["wall_s"]
        result["breakdown"] = {
            "device_ops": sorted(([n, s] for n, s in prof["by_name"].items()),
                                 key=lambda r: -r[1])[:10],
            "idle_gaps": sorted(([n, s] for n, s in
                                 prof["idle_by_span"].items()),
                                key=lambda r: -r[1])[:10]}
    result["detail"] = out["detail"]
    result["checks"] = out["checks"]
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(_finite(result), allow_nan=False))
    return 0


def _finite(x):
    """JSON has no inf or nan: such a number is written as a string."""
    if isinstance(x, float) and not math.isfinite(x):
        return repr(x)
    if isinstance(x, dict):
        return {str(k): _finite(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_finite(v) for v in x]
    return x


if __name__ == "__main__":
    sys.exit(main())
