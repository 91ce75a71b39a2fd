"""The readings the limits of ``correct`` are set from, at a cell's own
size: for each seed, the program as it runs (sound), the control (for the
``gnn`` family the plain reference in TF32 put in the program's place, one
precision below the configuration's float32) and the program with each
fault planted.
Each is held against the float32 reference by the cell's family's check,
every leaf's gaps kept beside them. The benchmark's runs never run this.

    python3 gpubench/readings.py --workload gcn-reddit-rsc \\
        --seeds 11,12,13 --fault-seeds 2 --out build/readings.jsonl

The control and the faults are read on the first ``--fault-seeds`` seeds,
the program as it runs on all of them. One JSON line per seed and reading
is appended to ``--out`` and printed.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent


def read_seed(cell: dict, seed: int, device: str, faults=None,
              control: bool = True) -> list:
    """The readings of one seed, through the cell's family: ``[{"reading",
    "numbers", ...the check's notes}]``; ``faults`` None: every fault the
    cell can have."""
    import gb_harness as H
    fam = H.family_of(cell)
    run = fam.Run(cell, seed, device)
    faults = fam.faults(cell) if faults is None else faults
    rows = []

    def row(reading, kept):
        numbers, notes = run.check(kept, every_leaf=True)
        return {"reading": reading, "numbers": numbers, **notes}

    for fault in (None, *faults):
        with run.planted(fault):
            job = run.job(0, follow=True, fault=fault, followed_only=True)
            job()
        kept = job.kept()
        del job
        rows.append(row(fault or "sound", kept))
    if control:
        rows.append(row(*run.control()))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds")
    ap.add_argument("--fault-seeds", type=int, default=3,
                    help="read the control and the faults on this many of "
                    "the seeds, the first")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(HERE))
    import run
    run._environment()
    import torch
    import gb_harness
    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = gb_harness.load_cell(args.workload)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        full = i < args.fault_seeds
        for row in read_seed(cell, seed, "cuda", None if full else (),
                             control=full):
            row.update(workload=args.workload, seed=seed,
                       device=torch.cuda.get_device_name(0),
                       seconds=time.perf_counter() - t0)
            line = json.dumps(row)
            print(line, flush=True)
            with out.open("a") as f:
                f.write(line + "\n")
        gc.collect()            # the seed's operands, held in cycles
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
