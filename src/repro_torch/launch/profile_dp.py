"""GNN data-parallel minibatch training per rank, with the all-reduce
overlapped and not.

    PYTHONPATH=src python -m repro_torch.launch.profile_dp --dp 4 -- \
        --dataset ogbn-products --scale 0.1 --layers 3 --hidden 256 \
        --block 128 --rsc --budget 0.1 --roots 2000 --walk-length 4

Runs ``train gnn --minibatch --dp N`` with the flags after ``--`` twice,
without and with ``--overlap-allreduce`` (NCCL with one card per rank
when the cards suffice; ``--force-host-devices N`` among the flags puts
every rank on one device over gloo), and prints one JSON line: the
card's name and power limit, and per run and rank the median step ms of
the RSC and the exact steps (past the first epoch; host clock to the
loss read back), the median all-reduce ms left after the backward, its
f32 bytes per step, the launches by variant, peak device memory and the
set-up seconds. The two runs' step medians differ by what the overlap
saves. A one-off measurement; the training path never calls it.
"""
from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np

from repro_torch.launch import train


def _summary(rank: dict, n_sub_per_rank: int) -> dict:
    h = rank["result"]["history"]
    modes = np.asarray(h["mode"])
    step_ms = np.asarray(h["step_time"]) * 1e3
    red = rank["allreduce"]

    def median(x):
        return float(np.median(x)) if len(x) else None
    return {"rank": rank["rank"],
            "rsc_step_ms": median(step_ms[modes == "rsc"][n_sub_per_rank:]),
            "exact_step_ms": median(step_ms[modes == "exact"][1:]),
            "allreduce_ms": median(red["reduce_ms"]),
            "f32_bytes_per_step": red["f32_bytes"],
            "buckets": red["buckets"],
            "launches_by_variant": rank["launches_by_variant"]["bcoo_spmm"],
            "peak_mem_gib": (rank["peak_mem_bytes"] / 2 ** 30
                             if rank["peak_mem_bytes"] is not None else None),
            "setup_s": rank["setup_s"], "wall_s": rank["wall_s"]}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dp", type=int, default=4)
    ap.add_argument("flags", nargs=argparse.REMAINDER,
                    help="train gnn's flags, after --")
    args = ap.parse_args(argv)
    flags = [f for f in args.flags if f != "--"]
    base = ["gnn", "--minibatch", "--dp", str(args.dp), *flags]
    card = None
    if "cpu" not in flags:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], check=True, capture_output=True,
            text=True, timeout=60).stdout.strip().splitlines()
    runs = {}
    for name, extra in (("serial", []), ("overlapped",
                                         ["--overlap-allreduce"])):
        out = train.main(base + extra)
        cfg = train.build_parser().parse_args(base + extra)
        n_sub = cfg.subgraphs // args.dp
        runs[name] = {"report": out["report"],
                      "ranks": [_summary(r, n_sub) for r in out["ranks"]]}
    report = {"dp": args.dp, "flags": flags, "card": card, "runs": runs}
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
