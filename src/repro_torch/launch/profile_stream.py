"""Stage times of one streaming full-graph GNN forward, serial and
overlapped, each without the partition LRU, with a cold one and with a
warm one.

    PYTHONPATH=src python -m repro_torch.launch.profile_stream \
        --scale 0.1 --rounds 3

Builds one ``StreamingInference`` of a GCN with batchnorm and seeded
weights on synthetic Reddit (3 × 256, block 128, a 2,048 MB partition
budget by default) and runs ``--rounds`` rounds of six forwards: serial
and overlapped, each with no LRU, a cold LRU and a warm LRU of
``--resident-mb``. Every forward is held bit for bit against the first
serial one. Prints one line per forward (wall, upload, stall, compute
and host ms) and then one JSON line of the same, with the card's name
and power limit. A one-off analysis of the serving stream's upload
path; the serving path never calls it.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import time

import numpy as np
import torch

import repro_torch
from repro_torch import obs
from repro_torch.graphs.datasets import load_dataset
from repro_torch.infer import StreamConfig, StreamingInference
from repro_torch.infer.stream import _DeviceLRU
from repro_torch.models.gnn import MODELS

MODES = [(overlap, lru) for overlap in (False, True)
         for lru in ("none", "cold", "warm")]


def timed_forward(si) -> tuple[np.ndarray, dict]:
    """One forward (``store=False``) with the stream's own metrics on: wall
    time, uploads (serial: ``stream.upload_ms``; overlapped: the worker's
    ``prefetch.upload_ms`` and the consumer's ``prefetch.stall_ms``), the
    pre-map + SpMM + read back (``stream.compute_ms``) and the rest (host
    row ops and gathers), in ms."""
    ob = obs.reset(metrics=True)
    if si.device.type == "cuda":
        torch.cuda.synchronize(si.device)
    t0 = time.perf_counter()
    logits = si.forward(store=False)
    wall = (time.perf_counter() - t0) * 1e3
    h = ob.registry.snapshot()["histograms"]
    obs.reset()

    def total(name):
        return sum(v["sum"] for k, v in h.items()
                   if k.split("{")[0] == name)

    st = {"wall_ms": wall, "upload_ms": total("stream.upload_ms"),
          "compute_ms": total("stream.compute_ms"),
          "prefetch_upload_ms": total("prefetch.upload_ms"),
          "stall_ms": total("prefetch.stall_ms")}
    st["host_ms"] = wall - st["upload_ms"] - st["stall_ms"] \
        - st["compute_ms"]
    if si.lru is not None:
        st["lru"] = {"hits": si.lru.hits, "misses": si.lru.misses,
                     "evictions": si.lru.evictions,
                     "resident_bytes": si.lru.resident_bytes}
    return logits, st


def profile_round(si, resident_mb: float, want: np.ndarray) -> dict:
    """One round of ``MODES`` on ``si``: ``{"serial_none": stages, ...}``;
    raises if a forward's bits differ from ``want``."""
    out = {}
    for overlap, lru in MODES:
        si.cfg = dataclasses.replace(si.cfg, overlap=overlap)
        if lru != "warm":
            si.lru = (None if lru == "none"
                      else _DeviceLRU(int(resident_mb * 2 ** 20)))
        logits, st = timed_forward(si)
        if not np.array_equal(logits, want):
            raise AssertionError(f"overlap={overlap} lru={lru}: the "
                                 "forward differs from the serial one")
        out[f"{'overlap' if overlap else 'serial'}_{lru}"] = st
    si.lru = None
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=float, default=0.1)
    ap.add_argument("--layers", type=int, default=3)
    ap.add_argument("--hidden", type=int, default=256)
    ap.add_argument("--block", type=int, default=128)
    ap.add_argument("--memory-budget-mb", type=float, default=2048.0)
    ap.add_argument("--resident-mb", type=float, default=4096.0)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    graph = load_dataset("reddit", scale=args.scale, seed=0)
    net = MODELS["gcn"].init(graph.features.shape[1], args.hidden,
                             graph.num_classes, args.layers, True, seed=0,
                             device=args.device)
    cfg = StreamConfig(block=args.block,
                       memory_budget_mb=args.memory_budget_mb,
                       device=args.device)
    t0 = time.perf_counter()
    si = StreamingInference(graph, "gcn", net, cfg)
    build_s = time.perf_counter() - t0
    want = si.forward(store=False).copy()
    rounds = []
    for r in range(args.rounds):
        rounds.append(profile_round(si, args.resident_mb, want))
        for k, st in rounds[-1].items():
            print(f"[stream round {r}] {k}: " + ", ".join(
                f"{a} {b:.1f}" for a, b in st.items() if a != "lru"),
                flush=True)
    card = (subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip() if si.device.type == "cuda" else None)
    out = {"args": vars(args), "package": repro_torch.__file__,
           "card": card, "n_nodes": graph.n,
           "n_partitions": si.n_partitions, "build_s": build_s,
           "rounds": rounds}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
