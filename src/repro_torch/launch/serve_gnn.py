"""GNN node-serving entry point: streaming full-graph forward + batched
queries.

Builds a GCN, GraphSAGE or GCNII (trained for ``--train-epochs`` full-batch
epochs with ``GNNTrainer``, or seeded random weights with
``--train-epochs 0``), precomputes full-graph activations by partitioned
streaming inference through the CUDA SpMM kernel, and answers batched
node-id queries from the cached logits:

    PYTHONPATH=src python -m repro_torch.launch.serve_gnn --dataset reddit \
        --scale 0.1 --model gcn --layers 3 --hidden 256 --block 128 \
        --memory-budget-mb 2048 --replicas 0 --train-epochs 0 \
        --queries 256 --query-batch 64

The flags are those of ``repro.launch.serve_gnn`` plus ``--device``
(``cuda`` by default; ``cpu`` runs the kernels' plain versions). This
port covers the bare-server path (``--replicas 0``, the default here).
Flags of parts not yet ported raise ``NotImplementedError`` naming the
ROADMAP.md Queue 1 item that ports them. With ``--train-epochs`` > 0 it
prints a ``[serve] trained ...`` line first; the last line is one JSON
object.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from repro_torch.device import resolve_device
from repro_torch.graphs.datasets import DATASETS, load_dataset
from repro_torch.infer import NodeServer, StreamConfig
from repro_torch.models.gnn import MODELS
from repro_torch.train.loop import GNNTrainer, TrainConfig

_CKPT = "Queue 1 item 5 (checkpoint and resume)"
_OBS = "Queue 1 item 6 (observability)"
_SERVING = "Queue 1 item 7 (serving: updates, LRU/overlap, replicas)"


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="GNN node serving: streaming full-graph forward + "
                    "batched node queries (PyTorch port)")
    ap.add_argument("--dataset", default="reddit", choices=sorted(DATASETS))
    ap.add_argument("--scale", type=float, default=0.002)
    ap.add_argument("--model", default="gcn",
                    choices=["gcn", "graphsage", "gcnii"])
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--dropout", type=float, default=0.5,
                    help="training dropout (no effect when serving)")
    ap.add_argument("--no-bn", action="store_true",
                    help="disable batchnorm")
    ap.add_argument("--block", type=int, default=64)
    ap.add_argument("--backend", default="kernel",
                    choices=["kernel", "ref", "dense"],
                    help="SpMM backend of training and serving: the CUDA "
                         "kernel (its plain version on --device cpu), the "
                         "CPU-only streaming ref, or dense (scatter into a "
                         "dense operand + matmul)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--train-epochs", type=int, default=10,
                    help="full-batch training epochs before serving (0: "
                         "seeded random weights)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--memory-budget-mb", type=float, default=64.0)
    ap.add_argument("--partitions", type=int, default=0,
                    help="explicit partition count (overrides the budget)")
    ap.add_argument("--queries", type=int, default=256)
    ap.add_argument("--query-batch", type=int, default=32)
    ap.add_argument("--update-edges", type=int, default=0)
    ap.add_argument("--replicas", type=int, default=0,
                    help="0 = bare single server (the only mode ported)")
    ap.add_argument("--max-batch", type=int, default=256,
                    help="frontend batching (no effect with --replicas 0)")
    ap.add_argument("--sampled-budget", type=float, default=0.0)
    ap.add_argument("--stream-resident-mb", type=float, default=0.0)
    ap.add_argument("--stream-overlap", action="store_true")
    ap.add_argument("--slow-log", default=None, metavar="PATH")
    ap.add_argument("--metrics", action="store_true")
    ap.add_argument("--metrics-port", type=int, default=None)
    ap.add_argument("--trace-out", default=None, metavar="PATH")
    ap.add_argument("--trace-jsonl", default=None, metavar="PATH")
    ap.add_argument("--slo", action="append", default=[],
                    metavar="KEY=TARGET")
    ap.add_argument("--strict-slo", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def check_ported(args) -> None:
    """Raise ``NotImplementedError`` for flags this port does not cover."""
    unported = [
        (args.ckpt_dir is not None, "--ckpt-dir", _CKPT),
        (args.replicas > 0, "--replicas > 0", _SERVING),
        (args.update_edges > 0, "--update-edges", _SERVING),
        (args.sampled_budget > 0, "--sampled-budget", _SERVING),
        (args.stream_resident_mb > 0, "--stream-resident-mb", _SERVING),
        (args.stream_overlap, "--stream-overlap", _SERVING),
        (args.slow_log is not None, "--slow-log", _OBS),
        (args.metrics, "--metrics", _OBS),
        (args.metrics_port is not None, "--metrics-port", _OBS),
        (args.trace_out is not None, "--trace-out", _OBS),
        (args.trace_jsonl is not None, "--trace-jsonl", _OBS),
        (bool(args.slo), "--slo", _OBS),
        (args.strict_slo, "--strict-slo", _OBS),
    ]
    for hit, flag, item in unported:
        if hit:
            raise NotImplementedError(
                f"{flag} is not ported to repro_torch yet: see ROADMAP.md "
                f"{item}")


def get_params(args, graph, device):
    """The model to serve, on ``device``: trained for ``--train-epochs``
    full-batch epochs (no RSC), as the reference's ``get_params`` does, or
    the seeded initial parameters (the trainer's own) without training."""
    if args.train_epochs <= 0:
        return MODELS[args.model].init(
            graph.features.shape[1], args.hidden, graph.num_classes,
            args.layers, not args.no_bn, seed=args.seed, device=device)
    cfg = TrainConfig(model=args.model, n_layers=args.layers,
                      hidden=args.hidden, epochs=args.train_epochs,
                      dropout=args.dropout, batchnorm=not args.no_bn,
                      block=args.block, seed=args.seed,
                      metric=DATASETS[args.dataset].metric,
                      backend=args.backend, device=str(device))
    tr = GNNTrainer(cfg, graph)
    res = tr.train(eval_every=max(args.train_epochs // 2, 1))
    print(f"[serve] trained {args.train_epochs} epochs, "
          f"test={res['best_test']:.4f}", flush=True)
    return tr.params


def run(args) -> tuple[dict, NodeServer]:
    """Build the server and answer the queries; returns the report and the
    server."""
    check_ported(args)
    device = resolve_device(args.device)
    graph = load_dataset(args.dataset, scale=args.scale, seed=args.seed)
    params = get_params(args, graph, device)
    cfg = StreamConfig(
        block=args.block,
        n_partitions=args.partitions or None,
        memory_budget_mb=(None if args.partitions
                          else args.memory_budget_mb),
        backend=args.backend, device=str(device))
    server = NodeServer(graph, args.model, params, cfg)

    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    n_batches = 0
    for start in range(0, args.queries, args.query_batch):
        ids = rng.integers(0, graph.n,
                           min(args.query_batch, args.queries - start))
        logits = server.query(ids)
        if not graph.multilabel and logits.shape != (ids.shape[0],
                                                     graph.num_classes):
            raise RuntimeError(f"query answered {logits.shape} for "
                               f"{ids.shape[0]} ids")
        n_batches += 1
    query_s = time.perf_counter() - t0

    out = {
        "dataset": args.dataset, "model": args.model,
        "device": str(device), "backend": args.backend,
        "n_nodes": graph.n,
        "replicas": 0,
        "n_partitions": server.si.n_partitions,
        "cache_build_s": round(server.build_seconds, 4),
        "queries": int(args.queries),
        "query_batches": n_batches,
        "queries_per_s": round(args.queries / max(query_s, 1e-9), 1),
        "updates": [],
        "serve_stats": server.stats(),
    }
    return out, server


def main(argv=None) -> dict:
    out, _ = run(build_parser().parse_args(argv))
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
