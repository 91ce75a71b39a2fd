"""GNN node-serving entry point: replicated snapshot frontend + batched
queries.

Builds a GCN, GraphSAGE or GCNII (trained for ``--train-epochs`` full-batch
epochs with ``GNNTrainer``, restored from ``--ckpt-dir``, or seeded random
weights with ``--train-epochs 0``), precomputes full-graph activations by
partitioned streaming inference through the CUDA SpMM kernel, then stands
up a :class:`ServeFrontend` (``--replicas`` NodeServers behind a
write-ahead update log and a query-batching dispatcher) and drives queries
while ``--update-edges`` random edge insertions rebuild the replicas one at
a time off the read path:

    PYTHONPATH=src python -m repro_torch.launch.serve_gnn --dataset reddit \
        --scale 0.1 --model gcn --layers 3 --hidden 256 --block 128 \
        --memory-budget-mb 2048 --train-epochs 0 --replicas 2 \
        --sampled-budget 0.3 --update-edges 2 --stream-resident-mb 4096 \
        --stream-overlap --queries 32768 --query-batch 16

The flags are those of ``repro.launch.serve_gnn`` plus ``--device``
(``cuda`` by default; ``cpu`` runs the kernels' plain versions) and
``--backend``. ``--replicas 0`` serves from a single bare NodeServer (no
frontend threads). ``--sampled-budget`` < 1 adds an RSC-sampled replica
that queries opt into with an error budget; ``--stream-resident-mb`` keeps
partitions' tiles on the card in an LRU; ``--stream-overlap``
double-buffers the partition uploads against the SpMM; ``--slow-log``
writes the frontend's slowest-K request reservoir (``/debug/slow``) to a
JSON file. The observability flags are the reference's (``--metrics``,
whose snapshot lands under ``metrics``; ``--metrics-port``,
``--trace-out``, ``--trace-jsonl``; ``--slo``/``--strict-slo``, whose
report lands under ``slo``). It prints a ``[serve] trained ...`` or
``[serve] restored ...`` line first when it trains or restores; the last
line is one JSON object with the reference's keys.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from repro_torch import obs
from repro_torch.checkpoint import Checkpointer
from repro_torch.convert import gnn_state_tree, load_gnn_state
from repro_torch.device import resolve_device
from repro_torch.graphs.datasets import DATASETS, load_dataset
from repro_torch.infer import NodeServer, ServeFrontend, StreamConfig
from repro_torch.models.gnn import MODELS
from repro_torch.obs import slo as slo_mod
from repro_torch.train.loop import GNNTrainer, TrainConfig
from repro_torch.train.optimizer import Adam


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
    ap.add_argument("--update-edges", type=int, default=0,
                    help="insert N random edges and recompute dirty sets")
    ap.add_argument("--replicas", type=int, default=2,
                    help="exact NodeServer replicas behind the frontend "
                         "(0 = bare single server, no frontend threads)")
    ap.add_argument("--max-batch", type=int, default=256,
                    help="max node ids coalesced into one dispatch")
    ap.add_argument("--sampled-budget", type=float, default=0.0,
                    help="add an RSC-sampled replica with this column "
                         "keep-fraction (<1); queries opt in via an "
                         "error budget (0 = exact replicas only)")
    ap.add_argument("--stream-resident-mb", type=float, default=0.0,
                    help="device-resident partition LRU budget for the "
                         "streaming forward (0 = re-upload every layer)")
    ap.add_argument("--stream-overlap", action="store_true",
                    help="double-buffer partition uploads against the "
                         "device SpMM during cache builds")
    ap.add_argument("--slow-log", default=None, metavar="PATH",
                    help="write the slowest-K request reservoir "
                         "(/debug/slow content) to this JSON file at exit")
    ap.add_argument("--seed", type=int, default=0)
    obs.add_cli_flags(ap)
    slo_mod.add_cli_flags(ap)
    return ap


def get_params(args, graph, device):
    """The model to serve, on ``device``: restored from the latest
    checkpoint in ``--ckpt-dir``, trained for ``--train-epochs``
    full-batch epochs (no RSC), as the reference's ``get_params`` does, or
    the seeded initial parameters (the trainer's own) without training."""
    if args.ckpt_dir or args.train_epochs <= 0:
        net = MODELS[args.model].init(
            graph.features.shape[1], args.hidden, graph.num_classes,
            args.layers, not args.no_bn, seed=args.seed, device=device)
        if not args.ckpt_dir:
            return net
        opt_state = Adam().init(dict(net.named_parameters()))
        step, tree = Checkpointer(args.ckpt_dir).restore(
            gnn_state_tree(net, opt_state), device=device)
        load_gnn_state(net, opt_state, tree)
        print(f"[serve] restored params from step {step}", flush=True)
        return net
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


def random_edge_updates(graph, n: int, rng) -> list[tuple[int, int]]:
    """n random non-edges to insert (original-id pairs)."""
    adj, out = graph.adj, []
    while len(out) < n:
        u, v = (int(x) for x in rng.integers(0, graph.n, 2))
        if u == v:
            continue
        if v in adj.col[adj.rowptr[u]: adj.rowptr[u + 1]]:
            continue
        out.append((u, v))
    return out


def _rounded(stats: dict) -> dict:
    return {k: (round(v, 6) if isinstance(v, float) else
                _rounded(v) if isinstance(v, dict) else v)
            for k, v in stats.items()}


def run(args, *, keep_open: bool = False
        ) -> tuple[dict, NodeServer | ServeFrontend]:
    """Build the server (``--replicas 0``) or the frontend, answer the
    queries and apply the edge updates; returns the report and the server,
    or the frontend: closed (its servers stay readable), or still serving
    with ``keep_open`` (the caller closes it). A frontend update's entry
    also holds each server's update statistics under ``servers``."""
    device = resolve_device(args.device)
    ob = obs.setup_from_args(args)
    monitor = slo_mod.monitor_from_args(args)
    if monitor is not None:
        monitor.start(period=0.25)
        if ob.exporter is not None:
            ob.exporter.attach(slo=monitor)
            print(f"[obs] slo objectives at {ob.exporter.url}/slo")
    graph = load_dataset(args.dataset, scale=args.scale, seed=args.seed)
    params = get_params(args, graph, device)
    cfg = StreamConfig(
        block=args.block,
        n_partitions=args.partitions or None,
        memory_budget_mb=(None if args.partitions
                          else args.memory_budget_mb),
        backend=args.backend,
        resident_mb=args.stream_resident_mb or None,
        overlap=args.stream_overlap, device=str(device))

    rng = np.random.default_rng(args.seed)
    updates: list[dict] = []

    def run_queries(query_fn) -> tuple[int, float]:
        t0 = time.perf_counter()
        n_batches = 0
        for start in range(0, args.queries, args.query_batch):
            ids = rng.integers(0, graph.n,
                               min(args.query_batch, args.queries - start))
            logits = query_fn(ids)
            if not graph.multilabel and logits.shape != (
                    ids.shape[0], graph.num_classes):
                raise RuntimeError(f"query answered {logits.shape} for "
                                   f"{ids.shape[0]} ids")
            n_batches += 1
        return n_batches, time.perf_counter() - t0

    if args.replicas <= 0:
        served = server = NodeServer(graph, args.model, params, cfg)
        n_batches, query_s = run_queries(server.query)
        if args.update_edges > 0:
            for e in random_edge_updates(graph, args.update_edges, rng):
                stats = server.update_edges(add=[e])
                updates.append(_rounded({k: v for k, v in stats.items()
                                         if k != "retile"}))
        n_parts = server.si.n_partitions
        build_s = server.build_seconds
        serve_stats = server.stats()
    else:
        served = frontend = ServeFrontend(
            graph, args.model, params, cfg, replicas=args.replicas,
            max_batch=args.max_batch,
            sampled_budget=(args.sampled_budget
                            if 0 < args.sampled_budget < 1 else None))
        try:
            if ob.exporter is not None and frontend.taillog is not None:
                ob.exporter.attach(taillog=frontend.taillog)
            n_batches, query_s = run_queries(
                lambda ids: frontend.query(ids).logits)
            servers = frontend.replicas + (
                [frontend.sampled_server] if frontend.sampled_server
                else [])
            if args.update_edges > 0:
                for e in random_edge_updates(graph, args.update_edges, rng):
                    seq = frontend.update_edges(add=[e], wait=True)
                    updates.append({
                        "seq": seq,
                        "min_applied": frontend.min_applied_seq(),
                        "servers": {s.name: _rounded(s.last_update)
                                    for s in servers}})
            n_parts = frontend.replicas[0].si.n_partitions
            build_s = frontend.replicas[0].build_seconds
            serve_stats = frontend.stats()
            if args.slow_log and frontend.taillog is not None:
                with open(args.slow_log, "w") as f:
                    json.dump(frontend.taillog.snapshot(), f, indent=1)
                print(f"[serve] slow-request log → {args.slow_log}")
        except BaseException:
            frontend.close()
            raise
        if not keep_open:
            frontend.close()

    out = {
        "dataset": args.dataset, "model": args.model,
        "device": str(device), "backend": args.backend,
        "n_nodes": graph.n,
        "replicas": max(args.replicas, 0),
        "n_partitions": n_parts,
        "cache_build_s": round(build_s, 4),
        "queries": int(args.queries),
        "query_batches": n_batches,
        "queries_per_s": round(args.queries / max(query_s, 1e-9), 1),
        "updates": updates,
        "serve_stats": serve_stats,
    }
    if monitor is not None:
        monitor.stop()
        out["slo"] = monitor.report()
        # raises SLOError under --strict-slo
        monitor.check(where="serve_gnn", hard_fail=args.strict_slo)
    snap = obs.finalize_from_args(args)
    if snap is not None:
        out["metrics"] = snap
    return out, served


def main(argv=None) -> dict:
    out, _ = run(build_parser().parse_args(argv))
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
