"""End-to-end minibatch run on the PyTorch port: GraphSAINT subgraph
pool + per-subgraph RSC.

Builds a ≥8-subgraph random-walk pool over a Reddit-statistics synthetic
graph and trains a GCN with the full RSC machinery (per-subgraph plan
caches, switch-back tail, double-buffered prefetch). The counterpart of
``train_saint_rsc.py``, with ``--device`` (the card by default). Its JSON
has the same keys but ``compiles``: the reference checks that each jitted
step compiled at most once per shape bucket, and the port runs eagerly
and compiles nothing (its kernels are built once, on first use), so there
is no count to report.

    PYTHONPATH=src python examples/torch_train_saint_rsc.py [--scale 0.008]
"""
import argparse
import json
import time

from repro_torch.graphs.datasets import DATASETS, load_dataset
from repro_torch.pipeline import MinibatchConfig, MinibatchTrainer


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dataset", default="reddit", choices=sorted(DATASETS))
    ap.add_argument("--scale", type=float, default=0.008)
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--subgraphs", type=int, default=8)
    ap.add_argument("--roots", type=int, default=300)
    ap.add_argument("--walk-length", type=int, default=4)
    ap.add_argument("--buckets", type=int, default=2)
    ap.add_argument("--budget", type=float, default=0.1)
    ap.add_argument("--method", default="random_walk",
                    choices=["random_walk", "ldg"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    spec = DATASETS[args.dataset]
    g = load_dataset(args.dataset, scale=args.scale)
    print(f"{args.dataset}: {g.n} nodes, {g.adj.nnz} edges "
          f"(scale={args.scale})")

    cfg = MinibatchConfig(
        model="gcn", n_layers=3, hidden=128, block=64, dropout=0.5,
        epochs=args.epochs, metric=spec.metric,
        rsc=True, budget=args.budget,
        n_subgraphs=args.subgraphs, method=args.method,
        roots=args.roots, walk_length=args.walk_length,
        n_buckets=args.buckets, prefetch=True, device=args.device)
    tr = MinibatchTrainer(cfg, g)
    print(f"pool: {len(tr.pool)} subgraphs in {len(tr.pool.buckets)} "
          f"buckets {[(b.n_blocks, b.s_pad) for b in tr.pool.buckets]}")

    t0 = time.perf_counter()
    res = tr.train(eval_every=5, verbose=True)
    wall = time.perf_counter() - t0

    out = {
        "best_test": round(res["best_test"], 4),
        "wall_s": round(wall, 1),
        "budget": args.budget,
        "flops_fraction": round(res["flops_fraction"], 4),
        "plan_hit_rate": round(res["plan_hit_rate"], 4),
        "n_buckets": res["n_buckets"],
        "modes": {m: res["history"]["mode"].count(m)
                  for m in ("rsc", "exact")},
    }
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
