"""End-to-end run on the PyTorch port: full-batch GCN on a
Reddit-statistics synthetic graph, a few hundred steps, baseline vs RSC
with the complete machinery — the paper's Table 3 protocol at small
scale. The counterpart of ``train_gcn_rsc.py``, with ``--device`` (the
card by default; ``cpu`` runs the kernels' plain versions).

    PYTHONPATH=src python examples/torch_train_gcn_rsc.py [--scale 0.01]
"""
import argparse
import json
import time

from repro_torch.graphs.datasets import DATASETS, load_dataset
from repro_torch.train.loop import GNNTrainer, TrainConfig


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dataset", default="reddit", choices=sorted(DATASETS))
    ap.add_argument("--scale", type=float, default=0.008)
    ap.add_argument("--epochs", type=int, default=300)
    ap.add_argument("--budget", type=float, default=0.1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    spec = DATASETS[args.dataset]
    g = load_dataset(args.dataset, scale=args.scale)
    print(f"{args.dataset}: {g.n} nodes, {g.adj.nnz} edges "
          f"(scale={args.scale})")
    common = dict(model="gcn", n_layers=3, hidden=128, block=64,
                  epochs=args.epochs, dropout=0.5, metric=spec.metric,
                  device=args.device)

    t0 = time.perf_counter()
    base = GNNTrainer(TrainConfig(**common), g).train(verbose=False)
    t_base = time.perf_counter() - t0

    t0 = time.perf_counter()
    rsc = GNNTrainer(TrainConfig(rsc=True, budget=args.budget, **common),
                     g).train(verbose=False)
    t_rsc = time.perf_counter() - t0

    out = {
        "baseline": {"test": round(base["best_test"], 4),
                     "wall_s": round(t_base, 1)},
        "rsc": {"test": round(rsc["best_test"], 4),
                "wall_s": round(t_rsc, 1),
                "budget": args.budget,
                "flops_fraction": round(rsc["flops_fraction"], 4),
                "e2e_speedup": round(t_base / t_rsc, 3)},
    }
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
