"""Quickstart on the PyTorch port: RSC in 40 lines.

Trains a 3-layer GCN on a synthetic cluster graph twice — exact baseline vs
RSC (budget C=0.1, greedy allocation, caching, switch-back) — and prints the
accuracy + backward-SpMM FLOPs comparison. The counterpart of
``quickstart.py``; on the card every SpMM runs the hand-written
``bcoo_spmm`` kernel, on the CPU (``--device cpu``) its plain version.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

from repro_torch.graphs.synthetic import sbm_graph
from repro_torch.train.loop import GNNTrainer, TrainConfig


def run(device: str = "cuda") -> tuple[dict, dict]:
    """The two trainings' results: (baseline, RSC)."""
    graph = sbm_graph(n_nodes=1500, n_clusters=10, avg_degree=15,
                      feat_dim=64, seed=0)
    baseline = GNNTrainer(
        TrainConfig(model="gcn", n_layers=3, hidden=64, epochs=120, block=64,
                    device=device),
        graph).train()
    rsc = GNNTrainer(
        TrainConfig(model="gcn", n_layers=3, hidden=64, epochs=120, block=64,
                    rsc=True,          # enable Randomized Sparse Computation
                    budget=0.1,        # Eq. 4b: backward-SpMM FLOPs ≤ 10%
                    refresh_every=10,  # §3.3.1 caching
                    rsc_fraction=0.8,  # §3.3.2 switch back for the last 20%
                    device=device),
        graph).train()
    return baseline, rsc


def main(argv=None) -> tuple[dict, dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    baseline, rsc = run(args.device)
    print(f"baseline  test acc: {baseline['best_test']:.4f}")
    print(f"RSC       test acc: {rsc['best_test']:.4f}")
    print(f"backward-SpMM FLOPs kept: {rsc['flops_fraction']:.1%}")
    print(f"allocator refreshes: {rsc['cache_stats'].refreshes} "
          f"({rsc['cache_stats'].host_seconds * 1e3:.1f} ms host time total)")
    if not rsc["best_test"] > baseline["best_test"] - 0.05:
        raise SystemExit(f"RSC's test accuracy {rsc['best_test']:.4f} is "
                         f"more than 0.05 below the baseline's "
                         f"{baseline['best_test']:.4f}")
    return baseline, rsc


if __name__ == "__main__":
    main()
