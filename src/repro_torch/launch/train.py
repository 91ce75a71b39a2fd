"""Command-line training entry point: GNN training, full batch or over a
GraphSAINT subgraph pool (the paper's models: GCN, GraphSAGE, GCNII), and
the LM stack.

    # the full-width GCN with RSC on the card (--model graphsage: the same
    # flags; --model gcnii: --layers 4)
    PYTHONPATH=src python -m repro_torch.launch.train gnn --dataset reddit \
        --scale 0.1 --layers 3 --hidden 256 --block 128 --rsc --budget 0.1

    # a small run on the CPU (plain versions of the kernels)
    PYTHONPATH=src python -m repro_torch.launch.train gnn --dataset reddit \
        --scale 0.003 --rsc --epochs 20 --block 32 --hidden 48 --layers 2 \
        --device cpu

    # minibatch: 8 random-walk subgraphs of 2,000 roots, walk length 4
    PYTHONPATH=src python -m repro_torch.launch.train gnn --minibatch \
        --dataset ogbn-products --scale 0.1 --layers 3 --hidden 256 \
        --block 128 --rsc --budget 0.1 --roots 2000 --walk-length 4

    # a small minibatch run on the CPU
    PYTHONPATH=src python -m repro_torch.launch.train gnn --minibatch \
        --device cpu --scale 0.004 --block 32 --hidden 48 --layers 2 \
        --subgraphs 4 --roots 50 --walk-length 2 --epochs 4 --rsc

    # data parallel: 2 gloo ranks on the CPU (on cards: --dp N alone runs
    # N NCCL ranks, one card each)
    PYTHONPATH=src python -m repro_torch.launch.train gnn --minibatch \
        --device cpu --scale 0.004 --block 32 --hidden 48 --layers 2 \
        --subgraphs 4 --roots 50 --walk-length 2 --epochs 4 --rsc \
        --dp 2 --force-host-devices 2 --compress-grads --overlap-allreduce

    PYTHONPATH=src python -m repro_torch.launch.train lm --arch qwen3-1.7b \
        --batch 4 --seq 4096 --microbatches 2 --rsc --rsc-keep 0.5 --steps 3

    # reduced config on the CPU (plain versions of the kernels)
    PYTHONPATH=src python -m repro_torch.launch.train lm --arch qwen3-1.7b \
        --smoke --steps 5 --device cpu

The ``gnn`` flags are the reference's, with ``--backend`` (``kernel``, the
default: the CUDA kernel, or its plain version on the CPU; ``ref``: the
CPU-only streaming schedule; ``dense``: the plan's tiles scattered into a
dense operand and one ``torch.matmul``; ``auto``: the autotuner's cached
decision per signature) and ``--device``. ``--minibatch`` trains over a
subgraph pool (``--subgraphs``, ``--pool-method``, ``--roots``,
``--walk-length``, ``--buckets``, ``--no-prefetch``, ``--no-autotune``,
``--no-saint-norm``, the reference's defaults); ``--eval-mode stream``
evaluates with the exact streaming full-graph forward, in either mode
(``--stream-partitions``, ``--stream-budget-mb``, and
``--stream-resident-mb`` / ``--stream-overlap`` for its partition LRU
and double-buffered uploads). It
prints the reference's JSON keys (``model``, ``dataset``, ``rsc``,
``budget``, ``best_test``, ``wall_s``, ``flops_fraction``; with
``--minibatch`` also ``minibatch``, ``pool``, ``subgraphs``,
``n_buckets`` and ``plan_hit_rate``). The reference's ``compiles`` key
counts jit compiles; the port runs eagerly and compiles nothing, so it has
no such key (nor ``--strict-compiles``). The observability flags are the
reference's: ``--metrics`` (the registry snapshot under ``metrics`` and the
ledger summary under ``ledger``), ``--metrics-port``, ``--trace-out``,
``--trace-jsonl``, ``--slo``/``--strict-slo`` (the report under ``slo``),
``--strict-budget``, ``--probe-every`` and ``--probe-rows``.

Data parallel (``--minibatch`` only): ``--dp N`` (or ``--mesh data:N``)
trains on N ranks, one process each (``distributed/group.py``): NCCL with
one card per rank when N cards are visible, or with ``--force-host-devices
N`` N gloo ranks sharing the ``--device`` (the CPU, or one card as a
functional check); anything else raises. ``--compress-grads`` (int8
error feedback on the all-reduce) and ``--overlap-allreduce`` (bucketed,
issued during the backward) need DP, as in the reference. Rank 0 writes
the checkpoints, traces and metrics and prints the report, which adds the
reference's ``dp``, ``compress_grads``, ``overlap_allreduce`` and
``shards`` (per-shard plan-cache statistics). ``run_gnn`` then also
returns every rank's summary under ``ranks`` (launch counts by variant,
history, all-reduce times and bytes, transfers, autotune counters, peak
memory and RSS).

The ``lm`` flags are those of ``repro.launch.train lm`` plus ``--device``
(``cuda`` by default, which raises without a card; ``cpu`` runs the
kernels' plain versions). Parameters come from a seeded random init, as in
the reference, and step ``i`` trains on ``make_batch(cfg, "train_4k",
batch, seq, seed=i)``. ``--rsc`` samples the MLP weight gradients through
``rsc_matmul``, whose dW runs on the ``gather_matmul`` kernel. Prints one
JSON line with ``arch``, ``final_loss``, ``first_loss`` and ``steps``
(and ``metrics`` with ``--metrics``). ``--ckpt-dir`` saves (params,
optimizer state) every ``--ckpt-every`` steps and at the end, keeping the
last two, in the reference's layout; a run whose directory holds a
checkpoint resumes from it (``steps`` then counts the steps run here).
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import math
import time

import torch

from repro_torch import obs
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_arch, make_batch, smoke_config
from repro_torch.convert import load_lm_state, lm_state_tree
from repro_torch.device import resolve_device
from repro_torch.distributed import group as dp_group
from repro_torch.graphs.datasets import DATASETS, load_dataset
from repro_torch.models.lm.backbone import init_params
from repro_torch.obs import slo as slo_mod
from repro_torch.pipeline.minibatch_loop import (MinibatchConfig,
                                                 MinibatchTrainer)
from repro_torch.train.lm_steps import make_train_step
from repro_torch.train.loop import GNNTrainer, TrainConfig
from repro_torch.train.optimizer import Adam

def check_dp_flags(args) -> int:
    """The reference's checks of the data-parallel flags (``SystemExit``);
    returns the degree (``--mesh`` sets it)."""
    dp_asked = args.dp > 1 or bool(args.mesh)
    if dp_asked and not args.minibatch:
        raise SystemExit("--dp/--mesh require --minibatch (the sharded "
                         "source partitions the subgraph pool)")
    if args.compress_grads and not dp_asked:
        raise SystemExit("--compress-grads compresses the data-parallel "
                         "all-reduce; it needs --dp N (or --mesh)")
    if args.overlap_allreduce and not dp_asked:
        raise SystemExit("--overlap-allreduce buckets the data-parallel "
                         "all-reduce; it needs --dp N (or --mesh)")
    dp = args.dp
    if args.mesh:
        mesh_dp = dp_group.parse_mesh_spec(args.mesh)
        if args.dp and args.dp != mesh_dp:
            raise SystemExit(f"--dp {args.dp} contradicts --mesh "
                             f"{args.mesh!r} (data axis = {mesh_dp})")
        dp = mesh_dp
    return dp


def _common_cfg(args, spec, device) -> dict:
    return dict(
        model=args.model, n_layers=args.layers, hidden=args.hidden,
        epochs=args.epochs, lr=args.lr, dropout=args.dropout,
        metric=spec.metric, rsc=args.rsc, budget=args.budget,
        caching=not args.no_caching, switching=not args.no_switching,
        strategy=args.strategy, block=args.block, seed=args.seed,
        backend=args.backend, eval_mode=args.eval_mode,
        stream_partitions=args.stream_partitions,
        stream_budget_mb=args.stream_budget_mb,
        stream_resident_mb=args.stream_resident_mb,
        stream_overlap=args.stream_overlap, device=str(device),
        strict_budget=args.strict_budget, probe_every=args.probe_every,
        probe_rows=args.probe_rows)


def _minibatch_cfg(args, common: dict, **extra) -> MinibatchConfig:
    return MinibatchConfig(
        n_subgraphs=args.subgraphs, method=args.pool_method,
        roots=args.roots, walk_length=args.walk_length,
        n_buckets=args.buckets, prefetch=not args.no_prefetch,
        autotune=not args.no_autotune,
        saint_norm=not args.no_saint_norm, **common, **extra)


def _report(args, res: dict, wall: float) -> dict:
    report = {"model": args.model, "dataset": args.dataset,
              "rsc": args.rsc, "budget": args.budget,
              "best_test": res["best_test"], "wall_s": round(wall, 2),
              "flops_fraction": res["flops_fraction"]}
    if args.minibatch:
        report.update({"minibatch": True, "pool": args.pool_method,
                       "subgraphs": args.subgraphs,
                       "n_buckets": res["n_buckets"],
                       "plan_hit_rate": res["plan_hit_rate"]})
    return report


def _finish(args, report: dict, res: dict, monitor) -> dict:
    if monitor is not None:
        monitor.stop()
        report["slo"] = monitor.report()
        monitor.check(where="train gnn", hard_fail=args.strict_slo)
    snap = obs.finalize_from_args(args)
    if snap is not None:
        report["metrics"] = snap
    if res.get("ledger") is not None:
        report["ledger"] = res["ledger"]
    return report


def _start_obs(args):
    """The registry, tracer and ledger as the flags ask; the SLO monitor,
    started (or None)."""
    ob = obs.setup_from_args(args)
    monitor = slo_mod.monitor_from_args(args)
    if monitor is not None:
        # p99_ms falls through to engine.step_ms when no serving tier
        # publishes request latencies: the training-loop objective.
        monitor.start(period=0.25)
        if ob.exporter is not None:
            ob.exporter.attach(slo=monitor)
    return monitor


def run_gnn(args, *, graph=None, pool=None, **minibatch) -> dict:
    """GNN training, full batch or (``--minibatch``) over a subgraph pool;
    returns the JSON report (under ``report``), the engine's result, the
    trainer, the graph and the set-up seconds (graph, operands or pool,
    planner, autotune sweeps and parameters, before the first step).
    ``graph`` (the loaded dataset), ``pool`` (a prebuilt ``SubgraphPool``
    of it) and ``minibatch`` (``MinibatchConfig`` fields the CLI has no
    flag for, such as ``resident``) are for callers that drive the path
    in-process more than once. With ``--metrics`` the report carries the
    registry snapshot (``metrics``) and the ledger summary (``ledger``),
    with ``--slo`` the monitor's report (``slo``). With ``--dp N`` the
    ranks run in their own processes (:func:`run_gnn_dp`)."""
    dp = check_dp_flags(args)
    if dp > 1:
        if graph is not None or pool is not None:
            raise ValueError("--dp ranks build their own graph and pool")
        return run_gnn_dp(args, dp, **minibatch)
    device = resolve_device(args.device)
    monitor = _start_obs(args)
    spec = DATASETS[args.dataset]
    t0 = time.perf_counter()
    g = graph if graph is not None else load_dataset(
        args.dataset, scale=args.scale, seed=args.seed)
    common = _common_cfg(args, spec, device)
    if args.minibatch:
        tr = MinibatchTrainer(_minibatch_cfg(args, common, **minibatch), g,
                              pool)
    else:
        tr = GNNTrainer(TrainConfig(**common), g)
    t1 = time.perf_counter()
    res = tr.train(verbose=args.verbose)
    wall = time.perf_counter() - t1
    report = _finish(args, _report(args, res, wall), res, monitor)
    return {"report": report, "result": res, "trainer": tr, "graph": g,
            "setup_s": t1 - t0}


def run_gnn_dp(args, dp: int, **minibatch) -> dict:
    """``--dp N``: N ranks, each in its own process
    (``distributed.group.launch``), each running :func:`gnn_rank`.
    Returns rank 0's report, result and set-up seconds, and every rank's
    summary under ``ranks`` (under ``torchrun``: this process's; the
    report only on rank 0). The caller's process launches nothing."""
    plan = dp_group.plan_group(dp, force_host_devices=args.force_host_devices,
                               device=args.device)
    args = copy.copy(args)
    args.dp = dp
    ranks = dp_group.launch(gnn_rank, (args, minibatch), plan=plan)
    main = next((r for r in ranks if r["rank"] == 0), None)
    return {"report": main["report"] if main else None,
            "result": main["result"] if main else None,
            "setup_s": main["setup_s"] if main else None, "ranks": ranks}


def gnn_rank(group, args, minibatch: dict) -> dict:
    """One rank of ``train gnn --minibatch --dp N``: build the graph and
    the whole pool from the seed, train this rank's shard in step with the
    others, and return the rank's summary (rank 0's carries the report).
    Launch counts start at 0 in the rank's fresh process. Every rank turns
    on the registry, tracer and ledger alike (collectives run where they
    are on); only rank 0 exports, writes trace files and checkpoints."""
    from repro_torch.kernels import autotune, ops
    ops.reset_launch_counts()
    device = group.device
    if group.is_main:
        monitor = _start_obs(args)
    else:
        monitor = None
        obs.configure(metrics=bool(args.metrics or args.metrics_port
                                   is not None),
                      trace=bool(args.trace_out or args.trace_jsonl),
                      ledger=bool(args.metrics or args.metrics_port
                                  is not None))
    spec = DATASETS[args.dataset]
    t0 = time.perf_counter()
    g = load_dataset(args.dataset, scale=args.scale, seed=args.seed)
    cfg = _minibatch_cfg(
        args, _common_cfg(args, spec, device), dp=args.dp,
        compress_grads=args.compress_grads,
        overlap_allreduce=args.overlap_allreduce, **minibatch)
    tr = MinibatchTrainer(cfg, g, group=group)
    t1 = time.perf_counter()
    res = tr.train(verbose=args.verbose)
    wall = time.perf_counter() - t1
    eng = tr.engine
    shards = (eng.planner.per_shard_summary()
              if hasattr(eng.planner, "per_shard_summary") else None)
    report = None
    if group.is_main:
        report = _report(args, res, wall)
        report.update({"dp": args.dp, "compress_grads": args.compress_grads,
                       "overlap_allreduce": args.overlap_allreduce})
        if shards is not None:
            report["shards"] = shards
        report = _finish(args, report, res, monitor)
    red = eng.runner.reducer
    cache = autotune.get_cache()
    return {
        "rank": group.rank, "device": str(device), "report": report,
        "result": res, "setup_s": t1 - t0,
        "wall_s": wall,
        "launches": ops.launch_counts(),
        "launches_by_variant": ops.launch_counts_by_variant(),
        "allreduce": {"overlap": red.overlap, "reduce_ms": red.reduce_ms,
                      "f32_bytes": red.f32_bytes,
                      "int8_bytes": red.int8_bytes,
                      "buckets": red.buckets},
        "transfer": {k: eng.source.transfer_stats(k)
                     for k in ("train", "eval")},
        "planner": (eng.planner.local.summary()
                    if hasattr(eng.planner, "local") else None),
        "autotune": {"stats": dataclasses.asdict(cache.stats),
                     "missed": sorted(cache.missed)},
        "peak_mem_bytes": (torch.cuda.max_memory_allocated(device)
                           if device.type == "cuda" else None),
        "rss_bytes": _rss_bytes(),       # at the end of the rank's run
    }


def _rss_bytes() -> int | None:
    """This process's resident host memory now (Linux ``VmRSS``); None
    where ``/proc`` does not say. Not ``ru_maxrss``: a spawned rank's
    counts its parent's peak as of the spawn."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        return None
    return None


def run_lm(args) -> dict:
    """Train; returns the JSON report (under ``report``), the losses, the
    per-step wall times (host clock; each step ends when its loss is read
    back), the config, the trained parameters and the step it started
    from (``start``: the checkpoint's, when ``--ckpt-dir`` holds one)."""
    device = resolve_device(args.device)
    obs.setup_from_args(args)
    cfg = smoke_config(args.arch) if args.smoke else get_arch(args.arch)
    params = init_params(cfg, args.seed, device)
    opt = Adam(lr=args.lr, clip_norm=1.0)
    opt_state = opt.init(dict(params.named_parameters()))
    rsc = {"keep_frac": args.rsc_keep, "backend": "kernel"} \
        if args.rsc else None
    step = make_train_step(cfg, opt, args.microbatches, rsc=rsc)
    ckpt = Checkpointer(args.ckpt_dir, keep=2) if args.ckpt_dir else None

    start = 0
    if ckpt and ckpt.latest_step() is not None:
        start, tree = ckpt.restore(lm_state_tree(params, opt_state, cfg),
                                   device=device)
        opt_state = load_lm_state(params, opt_state, tree, cfg)
        print(f"[train] resumed from step {start}")

    losses, step_s = [], []
    for i in range(start, args.steps):
        batch = make_batch(cfg, "train_4k", args.batch, args.seq, seed=i,
                           device=device)
        t0 = time.perf_counter()
        params, opt_state, loss = step(params, opt_state, batch)
        loss = float(loss)
        step_s.append(time.perf_counter() - t0)
        losses.append(loss)
        if args.verbose and i % 10 == 0:
            print(f"step {i:4d} loss {loss:.4f} ({step_s[-1]:.2f}s)")
        if ckpt and (i + 1) % args.ckpt_every == 0:
            ckpt.save(i + 1, lm_state_tree(params, opt_state, cfg))
    if ckpt:
        ckpt.save(args.steps, lm_state_tree(params, opt_state, cfg))
        ckpt.wait()
    if not losses or not math.isfinite(losses[-1]):
        raise RuntimeError(f"training gave no finite loss: {losses}")
    report = {"arch": cfg.name, "final_loss": losses[-1],
              "first_loss": losses[0], "steps": len(losses)}
    snap = obs.finalize_from_args(args)
    if snap is not None:
        report["metrics"] = snap
    return {"report": report, "losses": losses, "step_s": step_s,
            "cfg": cfg, "params": params, "start": start}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="Training (PyTorch port): GNN and LM")
    sub = ap.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("gnn")
    g.add_argument("--model", default="gcn",
                   choices=["gcn", "graphsage", "gcnii"])
    g.add_argument("--dataset", default="reddit", choices=sorted(DATASETS))
    g.add_argument("--scale", type=float, default=0.005)
    g.add_argument("--layers", type=int, default=3)
    g.add_argument("--hidden", type=int, default=256)
    g.add_argument("--epochs", type=int, default=200)
    g.add_argument("--lr", type=float, default=0.01)
    g.add_argument("--dropout", type=float, default=0.5)
    g.add_argument("--rsc", action="store_true")
    g.add_argument("--budget", type=float, default=0.1)
    g.add_argument("--no-caching", action="store_true")
    g.add_argument("--no-switching", action="store_true")
    g.add_argument("--strategy", default="greedy",
                   choices=["greedy", "uniform"])
    g.add_argument("--block", type=int, default=64)
    g.add_argument("--backend", default="kernel",
                   choices=["kernel", "ref", "dense", "auto"],
                   help="SpMM backend: the CUDA kernel (its plain version "
                        "on --device cpu), the CPU-only streaming ref, "
                        "dense (scatter into a dense operand + matmul), or "
                        "auto (the autotuner's decision per signature)")
    g.add_argument("--eval-mode", default="auto", choices=["auto", "stream"],
                   help="'stream' evaluates with the exact streaming "
                        "full-graph forward instead of the source's "
                        "full-graph / pooled evaluator")
    g.add_argument("--stream-partitions", type=int, default=0,
                   help="streaming-eval partition count (0 = size by "
                        "--stream-budget-mb)")
    g.add_argument("--stream-budget-mb", type=float, default=256.0,
                   help="device-memory budget per streaming-eval partition")
    g.add_argument("--stream-resident-mb", type=float, default=0.0,
                   help="device-resident partition LRU budget for the "
                        "streaming eval (0 = re-upload tiles every layer)")
    g.add_argument("--stream-overlap", action="store_true",
                   help="double-buffer streaming-eval partition uploads "
                        "against the device SpMM")
    g.add_argument("--minibatch", action="store_true",
                   help="GraphSAINT subgraph-pool training (pipeline/)")
    g.add_argument("--subgraphs", type=int, default=8)
    g.add_argument("--pool-method", default="random_walk",
                   choices=["random_walk", "ldg"])
    g.add_argument("--roots", type=int, default=200)
    g.add_argument("--walk-length", type=int, default=4)
    g.add_argument("--buckets", type=int, default=2)
    g.add_argument("--no-prefetch", action="store_true")
    g.add_argument("--no-autotune", action="store_true",
                   help="skip the per-bucket SpMM sweeps at startup")
    g.add_argument("--no-saint-norm", action="store_true",
                   help="disable GraphSAINT loss/aggregator bias "
                        "correction on sampled pools")
    g.add_argument("--dp", type=int, default=0,
                   help="data-parallel degree: shard the subgraph pool "
                        "over N ranks (one process each)")
    g.add_argument("--mesh", default="",
                   help="explicit mesh spec, 'data:N' or 'N' (default: "
                        "--dp ranks)")
    g.add_argument("--compress-grads", action="store_true",
                   help="int8 error-feedback compression on the DP "
                        "gradient all-reduce (switch-back applies)")
    g.add_argument("--overlap-allreduce", action="store_true",
                   help="bucket the DP gradient all-reduce (one all-reduce "
                        "per bucket, issued during the backward) so "
                        "communication overlaps the backward tail; "
                        "trajectory-identical")
    g.add_argument("--force-host-devices", type=int, default=0,
                   help="run the N ranks over gloo, all on the --device "
                        "(the CPU, or one card as a functional check)")
    g.add_argument("--seed", type=int, default=0)
    g.add_argument("--verbose", action="store_true")
    g.add_argument("--strict-budget", action="store_true",
                   help="hard-fail (BudgetError) when an allocator run "
                        "exceeds its FLOPs budget (the approximation "
                        "ledger's conservation invariant)")
    g.add_argument("--probe-every", type=int, default=1, metavar="N",
                   help="run exact-vs-sampled error probes every N "
                        "epochs when metrics/ledger are on (0 disables)")
    g.add_argument("--probe-rows", type=int, default=8, metavar="R",
                   help="row blocks per error probe")
    obs.add_cli_flags(g)
    slo_mod.add_cli_flags(g)
    g.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    g.set_defaults(fn=run_gnn)

    l = sub.add_parser("lm")
    l.add_argument("--arch", required=True)
    l.add_argument("--smoke", action="store_true")
    l.add_argument("--steps", type=int, default=50)
    l.add_argument("--batch", type=int, default=2)
    l.add_argument("--seq", type=int, default=64)
    l.add_argument("--lr", type=float, default=3e-4)
    l.add_argument("--microbatches", type=int, default=1)
    l.add_argument("--rsc", action="store_true")
    l.add_argument("--rsc-keep", type=float, default=0.5)
    l.add_argument("--ckpt-dir", default=None)
    l.add_argument("--ckpt-every", type=int, default=20)
    l.add_argument("--seed", type=int, default=0)
    l.add_argument("--verbose", action="store_true")
    obs.add_cli_flags(l)
    l.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    l.set_defaults(fn=run_lm)
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    out = args.fn(args)
    if out["report"] is not None:     # under torchrun: rank 0's only
        print(json.dumps(out["report"]))
    return out


if __name__ == "__main__":
    main()
