"""Command-line training entry point (the LM stack so far).

    PYTHONPATH=src python -m repro_torch.launch.train lm --arch qwen3-1.7b \
        --batch 4 --seq 4096 --microbatches 2 --rsc --rsc-keep 0.5 --steps 3

    # reduced config on the CPU (plain versions of the kernels)
    PYTHONPATH=src python -m repro_torch.launch.train lm --arch qwen3-1.7b \
        --smoke --steps 5 --device cpu

The ``lm`` flags are those of ``repro.launch.train lm`` plus ``--device``
(``cuda`` by default, which raises without a card; ``cpu`` runs the
kernels' plain versions). Parameters come from a seeded random init, as in
the reference, and step ``i`` trains on ``make_batch(cfg, "train_4k",
batch, seq, seed=i)``. ``--rsc`` samples the MLP weight gradients through
``rsc_matmul``, whose dW runs on the ``gather_matmul`` kernel. Prints one
JSON line with ``arch``, ``final_loss``, ``first_loss`` and ``steps``.
The ``gnn`` subcommand, ``--ckpt-dir`` and the observability flags raise
``NotImplementedError`` naming the ROADMAP.md item that ports them.
"""
from __future__ import annotations

import argparse
import json
import math
import time

from repro_torch.configs import get_arch, make_batch, smoke_config
from repro_torch.device import resolve_device
from repro_torch.models.lm.backbone import init_params
from repro_torch.train.lm_steps import make_train_step
from repro_torch.train.optimizer import Adam

_GNN = "Queue 1 item 2 (full-batch GNN training)"
_CKPT = "Queue 1 item 5 (checkpoint and resume)"
_OBS = "Queue 1 item 6 (observability)"


def _unported(flag: str, item: str):
    raise NotImplementedError(f"{flag} is not ported to repro_torch yet: see "
                              f"ROADMAP.md {item}")


def run_gnn(args) -> dict:
    _unported("train gnn", _GNN)


def check_ported(args) -> None:
    """Raise ``NotImplementedError`` for ``lm`` flags this port lacks."""
    unported = [
        (args.ckpt_dir is not None, "--ckpt-dir", _CKPT),
        (args.metrics, "--metrics", _OBS),
        (args.metrics_port is not None, "--metrics-port", _OBS),
        (args.trace_out is not None, "--trace-out", _OBS),
        (args.trace_jsonl is not None, "--trace-jsonl", _OBS),
    ]
    for hit, flag, item in unported:
        if hit:
            _unported(flag, item)


def run_lm(args) -> dict:
    """Train; returns the JSON report (under ``report``), the losses, the
    per-step wall times (host clock; each step ends when its loss is read
    back), the config and the trained parameters."""
    check_ported(args)
    device = resolve_device(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_arch(args.arch)
    params = init_params(cfg, args.seed, device)
    opt = Adam(lr=args.lr, clip_norm=1.0)
    opt_state = opt.init(dict(params.named_parameters()))
    rsc = {"keep_frac": args.rsc_keep, "backend": "kernel"} \
        if args.rsc else None
    step = make_train_step(cfg, opt, args.microbatches, rsc=rsc)

    losses, step_s = [], []
    for i in range(args.steps):
        batch = make_batch(cfg, "train_4k", args.batch, args.seq, seed=i,
                           device=device)
        t0 = time.perf_counter()
        params, opt_state, loss = step(params, opt_state, batch)
        loss = float(loss)
        step_s.append(time.perf_counter() - t0)
        losses.append(loss)
        if args.verbose and i % 10 == 0:
            print(f"step {i:4d} loss {loss:.4f} ({step_s[-1]:.2f}s)")
    if not losses or not math.isfinite(losses[-1]):
        raise RuntimeError(f"training gave no finite loss: {losses}")
    report = {"arch": cfg.name, "final_loss": losses[-1],
              "first_loss": losses[0], "steps": len(losses)}
    return {"report": report, "losses": losses, "step_s": step_s,
            "cfg": cfg, "params": params}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="Training (PyTorch port; the LM stack so far)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("gnn", help="not ported yet: takes the reference's "
                                    "flags and raises")
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
    l.add_argument("--metrics", action="store_true")
    l.add_argument("--metrics-port", type=int, default=None)
    l.add_argument("--trace-out", default=None, metavar="PATH")
    l.add_argument("--trace-jsonl", default=None, metavar="PATH")
    l.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    l.set_defaults(fn=run_lm)
    return ap


def main(argv=None) -> dict:
    ap = build_parser()
    args, extra = ap.parse_known_args(argv)
    if extra and args.cmd != "gnn":
        ap.error(f"unrecognized arguments: {' '.join(extra)}")
    out = args.fn(args)
    print(json.dumps(out["report"]))
    return out


if __name__ == "__main__":
    main()
