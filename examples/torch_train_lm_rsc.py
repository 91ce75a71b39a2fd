"""Train a ~100M-class LM on the PyTorch port (xlstm-125m at reduced width
for the CPU) for a few hundred steps with checkpoint/restart, optionally
with the beyond-paper dense-RSC backward sampling on its projections
(``--rsc``: on the card each sampled dW runs the hand-written
``gather_matmul`` kernel). The counterpart of ``train_lm_rsc.py``, with
``--device`` (the card by default); its checkpoints go under ``build/``
unless ``--ckpt`` says otherwise.

    PYTHONPATH=src python examples/torch_train_lm_rsc.py --steps 200 [--rsc]
"""
import argparse
import dataclasses
import json
import math
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_arch
from repro_torch.convert import lm_state_tree, load_lm_state
from repro_torch.data.tokens import TokenStream
from repro_torch.device import resolve_device
from repro_torch.models.lm.backbone import init_params
from repro_torch.train.lm_steps import make_train_step
from repro_torch.train.optimizer import Adam

CKPT = Path(__file__).resolve().parents[1] / "build" / "rsc_lm_ckpt"


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--rsc", action="store_true")
    ap.add_argument("--width", type=int, default=192,
                    help="d_model override for CPU feasibility")
    ap.add_argument("--ckpt", default=str(CKPT))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_arch("xlstm-125m")
    cfg = dataclasses.replace(
        cfg, d_model=args.width, head_dim=None, vocab=2048,
        name=f"xlstm-{args.width}")
    params = init_params(cfg, 0, device)
    n_params = sum(p.numel() for p in params.parameters())
    print(f"{cfg.name}: {n_params/1e6:.1f}M params")

    opt = Adam(lr=3e-4, clip_norm=1.0)
    opt_state = opt.init(dict(params.named_parameters()))
    rsc = {"keep_frac": 0.5, "bk": 64} if args.rsc else None
    step = make_train_step(cfg, opt, rsc=rsc)
    ckpt = Checkpointer(args.ckpt, keep=2)

    start = 0
    if ckpt.latest_step() is not None:
        start, tree = ckpt.restore(lm_state_tree(params, opt_state, cfg),
                                   device=device)
        opt_state = load_lm_state(params, opt_state, tree, cfg)
        print(f"resumed from step {start}")

    # skewed synthetic corpus (shard-aware, resumable) — learnable unigram
    # structure, so the loss demonstrably descends below ln(vocab).
    stream = TokenStream(vocab=cfg.vocab, seq_len=args.seq,
                         global_batch=args.batch, seed=args.seed, skew=2.0)

    t0 = time.perf_counter()
    losses = []
    for i in range(start, args.steps):
        b = stream.batch(i)
        batch = {k: torch.from_numpy(np.ascontiguousarray(b[k])).to(device)
                 for k in ("tokens", "targets")}
        params, opt_state, loss = step(params, opt_state, batch)
        losses.append(float(loss))
        if i % 20 == 0:
            print(f"step {i:4d} loss {losses[-1]:.4f}")
        if (i + 1) % 50 == 0:
            ckpt.save(i + 1, lm_state_tree(params, opt_state, cfg))
    ckpt.save(args.steps, lm_state_tree(params, opt_state, cfg),
              blocking=True)
    if not all(math.isfinite(x) for x in losses):
        raise SystemExit(f"non-finite loss: {losses}")
    head = float(np.mean(losses[:5]))
    tail = float(np.mean(losses[-5:]))
    out = {"first_losses_mean": head, "final_losses_mean": tail,
           "steps": len(losses), "rsc": bool(rsc),
           "wall_s": round(time.perf_counter() - t0, 1)}
    print(json.dumps(out))
    if not tail < head:
        raise SystemExit("loss should decrease")
    return out


if __name__ == "__main__":
    main()
