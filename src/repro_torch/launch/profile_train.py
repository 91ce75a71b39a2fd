"""Where a warm LM training step spends its time on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_train lm \
        --arch qwen3-1.7b --batch 4 --seq 4096 --microbatches 2 --rsc \
        --rsc-keep 0.5 --steps 2

Takes ``repro_torch.launch.train lm``'s flags. Trains with them (which
also warms every kernel up), then profiles one more step with
``torch.profiler`` and prints its host-clock wall time, summed device
time, the device's busy share, device time by kind of kernel
(``gather_matmul``, matrix products, copies and casts, the rest) and the
longest kernels. It then times one layer's training attention at the
step's shape with CUDA events — its forward alone (what the layer's
checkpointed forward runs) and its forward + backward (the layer's
recompute, the chunks' recompute and the backward) — and scales them to
the step: layers × microbatches × (forward + forward-and-backward). Ends
with one JSON line. A one-off analysis; the training path never calls it.
"""
from __future__ import annotations

import json
import time

import torch

from repro_torch.configs import make_batch
from repro_torch.launch import train
from repro_torch.launch.profile_serve import kernel_table
from repro_torch.models.lm.attention import flash_attention
from repro_torch.train.lm_steps import make_train_step
from repro_torch.train.optimizer import Adam


def profile_step(out: dict, args) -> dict:
    """Profile one training step of ``out``'s model (a ``train.run_lm``
    result) on a fresh batch, with fresh optimizer moments."""
    from torch.profiler import ProfilerActivity, profile
    cfg, params = out["cfg"], out["params"]
    device = params.embed.device
    opt = Adam(lr=args.lr, clip_norm=1.0)
    state = opt.init(dict(params.named_parameters()))
    rsc = {"keep_frac": args.rsc_keep, "backend": "kernel"} \
        if args.rsc else None
    step = make_train_step(cfg, opt, args.microbatches, rsc=rsc)
    batch = make_batch(cfg, "train_4k", args.batch, args.seq,
                       seed=args.steps, device=device)
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        _, _, loss = step(params, state, batch)
        float(loss)
        wall = time.perf_counter() - t0
    return kernel_table(prof, wall, top=12)


def _ms(fn, reps: int = 3) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def attention_time(cfg, args, device) -> dict:
    """One layer's training attention at the step's microbatch shape."""
    b = args.batch // args.microbatches
    gen = torch.Generator(device=device).manual_seed(0)
    dt = getattr(torch, cfg.dtype)

    def rand(heads):
        return torch.randn((b, args.seq, heads, cfg.hd), generator=gen,
                           device=device).to(dt).requires_grad_()
    q, k, v = rand(cfg.n_heads), rand(cfg.n_kv), rand(cfg.n_kv)
    pos = torch.arange(args.seq, dtype=torch.int32, device=device)
    ct = torch.randn(q.shape, generator=gen, device=device).to(dt)

    def fwd():
        with torch.no_grad():
            flash_attention(q, k, v, q_positions=pos, kv_positions=pos,
                            chunk=cfg.attn_chunk)

    def fwd_bwd():
        o = flash_attention(q, k, v, q_positions=pos, kv_positions=pos,
                            chunk=cfg.attn_chunk)
        torch.autograd.grad(o, (q, k, v), ct)

    f, fb = _ms(fwd), _ms(fwd_bwd)
    per_step = cfg.n_layers * args.microbatches * (f + fb)
    return {"forward_ms": f, "forward_backward_ms": fb,
            "per_step_ms": per_step}


def main(argv=None) -> dict:
    ap = train.build_parser()
    args = ap.parse_args(argv)
    out = train.run_lm(args)
    res = {"step": profile_step(out, args)}
    if out["params"].embed.device.type == "cuda":
        res["attention"] = attention_time(out["cfg"], args,
                                          out["params"].embed.device)
    r = res["step"]
    print(f"[profile step] wall {r['wall_ms']:.2f} ms, device "
          f"{r['device_ms']:.2f} ms, busy share {r['busy_share']:.3f}, "
          + ", ".join(f"{k} {v:.2f} ms"
                      for k, v in sorted(r["by_kind_ms"].items())))
    for row in r["top"]:
        print(f"[profile step]   {row['ms']:9.3f} ms  x{row['count']:<5d} "
              f"{row['name']}")
    if "attention" in res:
        a = res["attention"]
        print(f"[profile attention] one layer: forward {a['forward_ms']:.2f}"
              f" ms, forward + backward {a['forward_backward_ms']:.2f} ms; "
              f"{a['per_step_ms']:.1f} ms per step")
    print(json.dumps({"train": out["report"], "step_s": out["step_s"],
                      "profile": res}))
    return res


if __name__ == "__main__":
    main()
