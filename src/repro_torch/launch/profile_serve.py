"""Device time by kernel over one warm LM prefill and a few decode steps.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve \
        --arch qwen3-1.7b --batch 4 --prompt-len 4096 --gen 32

Takes ``repro_torch.launch.serve``'s flags plus ``--decode-steps``. Serves
one batch with them (which also warms every kernel up), then profiles a
second prefill of the same prompt and ``--decode-steps`` greedy decode
steps with ``torch.profiler`` and prints, for each phase, the host-clock
wall time, the summed device time, the device's busy share of the wall
time, device time by kind of kernel (the flash-attention kernel, matrix
products, copies and casts, the rest) and the longest kernels, then one
JSON line of the same. A one-off analysis of where serving spends its
time; the serving path never calls it.
"""
from __future__ import annotations

import json
import time

import torch

from repro_torch.launch import serve


def kernel_table(prof, wall_s: float, top: int = 8) -> dict:
    """Device time by kernel from a ``torch.profiler`` window: the top
    ``top`` kernels, the summed device time and the busy share of the
    window's host-clock length."""
    rows = []
    for evt in prof.key_averages():
        # device-side events only: an operator's own row repeats the time
        # of the kernels it launched
        if str(getattr(evt, "device_type", "")).endswith("CPU"):
            continue
        dt = getattr(evt, "self_device_time_total", 0.0) or 0.0
        if dt > 0:
            rows.append((dt / 1e3, evt.count, evt.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    by_kind: dict[str, float] = {}
    for ms, _, name in rows:
        kind = kernel_kind(name)
        by_kind[kind] = by_kind.get(kind, 0.0) + ms
    return {"wall_ms": wall_s * 1e3, "device_ms": busy,
            "busy_share": busy / (wall_s * 1e3) if wall_s else 0.0,
            "by_kind_ms": by_kind,
            "top": [{"ms": ms, "count": n, "name": name[:90]}
                    for ms, n, name in rows[:top]]}


def kernel_kind(name: str) -> str:
    if "flash_fwd" in name:
        return "flash_attention"
    if "gather_mm" in name:
        return "gather_matmul"
    if "spmm" in name or "reduce_chunks" in name:
        return "bcoo_spmm"
    if any(w in name.lower() for w in ("gemm", "gemv", "nvjet", "cutlass")):
        return "matmul"
    if "copy" in name:
        return "copy_cast"
    return "other"


def profile_phases(out: dict, n_decode: int) -> dict:
    """Profile one prefill of ``out``'s prompt and ``n_decode`` decode
    steps, with ``out`` a ``serve.run`` result."""
    from torch.profiler import ProfilerActivity, profile
    cfg, params, prompt = out["cfg"], out["params"], out["prompt"]
    x = prompt["embeds" if "embeds" in prompt else "tokens"]
    b, t, device = x.shape[0], x.shape[1], x.device
    prefill = serve.make_prefill_step(cfg)
    decode = serve.make_decode_step(cfg)
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    res = {}
    with torch.inference_mode():
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            logits, cache = prefill(params, prompt)
            serve._sync(device)
            wall = time.perf_counter() - t0
        res["prefill"] = kernel_table(prof, wall)
        cache = serve.graft(cfg, cache, b, t + n_decode + 1, device)
        tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(n_decode):
                logits, cache = decode(params, cache, {"tokens": tok})
                tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
            serve._sync(device)
            wall = time.perf_counter() - t0
        res["decode"] = kernel_table(prof, wall)
        res["decode"]["steps"] = n_decode
    return res


def main(argv=None) -> dict:
    ap = serve.build_parser()
    ap.add_argument("--decode-steps", type=int, default=8)
    args = ap.parse_args(argv)
    out = serve.run(args)
    res = profile_phases(out, args.decode_steps)
    for phase, r in res.items():
        print(f"[profile {phase}] wall {r['wall_ms']:.2f} ms, device "
              f"{r['device_ms']:.2f} ms, busy share {r['busy_share']:.3f}, "
              + ", ".join(f"{k} {v:.2f} ms"
                          for k, v in sorted(r["by_kind_ms"].items())))
        for row in r["top"]:
            print(f"[profile {phase}]   {row['ms']:9.3f} ms  "
                  f"x{row['count']:<5d} {row['name']}")
    print(json.dumps({"serve": out["report"], "profile": res}))
    return res


if __name__ == "__main__":
    main()
