"""Serve a small model on the PyTorch port with batched requests:
continuous prefill+decode over a queue of prompts of different lengths
(bucketed), reporting throughput. The counterpart of ``serve_lm.py``,
with ``--device`` (the card by default, where each prefill's attention
runs the hand-written flash kernel).

    PYTHONPATH=src python examples/torch_serve_lm.py --requests 8 --gen 24
"""
import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs import smoke_config
from repro_torch.device import resolve_device
from repro_torch.launch.serve import greedy_generate
from repro_torch.models.lm.backbone import init_params


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = smoke_config(args.arch)
    params = init_params(cfg, 0, device)
    rng = np.random.default_rng(0)

    # request queue: random prompt lengths, bucketed to the batch size
    prompts = [rng.integers(0, cfg.vocab, rng.integers(8, 33))
               for _ in range(args.requests)]
    buckets = [prompts[i:i + args.batch]
               for i in range(0, len(prompts), args.batch)]

    done, total_tokens = 0, 0
    t0 = time.perf_counter()
    for bucket in buckets:
        max_len = max(len(p) for p in bucket)
        # left-pad to a common length (greedy bucketing)
        toks = np.zeros((len(bucket), max_len), np.int32)
        for i, p in enumerate(bucket):
            toks[i, max_len - len(p):] = p
        batch = {"tokens": torch.from_numpy(toks).to(device)}
        out, stats, _ = greedy_generate(cfg, params, batch,
                                        max_len + args.gen + 1, args.gen)
        done += len(bucket)
        total_tokens += out.numel()
        print(f"bucket of {len(bucket)} (prompt≤{max_len}): "
              f"{stats['tok_per_s']:.1f} tok/s decode")
    wall = time.perf_counter() - t0
    res = {"requests": done, "generated_tokens": total_tokens,
           "wall_s": round(wall, 2), "req_per_s": round(done / wall, 3)}
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
