"""Warm LM serving and training times of one architecture, for comparing
two trees on the same card.

    PYTHONPATH=src python -m repro_torch.launch.profile_lm \
        --arch qwen3-1.7b --batch 4 --prompt-len 4096 --gen 32 \
        --train-batch 4 --seq 4096 --microbatches 2 --steps 3

Serves one batch through ``launch/serve.py`` (which also warms the
kernels), times ``--reps`` more prefill + greedy decode runs, then trains
``--steps`` RSC steps (keep 0.5) through ``launch/train.py lm``, and
prints one JSON line: the package's path, the prefill seconds of each
run and their median, decode tokens/s, the training step seconds and the
peak device memory. To compare two trees, run this file by path with
``PYTHONPATH`` set to each tree's ``src`` (a tree that predates the file
runs it as well: it uses only ``serve`` and ``train``), in turns.
"""
from __future__ import annotations

import argparse
import json
import statistics

import torch

import repro_torch
from repro_torch.launch import serve, train


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=4096)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--train-batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    smoke = ["--smoke"] if args.smoke else []
    out = serve.run(serve.build_parser().parse_args(
        ["--arch", args.arch, "--batch", str(args.batch), "--prompt-len",
         str(args.prompt_len), "--gen", str(args.gen), "--device",
         args.device, *smoke]))
    prefill, tok_s = [], []
    for _ in range(args.reps):
        _, st, _ = serve.greedy_generate(out["cfg"], out["params"],
                                         out["prompt"],
                                         args.prompt_len + args.gen + 1,
                                         args.gen)
        prefill.append(st["prefill_s"])
        tok_s.append(st["tok_per_s"])
    del out
    if args.device != "cpu":
        torch.cuda.empty_cache()
    res = train.main(
        ["lm", "--arch", args.arch, "--batch", str(args.train_batch),
         "--seq", str(args.seq), "--microbatches", str(args.microbatches),
         "--rsc", "--rsc-keep", "0.5", "--steps", str(args.steps),
         "--device", args.device, *smoke])
    report = {"package": repro_torch.__file__, "arch": args.arch,
              "prefill_s": prefill,
              "prefill_median_s": statistics.median(prefill),
              "tok_per_s": tok_s, "step_s": res["step_s"],
              "peak_gib": (torch.cuda.max_memory_allocated() / 2 ** 30
                           if args.device != "cpu" else None)}
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
