"""LM training on a (data × model) mesh, timed per rank.

    PYTHONPATH=src python -m repro_torch.launch.profile_lm_mesh \
        --mesh data:2,model:2 --arch qwen3-1.7b --batch 4 --seq 4096 \
        --microbatches 2 --steps 3

Starts one process per rank of ``--mesh`` (``distributed.group``: NCCL
with one card per rank when the cards suffice; gloo with every rank on
one device under ``--force-host-devices N``, through the host), draws the
seeded model on each rank and keeps its blocks
(``backbone.init_sharded_params``), and trains ``--steps`` RSC steps
(keep 0.5) through ``train.lm_steps.make_sharded_train_step``, twice:
first as the training path runs (the host enqueues the collectives and
runs ahead), then with the card synchronised around every collective
(``Mesh.sync_timing``), which gives each collective's own time and no
overlap of communication with anything else. The difference of the two
step times is what that overlap saves. The first step of each run warms
up and is left out of the medians. Prints one JSON line: the card's name
and power limit, and per rank the step seconds of both runs, the
collectives per step (calls, ms, bytes) of the synchronised run, the
``gather_matmul`` launches and skipped calls per step, and peak device
memory. ``--device cpu --smoke --force-host-devices N`` runs it on the
CPU (the plain versions of the kernels). A one-off measurement; the
training path never calls it.

``--serve`` times serving on the mesh instead
(``launch.serve.sharded_generate``: the sharded prefill of a
``--prompt-len`` prompt of ``--batch`` global rows, the graft into
prompt + ``--gen`` positions and ``--gen - 1`` greedy decode steps, the
KV cache sequence parallel over ``model``), three times: cold (the
first call builds the flash kernel and warms the libraries), as it runs,
and synchronised around every collective. Per rank and run:
prefill, graft and decode seconds, decode ms per token, the collectives
of the prefill and per decode step, flash launches by variant, the
cache's bytes against its spec's share, and peak device memory.
"""
from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import time

import torch

from repro_torch.configs import get_arch, make_batch, smoke_config
from repro_torch.distributed.group import launch, plan_group
from repro_torch.kernels import ops
from repro_torch.launch.mesh import parse_mesh_spec
from repro_torch.models.lm.backbone import init_sharded_params
from repro_torch.train.lm_steps import local_batch, make_sharded_train_step
from repro_torch.train.optimizer import Adam


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _run(step, state, ost, mesh, cfg, args, sync: bool) -> dict:
    dev = mesh.device
    mesh.sync_timing = sync
    step_s, stats = [], []
    calls = []
    for i in range(args.steps):
        batch = local_batch(make_batch(cfg, "train_4k", args.batch, args.seq,
                                       seed=i, device=dev), mesh,
                            args.microbatches)
        mesh.reset_stats()
        ops.reset_launch_counts()
        _sync(dev)
        t0 = time.perf_counter()
        state, ost, loss = step(state, ost, batch)
        float(loss)
        _sync(dev)
        step_s.append(time.perf_counter() - t0)
        stats.append(mesh.stats)
        calls.append((ops.launch_counts()["gather_matmul"],
                      ops.skipped_counts()["gather_matmul"]))
    mesh.sync_timing = False
    warm = step_s[1:] or step_s
    return {"step_s": step_s, "step_median_s": statistics.median(warm),
            "collectives": stats[-1], "gather_matmul": calls[-1]}


def rank_main(group, args) -> dict:
    mesh = parse_mesh_spec(args.mesh).bind(group.device)
    cfg = smoke_config(args.arch) if args.smoke else get_arch(args.arch)
    state = init_sharded_params(cfg, mesh, seed=0, device=group.device)
    opt = Adam(lr=3e-4, clip_norm=1.0)
    ost = opt.init(state.shards)
    step = make_sharded_train_step(cfg, opt, mesh, args.microbatches,
                                   {"keep_frac": 0.5, "backend": "kernel"})
    dev = mesh.device
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    runs = {"overlapped": _run(step, state, ost, mesh, cfg, args, False),
            "synchronised": _run(step, state, ost, mesh, cfg, args, True)}
    runs["overlap_gain_s"] = (runs["synchronised"]["step_median_s"]
                              - runs["overlapped"]["step_median_s"])
    runs["rank"] = group.rank
    runs["coords"] = mesh.coords
    runs["peak_mem_gib"] = (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                            if dev.type == "cuda" else None)
    runs["block_bytes"] = sum(t.numel() * t.element_size()
                              for t in state.shards.values())
    return runs


def _serve_once(cfg, state, prompt, mesh, args, sync: bool) -> dict:
    from repro_torch.launch.serve import sharded_generate
    mesh.sync_timing = sync
    ops.reset_launch_counts()
    toks, stats, rec = sharded_generate(
        cfg, state, prompt, args.prompt_len + args.gen, args.gen, mesh)
    mesh.sync_timing = False
    steps = max(args.gen - 1, 1)
    per_step = {op: {k: v / steps for k, v in st.items()}
                for op, st in rec["collectives"]["decode"].items()}
    cache = rec["cache"]
    return {**stats, "decode_ms_per_token": stats["decode_s"] / steps * 1e3,
            "launches": rec["launches"],
            "flash_by_variant": ops.launch_counts_by_variant()[
                "flash_attention"],
            "collectives": {"prefill": rec["collectives"]["prefill"],
                            "graft": rec["collectives"]["graft"],
                            "decode_per_step": per_step},
            "cache_bytes": sum(t.numel() * t.element_size()
                               for c in cache["layers"]
                               for t in c.values()),
            "tokens": toks.tolist()}


def serve_rank(group, args) -> dict:
    """``--serve`` on one rank (see the module's docstring)."""
    from repro_torch.convert import lm_cache_shardings
    from repro_torch.train.lm_steps import abstract_cache, local_batch
    mesh = parse_mesh_spec(args.mesh).bind(group.device)
    cfg = smoke_config(args.arch) if args.smoke else get_arch(args.arch)
    state = init_sharded_params(cfg, mesh, seed=0, device=group.device)
    dev = mesh.device
    prompt = local_batch(make_batch(cfg, "prefill_32k", args.batch,
                                    args.prompt_len, seed=0, device=dev),
                         mesh)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    with torch.inference_mode():
        runs = {name: _serve_once(cfg, state, prompt, mesh, args, sync)
                for name, sync in (("cold", False), ("overlapped", False),
                                   ("synchronised", True))}
    whole = abstract_cache(cfg, args.batch, args.prompt_len + args.gen)
    sh = lm_cache_shardings(cfg, mesh, whole)
    runs["spec_cache_bytes"] = sum(
        math.prod(cs[k].local_shape(tuple(t.shape))) * t.element_size()
        for c, cs in zip(whole["layers"], sh["layers"])
        for k, t in c.items())
    runs["rank"] = group.rank
    runs["coords"] = mesh.coords
    runs["peak_mem_gib"] = (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                            if dev.type == "cuda" else None)
    runs["block_bytes"] = sum(t.numel() * t.element_size()
                              for t in state.shards.values())
    return runs


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mesh", default="data:2,model:2")
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--serve", action="store_true",
                    help="time sharded prefill and decode, not training")
    ap.add_argument("--prompt-len", type=int, default=4096)
    ap.add_argument("--gen", type=int, default=64)
    ap.add_argument("--force-host-devices", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    mesh = parse_mesh_spec(args.mesh)
    plan = plan_group(mesh.size, force_host_devices=args.force_host_devices,
                      device=args.device)
    card = None
    if plan.devices[0] != "cpu":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], check=True, capture_output=True,
            text=True, timeout=60).stdout.strip().splitlines()
    ranks = launch(serve_rank if args.serve else rank_main, (args,),
                   plan=plan,
                   threads=2 if plan.devices[0] != "cpu" else None)
    report = {"mesh": mesh.shape, "arch": args.arch, "smoke": args.smoke,
              "backend": plan.backend, "card": card, "batch": args.batch,
              "ranks": ranks}
    if args.serve:
        report.update(serve=True, prompt_len=args.prompt_len, gen=args.gen,
                      max_len=args.prompt_len + args.gen)
    else:
        report.update(seq=args.seq, microbatches=args.microbatches)
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
