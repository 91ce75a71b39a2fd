#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py               # from the repository root

Phases, in order; any failure ends the run with a non-zero exit and
without the final ``{"ok": true, ...}`` line:

1. print the card's name and power limit (``nvidia-smi``);
2. build every CUDA kernel of the port from ``src/repro_torch/csrc``
   with ``nvcc`` (one ``nvcc`` per source, all started together); print
   each kernel's registers, static shared memory and spills (``ptxas
   -v``) and each library's count of tensor-core and asynchronous-load
   instructions (``cuobjdump -sass``: ``HMMA`` and ``LDGSTS`` for
   ``bcoo_spmm``, ``HGMMA`` and ``UTMALDG`` for the other two), and fail
   unless every library holds both;
3. GCN serving (``bcoo_spmm``): hold every variant against its plain
   PyTorch version on the card over (bm, bk) ∈ {8, 32, 64, 128}², d ∈
   {41, 256, 602}, f32 and bf16, every epilogue, empty row segments,
   sentinel padding and ``row_ptr=None`` (the picked tensor-core variant,
   and ``fma`` forced on the same inputs), then over split segments, a
   1,500-entry run of sentinel padding and 1-4-tile segments, checking
   that each launch is counted under its variant and that two launches
   give the same bits; and the serving forward at full width on a small
   graph against the same forward on the CPU (the kernels' plain
   versions);
4. drive the GCN serving path (``repro_torch.launch.serve_gnn``) at the
   full width of the repository's GCN (3 layers, hidden 256, block 128) on
   synthetic Reddit at ``--scale`` (0.1 by default) with the launch counts
   set to 0 just before and read just after; assert finite logits, query
   answers equal to the cached logits rows, and kernel launches equal to
   layers × partitions, all of them ``tf32x3``; compare the kernel with
   its plain version on the heaviest partition of every layer, and both
   with the plain version in f64;
5. time ``bcoo_spmm``, its plain version and ``torch.sparse.mm`` on a BSR
   tensor of the same operand (a yardstick the port never calls) at the
   serving path's shapes, work out the card's bounds for the same work
   (FP32 pipes, and TF32 tensor cores for ``tf32x3``), and time the
   stages of one full forward; then serve GraphSAGE (3 layers of 256;
   layer 0's SpMM at the feature width, d = 602, over D⁻¹A) and GCNII (4
   layers of 256) the same way, with the same assertions (layers ×
   partitions launches, all ``tf32x3``, finite logits, query answers
   equal to the cached rows);
6. GCN training with RSC (``bcoo_spmm`` in both directions): the small
   GCN of ``tests/test_torch_gnn_train.py`` (700 nodes, 2 layers of 48,
   block 32, RSC at budget 0.3, 30 epochs, dropout 0) on the card and on
   the CPU from one parameter set, the CPU planner fed the card's ∇H
   norms: plans identical at every step, losses within GNN_LOSS_RTOL and
   each parameter's change within TRAIN_DP_REL;
7. drive the GCN training path (``repro_torch.launch.train gnn``) at the
   GCN's full width (3 layers, hidden 256, block 128, batchnorm) on
   synthetic Reddit at ``--scale``, RSC at budget 0.1, 200 epochs, with
   the launch counts set to 0 just before and read just after; assert 6
   ``bcoo_spmm`` launches per step and 3 per evaluation, all ``tf32x3``,
   ``flops_fraction`` within the budget and a finite, falling loss;
   report the warm ``rsc`` and ``exact`` step medians (host clock to the
   loss read back), the RSC median apart for windows in which the
   allocator kept no column block of the output layer, the planner's
   time per refresh and peak memory; save the ∇H norms, picks and Ãᵀ
   metadata of two consecutive refreshes to ``chiprun_out/`` (the
   fixture of ``tests/test_torch_planner.py``);
8. re-run each launch of one warm RSC step (3 exact forward, 3 sampled
   backward), the 3 sampled backward launches under the plans the
   allocator picks next, and the 3 backward launches of one exact step on
   their own inputs: kernel against its plain version and both against f64; d,
   ``s_pad``, ``n_active``, the last row's sentinel padding, chunks;
   kernel (also without the padding), plain version and BSR
   ``sparse.mm`` times with the card's bound; profile 5 warm steps of
   each mode (busy share, device time by kind) and time their forward,
   backward and optimizer phases; then the same training run without RSC,
   whose best test RSC's must come within 0.07 of;
8b. the dense SpMM backend: the small GCN of phase 6 on the card through
   the dense backend against the same run through the kernel (the dense
   run's planner fed the kernel run's ∇H norms): identical plans, losses
   within GNN_LOSS_RTOL, no kernel launch in the dense run;
8c. GraphSAGE (3 layers of 256) and GCNII (4 layers of 256, α 0.1, λ 0.5)
   as phases 6–8 do GCN: the small run (3 layers of 48) on the card
   against the CPU; the full-width RSC run through ``launch.train gnn``
   with the launch counts set to 0 just before and read just after
   (GraphSAGE: 5 launches per step, its layer 0 having no backward SpMM,
   and 3 per evaluation, 1,063 in all; GCNII: 8 and 4, 1,684), all
   ``tf32x3``, ``flops_fraction`` within the budget, a finite, falling
   loss and best test above chance, with step medians, planner time,
   ``k_history`` and peak memory; each launch of one warm RSC step re-run
   on its own inputs (GraphSAGE's d = 602 forward over D⁻¹A among them);
   busy share and phases; the same run without RSC;
8d. minibatch GraphSAINT training (``pipeline/``, ``bcoo_spmm`` in both
   directions): the small GCN of phase 6 over a 4-subgraph random-walk
   pool in 2 buckets with streamed evaluation, on the card and on the CPU
   from one parameter set and one pool, the CPU planner fed the card's ∇H
   norms: the same subgraph order, identical plans at every RSC step,
   losses within GNN_LOSS_RTOL, each parameter's change within
   TRAIN_DP_REL, equal streamed val/test; then the full-width run through
   ``launch.train gnn --minibatch`` (GCN 3 × 256, block 128, RSC at budget
   0.1, synthetic ogbn-products at ``--scale`` 0.1, 8 random-walk
   subgraphs of 2,000 roots and walk length 4, 2 buckets, autotune on, 40
   epochs) with the launch counts set to 0 just before and read just
   after: 6 ``bcoo_spmm`` launches per step, 3 per subgraph per pooled
   evaluation and the autotune sweeps', all ``tf32x3``, ``flops_fraction``
   within the budget, a finite, falling loss and no autotune miss; the
   tuned decisions; the same pool without prefetch and with all 8
   subgraphs resident on the card, whose losses must equal the prefetch
   run's step for step; each mode's step medians, uploads, stall, planner
   time, hit rate, peak memory and a profiled epoch's busy share; the
   launches of one warm step re-run on their own inputs; the run without
   RSC, whose pooled best test RSC's must come within 0.07 of;
8e. checkpoints and observability: (a) phase 7's run again through
   ``launch.train gnn --metrics --trace-out --trace-jsonl --probe-every
   20`` (phase 7's graph), launch counts set to 0 just before and read
   just after: phase 7's 1,263 launches, all ``tf32x3``; ``engine.step_ms``
   counts summing to the 200 steps; ``step``, ``plan``, ``device_step``,
   ``eval`` and ``probe`` spans in both trace files; every allocation of
   the ledger within its budget, the last one's achieved fraction equal
   to ``flops_fraction``; finite probe gauges per op; it reports the warm
   RSC step median beside phase 7's, the probe's ms per op and the trace
   events written; (c, d) that run's model saved (host snapshot and
   written file timed) and served through ``serve_gnn --ckpt-dir
   --metrics --slo``: layers × partitions ``tf32x3`` launches, the saved
   parameters served, one ``serve.query_ms`` observation per query
   batch, an SLO report; (b) phase 8d's run again (its graph, pool and
   tuned cache) with ``--metrics --trace-jsonl``: 8d's launches,
   ``prefetch.uploads`` equal to the source's count, every training
   upload span in the trace of the step that consumed it (two threads
   each), plan-pool hits + refreshes + cold builds equal to the RSC
   steps; (c) the small minibatch run with dropout 0.5 and a checkpoint
   every 9 steps, uninterrupted and restored at step 9: the same losses
   and final parameters bit for bit, and the same directory restored
   into a full-batch engine of the model;
9. LM serving (``flash_attention``): sweep the kernel against its plain
   version over b ∈ {1, 2}, (nq, nkv) ∈ {(16, 8), (14, 2), (4, 4), (8, 1)}
   (GQA ratios 2, 7, 1, 8), hd ∈ {64, 128}, f32 (variant ``fma``) and
   bf16 (``wgmma``), tq = tk ∈ {1, 7, 64, 129, 257, 1024} and tq < tk
   with q_offset = tk − tq, window ∈ {None, 16, 100}, causal and not,
   checking that each launch is counted under its variant; then prefill +
   8 greedy decode steps of the f32 smoke qwen3-1.7b on the card against
   the same run on the CPU;
10. drive the LM serving path (``repro_torch.launch.serve``) at the full
    width of qwen3-1.7b (28 layers, d_model 2048, bf16, seeded random
    weights) with batch 4, a 4,096-token prompt and 32 generated tokens,
    launch counts set to 0 just before and read just after; assert 28
    kernel launches in the prefill, all of them ``wgmma``, and none in
    decode, finite logits, a (4, 32) token block, and the kernel against
    its plain version on the first layer's own q/k/v;
11. time the flash kernel, its plain version and
    ``scaled_dot_product_attention`` (a yardstick the port never calls) at
    the main path's shape, at one 32,768-token row and at qwen2-0.5b's
    widths (4 × 4,096, 14 / 2 heads, hd 64), with the card's bound; time a
    warm prefill and decode;
12. LM training (``gather_matmul``, the sampled weight gradient of
    ``rsc_matmul``): sweep the kernel against its plain version over
    n/bk ∈ {1, 3, 64}, bk ∈ {32, 64, 128}, (m, q) ∈ {(41, 96), (96, 41),
    (130, 264) (variant ``mma``), (200, 264), (2048, 6144), (6144, 2048)
    (``wgmma``)}, k_sel ∈ {1, half, all}, f32 (``fma``) and bf16; then
    3 training steps of the f32 smoke qwen3-1.7b with RSC (bk 32, keep
    0.5, 2 microbatches) on the card against the same steps on the CPU:
    equal selected blocks, losses within 1e-5 relative and each
    parameter's change within ``TRAIN_DP_REL`` of the CPU run's change;
13. drive the LM training path (``repro_torch.launch.train lm``) at the
    full width of qwen3-1.7b with batch 4 × 4,096 tokens in the
    microbatches ``configs.shapes.microbatches`` gives ``train_4k`` (2),
    RSC keep 0.5, 3 steps, launch counts set to 0 just
    before and read just after; assert 3 × 28 × 2 ``gather_matmul``
    launches per step, all of them ``wgmma``, and no ``flash_attention``
    launch, finite losses,
    and the kernel against its plain version on one of the path's own
    (x, g, idx) triples per shape;
14. time ``gather_matmul``, its plain version and a gather +
    ``torch.matmul`` (a yardstick the port never calls) at the path's
    gate/up and down shapes, with the card's bound; report the warm step
    time, tokens/s and peak device memory;
15. print each slice's JSON line (``slice``, ``bcoo_spmm_shapes``,
    ``gnn_train_slice``, ``gnn_models_slice``, ``minibatch_slice``,
    ``obs_slice``, ``lm_slice``,
    ``lm_train_slice``), the build report, the kernel line (with the
    variant each kernel ran on its main path; ``bcoo_spmm``'s launches are
    the three models' serving and RSC training runs', the minibatch
    run's and phase 8e's), the card line and,
    last, the result line.

Without a CUDA device it exits with code 2 and prints no result. It
imports nothing of JAX and nothing of the ``repro`` package.
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
KERNEL_SOURCES = ["bcoo_spmm", "gather_matmul",
                  "flash_attention"]                 # csrc/<name>.cu
# NVIDIA H100 SXM data sheet (dense, no sparsity), at the full 700 W limit.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12,     # FP32 outside the tensor cores:
              torch.bfloat16: 989e12}   # TF32 is off, so f32 runs here
TF32_FLOPS = 495e12   # bcoo_spmm's tf32x3 runs 3 TF32 products per product
# What each library's SASS must hold: tensor-core products (HGMMA: wgmma,
# HMMA: mma.sync) and asynchronous loads (UTMALDG: TMA, LDGSTS: cp.async).
SASS_OPS = {"bcoo_spmm": ("HMMA", "LDGSTS"),
            "gather_matmul": ("HGMMA", "UTMALDG"),
            "flash_attention": ("HGMMA", "UTMALDG")}
# f32: the kernel and the plain version sum the same f32 products in a
# different order. bf16: both round an f32 sum once to 8 significant bits,
# so the order can flip the last bit (2^-7 relative).
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 1e-3)}
TILES = [(8, 8), (32, 32), (64, 64), (128, 128)]
# bcoo_spmm edge cases at bm = bk = 128, as (tiles of each row block,
# sentinel entries padding the last): a row block of 320 tiles among few
# row blocks (its segment is split into chunks); a last row of 1,500
# sentinels, as a partition's padding piles up; and a sampled backward
# plan's 1-4 tiles per row over 62 row blocks (one chunk).
EDGE_CASES = {"split": ([320, 7, 0, 40], 0),
              "padded": ([12, 9, 10], 1500),
              "short": ([1, 2, 3, 4, 0, 1] * 10 + [2, 3], 0)}
WIDTHS = [41, 256, 602]
EPILOGUES = [(b, r, u) for b in (False, True) for r in (False, True)
             for u in (False, True)]
# Flash attention, scaled to each output row, since a row's size falls as
# 1/sqrt(keys it sees): element-wise |out - ref| <= atol_row + 2e-2·|ref|
# with atol_row = min(FLASH_ATOL, FLASH_ROW·rms(ref row)), FLASH_ATOL being
# tests/test_kernels.py's flash tolerances; and for each row
# ||out - ref|| <= FLASH_ROW_L2·||ref||. In bf16 the kernel rounds P to
# bf16 before P·V and both sides round the output once (a few 1e-3 of a
# row's norm); in f32 the two sum in other orders.
FLASH_ATOL = {torch.float32: 2e-4, torch.bfloat16: 5e-2}
FLASH_ROW = {torch.float32: 1e-3, torch.bfloat16: 5e-2}
FLASH_ROW_L2 = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
FLASH_RTOL = 2e-2
FLASH_HEADS = [(16, 8), (14, 2), (4, 4), (8, 1)]
FLASH_LENGTHS = [(t, t) for t in (1, 7, 64, 129, 257, 1024)] + [
    (1, 257), (7, 1024), (64, 257), (100, 385), (257, 1024)]   # (tq, tk)
LM_ARGV = ["--arch", "qwen3-1.7b", "--batch", "4", "--prompt-len", "4096",
           "--gen", "32", "--device", "cuda"]
# Flash timing rows (b, t, nq, nkv, hd, q_chunk of the plain version,
# reps) on seeded inputs, after the main path's own shape: one 32,768-token
# row of qwen3-1.7b's heads, and qwen2-0.5b's widths at the prefill shape.
FLASH_ROWS = [(1, 32768, 16, 8, 128, 1024, 3), (4, 4096, 14, 2, 64, None, 20)]
# gather_matmul against its plain version, in f32, scaled to the data: for
# each element |out - ref| <= rtol·|ref| + row·rms(ref row), and
# ||out - ref||_F <= norm·||ref||_F. bf16: both sides sum exact products in
# f32 (in other orders) and round once to 8 bits, so an element may differ
# by one unit of its last place (< 2^-7·|ref|); f32: the two orders differ
# by ~sqrt(terms)·2^-24 of a row's size. A selected block left out moves
# the result by ~1/sqrt(k_sel) of its norm (all of it when k_sel = 1).
GATHER_TOL = {torch.float32: (1e-4, 1e-4, 1e-4),
              torch.bfloat16: (1e-2, 1e-3, 2e-3)}      # (rtol, row, norm)
GATHER_WIDTHS = [(41, 96), (96, 41), (130, 264), (200, 264), (2048, 6144),
                 (6144, 2048)]                                  # (m, q)
# The smoke training on the card against the CPU: each parameter's change
# over the run within TRAIN_DP_REL of the CPU run's change, in L2 norm. A
# sampled dW that drops one of its two selected blocks moves it by ~0.7.
TRAIN_DP_REL = 1e-3
# The small GNN training run held on the card against the CPU: the graph
# and model of tests/test_torch_gnn_train.py's trajectory (GCN 2 × 48,
# block 32, so tf32x3; batchnorm; dropout 0; RSC at budget 0.3; 30 epochs).
GNN_GRAPH = dict(n_nodes=700, n_clusters=7, avg_degree=12, feat_dim=32,
                 seed=0)
GNN_SMALL = dict(model="gcn", n_layers=2, hidden=48, block=32,
                 batchnorm=True, dropout=0.0, rsc=True, budget=0.3, epochs=30)
# The same run for GraphSAGE and GCNII (3 layers of 48 each; GraphSAGE's
# layer 0 has no backward SpMM), and GNN_SMALL on the dense backend against
# the kernel on the card.
GNN_SMALL_DEEP = dict(GNN_SMALL, n_layers=3)
# Full width of each model on the training and serving paths: (layers,
# hidden); GCNII at the depth benchmarks/paper_tables.py gives it.
GNN_WIDTHS = {"gcn": (3, 256), "graphsage": (3, 256), "gcnii": (4, 256)}
# Its losses, card against CPU: both sum f32 products in other orders (the
# kernel's 3xTF32 products carry ~1e-6 of each sum), through 30 Adam steps
# from the same parameters with the same plans; each parameter's change is
# held to TRAIN_DP_REL as above. A tile left out of an SpMM moves the loss
# by far more.
GNN_LOSS_RTOL = 1e-4
# Two consecutive refreshes of the full-width training run, saved for
# tests/test_torch_planner.py (copied there as
# tests/test_torch_planner_main_path.npz)
REFRESH_FIXTURE_FIRST = 4
REFRESH_FIXTURE = ROOT / "chiprun_out" / "test_torch_planner_main_path.npz"
# The autotuner's cache file for this run: a fresh one, so the serving and
# full-batch phases dispatch the heuristic bd (no entry), the minibatch
# phase sweeps its own signatures, and its decisions come back.
AUTOTUNE_CACHE = ROOT / "chiprun_out" / "spmm_autotune_torch.json"
# The small minibatch run held on the card against the CPU: GNN_SMALL's
# graph and model over a random-walk pool of 4 subgraphs in 2 buckets,
# streamed evaluation in 2 partitions (autotune off: one fixed bd per
# shape on the card).
MB_SMALL = dict(GNN_SMALL, epochs=8, n_subgraphs=4, n_buckets=2, roots=100,
                walk_length=2, autotune=False, eval_mode="stream",
                stream_partitions=2)
# The full-width minibatch run: GCN 3 × 256, block 128, batchnorm, RSC at
# budget 0.1 on synthetic ogbn-products at --scale 0.1 (244,902 nodes, too
# many tiles for full-batch training on one card); 8 random-walk subgraphs
# of 2,000 roots and walk length 4 (GraphSAINT's random-walk sampler for
# Reddit, Zeng et al. ICLR 2020, train_config/table2/reddit2_rw.yml), 2
# buckets, autotune on; 40 epochs, the CLI's 200 cut for time. It runs in
# three upload modes (prefetch on, off, and all 8 subgraphs resident on
# the card), whose losses must be equal step for step, and without RSC.
MB_EPOCHS = 40
MB_RESIDENT = 8
# Phase 8e: the full-width GCN run probes every OBS_PROBE_EVERY epochs (the
# CLI's default is every epoch) on OBS_PROBE_ROWS row blocks per op; the
# serving run's SLO is a p99 no query here comes near.
OBS_PROBE_EVERY = 20
OBS_PROBE_ROWS = 8
OBS_SLO_P99_MS = 1000.0


def train_argv(microbatches: int) -> list[str]:
    """The full-width training run: batch 4 of 4,096 tokens."""
    return ["lm", "--arch", "qwen3-1.7b", "--batch", "4", "--seq", "4096",
            "--microbatches", str(microbatches), "--rsc", "--rsc-keep", "0.5",
            "--steps", "3", "--device", "cuda"]


def say(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()


def assert_close(out: torch.Tensor, ref: torch.Tensor, dtype) -> float:
    """Kernel output against the plain version, in f32; returns the max
    absolute error."""
    out, ref = out.float(), ref.float()
    rtol, atol = TOL[dtype]
    scale = max(1.0, float(ref.abs().max())) if ref.numel() else 1.0
    torch.testing.assert_close(out, ref, rtol=rtol, atol=atol * scale)
    return float((out - ref).abs().max()) if ref.numel() else 0.0


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean time of ``fn`` on the card from CUDA events over ``reps`` runs."""
    for _ in range(warmup):
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


# ------------------------------------------------------------------ phases

def kernel_label(mangled: str) -> str:
    """``flash_fwd_wgmma<128>`` or ``spmm_tc<float,64,1>`` from the mangled
    name ``ptxas`` prints: the last length-prefixed name of
    ``_ZN<len><name>...`` and its template arguments (types, and integer
    or bool values)."""
    pos, name = 3 if mangled.startswith("_ZN") else 2, None
    while (m := re.match(r"\d+", mangled[pos:])):
        start = pos + m.end()
        name, pos = mangled[start:start + int(m.group())], \
            start + int(m.group())
    if name is None:
        return mangled
    args = []
    if mangled[pos:pos + 1] == "I":
        pos += 1
        while pos < len(mangled) and mangled[pos] != "E":
            if (m := re.match(r"L[a-z](\d+)E", mangled[pos:])):
                args.append(m.group(1))
            elif (m := re.match(r"\d+", mangled[pos:])):
                end = pos + m.end() + int(m.group())
                args.append(mangled[pos + m.end():end].removeprefix("__nv_"))
                pos = end
                continue
            elif (m := re.match(r"[fdib]", mangled[pos:])):
                args.append({"f": "float", "d": "double", "i": "int",
                             "b": "bool"}[m.group()])
            else:
                break
            pos += m.end()
    return name + (f"<{','.join(args)}>" if args else "")


def ptxas_summary(log: str) -> dict[str, str]:
    """Registers, static shared memory and spills of each kernel, from the
    ``-Xptxas -v`` log (dynamic shared memory is set at launch)."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = kernel_label(m.group(1))
            out[name] = ""
        elif name and ("registers" in line or "spill" in line):
            out[name] = (out[name] + "; " if out[name] else "") + \
                line.split("ptxas info    :")[-1].strip()
    return out


def build_kernels(build) -> dict:
    """Build every kernel (one ``nvcc`` each, all at once), print each
    kernel's ``ptxas`` figures, any compiler warning and the count of the
    ``SASS_OPS`` instructions in each library, which must hold both."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as ex:
        built = list(ex.map(build.build, KERNEL_SOURCES))
    secs = time.perf_counter() - t0
    report = {"seconds": secs, "ptxas": {}, "sass": {}}
    for name, (path, log) in zip(KERNEL_SOURCES, built):
        sass = build.sass_counts(path, SASS_OPS[name])
        report["ptxas"].update(ptxas_summary(log))
        report["sass"][name] = sass
        say(f"[build] {name}: {path.name}, SASS {sass}")
        for kernel, info in ptxas_summary(log).items():
            say(f"[build]   {kernel}: {info}")
        for line in log.splitlines():
            if "warning" in line.lower():
                say(f"[build]   {line.strip()}")
        if min(sass.values()) < 1:
            raise AssertionError(f"{name} lacks tensor-core products or "
                                 f"asynchronous loads: {sass}")
    say(f"[build] {len(KERNEL_SOURCES)} kernel(s) in {secs:.2f} s")
    return report


def sweep_case(rng, bm, bk, d, dtype, dev, n_rb=6, n_cb=7, n_tiles=14):
    """A random operand with row block 2 empty, a sentinel inside the
    first segment and three sentinel pad entries on the last row."""
    pairs = set()
    while len(pairs) < n_tiles:
        r = int(rng.integers(0, n_rb))
        if r != 2:
            pairs.add((r, int(rng.integers(0, n_cb))))
    entries = sorted(pairs)
    s = len(entries)
    rows, cols, sel = ([e[0] for e in entries], [e[1] for e in entries],
                       list(range(s)))
    sel.insert(1, s)
    rows.insert(1, rows[0])
    cols.insert(1, 0)
    sel, rows, cols = sel + [s] * 3, rows + [rows[-1]] * 3, cols + [0] * 3
    blocks = rng.standard_normal((s + 1, bm, bk)).astype(np.float32)
    blocks[s] = 0.0

    def f(x):
        return torch.from_numpy(x).to(dev, dtype)

    def i(x):
        return torch.tensor(x, dtype=torch.int32, device=dev)

    return dict(
        blocks=f(blocks), sel=i(sel), row_ids=i(rows), col_ids=i(cols),
        h=f(rng.standard_normal((n_cb * bk, d)).astype(np.float32)),
        bias=f(rng.standard_normal(d).astype(np.float32)),
        residual=f(rng.standard_normal((n_rb * bm, d)).astype(np.float32)),
        n_rb=n_rb)


def segment_case(rng, segs, pad, bm, bk, d, dtype, dev):
    """Row block i holds ``segs[i]`` tiles (distinct sorted column
    blocks), and the last row ``pad`` sentinel entries after them."""
    n_cb = max(segs) + 3
    rows, cols = [], []
    for r, n in enumerate(segs):
        rows += [r] * n
        cols += sorted(rng.choice(n_cb, n, replace=False).tolist())
    s = len(rows)
    sel = list(range(s)) + [s] * pad
    rows, cols = rows + [len(segs) - 1] * pad, cols + [0] * pad
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(rng.integers(1 << 31)))
    blocks = randn(gen, (s + 1, bm, bk), dtype, dev)
    blocks[s] = 0

    def i(x):
        return torch.tensor(x, dtype=torch.int32, device=dev)

    return dict(
        blocks=blocks, sel=i(sel), row_ids=i(rows), col_ids=i(cols),
        h=randn(gen, (n_cb * bk, d), dtype, dev),
        bias=randn(gen, (d,), dtype, dev),
        residual=randn(gen, (len(segs) * bm, d), dtype, dev),
        n_rb=len(segs))


def spmm_check(ops, kmod, bcoo_spmm_ref, ids, kw, rptr, dtype, dev,
               force=None) -> tuple[str, float]:
    """One kernel call against the plain version, checking that it is
    counted once, under its variant, and that a second call gives the same
    bits. ``force="fma"`` launches the FMA variant (through ``launch``,
    into a buffer) where a tensor-core one would be picked."""
    blocks, sel, _, col_ids, h = ids
    d = h.shape[1]
    var = force or kmod.variant(dtype, kw["bm"], kw["bk"], d)
    outs = []
    for _ in range(2):
        before = dict(kmod.launches_by_variant)
        if force:
            out = torch.empty((kw["n_row_blocks"] * kw["bm"], d),
                              dtype=dtype, device=dev)
            kmod.launch(blocks, sel, col_ids, rptr, h, kw["bias"],
                        kw["residual"], out, bm=kw["bm"], bk=kw["bk"],
                        bd=ops.resolve_bd(None, d), relu=kw["relu"],
                        force=force)
        else:
            out = ops.bcoo_spmm(*ids, row_ptr=rptr, **kw)
        torch.cuda.synchronize()
        counted = {v: kmod.launches_by_variant[v] - before[v]
                   for v in kmod.VARIANTS}
        if counted != {v: int(v == var) for v in kmod.VARIANTS}:
            raise AssertionError(f"{var} launch counted as {counted}")
        outs.append(out)
    if not torch.equal(*outs):
        raise AssertionError(f"{var}: two launches on the same inputs differ")
    ref = bcoo_spmm_ref(*ids, **kw)
    if outs[0].dtype != dtype or outs[0].shape != ref.shape:
        raise AssertionError(f"got {outs[0].dtype} {outs[0].shape}")
    return var, assert_close(outs[0], ref, dtype)


def sweep(ops, kmod, bcoo_spmm_ref, plan_row_ptr, dev) -> dict:
    """Every variant over TILES × WIDTHS × dtypes × epilogues (the picked
    tensor-core variant through ``ops.bcoo_spmm``, and ``fma`` forced on
    the same inputs), then ``EDGE_CASES``: split segments, a long run of
    sentinel padding and a sampled backward plan's short segments."""
    rng = np.random.default_rng(0)
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    n_var: dict[str, int] = {}

    def note(dtype, var, err):
        worst[dtype] = max(worst[dtype], err)
        n_var[var] = n_var.get(var, 0) + 1

    for bm, bk in TILES:
        for d in WIDTHS:
            for dtype in (torch.float32, torch.bfloat16):
                c = sweep_case(rng, bm, bk, d, dtype, dev)
                rptr = plan_row_ptr(c["row_ids"], c["n_rb"])
                runs = [(e, rptr) for e in EPILOGUES] + [(EPILOGUES[-1], None)]
                ids = (c["blocks"], c["sel"], c["row_ids"], c["col_ids"],
                       c["h"])
                for (b, r, u), ptr in runs:
                    kw = dict(n_row_blocks=c["n_rb"], bm=bm, bk=bk, relu=u,
                              bias=c["bias"] if b else None,
                              residual=c["residual"] if r else None)
                    for force in (None, "fma"):
                        note(dtype, *spmm_check(
                            ops, kmod, bcoo_spmm_ref, ids, kw,
                            rptr if force else ptr, dtype, dev, force))
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    edges = {}
    for name, (segs, pad) in EDGE_CASES.items():
        for d in (41, 256):
            for dtype in (torch.float32, torch.bfloat16):
                c = segment_case(rng, segs, pad, 128, 128, d, dtype, dev)
                rptr = plan_row_ptr(c["row_ids"], c["n_rb"])
                n_chunks = kmod.chunks(c["n_rb"], c["sel"].shape[0], d,
                                       ops.resolve_bd(None, d), n_sm)
                if (n_chunks > 1) != (name != "short"):
                    raise AssertionError(f"{name} at d={d}: {n_chunks} "
                                         f"chunks")
                edges[f"{name} d={d}"] = n_chunks
                ids = (c["blocks"], c["sel"], c["row_ids"], c["col_ids"],
                       c["h"])
                for b, r, u in (EPILOGUES[0], EPILOGUES[-1]):
                    kw = dict(n_row_blocks=c["n_rb"], bm=128, bk=128,
                              relu=u, bias=c["bias"] if b else None,
                              residual=c["residual"] if r else None)
                    note(dtype, *spmm_check(ops, kmod, bcoo_spmm_ref, ids,
                                            kw, rptr, dtype, dev))
    n = sum(n_var.values())
    say(f"[sweep] {n} cases agree ({n_var}), two launches bit-equal in "
        f"each; chunks {edges}; max abs err f32 {worst[torch.float32]:.3e}, "
        f"bf16 {worst[torch.bfloat16]:.3e}")
    return {"cases": n, "cases_by_variant": n_var, "edge_chunks": edges,
            "max_abs_err_f32": worst[torch.float32],
            "max_abs_err_bf16": worst[torch.bfloat16]}


def small_reference(sbm_graph, StreamingInference, StreamConfig,
                    gcn) -> float:
    """The serving forward (3 layers, hidden 256, 602 features, 41
    classes, block 128, 2 partitions) on the card against the same forward
    on the CPU, on a 1,000-node graph. Tolerance 1e-4·max|logit|: the two
    sum the same f32 products in different orders."""
    g = sbm_graph(n_nodes=1000, n_clusters=41, avg_degree=20, feat_dim=602,
                  seed=0)
    cfg = dict(block=128, n_partitions=2, memory_budget_mb=None)
    outs = []
    for device in ("cpu", "cuda"):
        net = gcn.init(602, 256, 41, 3, True, seed=0, device=device)
        outs.append(StreamingInference(
            g, "gcn", net, StreamConfig(device=device, **cfg)).forward())
    ref, got = outs
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * scale)
    err = float(np.abs(got - ref).max())
    say(f"[reference] card forward = CPU forward on 1,000 nodes: max abs "
        f"err {err:.3e} (max |logit| {scale:.3e})")
    return err


def main_path(serve_gnn, ops, scale: float, model: str = "gcn"):
    """Serve ``model`` at its full width (``GNN_WIDTHS``) with seeded
    weights, launch counts set to 0 just before and read just after:
    layers × partitions launches, all ``tf32x3``; finite logits; query
    answers equal to the cached logits rows."""
    layers, hidden = GNN_WIDTHS[model]
    argv = ["--dataset", "reddit", "--scale", str(scale), "--model", model,
            "--layers", str(layers), "--hidden", str(hidden),
            "--block", "128",
            "--memory-budget-mb", "2048", "--replicas", "0",
            "--train-epochs", "0", "--queries", "256", "--query-batch", "64",
            "--device", "cuda"]
    args = serve_gnn.build_parser().parse_args(argv)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    report, server = serve_gnn.run(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    by_var = ops.launch_counts_by_variant()["bcoo_spmm"]
    si = server.si
    want = args.layers * si.n_partitions
    say(f"[serve {model}] {report['n_nodes']} nodes, {si.n_partitions} "
        f"partitions, "
        f"{si.host.s_total} tiles, build {server.build_seconds:.2f} s, "
        f"run {wall:.2f} s, launches {counts}, bcoo_spmm by variant {by_var}")
    if counts["bcoo_spmm"] != want:
        raise AssertionError(f"bcoo_spmm launched {counts['bcoo_spmm']} "
                             f"times, expected layers x partitions = {want}")
    if by_var["tf32x3"] != want:
        raise AssertionError(f"bcoo_spmm variants {by_var}: every f32 "
                             f"serving launch should be tf32x3")
    logits = si.logits
    if logits.shape != (si.host.n_rows, 41) or not np.isfinite(logits).all():
        raise AssertionError(f"logits {logits.shape} not finite/shaped")
    rng = np.random.default_rng(1)
    for _ in range(4):
        ids = rng.integers(0, si.n_valid, 64)
        got = server.query(ids)
        if not np.array_equal(got, logits[si.pos[ids]]):
            raise AssertionError("query answers differ from cached logits")
    return report, server, counts["bcoo_spmm"], by_var, wall


def bsr_operand(blocks, plan, nb_pad, bm, n_cols):
    """The partition's real tiles as a torch BSR tensor (yardstick only)."""
    keep = plan.sel != blocks.shape[0] - 1
    rows = plan.row_ids[keep].long()
    crow = torch.zeros(nb_pad + 1, dtype=torch.int64, device=blocks.device)
    crow[1:] = torch.cumsum(torch.bincount(rows, minlength=nb_pad), 0)
    return torch.sparse_bsr_tensor(
        crow, plan.col_ids[keep].long(), blocks[plan.sel[keep].long()],
        size=(nb_pad * bm, n_cols), check_invariants=True)


def layer_checks(server, ops, kmod, bcoo_spmm_ref, gcn) -> list[dict]:
    """Kernel vs plain version on the heaviest partition of every layer,
    both against the plain version in f64, then timings of kernel, plain
    version and BSR ``sparse.mm`` there, and the card's bounds: on the
    FP32 pipes (FLOP at 67 TFLOP/s) and, for ``tf32x3``, on the tensor
    cores (3 × FLOP at 495 TFLOP/s), each against the bytes."""
    si, params = server.si, server.si.params
    bm, bk = si.host.bm, si.host.bk
    p = max(si.parts, key=lambda q: q.n_active)
    nb_pad = p.row_ptr.shape[0] - 1
    rows = []
    for l in range(si.n_layers):
        with torch.inference_mode():
            blocks, plan = si.upload(p)
            slab = si.gather(p, si.layer_store[l], gcn.infer_pre(params, l))
            args = (blocks, plan.sel, plan.row_ids, plan.col_ids, slab)
            kw = dict(n_row_blocks=nb_pad, bm=bm, bk=bk)
            out = ops.bcoo_spmm(*args, row_ptr=plan.row_ptr, **kw)
            ref = bcoo_spmm_ref(*args, **kw)
            err = assert_close(out, ref, torch.float32)
            ref64 = bcoo_spmm_ref(blocks.double(), plan.sel, plan.row_ids,
                                  plan.col_ids, slab.double(), **kw)
            err64 = float((out.double() - ref64).abs().max())
            plain_err64 = float((ref.double() - ref64).abs().max())
            del ref64
            if l == si.n_layers - 1:
                # the served logits of this partition are this output
                torch.testing.assert_close(
                    torch.from_numpy(si.logits[p.out_rows]),
                    out[: p.n_rows].cpu(), rtol=1e-6, atol=1e-6)
            d = slab.shape[1]
            bd = ops.resolve_bd(None, d)
            buf = torch.empty_like(out)
            ms = cuda_ms(lambda: kmod.launch(
                blocks, plan.sel, plan.col_ids, plan.row_ptr, slab, None,
                None, buf, bm=bm, bk=bk, bd=bd, relu=False), reps=20)
            plain_ms = cuda_ms(lambda: bcoo_spmm_ref(*args, **kw), reps=3,
                               warmup=1)
            bsr = bsr_operand(blocks, plan, nb_pad, bm, slab.shape[0])
            lib_out = torch.sparse.mm(bsr, slab)
            assert_close(lib_out, ref, torch.float32)
            library_ms = cuda_ms(lambda: torch.sparse.mm(bsr, slab), reps=5,
                                 warmup=1)
        es = blocks.element_size()
        n_active = p.n_active
        nbytes = (n_active * bm * bk * es             # tiles, read once
                  + p.n_gather * bk * d * es          # gathered h rows
                  + nb_pad * bm * d * es              # output, written once
                  + (2 * plan.s_pad + nb_pad + 1) * 4)  # sel, col_ids, ptr
        flops = 2 * n_active * bm * bk * d
        variant = kmod.variant(blocks.dtype, bm, bk, d)
        n_sm = torch.cuda.get_device_properties(slab.device) \
            .multi_processor_count
        chunks = kmod.chunks(nb_pad, plan.s_pad, d, bd, n_sm) \
            if variant != "fma" else 1
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_fp32 = flops / PEAK_FLOPS[blocks.dtype] * 1e3
        t_ops = 3 * flops / TF32_FLOPS * 1e3 if variant == "tf32x3" \
            else t_fp32
        row = dict(layer=l, d=d, bd=bd, bm=bm, bk=bk, nb_pad=nb_pad,
                   s_pad=plan.s_pad, n_active=n_active, n_gather=p.n_gather,
                   variant=variant, chunks=chunks,
                   max_abs_err=err, max_abs_err_vs_f64=err64,
                   plain_max_abs_err_vs_f64=plain_err64, ms=ms,
                   plain_ms=plain_ms, library_ms=library_ms, bytes=nbytes,
                   flops=flops, bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   bound_fp32_ms=max(t_bytes, t_fp32),
                   tflops=flops / ms / 1e9)
        rows.append(row)
        say(f"[layer {l}] d={d} n_active={n_active} s_pad={plan.s_pad} "
            f"{variant} chunks={chunks} err={err:.3e} (vs f64 {err64:.3e}, "
            f"plain f32 vs f64 {plain_err64:.3e}) kernel {ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms, bsr {library_ms:.3f} ms, bound "
            f"{row['bound_ms']:.3f} ms ({row['bound_by']}; FP32 pipes "
            f"{row['bound_fp32_ms']:.3f} ms), {row['tflops']:.2f} TFLOP/s")
        del blocks, plan, slab, out, ref, buf, bsr, lib_out
        torch.cuda.empty_cache()
    return rows


def forward_stages(server, gcn) -> dict:
    """One more full forward, each stage timed on the host clock after a
    synchronize: where a serving build spends its time."""
    from repro_torch.core.rsc_spmm import spmm_apply
    si, params = server.si, server.si.params
    bm, bk = si.host.bm, si.host.bk
    t = dict(upload=0.0, premap=0.0, spmm=0.0, download=0.0, host=0.0)
    clock = time.perf_counter
    t_all = clock()
    with torch.inference_mode():
        h, ctx = gcn.infer_init(params, si.features)
        for l in range(si.n_layers):
            out = None
            for p in si.parts:
                t0 = clock()
                blocks, plan = si.upload(p)
                raw = torch.from_numpy(np.ascontiguousarray(
                    h[p.gather_rows])).to(si.device)
                torch.cuda.synchronize()
                t1 = clock()
                fn, lin = gcn.infer_pre(params, l)
                slab = fn(lin, raw)
                torch.cuda.synchronize()
                t2 = clock()
                res = spmm_apply(blocks, plan, slab, p.row_ptr.shape[0] - 1,
                                 bm, bk, "kernel")
                torch.cuda.synchronize()
                t3 = clock()
                res = res.cpu().numpy()
                t4 = clock()
                if out is None:
                    out = np.zeros((si.host.n_rows, res.shape[1]), np.float32)
                out[p.out_rows] = res[: p.n_rows]
                t["upload"] += t1 - t0
                t["premap"] += t2 - t1
                t["spmm"] += t3 - t2
                t["download"] += t4 - t3
            t0 = clock()
            h, _ = gcn.infer_post(params, l, out, h, ctx, si.valid, None)
            t["host"] += clock() - t0
    total = clock() - t_all
    np.testing.assert_allclose(h, si.logits, rtol=1e-5, atol=1e-5)
    stages = {k: v * 1e3 for k, v in t.items()}
    stages["total"] = total * 1e3
    stages["device_share"] = (t["premap"] + t["spmm"]) / total
    say("[stages] " + ", ".join(f"{k} {v:.1f} ms" for k, v in stages.items()
                                if k != "device_share")
        + f", device share {stages['device_share']:.3f}")
    return stages


# ------------------------------------------------------ GNN training phases

def gnn_argv(scale: float, rsc: bool, model: str = "gcn") -> list[str]:
    """The full-width training run of ``model`` (``GNN_WIDTHS``: 3 layers
    of 256, GCNII 4), block 128, RSC at budget 0.1 (the reference CLI's
    defaults for the rest: 200 epochs, lr 0.01, dropout 0.5, batchnorm,
    refresh every 10 steps, switch-back after 80 %)."""
    layers, hidden = GNN_WIDTHS[model]
    return ["gnn", "--model", model, "--dataset", "reddit", "--scale",
            str(scale), "--layers", str(layers), "--hidden", str(hidden),
            "--block", "128", "--budget", "0.1", "--epochs", "200",
            "--device", "cuda"] + (["--rsc"] if rsc else [])


def gnn_launches(module, layers: int, steps: int, evals: int) -> int:
    """``bcoo_spmm`` launches of a training run: each step one forward per
    layer and one backward per layer whose SpMM input carries a gradient
    (the ops the planner registers), each evaluation one per layer."""
    return (layers + len(module.spmm_names(layers))) * steps + layers * evals


class SpmmTap:
    """Stands in for ``bcoo_spmm_in_range`` (what the training path's
    SpMMs call) while it is armed: every call passes through unchanged
    (the wrapper still counts its own launches), and each armed call's
    arguments are kept."""

    def __init__(self, kmod):
        self.kmod, self.calls, self.armed = kmod, [], False

    def __enter__(self):
        self.inner = self.kmod.bcoo_spmm_in_range
        self.kmod.bcoo_spmm_in_range = self
        return self

    def __exit__(self, *exc):
        self.kmod.bcoo_spmm_in_range = self.inner

    def __call__(self, *args, **kw):
        if self.armed:
            self.calls.append((args, kw))
        return self.inner(*args, **kw)


def capture_planner(planner, feed=None):
    """Record each step's plans (as host arrays) and each RSC step's ∇H
    norms (host copies); with ``feed``, the planner is given those norms
    instead of its own run's, one per RSC step in order."""
    plans, norms = [], []
    plans_for, record = planner.plans_for, planner.record
    fed = iter(feed) if feed is not None else None

    def wrapped_plans_for(tag, step, schedule):
        out = plans_for(tag, step, schedule)
        plans.append({k: (tuple(t.cpu().numpy() for t in
                                (p.sel, p.row_ids, p.col_ids, p.row_ptr)),
                          p.n_active, p.s_pad) for k, p in out.items()})
        return out

    def wrapped_record(tag, n):
        norms.append({k: v.detach().cpu() for k, v in n.items()})
        record(tag, next(fed) if fed is not None else n)

    planner.plans_for, planner.record = wrapped_plans_for, wrapped_record
    return plans, norms


class RefreshTap:
    """Wraps ``PlanCache.refresh`` while it is entered: each refresh runs
    unchanged, and the ∇H norms it was given (the host arrays it reads
    anyway), the kept column blocks it picked and each op's ``n_active``
    are kept."""

    def __init__(self, cls):
        self.cls, self.seen = cls, []

    def __enter__(self):
        inner, seen = self.cls.refresh, self.seen
        self.inner = inner

        def refresh(cache, norms):
            alloc = inner(cache, norms)
            seen.append((dict(norms), alloc.k.copy(),
                         {k: e.plan.n_active for k, e in cache.ops.items()}))
            return alloc

        self.cls.refresh = refresh
        return self

    def __exit__(self, *exc):
        self.cls.refresh = self.inner


def write_refresh_fixture(tap, cache, first: int, path: Path) -> None:
    """Save what two consecutive refreshes of the main path (``first`` and
    the next) were given and picked, with the planner's host mirror of Ãᵀ,
    so ``tests/test_torch_planner.py`` can feed the same inputs to the
    port's and the reference's ``PlanCache``."""
    entries = list(cache.ops.values())
    e = entries[0]
    if any(x.meta is not e.meta or x.a_fro != e.a_fro for x in entries):
        raise AssertionError("the ops do not share one Ãᵀ")
    m = e.meta
    arrays = dict(
        row_ids=m.row_ids, col_ids=m.col_ids,
        col_block_tiles=m.col_block_tiles, col_block_norm=m.col_block_norm,
        col_nnz=m.col_nnz, col_norm=m.col_norm,
        shape=np.array([e.at.bk, e.at.n_row_blocks, e.at.n_col_blocks,
                        e.at.s_total]),
        a_fro=np.float64(e.a_fro), names=np.array(list(cache.ops)),
        dims=np.array([x.d for x in entries]),
        budget=np.float64(cache.budget_frac),
        step_frac=np.float64(cache.step_frac),
        refresh=np.array([first, first + 1]))
    for i in range(2):
        norms, k, n_active = tap.seen[first + i]
        arrays[f"k_{i}"] = k
        arrays[f"n_active_{i}"] = np.array([n_active[n] for n in cache.ops])
        for n in cache.ops:
            arrays[f"norms_{i}_{n}"] = norms[n]
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **arrays)


def inert_biases(net) -> set[str]:
    """The biases that feed batchnorm directly (GraphSAGE's ``self_lin`` /
    ``neigh_lin`` biases and GCNII's ``w`` biases on layers with
    batchnorm). Batchnorm removes a shift common to every row, so their
    gradient is zero up to rounding, and Adam scales that noise up to steps
    of about the learning rate on either side: their change is no measure
    of agreement, and they do not change any output."""
    return {f"{group}.{l}.bias" for l in net.bn
            for group in ("self_lin", "neigh_lin", "w") if hasattr(net, group)}


def gnn_train_small_reference(GNNTrainer, TrainConfig, sbm_graph, module,
                              small: dict, ops, dev,
                              second: str = "cpu") -> dict:
    """``small`` (a ``GNN_SMALL``-like config of ``module``) on the card
    through the kernel, and again from the same parameters either on the
    CPU (``second="cpu"``, the kernels' plain versions) or on the card
    through the dense backend (``second="dense"``). The second run's
    planner is fed the first run's ∇H norms, so both sample the same plans
    by construction (asserted at every step); then the losses within
    GNN_LOSS_RTOL and each parameter's change within TRAIN_DP_REL of the
    second run's change."""
    g = sbm_graph(**GNN_GRAPH)
    layers = small["n_layers"]
    cpu_net = module.init(GNN_GRAPH["feat_dim"], small["hidden"], 7, layers,
                          True, seed=0, device="cpu")
    start = {k: p.detach().clone() for k, p in cpu_net.named_parameters()}
    card_net = copy.deepcopy(cpu_net).to(dev)
    second_net = cpu_net if second == "cpu" else \
        copy.deepcopy(cpu_net).to(dev)
    runs, feed = {}, None
    for name, net, device, backend in (
            ("card", card_net, str(dev), "kernel"),
            (second, second_net, "cpu" if second == "cpu" else str(dev),
             "dense" if second == "dense" else "kernel")):
        tr = GNNTrainer(TrainConfig(**small, device=device, backend=backend),
                        g, model=net)
        plans, norms = capture_planner(tr.engine.planner, feed)
        ops.reset_launch_counts()
        res = tr.train(eval_every=10)
        runs[name] = (res, plans, norms, ops.launch_counts()["bcoo_spmm"])
        feed = norms
    (gres, gplans, gnorms, glaunch), (cres, cplans, cnorms, claunch) = \
        runs["card"], runs[second]
    steps = small["epochs"]
    want = gnn_launches(module, layers, steps, len(gres["history"]["val"]))
    if claunch != 0 or glaunch != want:
        raise AssertionError(f"bcoo_spmm launches: {second} {claunch}, "
                             f"card {glaunch}, expected 0 and {want}")
    if gres["history"]["mode"] != cres["history"]["mode"]:
        raise AssertionError(f"step modes differ between card and {second}")
    if len(gplans) != len(cplans) or not all(
            all(np.array_equal(x, y) for x, y in zip(a[k][0], b[k][0]))
            and a[k][1:] == b[k][1:] for a, b in zip(gplans, cplans)
            for k in a):
        raise AssertionError(f"the card's and the {second} run's plans "
                             f"differ")
    gloss, closs = gres["history"]["loss"], cres["history"]["loss"]
    loss_err = float(np.max(np.abs(np.subtract(gloss, closs))
                            / np.abs(closs)))
    norm_err = max(float((a[k] - b[k]).abs().max() / b[k].abs().max())
                   for a, b in zip(gnorms, cnorms) for k in a)
    rel, inert = {}, inert_biases(card_net)
    for (name, a), (_, b) in zip(second_net.named_parameters(),
                                 card_net.named_parameters()):
        if name in inert:
            continue
        moved = a.detach().cpu() - start[name]
        rel[name] = float((b.detach().cpu() - a.detach().cpu()).norm()
                          / moved.norm().clamp(min=1e-30))
    worst = max(rel, key=rel.get)
    n_sampled = sum(p[k][1] < p[k][2] for p in gplans for k in p)
    label = f"{small['model']} {layers}x{small['hidden']} block " \
        f"{small['block']} RSC" + (", dense backend" if second == "dense"
                                    else "")
    say(f"[gnn reference] {label}, {steps} steps: plans identical at all "
        f"{len(gplans)} RSC steps ({n_sampled} sampled op plans), flops "
        f"fraction {gres['flops_fraction']:.4f}; launches card {glaunch}, "
        f"{second} {claunch}; largest loss error {loss_err:.3e} (limit "
        f"{GNN_LOSS_RTOL:.0e}), ∇H norms {norm_err:.3e} of max, parameter "
        f"change {rel[worst]:.3e} ({worst}, limit {TRAIN_DP_REL:.0e}; "
        f"{len(inert)} biases feeding batchnorm left out)")
    np.testing.assert_allclose(gloss, closs, rtol=GNN_LOSS_RTOL)
    if rel[worst] > TRAIN_DP_REL:
        raise AssertionError(f"{worst}'s change differs from the {second} "
                             f"run's by {rel[worst]:.3e} of its norm")
    return {"model": small["model"], "second": second, "steps": steps,
            "launches": glaunch, "flops_fraction": gres["flops_fraction"],
            "sampled_op_plans": int(n_sampled),
            "max_loss_rel_err": loss_err, "max_norm_rel_err": norm_err,
            "max_param_change_err": rel[worst],
            "losses_card": gloss, f"losses_{second}": closs}


def gnn_train_main_path(train, ops, scale: float,
                        model: str = "gcn") -> tuple[dict, dict]:
    """The full-width RSC training run of ``model`` through ``launch.train
    gnn``, with the launch counts set to 0 just before and read just
    after: ``gnn_launches`` ``bcoo_spmm`` launches (GCN: 6 per step, 3 per
    evaluation), all ``tf32x3``; flops fraction within the budget; finite,
    falling loss; best test above chance. For GCN the refreshes
    ``REFRESH_FIXTURE_FIRST`` and the next are saved as the planner
    test's fixture."""
    from repro_torch.core.cache import PlanCache
    from repro_torch.models.gnn import MODELS
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    argv = gnn_argv(scale, rsc=True, model=model)
    ops.reset_launch_counts()
    with RefreshTap(PlanCache) as refreshes:
        t0 = time.perf_counter()
        out = train.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    by_var = ops.launch_counts_by_variant()["bcoo_spmm"]
    peak = torch.cuda.max_memory_allocated()
    res, hist = out["result"], out["result"]["history"]
    steps, evals = len(hist["loss"]), len(hist["val"])
    layers = out["trainer"].cfg.n_layers
    module = MODELS[model]
    want = gnn_launches(module, layers, steps, evals)
    per_step = layers + len(module.spmm_names(layers))
    losses = np.asarray(hist["loss"])
    modes = np.asarray(hist["mode"])
    step_ms = np.asarray(hist["step_time"]) * 1e3
    rsc_ms = step_ms[modes == "rsc"][3:]           # past the first steps
    exact_ms = step_ms[modes == "exact"][1:]
    stats = res["cache_stats"]
    # RSC steps by window: one where the allocator kept no column block of
    # the last op (the output layer's SpMM), or one where it kept some
    ks = hist["k"]
    rsc_at = np.flatnonzero(modes == "rsc")[-len(ks):]
    empty = np.array([k[-1] == 0 for k in ks])
    by_window = {w: float(np.median(step_ms[rsc_at[sel]]))
                 for w, sel in (("output_layer_empty", empty),
                                ("output_layer_kept", ~empty)) if sel.any()}
    k_hist = np.array([k.tolist() for k in stats.k_history])
    names = module.spmm_names(layers)
    empty_windows = {n: int((k_hist[:, i] == 0).sum())
                     for i, n in enumerate(names)}
    if model == "gcn":
        write_refresh_fixture(refreshes, out["trainer"].engine.planner.cache,
                              REFRESH_FIXTURE_FIRST, REFRESH_FIXTURE)
    say(f"[gnn train {model}] {steps} steps ({int((modes == 'rsc').sum())} "
        f"rsc), {evals} evaluations, setup {out['setup_s']:.2f} s, run "
        f"{wall:.2f} s, launches {counts}, bcoo_spmm by variant {by_var}, "
        f"flops fraction {res['flops_fraction']:.4f}, best test "
        f"{res['best_test']:.4f}, loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
        f"peak {peak / 2 ** 30:.2f} GiB")
    if counts["bcoo_spmm"] != want or counts["flash_attention"] \
            or counts["gather_matmul"]:
        raise AssertionError(f"launches {counts}, expected {want} bcoo_spmm "
                             f"({per_step} per step, {layers} per "
                             f"evaluation) and nothing else")
    if by_var["tf32x3"] != want:
        raise AssertionError(f"bcoo_spmm variants {by_var}: every training "
                             f"launch should be tf32x3")
    if not res["flops_fraction"] <= 0.1 + 1e-9:
        raise AssertionError(f"flops fraction {res['flops_fraction']} "
                             f"above the budget 0.1")
    if not np.isfinite(losses).all() or \
            not losses[-10:].mean() < losses[:10].mean():
        raise AssertionError(f"loss not finite or not falling: {losses}")
    if not res["best_test"] > 1 / 41:
        raise AssertionError(f"best test {res['best_test']} at chance")
    warm = {"rsc_step_ms_median": float(np.median(rsc_ms)),
            "exact_step_ms_median": float(np.median(exact_ms)),
            "first_step_ms": float(step_ms[0]),
            "planner_s_per_refresh": stats.host_seconds
            / max(stats.refreshes, 1),
            "refreshes": stats.refreshes, "peak_mem_gib": peak / 2 ** 30,
            "k_history": k_hist.tolist(),
            "windows_keeping_no_block": empty_windows,
            "rsc_step_ms_median_by_window": by_window,
            "rsc_steps_by_window": {
                "output_layer_empty": int(empty.sum()),
                "output_layer_kept": int((~empty).sum())}}
    say(f"[gnn train {model} warm] step median rsc "
        f"{warm['rsc_step_ms_median']:.3f} ms, exact "
        f"{warm['exact_step_ms_median']:.3f} ms (first "
        f"{warm['first_step_ms']:.1f} ms); planner "
        f"{warm['planner_s_per_refresh'] * 1e3:.2f} ms per refresh "
        f"({stats.refreshes} refreshes; kept column blocks per op "
        f"{warm['k_history']}; refreshes keeping no block, per op "
        f"{empty_windows}); rsc step median by window {by_window} over "
        f"{warm['rsc_steps_by_window']} steps"
        + (f"; refreshes {REFRESH_FIXTURE_FIRST} and "
           f"{REFRESH_FIXTURE_FIRST + 1} saved to "
           f"{REFRESH_FIXTURE.relative_to(ROOT)}" if model == "gcn" else ""))
    return out, {"model": model, "argv": argv, "report": out["report"],
                 "run_s": wall, "setup_s": out["setup_s"], "steps": steps,
                 "evaluations": evals, "launches": counts["bcoo_spmm"],
                 "launches_by_variant": by_var, "warm": warm,
                 "loss_first": float(losses[0]),
                 "loss_last": float(losses[-1])}


def spmm_f64(blocks, sel, row_ids, col_ids, h, n_row_blocks, bm, bk,
             bias, residual, relu, chunk=2048) -> torch.Tensor:
    """The SpMM with its epilogue in f64 on the card, ``chunk`` entries at
    a time (the yardstick for both the kernel and the plain version)."""
    d = h.shape[1]
    hb = h.double().reshape(-1, bk, d)
    acc = torch.zeros((n_row_blocks, bm, d), dtype=torch.float64,
                      device=h.device)
    for lo in range(0, sel.shape[0], chunk):
        part = torch.einsum("sij,sjd->sid",
                            blocks[sel[lo:lo + chunk].long()].double(),
                            hb[col_ids[lo:lo + chunk].long()])
        acc.index_add_(0, row_ids[lo:lo + chunk].long(), part)
    y = acc.reshape(n_row_blocks * bm, d)
    if bias is not None:
        y = y + bias.double()
    if residual is not None:
        y = y + residual.double()
    return torch.relu(y) if relu else y


def trimmed(sel, col_ids, row_ptr, sentinel: int):
    """The id lists without the bucket's padding: the sentinel entries
    after the last row block's last real tile (one kept if it has none)."""
    s, rp = sel.cpu().numpy(), row_ptr.cpu().numpy().copy()
    last = np.nonzero(s[rp[-2]:] != sentinel)[0]
    end = int(rp[-2] + (last[-1] + 1 if last.size else 1))
    rp[-1] = end
    return sel[:end], col_ids[:end], torch.from_numpy(rp).to(sel.device), \
        s.shape[0] - end


def spmm_launch_row(call, label, ops, kmod, bcoo_spmm_ref, n_sm) -> dict:
    """One training launch, re-run on its own inputs: the kernel against
    its plain version (TOL) and both against f64; kernel, plain version
    and BSR ``sparse.mm`` times; the chunk count; for a sampled plan the
    kernel's time without the bucket's padding; the card's bound."""
    args, kw = call
    blocks, sel, row_ids, col_ids, h = args
    nrb, bm, bk, bd = (kw[k] for k in ("n_row_blocks", "bm", "bk", "bd"))
    row_ptr, bias, res, relu = (kw[k] for k in
                                ("row_ptr", "bias", "residual", "relu"))
    d, s_pad, sentinel = h.shape[1], sel.shape[0], blocks.shape[0] - 1
    real = sel != sentinel
    n_active = int(real.sum())
    n_gather = int(torch.unique(col_ids[real]).numel()) * bk
    ekw = dict(bias=bias, residual=res, relu=relu)
    with torch.no_grad():
        out = kmod.bcoo_spmm(*args, **kw)
        ref = bcoo_spmm_ref(*args, n_row_blocks=nrb, bm=bm, bk=bk, **ekw)
        err = assert_close(out, ref, torch.float32)
        ref64 = spmm_f64(*args, nrb, bm, bk, bias, res, relu)
        err64 = float((out.double() - ref64).abs().max())
        plain_err64 = float((ref.double() - ref64).abs().max())
        del ref64
        buf = torch.empty_like(out)

        def kernel(s=sel, c=col_ids, p=row_ptr):
            kmod.launch(blocks, s, c, p, h, bias, res, buf, bm=bm, bk=bk,
                        bd=bd, relu=relu)

        ms = cuda_ms(kernel, reps=20)
        plain_ms = cuda_ms(lambda: bcoo_spmm_ref(
            *args, n_row_blocks=nrb, bm=bm, bk=bk, **ekw), reps=3, warmup=1)
        ts, tc, tp, n_pad = trimmed(sel, col_ids, row_ptr, sentinel)
        ms_no_pad = cuda_ms(lambda: kernel(ts, tc, tp), reps=20) \
            if n_pad else ms
        bsr = bsr_operand(blocks, SimpleNamespace(
            sel=sel, row_ids=row_ids, col_ids=col_ids), nrb, bm, h.shape[0])
        assert_close(torch.sparse.mm(bsr, h), bcoo_spmm_ref(
            *args, n_row_blocks=nrb, bm=bm, bk=bk), torch.float32)
        library_ms = cuda_ms(lambda: torch.sparse.mm(bsr, h), reps=3,
                             warmup=1)
        del out, ref, buf, bsr
    es = blocks.element_size()
    nbytes = (n_active * bm * bk * es + n_gather * d * es
              + nrb * bm * d * es * (2 if res is not None else 1)
              + (2 * s_pad + nrb + 1) * 4)
    flops = 2 * n_active * bm * bk * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 3 * flops / TF32_FLOPS * 1e3
    row = dict(launch=label, d=d, bd=bd, nb=nrb, s_pad=s_pad,
               n_active=n_active, pad_entries=n_pad,
               chunks=kmod.chunks(nrb, s_pad, d, bd, n_sm),
               variant=kmod.variant(blocks.dtype, bm, bk, d),
               max_abs_err=err, max_abs_err_vs_f64=err64,
               plain_max_abs_err_vs_f64=plain_err64, ms=ms,
               ms_without_padding=ms_no_pad, plain_ms=plain_ms,
               library_ms=library_ms, bytes=nbytes, flops=flops,
               bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               tflops=flops / ms / 1e9)
    say(f"[gnn launch {label}] d={d} s_pad={s_pad} n_active={n_active} "
        f"pad={n_pad} chunks={row['chunks']} {row['variant']} kernel "
        f"{ms:.4f} ms (no padding {ms_no_pad:.4f}), plain {plain_ms:.3f} "
        f"ms, bsr {library_ms:.3f} ms, bound {row['bound_ms']:.4f} ms "
        f"({row['bound_by']}), err {err:.2e} (vs f64 {err64:.2e}, plain "
        f"f32 vs f64 {plain_err64:.2e})")
    return row


def gnn_steps(eng, n: int, rsc: bool, gen) -> float:
    """``n`` more steps of the trained engine under its current plans,
    each ending in its loss read (as the training loop's do; an RSC step's
    ∇H norms go to the planner); returns the last loss."""
    plans = eng.planner.cache.plans() if rsc else None
    for _ in range(n):
        if rsc:
            _, eng.opt_state, lv, norms = eng.rsc_step(
                eng.model, eng.opt_state, eng.source.ops, plans, gen)
            eng.planner.record(None, norms)
        else:
            _, eng.opt_state, lv = eng.exact_step(
                eng.model, eng.opt_state, eng.source.ops, gen)
        loss = float(lv)
    return loss


def gnn_step_phases(eng, rsc: bool, gen, reps: int = 5) -> dict:
    """Mean device time of a step's forward (with the loss), backward and
    optimizer update, from CUDA events around each phase."""
    from repro_torch.train.optimizer import apply_updates
    from repro_torch.train.steps import gnn_loss
    ops_, model, cfg = eng.source.ops, eng.model, eng.cfg
    plans = eng.planner.cache.plans() if rsc else None
    names = eng.module.spmm_names(cfg.n_layers)
    dims = eng.module.spmm_dims(cfg.n_layers, cfg.hidden, eng.n_classes)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    tot = np.zeros(3)
    for i in range(reps + 1):
        taps = {k: torch.zeros((ops_.features.shape[0], dims[k]),
                               device=ops_.features.device,
                               requires_grad=True)
                for k in (names if rsc else ())}
        params = dict(model.named_parameters())
        ev[0].record()
        logits = eng.module.apply(model, ops_, taps, plans,
                                  dropout_rate=cfg.dropout, train=True,
                                  generator=gen, backend=cfg.backend)
        loss = gnn_loss(logits, ops_)
        ev[1].record()
        grads = torch.autograd.grad(loss, [*params.values(),
                                           *taps.values()])
        ev[2].record()
        upd, eng.opt_state = eng.opt.update(
            dict(zip(params, grads[:len(params)])), eng.opt_state, params)
        apply_updates(params, upd)
        ev[3].record()
        ev[3].synchronize()
        if i:
            tot += [ev[j].elapsed_time(ev[j + 1]) for j in range(3)]
    return dict(zip(("forward_ms", "backward_ms", "optimizer_ms"),
                    (tot / reps).tolist()))


def gnn_train_timings(out, ops, kmod, bcoo_spmm_ref, kernel_table,
                      dev) -> dict:
    """On the trained engine: the launches of one warm RSC step under the
    run's last plans, each re-run on its own inputs
    (``spmm_launch_row``); for GCN also the backward launches of one
    RSC step under the plans the allocator picks next (refreshed from the
    last warm step's norms) and of one exact step; a profiled window of 5
    warm RSC and of 5 exact steps (busy share, device time by kind); the
    phases of a step."""
    from torch.profiler import ProfilerActivity, profile
    eng = out["trainer"].engine
    n = eng.cfg.n_layers
    names = eng.module.spmm_names(n)
    gen = torch.Generator(device=dev)
    gen.manual_seed(12345)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count

    def rows_of(calls, labels):
        return [spmm_launch_row(c, f"{eng.cfg.model} {lab}", ops, kmod,
                                bcoo_spmm_ref, n_sm)
                for c, lab in zip(calls, labels)]

    fwd = [f"fwd{l}" for l in range(n)]
    bwd = [f"bwd{name.rsplit('spmm', 1)[1]}" for name in reversed(names)]
    with SpmmTap(kmod) as tap:
        def capture(rsc: bool) -> list:
            gnn_steps(eng, 2, rsc, gen)                     # warm
            tap.calls, tap.armed = [], True
            gnn_steps(eng, 1, rsc, gen)
            tap.armed = False
            calls, tap.calls = tap.calls, []
            if len(calls) != n + len(names):
                raise AssertionError(f"a step made {len(calls)} SpMM "
                                     f"calls, expected {n + len(names)}")
            return calls

        k_last = eng.planner.k_latest().tolist()
        rows = rows_of(capture(True), fwd + [b + "_sampled" for b in bwd])
        extra = {}
        if eng.cfg.model == "gcn":
            eng.planner.plans_for(None, 0, eng.schedule)    # refresh
            extra["k_next"] = eng.planner.k_latest().tolist()
            extra["next_backward_rows"] = rows_of(
                capture(True)[n:], [b + "_sampled_next" for b in bwd])
            extra["exact_backward_rows"] = rows_of(
                capture(False)[n:], [b + "_exact" for b in bwd])
    torch.cuda.empty_cache()
    busy, phases = {}, {}
    for rsc in (True, False):
        mode = "rsc" if rsc else "exact"
        gnn_steps(eng, 2, rsc, gen)
        # before the profiled window: timed right after one, the phases
        # read slow (GCNII's RSC forward at twice its exact forward)
        phases[mode] = gnn_step_phases(eng, rsc, gen)
        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            gnn_steps(eng, 5, rsc, gen)
            wall = time.perf_counter() - t0
        busy[mode] = kernel_table(prof, wall, top=6)
        busy[mode]["steps"] = 5
        say(f"[gnn busy {eng.cfg.model} {mode}] 5 warm steps: "
            f"{wall * 1e3:.2f} ms wall, {busy[mode]['device_ms']:.2f} ms "
            f"device, busy share {busy[mode]['busy_share']:.3f}, by kind "
            f"{ {k: round(v, 3) for k, v in busy[mode]['by_kind_ms'].items()} }"
            f"; phases per step {phases[mode]}")
    return {"launch_rows": rows, "k_last": k_last, **extra, "busy": busy,
            "phases_ms": phases}


def gnn_train_exact_run(train, ops, scale: float, model: str = "gcn") -> dict:
    """The same run without RSC, for the reference test's accuracy margin
    (RSC's best test within 0.07 of it)."""
    from repro_torch.models.gnn import MODELS
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    out = train.main(gnn_argv(scale, rsc=False, model=model))
    res = out["result"]
    counts = ops.launch_counts()["bcoo_spmm"]
    steps, evals = len(res["history"]["loss"]), len(res["history"]["val"])
    layers = out["trainer"].cfg.n_layers
    if counts != gnn_launches(MODELS[model], layers, steps, evals):
        raise AssertionError(f"exact run: {counts} bcoo_spmm launches")
    step_ms = np.asarray(res["history"]["step_time"][1:]) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    say(f"[gnn exact {model}] best test {res['best_test']:.4f}, step median "
        f"{np.median(step_ms):.3f} ms, run {out['report']['wall_s']} s, "
        f"peak {peak:.2f} GiB")
    return {"best_test": res["best_test"], "launches": counts,
            "step_ms_median": float(np.median(step_ms)),
            "wall_s": out["report"]["wall_s"], "peak_mem_gib": peak}


# ------------------------------------------------------- minibatch phases

def mb_argv(rsc: bool = True, prefetch: bool = True) -> list[str]:
    """The full-width minibatch run (``MB_EPOCHS``; the rest as the
    comment on ``MB_EPOCHS`` says)."""
    return (["gnn", "--minibatch", "--dataset", "ogbn-products", "--scale",
             "0.1", "--layers", "3", "--hidden", "256", "--block", "128",
             "--budget", "0.1", "--epochs", str(MB_EPOCHS), "--subgraphs",
             "8", "--roots", "2000", "--walk-length", "4", "--buckets", "2",
             "--device", "cuda"] + (["--rsc"] if rsc else [])
            + ([] if prefetch else ["--no-prefetch"]))


def mb_small_reference(ops, dev) -> dict:
    """``MB_SMALL`` on the card through the kernel and on the CPU (the
    kernels' plain versions) from one parameter set and one pool, the CPU
    planner fed the card's ∇H norms: the same subgraph order, identical
    plans at every RSC step, losses within GNN_LOSS_RTOL, each parameter's
    change within TRAIN_DP_REL of the CPU run's, and the streamed val/test
    of every evaluation equal."""
    from repro_torch.graphs.synthetic import sbm_graph
    from repro_torch.models.gnn import gcn
    from repro_torch.pipeline import (MinibatchConfig, MinibatchTrainer,
                                      PoolConfig, build_pool)
    g = sbm_graph(**GNN_GRAPH)
    pool = build_pool(g, PoolConfig(
        n_subgraphs=MB_SMALL["n_subgraphs"], roots=MB_SMALL["roots"],
        walk_length=MB_SMALL["walk_length"],
        n_buckets=MB_SMALL["n_buckets"], block=MB_SMALL["block"]))
    cpu_net = gcn.init(GNN_GRAPH["feat_dim"], MB_SMALL["hidden"], 7,
                       MB_SMALL["n_layers"], True, seed=0, device="cpu")
    start = {k: p.detach().clone() for k, p in cpu_net.named_parameters()}
    card_net = copy.deepcopy(cpu_net).to(dev)
    runs, feed = {}, None
    for name, net, device in (("card", card_net, str(dev)),
                              ("cpu", cpu_net, "cpu")):
        tr = MinibatchTrainer(MinibatchConfig(**MB_SMALL, device=device), g,
                              pool, model=net)
        plans, norms = capture_planner(tr.engine.planner, feed)
        ops.reset_launch_counts()
        res = tr.train(eval_every=2)
        runs[name] = (res, plans, norms, ops.launch_counts()["bcoo_spmm"],
                      tr.engine.stream_eval.si.n_partitions)
        feed = norms
    (gres, gplans, gnorms, glaunch, parts), (cres, cplans, _, claunch, _) = \
        runs["card"], runs["cpu"]
    gh, ch = gres["history"], cres["history"]
    layers = MB_SMALL["n_layers"]
    want = 2 * layers * len(gh["loss"]) + layers * parts * len(gh["val"])
    if claunch != 0 or glaunch != want:
        raise AssertionError(f"bcoo_spmm launches: cpu {claunch}, card "
                             f"{glaunch}, expected 0 and {want}")
    if gh["sub_id"] != ch["sub_id"] or gh["mode"] != ch["mode"]:
        raise AssertionError("subgraph order or step modes differ between "
                             "card and cpu")
    if len(gplans) != len(cplans) or not all(
            all(np.array_equal(x, y) for x, y in zip(a[k][0], b[k][0]))
            and a[k][1:] == b[k][1:] for a, b in zip(gplans, cplans)
            for k in a):
        raise AssertionError("the card's and the cpu run's plans differ")
    loss_err = float(np.max(np.abs(np.subtract(gh["loss"], ch["loss"]))
                            / np.abs(ch["loss"])))
    rel = {}
    for (name, a), (_, b) in zip(cpu_net.named_parameters(),
                                 card_net.named_parameters()):
        moved = a.detach().cpu() - start[name]
        rel[name] = float((b.detach().cpu() - a.detach().cpu()).norm()
                          / moved.norm().clamp(min=1e-30))
    worst = max(rel, key=rel.get)
    rsc_sids = [sid for sid, m in zip(gh["sub_id"], gh["mode"])
                if m == "rsc"]
    n_sampled = sum(p[k][1] < pool.subgraphs[sid].meta.row_ids.shape[0]
                    for p, sid in zip(gplans, rsc_sids) for k in p)
    say(f"[minibatch reference] gcn {layers}x{MB_SMALL['hidden']} block "
        f"{MB_SMALL['block']} RSC, {len(pool)} subgraphs in "
        f"{len(pool.buckets)} buckets, {len(gh['loss'])} steps, subgraph "
        f"order {gh['sub_id'][:8]}...: plans identical at all "
        f"{len(gplans)} RSC steps ({n_sampled} sampled op plans), hit rate "
        f"{gres['plan_hit_rate']:.3f}; launches card {glaunch}, cpu "
        f"{claunch}; largest loss error {loss_err:.3e} (limit "
        f"{GNN_LOSS_RTOL:.0e}), parameter change {rel[worst]:.3e} ({worst}, "
        f"limit {TRAIN_DP_REL:.0e}); streamed val/test card {gh['val']} "
        f"{gh['test']}, cpu {ch['val']} {ch['test']}")
    np.testing.assert_allclose(gh["loss"], ch["loss"], rtol=GNN_LOSS_RTOL)
    if rel[worst] > TRAIN_DP_REL:
        raise AssertionError(f"{worst}'s change differs from the cpu run's "
                             f"by {rel[worst]:.3e} of its norm")
    if gh["val"] != ch["val"] or gh["test"] != ch["test"]:
        raise AssertionError("streamed val/test differ between card and cpu")
    if not n_sampled:
        raise AssertionError("no sampled plan in the small minibatch run")
    return {"steps": len(gh["loss"]), "launches": glaunch,
            "sub_id": gh["sub_id"], "sampled_op_plans": int(n_sampled),
            "plan_hit_rate": gres["plan_hit_rate"],
            "max_loss_rel_err": loss_err, "max_param_change_err": rel[worst],
            "val": gh["val"], "test": gh["test"]}


def mb_epoch(eng, gen) -> tuple[int, float]:
    """One more epoch of RSC steps through the trained engine's own source
    (its upload mode), each ending in its loss read; (steps, seconds)."""
    t0 = time.perf_counter()
    n = 0
    for tag, ops_ in eng.source.batches(0):
        plans = eng.planner.plans_for(tag, 0, eng.schedule)
        _, eng.opt_state, lv, norms = eng.rsc_step(
            eng.model, eng.opt_state, ops_, plans, gen)
        eng.planner.record(tag, norms)
        float(lv)
        n += 1
    return n, time.perf_counter() - t0


def mb_window(eng, gen, kernel_table) -> dict:
    """A timed epoch of RSC steps (fetch included: the per-step cost end
    to end), then a profiled one: the busy share counts the card's compute
    (every device event but the copies), the copies apart."""
    from torch.profiler import ProfilerActivity, profile
    n, epoch_s = mb_epoch(eng, gen)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        mb_epoch(eng, gen)
        wall = time.perf_counter() - t0
    table = kernel_table(prof, wall, top=6)
    copy_ms = sum(
        (getattr(e, "self_device_time_total", 0.0) or 0.0) / 1e3
        for e in prof.key_averages()
        if not str(getattr(e, "device_type", "")).endswith("CPU")
        and e.key.startswith(("Memcpy", "Memset")))
    compute_ms = table["device_ms"] - copy_ms
    return {"steps": n, "epoch_ms_per_step": epoch_s * 1e3 / n,
            "wall_ms": wall * 1e3, "compute_ms": compute_ms,
            "copy_ms": copy_ms, "busy_share": compute_ms / (wall * 1e3),
            "by_kind_ms": table["by_kind_ms"]}


def mb_mode(out, label: str, peak: float, gen, kernel_table) -> dict:
    """What one minibatch run spent where: warm step medians, uploads
    (per step, bytes each, the consumer's stall), planner time per
    refresh, plan hit rate, peak memory and a profiled epoch's busy
    share."""
    res, tr = out["result"], out["trainer"]
    eng = tr.engine
    hist = res["history"]
    modes = np.asarray(hist["mode"])
    step_ms = np.asarray(hist["step_time"]) * 1e3
    n_sub = len(tr.pool)
    rsc_ms = step_ms[modes == "rsc"][n_sub:]          # past the first epoch
    exact_ms = step_ms[modes == "exact"][1:]
    t = eng.source.transfer_stats("train")
    steps = len(hist["loss"])
    pp = tr.plan_pool
    row = {"mode": label, "steps": steps,
           "rsc_step_ms_median": (float(np.median(rsc_ms)) if rsc_ms.size
                                  else None),
           "exact_step_ms_median": (float(np.median(exact_ms))
                                    if exact_ms.size else None),
           "uploads": t["uploads"], "resident_hits": t["resident_hits"],
           "upload_ms_per_upload": t["upload_seconds"] * 1e3
           / max(t["uploads"], 1),
           "upload_ms_per_step": t["upload_seconds"] * 1e3 / steps,
           "bytes_per_upload": t["upload_bytes"] / max(t["uploads"], 1),
           "stall_ms_per_step": t["stall_seconds"] * 1e3 / steps,
           "planner_ms_per_refresh": (pp.host_seconds() * 1e3
                                      / max(pp.stats.refreshes, 1)
                                      if pp is not None else None),
           "plan_hit_rate": res["plan_hit_rate"],
           "peak_mem_gib": peak / 2 ** 30,
           "best_test": res["best_test"],
           "run_s": out["report"]["wall_s"], "setup_s": out["setup_s"]}
    if pp is not None:
        row["window"] = mb_window(eng, gen, kernel_table)
    say(f"[minibatch {label}] {steps} steps, best test "
        f"{res['best_test']:.4f}, step median rsc "
        f"{row['rsc_step_ms_median']} ms, exact "
        f"{row['exact_step_ms_median']} ms; {t['uploads']} uploads "
        f"({row['upload_ms_per_upload']:.2f} ms and "
        f"{row['bytes_per_upload'] / 1e6:.1f} MB each, "
        f"{row['upload_ms_per_step']:.2f} ms per step), {t['resident_hits']} "
        f"resident hits, stall {row['stall_ms_per_step']:.2f} ms per step; "
        f"planner {row['planner_ms_per_refresh']} ms per refresh, hit rate "
        f"{row['plan_hit_rate']}; peak {row['peak_mem_gib']:.2f} GiB"
        + (f"; one epoch {row['window']['epoch_ms_per_step']:.2f} ms per "
           f"step with its fetch; one epoch profiled: "
           f"{row['window']['wall_ms']:.1f} ms wall, "
           f"compute {row['window']['compute_ms']:.1f} ms, copies "
           f"{row['window']['copy_ms']:.1f} ms, busy share "
           f"{row['window']['busy_share']:.3f}" if "window" in row else ""))
    return row


def mb_launch_rows(eng, ops, kmod, bcoo_spmm_ref, dev) -> list[dict]:
    """The launches of one warm RSC step on subgraph 0 (after two more
    steps there), each re-run on its own inputs (``spmm_launch_row``): the
    forwards over the bucket's Ã and the sampled backwards over
    ``plan_pad`` entries."""
    from repro_torch.pipeline import device_operands
    pool = eng.source.pool
    ops_ = device_operands(pool, pool.subgraphs[0], dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(12345)
    n = eng.cfg.n_layers
    names = eng.module.spmm_names(n)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    with SpmmTap(kmod) as tap:
        for armed in (False, False, True):
            plans = eng.planner.plans_for(0, 0, eng.schedule)
            tap.calls, tap.armed = [], armed
            _, eng.opt_state, lv, norms = eng.rsc_step(
                eng.model, eng.opt_state, ops_, plans, gen)
            tap.armed = False
            eng.planner.record(0, norms)
            float(lv)
        calls = tap.calls
    if len(calls) != n + len(names):
        raise AssertionError(f"a minibatch step made {len(calls)} SpMM "
                             f"calls, expected {n + len(names)}")
    labels = [f"fwd{l}" for l in range(n)] + [
        f"bwd{name.rsplit('spmm', 1)[1]}_sampled" for name in reversed(names)]
    return [spmm_launch_row(c, f"minibatch {lab}", ops, kmod, bcoo_spmm_ref,
                            n_sm) for c, lab in zip(calls, labels)]


def mb_main_path(train, ops, kmod, bcoo_spmm_ref, autotune, kernel_table,
                 dev) -> tuple[int, dict]:
    """Phase 8d: the full-width minibatch run through ``launch.train gnn
    --minibatch`` with the launch counts set to 0 just before and read just
    after (6 ``bcoo_spmm`` launches per step, 3 per subgraph per pooled
    evaluation, and the autotune sweeps', all ``tf32x3``; flops fraction
    within the budget; a finite, falling loss; no autotune miss); the same
    pool again without prefetch and with every subgraph resident (losses
    equal step for step); the run without RSC; one warm step's launches.
    Returns the main run's launches, the slice's report, the graph and
    the pool."""
    if AUTOTUNE_CACHE.exists():
        AUTOTUNE_CACHE.unlink()
    cache = autotune.reset(AUTOTUNE_CACHE)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    argv = mb_argv()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = train.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    by_var = ops.launch_counts_by_variant()["bcoo_spmm"]
    peak = torch.cuda.max_memory_allocated()
    res, hist = out["result"], out["result"]["history"]
    tr = out["trainer"]
    pool, graph = tr.pool, out["graph"]
    steps, evals, n_sub = len(hist["loss"]), len(hist["val"]), len(pool)
    sweeps = cache.stats.sweep_launches
    want = 6 * steps + 3 * n_sub * evals + sweeps
    losses = np.asarray(hist["loss"])
    tuned = {sig: {"bd": e["bd"], "us": e["us"],
                   "candidates_us": e.get("candidates")}
             for sig, e in sorted(cache.entries.items())}
    shapes = [{"n_blocks": b.n_blocks, "s_pad": b.s_pad,
               "plan_pad": b.plan_pad} for b in pool.buckets]
    say(f"[minibatch train] {argv[1:]}: {steps} steps "
        f"({int((np.asarray(hist['mode']) == 'rsc').sum())} rsc), {evals} "
        f"pooled evaluations, setup {out['setup_s']:.2f} s, run {wall:.2f} "
        f"s; {n_sub} subgraphs of {[s.n_valid for s in pool.subgraphs]} "
        f"nodes in buckets {shapes}; launches {counts} ({sweeps} by the "
        f"autotune sweeps), bcoo_spmm by variant {by_var}; flops fraction "
        f"{res['flops_fraction']:.4f}, plan hit rate "
        f"{res['plan_hit_rate']:.3f}, best test {res['best_test']:.4f}, loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}; autotune {cache.stats}, "
        f"tuned {tuned}")
    if counts["bcoo_spmm"] != want or counts["flash_attention"]             or counts["gather_matmul"]:
        raise AssertionError(f"launches {counts}, expected {want} bcoo_spmm "
                             f"(6 per step, 3 per subgraph per evaluation, "
                             f"{sweeps} by the sweeps) and nothing else")
    if by_var["tf32x3"] != want:
        raise AssertionError(f"bcoo_spmm variants {by_var}: every launch "
                             f"should be tf32x3")
    if not res["flops_fraction"] <= 0.1 + 1e-9:
        raise AssertionError(f"flops fraction {res['flops_fraction']} above "
                             f"the budget 0.1")
    if not np.isfinite(losses).all() or \
            not losses[-n_sub:].mean() < losses[:n_sub].mean():
        raise AssertionError(f"loss not finite or not falling: {losses}")
    if cache.stats.defaults or cache.missed or not cache.stats.sweeps:
        raise AssertionError(f"autotune missed {sorted(cache.missed)} "
                             f"({cache.stats})")
    out_report = out["report"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(777)
    modes = [mb_mode(out, "prefetch", peak, gen, kernel_table)]
    rows = mb_launch_rows(tr.engine, ops, kmod, bcoo_spmm_ref, dev)
    del out, tr
    runs = {}
    for label, argv_m, extra in (
            ("no_prefetch", mb_argv(prefetch=False), {}),
            (f"resident{MB_RESIDENT}", mb_argv(), {"resident": MB_RESIDENT}),
            ("exact", mb_argv(rsc=False), {})):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        o = train.run_gnn(train.build_parser().parse_args(argv_m),
                          graph=graph, pool=pool, **extra)
        torch.cuda.synchronize()
        runs[label] = o["result"]["history"]
        modes.append(mb_mode(o, label, torch.cuda.max_memory_allocated(),
                             gen, kernel_table))
        del o
    for label in ("no_prefetch", f"resident{MB_RESIDENT}"):
        h = runs[label]
        if h["sub_id"] != hist["sub_id"] or h["loss"] != hist["loss"]:
            diff = float(np.max(np.abs(np.subtract(h["loss"],
                                                   hist["loss"]))))
            raise AssertionError(f"{label}: subgraph order or losses differ "
                                 f"from the prefetch run (largest loss "
                                 f"difference {diff:.3e})")
    exact_best = modes[-1]["best_test"]
    if not res["best_test"] > exact_best - 0.07:
        raise AssertionError(f"minibatch RSC best test {res['best_test']} "
                             f"not within 0.07 of the exact run's "
                             f"{exact_best}")
    say(f"[minibatch modes] losses identical step for step with prefetch "
        f"on, off and {MB_RESIDENT} resident ({steps} steps); best test "
        f"RSC {res['best_test']:.4f}, exact {exact_best:.4f}")
    return counts["bcoo_spmm"], {
        "argv": argv, "report": out_report,
        "run_s": wall, "steps": steps, "evaluations": evals,
        "launches": counts["bcoo_spmm"], "sweep_launches": sweeps,
        "launches_by_variant": by_var, "buckets": shapes,
        "subgraph_nodes": [s.n_valid for s in pool.subgraphs],
        "autotune": {"stats": dataclasses.asdict(cache.stats),
                     "tuned": tuned},
        "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
        "modes": modes, "launch_rows": rows}, graph, pool


# ------------------------------------------- observability and checkpoints

def _spans(events, kind_key: str) -> dict[str, list]:
    """Span records by name (``kind_key``: the JSONL's ``kind`` == span,
    or the Chrome trace's ``ph`` == X)."""
    out: dict[str, list] = {}
    for e in events:
        if e.get(kind_key) in ("span", "X"):
            out.setdefault(e["name"], []).append(e)
    return out


def _rsc_step_median(res) -> float:
    """Warm RSC step median (ms) of a training run, past its first 3."""
    modes = np.asarray(res["history"]["mode"])
    ms = np.asarray(res["history"]["step_time"]) * 1e3
    return float(np.median(ms[modes == "rsc"][3:]))


def obs_full_batch(train, ops, scale: float, graph, phase7: dict):
    """Phase 8e (a): phase 7's full-width GCN RSC run through ``launch.train
    gnn`` with ``--metrics --trace-out --trace-jsonl --probe-every
    OBS_PROBE_EVERY``, launch counts set to 0 just before and read just
    after: phase 7's launches (6 per step, 3 per evaluation, all
    ``tf32x3``); ``engine.step_ms`` counts summing to the steps; the
    ``step``/``plan``/``device_step``/``eval``/``probe`` spans in both
    trace files; every allocation within its budget and the last one's
    achieved fraction equal to ``flops_fraction``; finite probe gauges per
    op. Reports the probe's ms per op, the trace events written and the
    warm RSC step median beside phase 7's and beside those of the same
    run with observability off, in turns on, off, off, on (the off runs
    and the second on run after the counted one; one graph). Returns (its
    run, its report)."""
    from repro_torch import obs
    from repro_torch.models.gnn import MODELS
    chrome = ROOT / "chiprun_out" / "obs_gnn_trace.json"
    jsonl = ROOT / "chiprun_out" / "obs_gnn_trace.jsonl"
    jsonl.parent.mkdir(parents=True, exist_ok=True)
    argv = gnn_argv(scale, rsc=True) + [
        "--metrics", "--trace-out", str(chrome), "--trace-jsonl",
        str(jsonl), "--probe-every", str(OBS_PROBE_EVERY)]
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = train.run_gnn(train.build_parser().parse_args(argv), graph=graph)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    by_var = ops.launch_counts_by_variant()["bcoo_spmm"]
    ledger = obs.get_ledger().snapshot()
    obs.reset()
    res, rep = out["result"], out["report"]
    hist, snap = res["history"], rep["metrics"]
    steps, evals = len(hist["loss"]), len(hist["val"])
    module, layers = MODELS["gcn"], GNN_WIDTHS["gcn"][0]
    names = module.spmm_names(layers)
    want = gnn_launches(module, layers, steps, evals)
    if counts["bcoo_spmm"] != want or want != phase7["launches"] or \
            by_var["tf32x3"] != want:
        raise AssertionError(f"launches {counts} by variant {by_var}, "
                             f"expected phase 7's {phase7['launches']}, all "
                             f"tf32x3")
    step_counts = {k: h["count"] for k, h in snap["histograms"].items()
                   if k.startswith("engine.step_ms")}
    if sum(step_counts.values()) != steps:
        raise AssertionError(f"engine.step_ms counts {step_counts} do not "
                             f"sum to the {steps} steps")
    recs = [json.loads(x) for x in jsonl.read_text().splitlines()]
    cev = json.loads(chrome.read_text())["traceEvents"]
    need = {"step", "plan", "device_step", "eval", "probe"}
    by_name, c_names = _spans(recs, "kind"), set(_spans(cev, "ph"))
    if not need <= set(by_name) or not need <= c_names:
        raise AssertionError(f"spans missing: jsonl {sorted(by_name)}, "
                             f"chrome {sorted(c_names)}")
    allocs = [a for row in ledger["epochs"] for a in row["allocations"]]
    last = allocs[-1]
    achieved = last["cost"] / last["budget"] * 0.1
    if not all(a["ok"] for a in allocs) or last["cost"] > last["budget"] \
            or abs(achieved - res["flops_fraction"]) > 1e-9:
        raise AssertionError(f"ledger: allocations {allocs[-2:]}, achieved "
                             f"{achieved} against flops fraction "
                             f"{res['flops_fraction']}")
    gauges = {n: snap["gauges"].get(f"rsc.probe.rel_error{{layer={n}}}")
              for n in names}
    if not all(g is not None and np.isfinite(g) for g in gauges.values()):
        raise AssertionError(f"probe gauges {gauges}")
    rsc_ms = _rsc_step_median(res)
    turns = {"on": [rsc_ms], "off": []}
    for on in (False, False, True):
        extra = ["--metrics", "--trace-jsonl", str(jsonl.with_suffix(
            ".again.jsonl")), "--probe-every", str(OBS_PROBE_EVERY)]
        o = train.run_gnn(train.build_parser().parse_args(
            gnn_argv(scale, rsc=True) + (extra if on else [])), graph=graph)
        obs.reset()
        turns["on" if on else "off"].append(_rsc_step_median(o["result"]))
        del o
        torch.cuda.empty_cache()
    overhead = float(np.mean(turns["on"]) - np.mean(turns["off"]))
    probe_ms = [e["dur_us"] / 1e3 / len(names) for e in by_name["probe"]]
    # the counted run's RSC steps from its trace, past the first 3: the
    # step span, its device_step (launch to loss read) and plan spans, and
    # the rest of the step (the planner's record, the ledger, the spans')
    rsc = [i for i, e in enumerate(by_name["step"])
           if e["args"]["mode"] == "rsc"][3:]
    dev_rsc = [e for e in by_name["device_step"] if e["args"]["mode"] ==
               "rsc"]

    def med_ms(xs):
        return float(np.median(xs)) / 1e3

    inner = {"step": med_ms([by_name["step"][i]["dur_us"] for i in rsc]),
             "device_step": med_ms([e["dur_us"] for e in dev_rsc[3:]]),
             "plan": med_ms([e["dur_us"] for e in by_name["plan"][3:]]),
             "rest": med_ms([by_name["step"][i]["dur_us"]
                             - by_name["plan"][j]["dur_us"]
                             - dev_rsc[j]["dur_us"]
                             for j, i in enumerate(rsc, start=3)])}
    row = {"argv": argv, "run_s": wall, "steps": steps, "evaluations": evals,
           "launches": counts["bcoo_spmm"],
           "rsc_step_ms_median": rsc_ms,
           "phase7_rsc_step_ms_median": phase7["warm"]["rsc_step_ms_median"],
           "rsc_step_ms_median_turns": turns, "obs_overhead_ms": overhead,
           "rsc_step_spans_ms_median": inner,
           "probe_ms_per_op": probe_ms,
           "probe_ms_per_op_median": float(np.median(probe_ms)),
           "probes": len(probe_ms), "probe_rel_error": gauges,
           "trace_events_jsonl": len(recs), "trace_events_chrome": len(cev),
           "allocations": len(allocs), "achieved_fraction": achieved,
           "flops_fraction": res["flops_fraction"],
           "ledger": rep["ledger"], "step_ms_counts": step_counts}
    say(f"[obs gnn] {steps} steps, {evals} evaluations, launches "
        f"{counts['bcoo_spmm']} (phase 7 {phase7['launches']}), all tf32x3; "
        f"rsc step median {rsc_ms:.3f} ms with metrics, traces, ledger and "
        f"probes (phase 7: {row['phase7_rsc_step_ms_median']:.3f} ms; in "
        f"turns on {turns['on']}, off {turns['off']}: overhead "
        f"{overhead:+.3f} ms per step; its spans' medians {inner}); probe "
        f"{row['probe_ms_per_op_median']:.2f} ms per op (median of "
        f"{len(probe_ms)}, every {OBS_PROBE_EVERY} epochs, "
        f"{OBS_PROBE_ROWS} rows); trace events {len(recs)} (jsonl), "
        f"{len(cev)} (chrome); {len(allocs)} allocations within budget, "
        f"last achieved {achieved:.6f} = flops fraction; probe rel. error "
        f"{gauges}")
    return out, row


def obs_minibatch(train, ops, graph, pool, phase8d: dict):
    """Phase 8e (b): phase 8d's full-width minibatch run (its graph, pool
    and tuned cache) with ``--metrics --trace-jsonl``, launch counts set
    to 0 just before and read just after (6 per step and 3 per subgraph
    per pooled evaluation, as 8d, no sweep): ``prefetch.uploads`` equals
    the source's uploads, every training upload span shares its trace id
    with the step span that consumed it, and the plan pool's hits,
    refreshes and cold builds add up to the RSC steps."""
    from repro_torch import obs
    jsonl = ROOT / "chiprun_out" / "obs_minibatch_trace.jsonl"
    argv = mb_argv() + ["--metrics", "--trace-jsonl", str(jsonl)]
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = train.run_gnn(train.build_parser().parse_args(argv), graph=graph,
                        pool=pool)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    by_var = ops.launch_counts_by_variant()["bcoo_spmm"]
    obs.reset()
    res, snap = out["result"], out["report"]["metrics"]
    hist = res["history"]
    tr = out["trainer"]
    steps, evals, n_sub = len(hist["loss"]), len(hist["val"]), len(pool)
    want = 6 * steps + 3 * n_sub * evals
    if counts["bcoo_spmm"] != want or by_var["tf32x3"] != want:
        raise AssertionError(f"launches {counts} by variant {by_var}, "
                             f"expected {want} tf32x3")
    src = tr.engine.source
    uploads = snap["counters"].get("prefetch.uploads", 0.0)
    if uploads != src.transfer_stats()["uploads"]:
        raise AssertionError(f"prefetch.uploads {uploads}, the source "
                             f"counted {src.transfer_stats()}")
    recs = [json.loads(x) for x in jsonl.read_text().splitlines()]
    by_trace: dict = {}
    for e in recs:
        if e["kind"] == "span" and e.get("trace"):
            by_trace.setdefault(e["trace"], []).append(e)
    linked = [v for v in by_trace.values()
              if {"upload", "step"} <= {e["name"] for e in v}]
    train_uploads = src.transfer_stats("train")["uploads"]
    threads = {len({e["tid"] for e in v}) for v in linked}
    if len(linked) != train_uploads or train_uploads != steps or \
            threads != {2}:
        raise AssertionError(f"{len(linked)} traces link an upload to its "
                             f"step ({train_uploads} training uploads, "
                             f"{steps} steps, threads per trace {threads})")
    pp = {k: snap["counters"].get(f"plan_pool.{k}{{pool=pool}}", 0.0)
          for k in ("hits", "refreshes", "cold")}
    n_rsc = hist["mode"].count("rsc")
    if sum(pp.values()) != n_rsc:
        raise AssertionError(f"plan pool counters {pp}, {n_rsc} rsc steps")
    modes = np.asarray(hist["mode"])
    rsc_ms = (np.asarray(hist["step_time"]) * 1e3)[modes == "rsc"][n_sub:]
    up = snap["histograms"]["prefetch.upload_ms"]
    stall = snap["histograms"]["prefetch.stall_ms"]
    row = {"argv": argv, "run_s": wall, "steps": steps,
           "launches": counts["bcoo_spmm"],
           "rsc_step_ms_median": float(np.median(rsc_ms)),
           "phase8d_rsc_step_ms_median":
           phase8d["modes"][0]["rsc_step_ms_median"],
           "uploads": uploads, "linked_traces": len(linked),
           "plan_pool": pp, "upload_ms": up, "stall_ms": stall,
           "refresh_ms": snap["histograms"].get(
               "plan_pool.refresh_ms{pool=pool}"),
           "trace_events_jsonl": len(recs)}
    say(f"[obs minibatch] {steps} steps, launches {counts['bcoo_spmm']}; "
        f"prefetch.uploads {uploads:.0f} = the source's; {len(linked)} "
        f"upload spans share their trace with the step that used them "
        f"(two threads each); plan pool {pp} = {n_rsc} rsc steps; rsc step "
        f"median {row['rsc_step_ms_median']:.3f} ms (8d: "
        f"{row['phase8d_rsc_step_ms_median']:.3f} ms); upload_ms p50 "
        f"{up['p50']:.2f} p99 {up['p99']:.2f}, stall_ms p50 "
        f"{stall['p50']:.2f}; {len(recs)} trace events")
    return row


def obs_resume(dev) -> dict:
    """Phase 8e (c): ``MB_SMALL`` with dropout 0.5 and a checkpoint every
    9 steps on the card, uninterrupted and restored at step 9 (mid-epoch):
    losses and final parameters compared step for step; then the same
    directory restored into a full-batch Engine of the same model."""
    import shutil
    from repro_torch.graphs.synthetic import sbm_graph
    from repro_torch.pipeline import MinibatchConfig, MinibatchTrainer
    from repro_torch.train.loop import GNNTrainer, TrainConfig
    d = ROOT / "chiprun_out" / "obs_resume_ckpt"
    shutil.rmtree(d, ignore_errors=True)
    g = sbm_graph(**GNN_GRAPH)
    cfg = MinibatchConfig(**dict(MB_SMALL, dropout=0.5, epochs=6),
                          ckpt_dir=str(d),
                          ckpt_every=9, device=str(dev))
    a = MinibatchTrainer(cfg, g)
    ra = a.train(eval_every=2)
    b = MinibatchTrainer(cfg, g)
    step = b.engine.restore(step=9)
    rb = b.train(eval_every=2)
    la, lb = ra["history"]["loss"][9:], rb["history"]["loss"]
    params_equal = all(torch.equal(x, y) for x, y in zip(
        a.params.parameters(), b.params.parameters()))
    exact = la == lb and params_equal
    loss_err = float(np.max(np.abs(np.subtract(la, lb)) / np.abs(la)))
    fields = {f.name for f in dataclasses.fields(TrainConfig)}
    full = GNNTrainer(TrainConfig(**{k: v for k, v in cfg.__dict__.items()
                                     if k in fields and k != "ckpt_every"}),
                      g)
    full_step = full.engine.restore()
    layout_ok = all(torch.equal(x, y) for x, y in zip(
        a.params.parameters(), full.params.parameters()))
    say(f"[obs resume] minibatch gcn {MB_SMALL['n_layers']}x"
        f"{MB_SMALL['hidden']}, dropout 0.5, RSC, checkpoint every 9: "
        f"restored at step {step} of {len(ra['history']['loss'])}, "
        f"{len(lb)} steps on; losses and final parameters bit-identical: "
        f"{exact} (largest loss difference {loss_err:.3e}); the final "
        f"checkpoint (step {full_step}) restored into a full-batch Engine: "
        f"parameters equal {layout_ok}")
    if step != 9 or rb["history"]["sub_id"] != ra["history"]["sub_id"][9:]:
        raise AssertionError("the resumed run did not continue at step 9 "
                             "in the same subgraph order")
    np.testing.assert_allclose(lb, la, rtol=GNN_LOSS_RTOL)
    if not exact:
        raise AssertionError("the resumed run is not bit-identical")
    if not layout_ok or full_step != len(ra["history"]["loss"]):
        raise AssertionError("the full-batch engine did not restore the "
                             "minibatch run's parameters")
    return {"steps": len(ra["history"]["loss"]), "restored_at": step,
            "bit_identical": exact, "max_loss_rel_diff": loss_err,
            "full_batch_restore_step": full_step}


def obs_save_and_serve(serve_gnn, ops, scale: float, out) -> dict:
    """Phase 8e (c, d): save (a)'s full-width GCN (host snapshot, then the
    written file), then serve it through ``serve_gnn --ckpt-dir --metrics
    --slo``, launch counts set to 0 just before and read just after:
    layers × partitions ``tf32x3`` launches, the restored parameters equal
    the saved ones, one ``serve.query_ms`` observation per query batch,
    an SLO report."""
    import shutil
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.convert import gnn_state_tree
    d = ROOT / "chiprun_out" / "obs_gnn_ckpt"
    shutil.rmtree(d, ignore_errors=True)
    eng = out["trainer"].engine
    ck = Checkpointer(d)
    saves = []
    for step in (199, 200):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ck.save(step, gnn_state_tree(eng.model, eng.opt_state))
        t1 = time.perf_counter()
        ck.wait()
        saves.append(((t1 - t0) * 1e3, (time.perf_counter() - t0) * 1e3))
    size = (d / "step_200.npz").stat().st_size
    layers, hidden = GNN_WIDTHS["gcn"]
    argv = ["--dataset", "reddit", "--scale", str(scale), "--model", "gcn",
            "--layers", str(layers), "--hidden", str(hidden), "--block",
            "128", "--memory-budget-mb", "2048", "--replicas", "0",
            "--queries", "256", "--query-batch", "64", "--device",
            eng.source.device.type, "--ckpt-dir", str(d), "--metrics", "--slo",
            f"p99_ms={OBS_SLO_P99_MS}"]
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    report, server = serve_gnn.run(serve_gnn.build_parser().parse_args(argv))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    by_var = ops.launch_counts_by_variant()["bcoo_spmm"]
    want = layers * server.si.n_partitions
    same = all(torch.equal(x, y) for x, y in zip(
        eng.model.parameters(), server.si.params.parameters()))
    h = report["metrics"]["histograms"]["serve.query_ms{replica=r0}"]
    slo = report.get("slo", {})
    say(f"[obs save] full-width gcn checkpoint ({size / 1e6:.2f} MB): "
        f"host snapshot {saves[-1][0]:.2f} ms, written "
        f"{saves[-1][1]:.2f} ms (first save {saves[0][0]:.2f} / "
        f"{saves[0][1]:.2f} ms)")
    say(f"[obs serve] restored and served in {wall:.2f} s: launches "
        f"{counts['bcoo_spmm']} ({want} expected, by variant {by_var}); "
        f"parameters equal the saved ones: {same}; serve.query_ms count "
        f"{h['count']} for {report['query_batches']} batches, p50 "
        f"{h['p50']:.3f} ms p99 {h['p99']:.3f} ms; slo {slo.get('objectives')}")
    if counts["bcoo_spmm"] != want or by_var["tf32x3"] != want:
        raise AssertionError(f"serving launches {counts} {by_var}, "
                             f"expected {want} tf32x3")
    if not same:
        raise AssertionError("served parameters differ from the saved ones")
    if h["count"] != report["query_batches"] or \
            "p99_ms" not in slo.get("objectives", {}):
        raise AssertionError(f"query histogram {h} / slo report {slo}")
    del server
    torch.cuda.empty_cache()
    return {"checkpoint_bytes": size,
            "save_host_snapshot_ms": [s[0] for s in saves],
            "save_written_ms": [s[1] for s in saves],
            "serve_run_s": wall, "serve_launches": counts["bcoo_spmm"],
            "query_ms": h, "slo": slo}


# ------------------------------------------------------------ LM phases

def flash_close(out, ref, dtype) -> tuple[float, float]:
    """Flash kernel against its plain version, in f32, by the row-scaled
    rule above; returns the max absolute error and the max row-relative
    L2 error."""
    out, ref = out.float(), ref.float()
    err = (out - ref).abs()
    rms = ref.square().mean(-1, keepdim=True).sqrt()
    atol = (FLASH_ROW[dtype] * rms).clamp(max=FLASH_ATOL[dtype])
    bad = err > atol + FLASH_RTOL * ref.abs()
    rel = (err.norm(dim=-1) / ref.norm(dim=-1).clamp(min=1e-30)).max()
    if bad.any() or rel > FLASH_ROW_L2[dtype]:
        raise AssertionError(
            f"flash kernel != plain version: {int(bad.sum())} of "
            f"{bad.numel()} elements out of tolerance, max abs err "
            f"{float(err.max()):.3e}, max row-relative L2 err "
            f"{float(rel):.3e} (limit {FLASH_ROW_L2[dtype]:.0e})")
    return float(err.max()), float(rel)


def randn(gen, shape, dtype, dev):
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


def flash_sweep(ops, fmod, flash_attention_ref, dev) -> dict:
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    worst = {torch.float32: [0.0, 0.0], torch.bfloat16: [0.0, 0.0]}
    n, n_var = 0, {}
    for b in (1, 2):
        for nq, nkv in FLASH_HEADS:
            for hd in (64, 128):
                for dtype in (torch.float32, torch.bfloat16):
                    for tq, tk in FLASH_LENGTHS:
                        q = randn(gen, (b, tq, nq, hd), dtype, dev)
                        k = randn(gen, (b, tk, nkv, hd), dtype, dev)
                        v = randn(gen, (b, tk, nkv, hd), dtype, dev)
                        for window in (None, 16, 100):
                            for causal in (True, False):
                                kw = dict(q_offset=tk - tq, causal=causal,
                                          window=window)
                                var = fmod.variant(dtype, hd)
                                before = fmod.launches_by_variant[var]
                                out = ops.flash_attention(q, k, v, **kw)
                                torch.cuda.synchronize()
                                if fmod.launches_by_variant[var] != \
                                        before + 1:
                                    raise AssertionError(
                                        f"{var} launch not counted")
                                if out.dtype != dtype or \
                                        out.shape != q.shape:
                                    raise AssertionError(
                                        f"got {out.dtype} {out.shape}")
                                errs = flash_close(
                                    out, flash_attention_ref(q, k, v, **kw),
                                    dtype)
                                worst[dtype] = [max(a, e) for a, e in
                                                zip(worst[dtype], errs)]
                                n += 1
                                n_var[var] = n_var.get(var, 0) + 1
    f32, bf16 = worst[torch.float32], worst[torch.bfloat16]
    say(f"[flash sweep] {n} cases agree ({n_var}); max abs err f32 "
        f"{f32[0]:.3e}, bf16 {bf16[0]:.3e}; max row-relative L2 err f32 "
        f"{f32[1]:.3e}, bf16 {bf16[1]:.3e}")
    return {"cases": n, "cases_by_variant": n_var,
            "max_abs_err_f32": f32[0], "max_abs_err_bf16": bf16[0],
            "max_row_rel_err_f32": f32[1], "max_row_rel_err_bf16": bf16[1]}


def lm_small_reference(serve, smoke_config, make_batch, init_params,
                       dev) -> float:
    """Prefill + 8 greedy decode steps of the f32 smoke qwen3-1.7b (2
    layers, d_model 64, hd 16) on the card against the same run on the CPU
    (plain versions), one parameter set on both. Logits within
    1e-4·max|logit| (the two sum the same f32 products in other orders)
    and identical tokens."""
    cfg = dataclasses.replace(smoke_config("qwen3-1.7b"), dtype="float32")
    net = init_params(cfg, seed=0, device="cpu")
    runs = []
    for d, params in (("cpu", net), (dev, copy.deepcopy(net).to(dev))):
        prompt = make_batch(cfg, "prefill_32k", 4, 64, seed=0, device=d)
        toks, _, rec = serve.greedy_generate(cfg, params, prompt, 74, 9)
        runs.append((toks, rec))
    (ctoks, crec), (gtoks, grec) = runs
    if grec["launches"]["prefill"]["flash_attention"] != cfg.n_layers:
        raise AssertionError(f"smoke prefill launched {grec['launches']}")
    if not torch.equal(ctoks, gtoks):
        raise AssertionError(f"tokens differ:\n{ctoks}\n{gtoks}")
    err, scale = 0.0, 0.0
    for phase in ("prefill", "last"):
        ref = crec["logits"][phase]
        got = grec["logits"][phase].cpu()
        scale = max(scale, float(ref.abs().max()))
        torch.testing.assert_close(got, ref, rtol=0,
                                   atol=1e-4 * float(ref.abs().max()))
        err = max(err, float((got - ref).abs().max()))
    say(f"[lm reference] smoke qwen3-1.7b f32, 8 decode steps: card = CPU, "
        f"tokens identical, max abs logit err {err:.3e} (max |logit| "
        f"{scale:.3e})")
    return err


def lm_main_path(serve, ops):
    args = serve.build_parser().parse_args(LM_ARGV)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = serve.run(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    by_var = ops.launch_counts_by_variant()["flash_attention"]
    cfg, rec = out["cfg"], out
    say(f"[lm serve] {cfg.name}: {json.dumps(out['report'])}, run "
        f"{wall:.2f} s, launches {counts}, by phase {rec['launches']}, by "
        f"variant {by_var}")
    if rec["launches"]["prefill"]["flash_attention"] != cfg.n_layers or \
            rec["launches"]["decode"]["flash_attention"] != 0 or \
            counts["flash_attention"] != cfg.n_layers:
        raise AssertionError(f"flash_attention launches {rec['launches']}, "
                             f"expected {cfg.n_layers} per prefill and 0 in "
                             f"decode")
    if by_var["wgmma"] != cfg.n_layers:
        raise AssertionError(f"flash_attention variants {by_var}: every "
                             f"prefill launch should be wgmma")
    for phase, lg in rec["logits"].items():
        if not torch.isfinite(lg).all():
            raise AssertionError(f"{phase} logits not finite")
    if tuple(out["tokens"].shape) != (args.batch, args.gen):
        raise AssertionError(f"tokens {tuple(out['tokens'].shape)}")
    return out, counts["flash_attention"], wall


def first_layer_qkv(out, apply_norm, project_qkv):
    """Layer 0's q, k, v of the served prompt, recomputed from the same
    parameters and tokens."""
    cfg, net = out["cfg"], out["params"]
    tokens = out["prompt"]["tokens"]
    with torch.inference_mode():
        h = net.embed[tokens.long()]
        hn = apply_norm(net.layers[0].ln1, h, cfg.norm_eps)
        pos = torch.arange(tokens.shape[1], dtype=torch.int32,
                           device=tokens.device)
        return project_qkv(net.layers[0].attn, cfg, hn, pos)


def flash_row(q, k, v, fmod, flash_attention_ref, q_chunk, reps) -> dict:
    """Kernel vs plain version, then the times of kernel, plain version
    and SDPA (causal, GQA) on these inputs, and the card's bound."""
    F = torch.nn.functional
    with torch.inference_mode():
        got = fmod.flash_attention(q, k, v, causal=True)
        ref = flash_attention_ref(q, k, v, causal=True, q_chunk=q_chunk)
        err, rel = flash_close(got, ref, q.dtype)
        buf = torch.empty_like(q)
        ms = cuda_ms(lambda: fmod.launch(q, k, v, buf, q_offset=0,
                                         causal=True, window=None), reps)
        plain_ms = cuda_ms(lambda: flash_attention_ref(
            q, k, v, causal=True, q_chunk=q_chunk), reps=2, warmup=1)
        del got
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        lib = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                             enable_gqa=True)
        lib_err = float((lib.transpose(1, 2).float() - ref.float())
                        .abs().max())
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), reps)
    b, t, nq, hd = q.shape
    nkv = k.shape[2]
    pairs = t * (t + 1) // 2                  # unmasked (q, k) pairs
    flops = 4 * b * nq * hd * pairs
    es = q.element_size()
    nbytes = (2 * b * t * nq * hd + 2 * b * t * nkv * hd) * es
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[q.dtype] * 1e3
    row = dict(b=b, t=t, nq=nq, nkv=nkv, hd=hd, dtype=str(q.dtype),
               variant=fmod.variant(q.dtype, hd),
               max_abs_err=err, max_row_rel_err=rel,
               sdpa_max_abs_err=lib_err, ms=ms,
               plain_ms=plain_ms, library_ms=library_ms, flops=flops,
               bytes=nbytes, bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               tflops=flops / ms / 1e9)
    say(f"[flash {b}x{t} nq {nq} nkv {nkv} hd {hd}] err={err:.3e} row-rel={rel:.3e} kernel {ms:.4f} "
        f"ms, plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound "
        f"{row['bound_ms']:.4f} ms ({row['bound_by']}), "
        f"{row['tflops']:.2f} TFLOP/s")
    return row


def lm_timings(out, serve, fmod, flash_attention_ref, apply_norm,
               project_qkv) -> tuple[list[dict], dict]:
    q, k, v = first_layer_qkv(out, apply_norm, project_qkv)
    rows = [flash_row(q, k, v, fmod, flash_attention_ref, None, reps=20)]
    del q, k, v
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    for b, t, nq, nkv, hd, q_chunk, reps in FLASH_ROWS:
        q = randn(gen, (b, t, nq, hd), torch.bfloat16, "cuda")
        k = randn(gen, (b, t, nkv, hd), torch.bfloat16, "cuda")
        v = randn(gen, (b, t, nkv, hd), torch.bfloat16, "cuda")
        rows.append(flash_row(q, k, v, fmod, flash_attention_ref, q_chunk,
                              reps=reps))
        del q, k, v
        torch.cuda.empty_cache()
    # a warm prefill + decode with the main path's parameters and prompt
    args = serve.build_parser().parse_args(LM_ARGV)
    _, stats, _ = serve.greedy_generate(
        out["cfg"], out["params"], out["prompt"],
        args.prompt_len + args.gen + 1, args.gen)
    warm = {"prefill_s": stats["prefill_s"], "decode_s": stats["decode_s"],
            "tok_per_s": stats["tok_per_s"],
            "attention_share_of_prefill":
                out["cfg"].n_layers * rows[0]["ms"] / 1e3
                / stats["prefill_s"]}
    say(f"[lm warm] prefill {stats['prefill_s']:.4f} s, decode "
        f"{stats['decode_s']:.4f} s ({stats['tok_per_s']:.1f} tok/s), "
        f"attention kernel share of prefill "
        f"{warm['attention_share_of_prefill']:.3f}")
    return rows, warm


# ------------------------------------------------------- LM training phases

def gather_close(out, ref, dtype) -> tuple[float, float]:
    """``gather_matmul`` against its plain version, in f32, by the
    data-scaled rule above; returns the max absolute error and the
    norm-relative error."""
    out, ref = out.float(), ref.float()
    rtol, row, norm = GATHER_TOL[dtype]
    err = (out - ref).abs()
    rms = ref.square().mean(-1, keepdim=True).sqrt()
    bad = err > rtol * ref.abs() + row * rms
    rel = float((out - ref).norm() / ref.norm().clamp(min=1e-30))
    if bad.any() or rel > norm:
        raise AssertionError(
            f"gather_matmul != plain version: {int(bad.sum())} of "
            f"{bad.numel()} elements out of tolerance, max abs err "
            f"{float(err.max()):.3e}, norm-relative err {rel:.3e} (limit "
            f"{norm:.0e})")
    return float(err.max()), rel


def gather_sweep(ops, gmod, gather_matmul_ref, dev) -> dict:
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    rng = np.random.default_rng(2)
    worst = {torch.float32: [0.0, 0.0], torch.bfloat16: [0.0, 0.0]}
    n, n_var = 0, {}
    for n_blocks in (1, 3, 64):
        for bk in (32, 64, 128):
            for m, q in GATHER_WIDTHS:
                for dtype in (torch.float32, torch.bfloat16):
                    x = randn(gen, (n_blocks * bk, m), dtype, dev)
                    g = randn(gen, (n_blocks * bk, q), dtype, dev)
                    for k_sel in sorted({1, max(1, n_blocks // 2),
                                         n_blocks}):
                        idx = torch.from_numpy(np.sort(rng.choice(
                            n_blocks, k_sel, replace=False)).astype(
                                np.int32)).to(dev)
                        var = gmod.variant(dtype, m, q)
                        before = gmod.launches_by_variant[var]
                        out = ops.gather_matmul(x, g, idx, bk=bk)
                        torch.cuda.synchronize()
                        if gmod.launches_by_variant[var] != before + 1:
                            raise AssertionError(f"{var} launch not counted")
                        if out.dtype != dtype or out.shape != (m, q):
                            raise AssertionError(
                                f"got {out.dtype} {tuple(out.shape)}")
                        errs = gather_close(
                            out, gather_matmul_ref(x, g, idx, bk=bk), dtype)
                        worst[dtype] = [max(a, e) for a, e in
                                        zip(worst[dtype], errs)]
                        n += 1
                        n_var[var] = n_var.get(var, 0) + 1
                    del x, g
    f32, bf16 = worst[torch.float32], worst[torch.bfloat16]
    say(f"[gather sweep] {n} cases agree ({n_var}); max abs err f32 "
        f"{f32[0]:.3e}, bf16 {bf16[0]:.3e}; max norm-relative err f32 "
        f"{f32[1]:.3e}, bf16 {bf16[1]:.3e}")
    return {"cases": n, "cases_by_variant": n_var,
            "max_abs_err_f32": f32[0], "max_abs_err_bf16": bf16[0],
            "max_norm_rel_err_f32": f32[1], "max_norm_rel_err_bf16": bf16[1]}


class GatherTap:
    """Stands in for ``gather_matmul_in_range`` (what ``rsc_matmul``'s
    backward calls) while a training run is driven. Every call passes
    through unchanged (the kernel wrapper still counts its own launches);
    the tap keeps each call's selected block ids and the first
    (x, g, idx, bk) of each operand shape."""

    def __init__(self, gmod):
        self.gmod, self.idx, self.first = gmod, [], {}

    def __enter__(self):
        self.inner = self.gmod.gather_matmul_in_range
        self.gmod.gather_matmul_in_range = self
        return self

    def __exit__(self, *exc):
        self.gmod.gather_matmul_in_range = self.inner

    def __call__(self, x, g, idx, *, bk, **kw):
        self.idx.append(idx)
        self.first.setdefault((tuple(x.shape), tuple(g.shape)),
                              (x.detach(), g.detach(), idx, bk))
        return self.inner(x, g, idx, bk=bk, **kw)


def lm_train_small_reference(ops, gmod, smoke_config, make_batch,
                             init_params, make_train_step, Adam, dev) -> dict:
    """3 steps of the f32 smoke qwen3-1.7b (2 layers, d_model 64) with RSC
    (bk 32, keep 0.5, 2 microbatches of 2 × 64 tokens: 4 blocks, 2 kept)
    on the card against the same steps on the CPU, from one parameter
    set: equal selected blocks, losses within 1e-5 relative, each
    parameter's change within TRAIN_DP_REL of the CPU run's change."""
    cfg = dataclasses.replace(smoke_config("qwen3-1.7b"), dtype="float32")
    rsc = {"keep_frac": 0.5, "bk": 32, "backend": "kernel"}
    lr, steps = 1e-3, 3
    cpu_net = init_params(cfg, seed=0, device="cpu")
    start = {k: p.detach().clone() for k, p in cpu_net.named_parameters()}
    card_net = copy.deepcopy(cpu_net).to(dev)
    runs = []
    for d, net in (("cpu", cpu_net), (dev, card_net)):
        opt = Adam(lr=lr, clip_norm=1.0)
        state = opt.init(dict(net.named_parameters()))
        step = make_train_step(cfg, opt, 2, rsc=rsc)
        losses = []
        ops.reset_launch_counts()
        with GatherTap(gmod) as tap:
            for i in range(steps):
                batch = make_batch(cfg, "train_4k", 4, 64, seed=i, device=d)
                net, state, loss = step(net, state, batch)
                losses.append(float(loss))
        runs.append((losses, [t.cpu().tolist() for t in tap.idx],
                     ops.launch_counts()["gather_matmul"]))
    (closs, cidx, claunch), (gloss, gidx, glaunch) = runs
    want = 3 * cfg.n_layers * 2 * steps
    # each parameter's change on the card against its change on the CPU
    rel = {}
    for (name, a), (_, b) in zip(cpu_net.named_parameters(),
                                 card_net.named_parameters()):
        moved = a.detach() - start[name]
        rel[name] = float((b.detach().cpu() - a.detach()).norm()
                          / moved.norm().clamp(min=1e-30))
    worst = max(rel, key=rel.get)
    say(f"[train reference] smoke qwen3-1.7b f32 RSC, {steps} steps: "
        f"launches CPU {claunch}, card {glaunch} of {want}; losses {gloss} "
        f"(CPU {closs}); largest parameter-change error {rel[worst]:.3e} "
        f"({worst}, limit {TRAIN_DP_REL:.0e})")
    if claunch != 0 or glaunch != want or len(gidx) != want:
        raise AssertionError(f"gather_matmul launches: CPU {claunch}, card "
                             f"{glaunch} of {want} calls")
    if cidx != gidx:
        raise AssertionError(f"selected blocks differ:\n{cidx}\n{gidx}")
    np.testing.assert_allclose(gloss, closs, rtol=1e-5)
    if rel[worst] > TRAIN_DP_REL:
        raise AssertionError(f"{worst}'s change differs from the CPU's by "
                             f"{rel[worst]:.3e} of its norm")
    say("[train reference] card = CPU: selected blocks identical")
    return {"losses_card": gloss, "losses_cpu": closs, "launches": glaunch,
            "max_param_change_err": rel[worst]}


def lm_train_main_path(train, ops, gmod, gather_matmul_ref, argv):
    """The full-width training run, with the launch counts set to 0 just
    before and read just after; the kernel against its plain version on
    the first (x, g, idx) of each shape the run gave it."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with GatherTap(gmod) as tap:
        out = train.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    by_var = ops.launch_counts_by_variant()["gather_matmul"]
    peak = torch.cuda.max_memory_allocated()
    args = train.build_parser().parse_args(argv)
    cfg = out["cfg"]
    want = 3 * cfg.n_layers * args.microbatches * args.steps
    say(f"[lm train] {cfg.name}: losses {out['losses']}, step s "
        f"{[round(s, 4) for s in out['step_s']]}, run {wall:.2f} s, peak "
        f"{peak / 2 ** 30:.2f} GiB, launches {counts}, gather_matmul by "
        f"variant {by_var}")
    if counts["gather_matmul"] != want or counts["flash_attention"] != 0 \
            or counts["bcoo_spmm"] != 0:
        raise AssertionError(f"launches {counts}, expected {want} "
                             f"gather_matmul (3 per layer per microbatch "
                             f"per step) and nothing else")
    if by_var["wgmma"] != want:
        raise AssertionError(f"gather_matmul variants {by_var}: every "
                             f"training launch should be wgmma")
    if not all(np.isfinite(out["losses"])):
        raise AssertionError(f"losses not finite: {out['losses']}")
    checks = {}
    for (xs, gs), (x, g, idx, bk) in tap.first.items():
        got = gmod.gather_matmul(x, g, idx, bk=bk)
        checks[f"{xs[1]}x{gs[1]}"] = gather_close(
            got, gather_matmul_ref(x, g, idx, bk=bk), x.dtype)
    say(f"[lm train] kernel = plain version on the path's own operands: "
        f"{checks}")
    return out, args, tap, counts["gather_matmul"], wall, peak, checks


def gather_row(x, g, idx, bk, gmod, gather_matmul_ref) -> dict:
    """Times of the kernel, its plain version and a gather +
    ``torch.matmul`` on these operands, and the card's bound."""
    (n, m), q = x.shape, g.shape[1]
    k_sel = idx.numel()
    ref = gather_matmul_ref(x, g, idx, bk=bk)
    buf = torch.empty((m, q), dtype=x.dtype, device=x.device)

    def library():
        sel = idx.long()
        return torch.matmul(x.view(-1, bk, m)[sel].reshape(-1, m).t(),
                            g.view(-1, bk, q)[sel].reshape(-1, q))

    lib_err = float((library().float() - ref.float()).abs().max())
    ms = cuda_ms(lambda: gmod.launch(x, g, idx, buf, bk=bk), reps=20)
    plain_ms = cuda_ms(lambda: gather_matmul_ref(x, g, idx, bk=bk), reps=5)
    library_ms = cuda_ms(library, reps=20)
    es = x.element_size()
    flops = 2 * k_sel * bk * m * q
    nbytes = (k_sel * bk * (m + q) + m * q) * es + k_sel * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[x.dtype] * 1e3
    row = dict(m=m, q=q, n=n, bk=bk, k_sel=k_sel, dtype=str(x.dtype),
               variant=gmod.variant(x.dtype, m, q), ms=ms,
               plain_ms=plain_ms, library_ms=library_ms,
               library_max_abs_err=lib_err, flops=flops, bytes=nbytes,
               bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               tflops=flops / ms / 1e9)
    say(f"[gather {m}x{q}] kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"gather+matmul {library_ms:.4f} ms, bound {row['bound_ms']:.4f} ms "
        f"({row['bound_by']}), {row['tflops']:.2f} TFLOP/s")
    return row


def lm_train_timings(out, args, tap, gmod, gather_matmul_ref,
                     peak) -> tuple[list[dict], dict]:
    """The kernel rows at the gate/up and the down shapes, then the warm
    step (the mean of the steps after the first), tokens/s, peak memory
    and the kernel's share of a warm step."""
    cfg = out["cfg"]
    rows = sorted((gather_row(x, g, idx, bk, gmod, gather_matmul_ref)
                   for (x, g, idx, bk) in tap.first.values()),
                  key=lambda r: r["m"] != cfg.d_model)   # gate/up first
    gate_up, down = rows
    warm_s = float(np.mean(out["step_s"][1:]))
    kernel_s = cfg.n_layers * args.microbatches * (
        2 * gate_up["ms"] + down["ms"]) / 1e3
    warm = {"first_step_s": out["step_s"][0], "warm_step_s": warm_s,
            "tokens_per_s": args.batch * args.seq / warm_s,
            "peak_mem_gib": peak / 2 ** 30, "losses": out["losses"],
            "gather_matmul_s_per_step": kernel_s,
            "gather_matmul_share_of_step": kernel_s / warm_s}
    say(f"[lm train warm] step {warm_s:.4f} s (first "
        f"{out['step_s'][0]:.4f} s), {warm['tokens_per_s']:.1f} tokens/s, "
        f"peak {warm['peak_mem_gib']:.2f} GiB, gather_matmul "
        f"{kernel_s * 1e3:.2f} ms per step "
        f"({warm['gather_matmul_share_of_step']:.4f} of it)")
    return rows, warm


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=float, default=0.1,
                    help="synthetic Reddit scale of the serving run")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    smi = nvidia_smi()
    say(f"[card] {smi}")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.plan import plan_row_ptr
    from repro_torch.graphs.synthetic import sbm_graph
    from repro_torch.infer import StreamConfig, StreamingInference
    from repro_torch.kernels import bcoo_spmm as kmod
    from repro_torch.kernels import autotune, build, ops
    from repro_torch.kernels.ref import bcoo_spmm_ref
    from repro_torch.launch import serve_gnn
    from repro_torch.models.gnn import MODELS, gcn
    from repro_torch.configs import make_batch, smoke_config
    from repro_torch.configs.shapes import microbatches
    from repro_torch.kernels import flash_attention as fmod
    from repro_torch.kernels.ref import flash_attention_ref
    from repro_torch.launch import serve
    from repro_torch.models.lm.attention import _project_qkv
    from repro_torch.models.lm.backbone import init_params
    from repro_torch.models.lm.layers import apply_norm
    from repro_torch.kernels import gather_matmul as gmod
    from repro_torch.kernels.ref import gather_matmul_ref
    from repro_torch.launch import train
    from repro_torch.launch.profile_serve import kernel_table
    from repro_torch.train.loop import GNNTrainer, TrainConfig
    from repro_torch.train.lm_steps import make_train_step
    from repro_torch.train.optimizer import Adam

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # a fresh autotune cache: every phase before 8d dispatches its
    # heuristic bd, as before the autotuner existed
    AUTOTUNE_CACHE.parent.mkdir(parents=True, exist_ok=True)
    if AUTOTUNE_CACHE.exists():
        AUTOTUNE_CACHE.unlink()
    autotune.reset(AUTOTUNE_CACHE)
    build_rep = build_kernels(build)
    sweep_res = sweep(ops, kmod, bcoo_spmm_ref, plan_row_ptr, dev)
    ref_err = small_reference(sbm_graph, StreamingInference, StreamConfig,
                              gcn)
    report, server, launches, spmm_by_var, run_s = main_path(
        serve_gnn, ops, args.scale)
    rows = layer_checks(server, ops, kmod, bcoo_spmm_ref, gcn)
    stages = forward_stages(server, gcn)
    del server
    torch.cuda.empty_cache()
    serving = {}
    for model in ("graphsage", "gcnii"):
        rep, srv, n_launch, by_var, wall = main_path(serve_gnn, ops,
                                                     args.scale, model)
        serving[model] = {"report": rep, "launches": n_launch,
                          "launches_by_variant": by_var, "run_s": wall,
                          "n_partitions": srv.si.n_partitions,
                          "spmm_dims": MODELS[model].infer_spmm_dims(
                              srv.si.params, srv.si.features.shape[1])}
        del srv
        torch.cuda.empty_cache()
    gnn_ref = gnn_train_small_reference(GNNTrainer, TrainConfig, sbm_graph,
                                        gcn, GNN_SMALL, ops, dev)
    gnn_out, gnn_slice = gnn_train_main_path(train, ops, args.scale)
    gnn_slice["small_reference"] = gnn_ref
    gnn_slice.update(gnn_train_timings(gnn_out, ops, kmod, bcoo_spmm_ref,
                                       kernel_table, dev))
    gnn_graph = gnn_out["graph"]
    del gnn_out
    gnn_slice["exact_run"] = gnn_train_exact_run(train, ops, args.scale)
    rsc_best = gnn_slice["report"]["best_test"]
    if not rsc_best > gnn_slice["exact_run"]["best_test"] - 0.07:
        raise AssertionError(f"RSC best test {rsc_best} not within 0.07 of "
                             f"the exact run's")
    torch.cuda.empty_cache()
    models_slice = {"serving": serving, "dense_backend":
                    gnn_train_small_reference(GNNTrainer, TrainConfig,
                                              sbm_graph, gcn, GNN_SMALL, ops,
                                              dev, second="dense")}
    for model in ("graphsage", "gcnii"):
        small = gnn_train_small_reference(
            GNNTrainer, TrainConfig, sbm_graph, MODELS[model],
            dict(GNN_SMALL_DEEP, model=model), ops, dev)
        m_out, m_slice = gnn_train_main_path(train, ops, args.scale, model)
        m_slice["small_reference"] = small
        m_slice.update(gnn_train_timings(m_out, ops, kmod, bcoo_spmm_ref,
                                         kernel_table, dev))
        del m_out
        torch.cuda.empty_cache()
        m_slice["exact_run"] = gnn_train_exact_run(train, ops, args.scale,
                                                   model)
        models_slice[model] = m_slice
        torch.cuda.empty_cache()
    mb_small = mb_small_reference(ops, dev)
    mb_launches, mb_slice, mb_graph, mb_pool = mb_main_path(
        train, ops, kmod, bcoo_spmm_ref, autotune, kernel_table, dev)
    mb_slice["small_reference"] = mb_small
    torch.cuda.empty_cache()
    obs_out, obs_gnn = obs_full_batch(train, ops, args.scale, gnn_graph,
                                      gnn_slice)
    obs_slice = {"full_batch": obs_gnn,
                 "save_serve": obs_save_and_serve(serve_gnn, ops, args.scale,
                                                  obs_out)}
    del obs_out, gnn_graph
    obs_slice["minibatch"] = obs_minibatch(train, ops, mb_graph, mb_pool,
                                           mb_slice)
    del mb_graph, mb_pool
    obs_slice["resume"] = obs_resume(dev)
    torch.cuda.empty_cache()
    flash_res = flash_sweep(ops, fmod, flash_attention_ref, dev)
    lm_ref_err = lm_small_reference(serve, smoke_config, make_batch,
                                    init_params, dev)
    lm_out, flash_launches, lm_run_s = lm_main_path(serve, ops)
    flash_rows, lm_warm = lm_timings(lm_out, serve, fmod,
                                     flash_attention_ref, apply_norm,
                                     _project_qkv)
    lm_report, lm_launches = lm_out["report"], lm_out["launches"]
    del lm_out
    torch.cuda.empty_cache()
    gather_res = gather_sweep(ops, gmod, gather_matmul_ref, dev)
    train_ref = lm_train_small_reference(ops, gmod, smoke_config,
                                         make_batch, init_params,
                                         make_train_step, Adam, dev)
    argv = train_argv(microbatches("qwen3-1.7b", "train_4k"))
    (train_out, train_args, tap, gather_launches, train_run_s, peak,
     path_checks) = lm_train_main_path(train, ops, gmod, gather_matmul_ref,
                                       argv)
    gather_rows, train_warm = lm_train_timings(
        train_out, train_args, tap, gmod, gather_matmul_ref, peak)
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    if bad:
        raise AssertionError(f"JAX or the reference was imported: {bad}")

    hidden = next(r for r in rows if r["d"] == 256)
    kernels = [{
        "name": "bcoo_spmm", "route": "cuda",
        "source": "src/repro_torch/csrc/bcoo_spmm.cu",
        "replaces": "src/repro/kernels/bcoo_spmm.py:51",
        "variant": hidden["variant"],
        "launches": launches + gnn_slice["launches"] + mb_launches + sum(
            models_slice[m]["launches"] + serving[m]["launches"]
            for m in serving) + obs_gnn["launches"]
        + obs_slice["minibatch"]["launches"]
        + obs_slice["save_serve"]["serve_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": hidden["ms"], "plain_ms": hidden["plain_ms"],
        "bound_ms": hidden["bound_ms"], "bound_by": hidden["bound_by"],
        "library_ms": hidden["library_ms"]}, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:31",
        "variant": flash_rows[0]["variant"], "launches": flash_launches,
        "max_abs_err": flash_rows[0]["max_abs_err"],
        "ms": flash_rows[0]["ms"], "plain_ms": flash_rows[0]["plain_ms"],
        "bound_ms": flash_rows[0]["bound_ms"],
        "bound_by": flash_rows[0]["bound_by"],
        "library_ms": flash_rows[0]["library_ms"]}, {
        "name": "gather_matmul", "route": "cuda",
        "source": "src/repro_torch/csrc/gather_matmul.cu",
        "replaces": "src/repro/kernels/gather_matmul.py:28",
        "variant": gather_rows[0]["variant"], "launches": gather_launches,
        "max_abs_err": max(c[0] for c in path_checks.values()),
        "ms": gather_rows[0]["ms"], "plain_ms": gather_rows[0]["plain_ms"],
        "bound_ms": gather_rows[0]["bound_ms"],
        "bound_by": gather_rows[0]["bound_by"],
        "library_ms": gather_rows[0]["library_ms"]}]
    say(json.dumps({"slice": {
        "build_kernels_s": build_rep["seconds"], "serve_run_s": run_s,
        "cache_build_s": report["cache_build_s"],
        "queries_per_s": report["queries_per_s"],
        "n_nodes": report["n_nodes"], "n_partitions": report["n_partitions"],
        "launches_by_variant": spmm_by_var,
        "sweep": sweep_res, "small_reference_max_abs_err": ref_err,
        "stages_ms": stages}}))
    say(json.dumps({"bcoo_spmm_shapes": rows}))
    say(json.dumps({"gnn_train_slice": gnn_slice}))
    say(json.dumps({"gnn_models_slice": models_slice}))
    say(json.dumps({"minibatch_slice": mb_slice}))
    say(json.dumps({"obs_slice": obs_slice}))
    say(json.dumps({"lm_slice": {
        "report": lm_report, "run_s": lm_run_s,
        "launches": lm_launches, "warm": lm_warm,
        "flash_sweep": flash_res, "small_reference_max_abs_err": lm_ref_err,
        "flash_shapes": flash_rows}}))
    say(json.dumps({"lm_train_slice": {
        "report": train_out["report"], "argv": argv,
        "run_s": train_run_s, "launches": gather_launches,
        "warm": train_warm, "gather_sweep": gather_res,
        "small_reference": train_ref, "path_checks": path_checks,
        "gather_shapes": gather_rows}}))
    say(json.dumps({"build": build_rep,
                    "total_s": time.perf_counter() - t_start}))
    say(json.dumps({"kernels": kernels}))
    say(smi)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
