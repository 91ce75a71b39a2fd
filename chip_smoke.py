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
5b. GCN serving behind the frontend: ``serve_gnn`` at phase 4's width
   and graph with 2 replicas (r1 warm-started), a sampled replica (keep
   0.3), 2 random edge insertions, the partition LRU (4,096 MB),
   overlapped uploads and the slow log, 2,048 queries of 16 ids from one
   client, launch counts set to 0 just
   before and read just after: layers × partitions for r0's build and for
   the sampled build plus every server's recompute chunks, all
   ``tf32x3``; the update log drained in order with monotone versions;
   both replicas against the CPU port after the same updates and against
   the ``incremental=False`` oracle on the card (1e-4·max|logit|; the
   oracle's clean rows bit-identical to its previous version at each
   update); the sampled error and CI finite and a loose error budget
   answered by the sampled replica; 2,048 more requests of 16 ids from 8
   client threads at once (request latency p50 / p99 and requests per
   dispatch under load); a third update on r0 with its
   previous version pinned (clean rows bit-identical, version and
   ``applied_seq`` one higher, one launch per chunk); the slow log
   (at most K records with phases); kernel, plain version and BSR times
   of a sampled partition and of recompute chunks with the card's bound;
   and one stream's forward by stage without the LRU, with a cold and a
   warm LRU (no miss, layers × partitions hits) and overlapped, each
   equal to the serial forward bit for bit; build seconds, per-update
   costs, queries/s, query p50 / p99 with their sample counts, host RSS
   and device peak;
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
8f. data-parallel GraphSAINT training on 2 gloo ranks sharing the card
   (NCCL refuses two ranks on one GPU, so the all-reduce goes through the
   host: a functional check, not an NCCL figure): (a) phase 8d's small
   GCN and pool on the ranks, the all-reduce int8-compressed with error
   feedback and bucketed during the backward, against a one-process
   simulation of the same schedule on the card (each rank's gradients
   with the run's own plans, compressed as the run's steps say, averaged
   on the host, Adam applied): the same subgraph tuples and modes,
   ``compress`` exactly on the RSC steps, plans identical to a plan pool
   per shard fed that rank's norms, losses within GNN_LOSS_RTOL, each
   parameter's change within TRAIN_DP_REL; then the full-width GCN's
   gradients all-reduced per leaf and in 4 buckets, timed; (b) ``launch.train
   gnn --minibatch --dp 2 --force-host-devices 2 --compress-grads
   --overlap-allreduce`` at 8d's width, 10 epochs (4 global steps each;
   cut from 8d's 40 for time), autotuned afresh (rank 0 sweeps, rank 1
   reads its decisions): each rank's launch counts start at 0 in its own
   process and come back by variant, this process launches nothing; 6
   ``bcoo_spmm`` launches per step per rank, 3 per subgraph per
   evaluation plus the sweeps' on rank 0, all ``tf32x3``; flops fraction
   within the budget; a finite, falling loss; ``compress`` exactly on the
   RSC steps; every shard's hit rate above 0; no autotune miss; each
   rank's step medians, all-reduce ms after the backward, f32 bytes per
   step and what int8 codes and scales would take, upload, stall,
   planner ms per refresh, peak device memory and host RSS at the end of
   its run;
9. LM serving (``flash_attention``): sweep the kernel against its plain
   version over b ∈ {1, 2}, (nq, nkv) ∈ {(16, 8), (14, 2), (4, 4), (8, 1)}
   (GQA ratios 2, 7, 1, 8), hd ∈ {64, 128}, f32 (variant ``fma``) and
   bf16 (``wgmma``), tq = tk ∈ {1, 7, 64, 129, 257, 1024} and tq < tk
   with q_offset = tk − tq, window ∈ {None, 16, 100}, causal and not,
   checking that each launch is counted under its variant; then prefill +
   8 greedy decode steps of the f32 smoke qwen3-1.7b on the card against
   the same run on the CPU;
9b. the flash sweep over the other families' heads: hd 256 at (nq, nkv)
   = (16, 1) and (4, 1) (variants ``wgmma_hd256`` and ``fma``), (32, 8) at
   hd 128 and (24, 24) at hd 64, windows {None, 100, 2,048}, lengths up to
   2,100 (past the 2,048 window), the same checks;
10. drive the LM serving path (``repro_torch.launch.serve``) at the full
    width of qwen3-1.7b (28 layers, d_model 2048, bf16, seeded random
    weights) with batch 4, a 4,096-token prompt and 32 generated tokens,
    launch counts set to 0 just before and read just after; assert 28
    kernel launches in the prefill, all of them ``wgmma``, and none in
    decode, finite logits, a (4, 32) token block, and the kernel against
    its plain version on the first layer's own q/k/v;
10b. the other LM families at their published widths (bf16, seeded
    random weights), one at a time: xlstm-125m, recurrentgemma-9b,
    llama-3.2-vision-11b (with 6,404 ``cross_states``), deepseek-v2-lite-16b,
    musicgen-medium (embedding input) and deepseek-v2-236b (its dense
    prefix layer and one attn_moe layer: 60 layers do not fit one card),
    batch 2, a 4,096-token prompt, 16 generated tokens, through the
    serving entry point with the launch counts set to 0 just before and
    read just after: one flash launch per self-attention layer in the
    prefill (12, all ``wgmma_hd256``; 32 and 48 ``wgmma``; 0 for xLSTM and
    MLA), none in decode, finite logits, a (2, 16) token block; cold and
    warm prefill, decode tok/s, peak memory, the RG-LRU scan's and
    sLSTM's share of a prefill; the kernel against its plain version and
    timed beside SDPA (given recurrentgemma's window as a mask) on the
    first kernel layer's own q/k/v;
10c. each of those families' f32 smoke config, prefill + 8 greedy decode
    steps on the card against the same run on the CPU: identical tokens,
    logits within 1e-4·max|logit|;
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
12b. the same 3 steps for each family of phase 10b (its f32 smoke
    config): equal selected blocks, losses within 1e-5 relative (or twice
    the CPU run's own move from weights one unit in the last place away,
    where that is more: xLSTM), one ``gather_matmul`` launch per RSC'd MLP
    linear per microbatch (MoE experts and xLSTM's cells take no RSC);
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
14b. the dry run against the card (``launch/dryrun.py``): phase 13's
    step (qwen3-1.7b, bf16, batch 4 × 4,096 in 2 microbatches) run on
    meta tensors without RSC, as the reference's dry run builds it; its
    peak beside phase 13's measured ``max_memory_allocated`` (it fails
    more than ``DRYRUN_UNDER`` below it), their ratio, and the FLOPs of
    the step that was timed (the dry run's, less the MLP weight-gradient
    products RSC skips) over phase 13's warm step time as TFLOP/s and as
    a share of the card's bf16 dense peak; no kernel launches in it. Then
    the quickstart (``examples/torch_quickstart.py``, its two 120-epoch
    GCN trainings at its own size, in this process) through
    ``bcoo_spmm``, with the launch counts set to 0 before it and read
    after; the output the run got from the first call of each SpMM
    signature (width, plan length, epilogue) is held against the plain
    version on that call's inputs (``TOL``);
13b. LM training on a (data 2, model 2) mesh: 4 gloo ranks sharing the
    card (NCCL refuses two ranks on one GPU), FSDP over ``data`` and
    tensor parallelism over ``model``, through
    ``train.lm_steps.make_sharded_train_step``. (a) qwen3's and qwen2's
    f32 smoke configs, 3 RSC steps (bk 32, keep 0.5, 2 microbatches),
    against the one-process run on the card from the same parameters:
    equal selected blocks, losses within 1e-5 relative, each parameter's
    change within ``TRAIN_DP_REL`` of the one-process change (or twice
    what that run's own change moves from weights one unit in the last
    place away, where that is more: qwen2's k bias), each rank's blocks
    of the shape its spec gives, and the trained state gathered and
    placed on (2, 1) and (1, 1) gathering back bit for bit. (b)
    qwen3-1.7b at full width (batch 4 × 4,096, 2 microbatches, RSC keep
    0.5, bk 128), 1 step (cut from 2 for the run's time) from phase 13's
    seeded parameters and batches, against phase 13's first step (its
    parameters saved after it, outside its step timer): the loss within
    1e-3 and each parameter within
    5e-2 (max abs), the reference's bounds for its bf16 sharded step;
    3 × 28 × 2 ``gather_matmul`` calls on each rank, launched
    (all ``wgmma``, at the tensor-parallel shapes) or counted as skipped;
    no ``flash_attention`` launch; each rank's parameter and moment bytes
    against the spec's share; its peak memory, step median and host-clock
    all-gather / reduce-scatter / all-reduce ms (through the host under
    gloo: a functional figure, not NCCL's); the kernel against its plain
    version on the path's own operands and timed at those shapes;
13c. the six non-dense families on the same mesh and ranks (launched
    once with 13b), tensor parallel over ``model`` (MoE experts, MLA and
    attention heads, the LRU width, xLSTM heads, the ffn columns). (a)
    each family's f32 smoke config (cross gates 0.5), 2 plain-SGD steps
    (lr 0.1) with RSC (bk 32, keep 0.5, 2 microbatches), against the
    one-process run on the card from the same parameters: equal selected
    blocks, losses within 1e-5 relative (or twice the one-process run's
    own move from weights one unit in the last place away: xLSTM), each
    parameter's change within ``TRAIN_DP_REL`` (or twice that run's own
    move), one ``gather_matmul`` call per RSC'd linear per microbatch on
    each rank (launched or skipped), the MoE expert ids of every rank
    equal to the one-process run's for its rows, each rank's blocks of
    the spec's shape. (b) deepseek-v2-lite-16b at its published widths
    (d 2,048, 16 MLA heads, 64 routed + 2 shared experts of 1,408,
    ``d_ff_dense`` 10,944, vocab 102,400) cut to 2 of its 27 layers (the
    dense first layer and one MoE layer), 1 step of batch 4 × 4,096 in 2
    microbatches, RSC keep 0.5 (bk 128), against the one-process step on
    the card from the same seed (its parameters saved after it): the loss
    within 1e-3 and each parameter within 5e-2 (max abs), 13b's bounds;
    6 ``gather_matmul`` calls per rank (3 per microbatch, the dense
    layer's), launched (all ``wgmma``, at 5,472 ffn columns per rank) or
    counted as skipped; the MoE routing identical along each ``model``
    line and its share of picks equal to the one process's; each rank's
    parameter and moment bytes against the spec's share, peak memory,
    step time and host-clock collectives; the kernel against its plain
    version on the path's own operands and timed at those shapes;
13d. serving on the same mesh and ranks (after 13c), under
    ``DECODE_RULES`` (the KV cache sequence parallel over ``model``),
    through ``make_sharded_prefill_step``, ``launch.serve.sharded_graft``
    and ``make_sharded_decode_step``. (a) the 10 architectures' f32 smoke
    configs (cross gates 0.5), 4 rows, a prompt of 14 or 13 positions
    (``model`` does not divide 13: the prefill's cache is whole on each
    rank), grafted into 32 positions, 4 decode steps fed seeded tokens
    (the write crosses into ``model`` rank 1's block at position 16;
    recurrentgemma's 16-slot ring wraps there), against the one-process
    prefill / graft / decode on the card: logits within 1e-5 of the row's
    max |logit| (or twice the one-process run's own move from weights one
    unit in the last place away: xLSTM), the caches gathered back within
    the same rule, each rank's blocks of the sanitized spec's shape, MoE
    routing equal along each ``model`` line. (b) qwen3-1.7b at its
    published widths, bf16, phase 13's seed: 4 rows (2 a data rank), a
    4,096-token prompt, 8 tokens, ``max_len`` 4,104 (2,052 positions a
    ``model`` rank) through ``launch.serve.sharded_generate``, teacher-
    forced with the one-process ``greedy_generate``'s tokens: every
    step's logits within 5e-2 of the row's max |logit|; the greedy tokens
    reported with the first step at which they differ, if any, and the
    one-process top-2 margin there; 28 ``flash_attention`` launches a
    rank, all ``wgmma`` at 8 / 4 heads and hd 128, the first held against
    its plain version on its own q / k / v and timed with its bound and
    SDPA's time; each rank's cache bytes = the spec's share; peak memory,
    prefill, graft and decode seconds, host-clock collectives;
15. print each slice's JSON line (``slice``, ``bcoo_spmm_shapes``,
    ``frontend_slice``,
    ``gnn_train_slice``, ``gnn_models_slice``, ``minibatch_slice``,
    ``obs_slice``, ``dp_slice``, ``lm_slice``, ``lm_families_slice``,
    ``lm_train_slice``, ``dryrun_slice``, ``lm_mesh_slice`` with 13c's
    ``families`` and
    ``moe_full_width`` and 13d's ``serve``), the build report, the kernel
    line (with the
    variant each kernel ran on its main path; ``bcoo_spmm``'s launches are
    the three models' serving and RSC training runs', the frontend's, the
    minibatch run's, phase 8e's, both ranks' of phase 8f (b) and the
    quickstart's of 14b;
    ``flash_attention``'s qwen3-1.7b's, the families' of phase 10b and
    every rank's of 13d;
    ``gather_matmul``'s phase 13's and every rank's of phase 13b (b)
    and of 13c (a) and (b)),
    the card line and, last, the result line.

Without a CUDA device it exits with code 2 and prints no result. It
imports nothing of JAX and nothing of the ``repro`` package.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import functools
import gc
import json
import math
import os
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
# Phase 9b: the flash sweep over the other families' heads: hd 256 at
# recurrentgemma-9b's 16/1 and at 4/1, llama-3.2-vision-11b's 32/8 at hd
# 128, musicgen-medium's 24/24 at hd 64; windows up to recurrentgemma's
# 2,048, with lengths past it.
FLASH_FAMILY_HEADS = [(16, 1, 256), (4, 1, 256), (32, 8, 128), (24, 24, 64)]
FLASH_FAMILY_LENGTHS = [(1, 1), (64, 64), (129, 129), (100, 385),
                        (257, 1024), (2100, 2100)]
FLASH_FAMILY_WINDOWS = (None, 100, 2048)
# Phase 10b: the other LM families at their published widths (bf16,
# seeded random weights), batch 2, a 4,096-token prompt (past
# recurrentgemma's 2,048 window, so its ring buffer wraps), 16 generated
# tokens, one model at a time. deepseek-v2-236b's 60 layers do not fit one
# card: it runs its dense prefix layer and one attn_moe layer.
FAMILIES = ["xlstm-125m", "recurrentgemma-9b", "llama-3.2-vision-11b",
            "deepseek-v2-lite-16b", "musicgen-medium", "deepseek-v2-236b"]
FAMILY_BATCH, FAMILY_PROMPT, FAMILY_GEN = 2, 4096, 16
FAMILY_CUT = {"deepseek-v2-236b": 2}
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
# Phase 13b: the mesh, its smoke archs and steps, and the limits of the
# full-width run against phase 13, the reference's own for its bf16
# sharded step (tests/test_sharding_multidevice.py:274-275). Phase 13's
# parameters after MESH_FULL_STEPS steps go to MESH_SNAPSHOT for the ranks.
MESH = (2, 2)
MESH_SMALL = ("qwen3-1.7b", "qwen2-0.5b")
MESH_SMALL_STEPS = 3
MESH_FULL_STEPS = 1     # cut from 2: each step takes ~35 s through gloo
MESH_FULL = ("qwen3-1.7b", 4, 4096, 2)     # arch, batch, seq, microbatches
MESH_LOSS_ATOL = 1e-3
MESH_PARAM_ATOL = 5e-2
MESH_SNAPSHOT = ROOT / "build" / "phase13_params.pt"
# Phase 13c: the non-dense families on MESH. (a) each family's f32 smoke
# config, MESH_FAMILY_STEPS plain-SGD steps (each change a multiple of the
# gradient: Adam's first step is ±lr wherever a gradient passes its eps,
# which turns the rounding of a gradient near 0 into a full step) in 2
# microbatches with RSC (bk 32, keep 0.5), against the one-process run on
# the card. At lr 1 the xLSTM smoke model's second step moves 2.8e-2 of a
# parameter's change from weights one unit in the last place away, and
# the mesh's other order of sums moved it 5.6e-2 (on the card, limit
# 5.5e-2); at MESH_FAMILY_LR the first step's change is still the
# gradient, scaled, and the second less ill-conditioned. (b) deepseek-v2-lite-16b at its published widths, cut to
# MOE_FULL_LAYERS of its 27 layers (the dense first layer and one MoE
# layer: 27 do not fit 4 ranks on one card), 1 step, RSC keep 0.5 (bk
# 128), against the one-process step on the card within 13b's bounds; the
# one-process parameters after the step go to MOE_SNAPSHOT for the ranks.
MESH_FAMILIES = ["xlstm-125m", "recurrentgemma-9b", "llama-3.2-vision-11b",
                 "deepseek-v2-lite-16b", "deepseek-v2-236b",
                 "musicgen-medium"]
MESH_FAMILY_STEPS = 2
MESH_FAMILY_LR = 0.1
MOE_FULL = ("deepseek-v2-lite-16b", 4, 4096, 2)   # arch, batch, seq, mb
MOE_FULL_LAYERS = 2
MOE_FULL_STEPS = 1
MOE_SNAPSHOT = ROOT / "build" / "phase13c_params.pt"
# Phase 13d: serving on MESH through the sharded prefill, graft and decode
# steps (DECODE_RULES: the KV cache sequence parallel over model), on the
# ranks of 13b / 13c. (a) the 10 architectures' f32 smoke configs (cross
# gates 0.5), SERVE_SMALL's batch, a prompt of 14 positions, or 13 for
# every second architecture (model = 2 does not divide 13: the prefill's
# cache is whole on each rank), grafted into SERVE_SMALL's max_len and fed
# SERVE_SMALL's decode tokens (seeded, the same for both runs, so a near-
# tie cannot fork them), against the one-process prefill / graft / decode
# on the card: logits within SERVE_TOL of the row's max |logit|, or twice
# the one-process run's own move from weights one unit in the last place
# away where that is more (the xLSTM smoke model's logits move ~4e-5 that
# way), and the caches gathered back within the same rule. (b) SERVE_FULL:
# qwen3-1.7b at its published widths (bf16, phase 13's seed) against the
# one-process greedy_generate on the card; its max_len gives each model
# rank 2,052 positions, so the prompt spans both blocks and the generated
# tokens land on rank 1. Its logits within SERVE_BF16_TOL of the row's max
# |logit|: the mesh sums the row-parallel products' bf16 partial outputs
# over model and the softmax in other orders, ~2^-8 relative per rounding
# through 28 layers.
SERVE_ARCHS = ["qwen3-1.7b", "qwen2-0.5b", "qwen3-32b",
               "internlm2-20b"] + MESH_FAMILIES
SERVE_SMALL = (4, 32, 4)       # batch, max_len, decode steps
SERVE_TOL = 1e-5
SERVE_FULL = ("qwen3-1.7b", 4, 4096, 8)   # arch, batch, prompt, tokens
SERVE_BF16_TOL = 5e-2
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
# Phase 8f: data-parallel GraphSAINT training on DP_RANKS gloo ranks sharing
# the one card (NCCL refuses two ranks on one GPU): a functional check whose
# all-reduce goes through the host, not an NCCL figure. (a) MB_SMALL's
# graph, pool and model on the ranks, the all-reduce compressed (int8 error
# feedback) and bucketed during the backward, held against a one-process
# simulation of the same schedule on the card; the all-reduce of the
# full-width GCN's gradients (ogbn-products widths) timed per leaf and in
# DP_BUCKETS buckets over DP_REPS rounds. (b) 8d's full-width run on the
# ranks with --compress-grads --overlap-allreduce, cut from 8d's 40 epochs
# to DP_EPOCHS (4 global steps each) for time, tuned afresh into its own
# cache file (rank 0 sweeps, rank 1 reads its decisions).
DP_RANKS = 2
DP_SMALL = dict(MB_SMALL, compress_grads=True, overlap_allreduce=True)
DP_EPOCHS = 10
DP_BUCKETS = 4
DP_REPS = 20
DP_AUTOTUNE_CACHE = ROOT / "chiprun_out" / "spmm_autotune_dp.json"
OBS_SLO_P99_MS = 1000.0
# Phase 5b: GCN serving behind the frontend at phase 4's width and graph:
# 2 exact replicas (r1 warm-started from r0), a sampled replica keeping
# 0.3 of each partition's tiles, 2 random edge insertions through the
# update log (each dirties 82-89 % of layer 3's rows, so a third or a
# fourth would exercise nothing new; a third update on r0 with its
# previous version pinned follows the run), the partition LRU at 4,096 MB
# (the 3 partitions' ~2.1 GB of tiles fit), overlapped uploads and the
# slow log. Queries: FRONTEND_QUERIES ids in requests of
# FRONTEND_QUERY_BATCH from serve_gnn's one client, then LOAD_CLIENTS
# threads sending LOAD_REQUESTS requests of FRONTEND_QUERY_BATCH ids each
# at once, enough requests for p99 to rest on ~20 samples. Replicas against the
# CPU port after the same updates and against the incremental=False oracle
# on the card: 1e-4·max|logit| (the kernel and the plain version sum the
# same f32 products in other orders; the oracle re-plans the partitions).
FRONTEND_UPDATES = 2
FRONTEND_QUERIES = 32768
FRONTEND_QUERY_BATCH = 16
LOAD_CLIENTS = 8
LOAD_REQUESTS = 256
FRONTEND_RESIDENT_MB = 4096
SLOW_LOG = ROOT / "chiprun_out" / "slow.json"
SLOW_K = 16          # ServeFrontend's default reservoir
FRONTEND_RTOL = 1e-4


# Phase 14b: the dry run's peak may lie at most this far below the
# measured one (a dry run that under-counts cannot say a cell fits).
DRYRUN_UNDER = 0.10
QUICKSTART = ROOT / "examples" / "torch_quickstart.py"


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


def launch_timings(ops, kmod, bcoo_spmm_ref, blocks, plan, slab, ref,
                   nb_pad: int, bm: int, bk: int, n_active: int,
                   n_gather: int) -> dict:
    """Times of one serving launch on its own inputs (kernel, plain
    version, and BSR ``sparse.mm``, held against ``ref`` first) and the
    card's bounds: on the FP32 pipes (FLOP at 67 TFLOP/s) and, for
    ``tf32x3``, on the tensor cores (3 × FLOP at 495 TFLOP/s), each
    against the bytes (tiles, gathered rows and output once, plus the id
    lists)."""
    args = (blocks, plan.sel, plan.row_ids, plan.col_ids, slab)
    kw = dict(n_row_blocks=nb_pad, bm=bm, bk=bk)
    d = slab.shape[1]
    bd = ops.resolve_bd(None, d)
    buf = torch.empty((nb_pad * bm, d), dtype=slab.dtype, device=slab.device)
    ms = cuda_ms(lambda: kmod.launch(
        blocks, plan.sel, plan.col_ids, plan.row_ptr, slab, None, None,
        buf, bm=bm, bk=bk, bd=bd, relu=False), reps=20)
    plain_ms = cuda_ms(lambda: bcoo_spmm_ref(*args, **kw), reps=3, warmup=1)
    bsr = bsr_operand(blocks, plan, nb_pad, bm, slab.shape[0])
    assert_close(torch.sparse.mm(bsr, slab), ref, torch.float32)
    library_ms = cuda_ms(lambda: torch.sparse.mm(bsr, slab), reps=5,
                         warmup=1)
    es = blocks.element_size()
    nbytes = (n_active * bm * bk * es + n_gather * bk * d * es
              + nb_pad * bm * d * es + (2 * plan.s_pad + nb_pad + 1) * 4)
    flops = 2 * n_active * bm * bk * d
    variant = kmod.variant(blocks.dtype, bm, bk, d)
    n_sm = torch.cuda.get_device_properties(slab.device) \
        .multi_processor_count
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_fp32 = flops / PEAK_FLOPS[blocks.dtype] * 1e3
    t_ops = 3 * flops / TF32_FLOPS * 1e3 if variant == "tf32x3" else t_fp32
    return dict(d=d, bd=bd, bm=bm, bk=bk, nb_pad=nb_pad, s_pad=plan.s_pad,
                n_active=n_active, n_gather=n_gather, variant=variant,
                chunks=(kmod.chunks(nb_pad, plan.s_pad, d, bd, n_sm)
                        if variant != "fma" else 1),
                ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bytes=nbytes, flops=flops, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bound_fp32_ms=max(t_bytes, t_fp32), tflops=flops / ms / 1e9)


def layer_checks(server, ops, kmod, bcoo_spmm_ref, gcn) -> list[dict]:
    """Kernel vs plain version on the heaviest partition of every layer,
    both against the plain version in f64, then the launch's timings and
    the card's bounds there (``launch_timings``)."""
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
            row = dict(layer=l, max_abs_err=err, max_abs_err_vs_f64=err64,
                       plain_max_abs_err_vs_f64=plain_err64,
                       **launch_timings(ops, kmod, bcoo_spmm_ref, blocks,
                                        plan, slab, ref, nb_pad, bm, bk,
                                        p.n_active, p.n_gather))
        rows.append(row)
        say(f"[layer {l}] d={row['d']} n_active={row['n_active']} "
            f"s_pad={row['s_pad']} {row['variant']} chunks={row['chunks']} "
            f"err={err:.3e} (vs f64 {err64:.3e}, plain f32 vs f64 "
            f"{plain_err64:.3e}) kernel {row['ms']:.3f} ms, plain "
            f"{row['plain_ms']:.3f} ms, bsr {row['library_ms']:.3f} ms, "
            f"bound {row['bound_ms']:.3f} ms ({row['bound_by']}; FP32 pipes "
            f"{row['bound_fp32_ms']:.3f} ms), {row['tflops']:.2f} TFLOP/s")
        del blocks, plan, slab, out, ref
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


# ------------------------------------------------- GNN serving frontend

def frontend_argv(scale: float) -> list[str]:
    layers, hidden = GNN_WIDTHS["gcn"]
    return ["--dataset", "reddit", "--scale", str(scale), "--model", "gcn",
            "--layers", str(layers), "--hidden", str(hidden), "--block",
            "128", "--memory-budget-mb", "2048", "--train-epochs", "0",
            "--replicas", "2", "--sampled-budget", "0.3", "--update-edges",
            str(FRONTEND_UPDATES), "--stream-resident-mb",
            str(FRONTEND_RESIDENT_MB), "--stream-overlap", "--slow-log",
            str(SLOW_LOG), "--queries", str(FRONTEND_QUERIES),
            "--query-batch", str(FRONTEND_QUERY_BATCH), "--metrics",
            "--device", "cuda"]


def host_rss_gib() -> tuple[float, float]:
    """(resident, peak resident) host memory of this process, GiB: VmRSS
    from /proc/self/status and getrusage's ru_maxrss (KiB on Linux)."""
    import resource
    rss = next(int(line.split()[1]) for line in
               Path("/proc/self/status").read_text().splitlines()
               if line.startswith("VmRSS:"))
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    return rss / 2 ** 20, peak / 2 ** 20


def shape_row(si, p, mode: str, l: int, pre, ops, kmod, bcoo_spmm_ref,
              label: str) -> dict:
    """One launch shape of the serving path on its own inputs (a
    partition or a recompute chunk ``p`` at ``mode``'s padded shape, layer
    ``l``'s stored activations): kernel against the plain version, two
    launches bit-equal, then ``launch_timings``."""
    bm, bk = si.host.bm, si.host.bk
    nb_pad, s_pad, _ = si._pads[mode]
    with torch.inference_mode():
        blocks, plan = si.upload(p, mode)
        slab = si.gather(p, si.layer_store[l], pre)
        args = (blocks, plan.sel, plan.row_ids, plan.col_ids, slab)
        kw = dict(n_row_blocks=nb_pad, bm=bm, bk=bk)
        out = ops.bcoo_spmm(*args, row_ptr=plan.row_ptr, **kw)
        torch.testing.assert_close(
            ops.bcoo_spmm(*args, row_ptr=plan.row_ptr, **kw), out, rtol=0,
            atol=0)
        ref = bcoo_spmm_ref(*args, **kw)
        err = assert_close(out, ref, torch.float32)
        row = dict(label=label, mode=mode, layer=l, max_abs_err=err,
                   row_blocks=len(p.rbs),
                   sentinel_only_rows=int(nb_pad - np.unique(
                       p.row_ids[p.sel != p.blocks.shape[0] - 1]).size),
                   **launch_timings(ops, kmod, bcoo_spmm_ref, blocks, plan,
                                    slab, ref, nb_pad, bm, bk, p.n_active,
                                    p.n_gather))
    say(f"[frontend launch {label}] layer {l} d={row['d']} n_active="
        f"{row['n_active']} s_pad={s_pad} rows {row['row_blocks']}/{nb_pad} "
        f"(sentinel-only {row['sentinel_only_rows']}) {row['variant']} "
        f"err={err:.3e} kernel {row['ms']:.4f} ms, plain "
        f"{row['plain_ms']:.3f} ms, bsr {row['library_ms']:.3f} ms, bound "
        f"{row['bound_ms']:.4f} ms ({row['bound_by']})")
    del blocks, plan, slab, out, ref
    return row


QUERY_HISTS = ("serve.query_ms", "frontend.request_ms",
               "frontend.queue_wait_ms", "frontend.batch_requests")


def query_load(fe, reg, n_nodes: int, smi: str) -> dict:
    """LOAD_CLIENTS threads each send LOAD_REQUESTS requests of
    FRONTEND_QUERY_BATCH random ids to the open frontend at once, each
    waiting for its answer before the next: requests/s and ids/s over the
    wall time, each request's latency on the client's clock and its
    queue wait (p50 / p99 over every request, n beside them), and requests
    per dispatch from the frontend's ``frontend.batch_requests`` (its
    registry ``reg``, before against after)."""
    def counts():
        h = reg.snapshot()["histograms"].get("frontend.batch_requests",
                                             {"count": 0, "sum": 0.0})
        return h["count"], h["sum"]

    def client(c):
        rng = np.random.default_rng(100 + c)
        lat, queue = [], []
        for _ in range(LOAD_REQUESTS):
            ids = rng.integers(0, n_nodes, FRONTEND_QUERY_BATCH)
            t = time.perf_counter()
            res = fe.query(ids, timeout=60.0)
            lat.append((time.perf_counter() - t) * 1e3)
            queue.append(res.phases["queue_ms"])
            if res.logits.shape[0] != ids.size or \
                    not np.isfinite(res.logits).all():
                raise AssertionError(f"load: answer {res.logits.shape}")
        return lat, queue

    d0, q0 = counts()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(LOAD_CLIENTS) as ex:
        got = list(ex.map(client, range(LOAD_CLIENTS)))
    wall = time.perf_counter() - t0
    d1, q1 = counts()
    lat = np.concatenate([g[0] for g in got])
    queue = np.concatenate([g[1] for g in got])
    n_req = LOAD_CLIENTS * LOAD_REQUESTS
    out = {"clients": LOAD_CLIENTS, "requests": n_req,
           "ids_per_request": FRONTEND_QUERY_BATCH, "wall_s": wall,
           "requests_per_s": n_req / wall,
           "ids_per_s": n_req * FRONTEND_QUERY_BATCH / wall,
           "latency_ms": {"n": int(lat.size),
                          "p50": float(np.percentile(lat, 50)),
                          "p99": float(np.percentile(lat, 99)),
                          "max": float(lat.max())},
           "queue_ms": {"n": int(queue.size),
                        "p50": float(np.percentile(queue, 50)),
                        "p99": float(np.percentile(queue, 99))},
           "dispatches": int(d1 - d0),
           "requests_per_dispatch": (q1 - q0) / max(d1 - d0, 1)}
    say(f"[frontend load] {LOAD_CLIENTS} clients x {LOAD_REQUESTS} "
        f"requests of {FRONTEND_QUERY_BATCH} ids in {wall:.3f} s: "
        f"{out['requests_per_s']:.1f} requests/s, {out['ids_per_s']:.1f} "
        f"ids/s; latency n {lat.size} p50 {out['latency_ms']['p50']:.4f} "
        f"p99 {out['latency_ms']['p99']:.4f} max "
        f"{out['latency_ms']['max']:.4f} ms; queue p50 "
        f"{out['queue_ms']['p50']:.4f} p99 {out['queue_ms']['p99']:.4f} "
        f"ms; {out['dispatches']} dispatches, "
        f"{out['requests_per_dispatch']:.2f} requests each; {smi}")
    if out["dispatches"] <= 0 or q1 - q0 != n_req:
        raise AssertionError(f"load: dispatches {out}")
    return out


def close_to(got, want, what: str) -> float:
    atol = FRONTEND_RTOL * float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    if not err <= atol:
        raise AssertionError(f"{what}: max abs err {err:.3e} > {atol:.3e}")
    return err


def serving_frontend(serve_gnn, ops, kmod, bcoo_spmm_ref, gcn, scale: float,
                     smi: str) -> dict:
    """Phase 5b: GCN serving through ``serve_gnn``'s frontend path (2
    replicas, a sampled replica, FRONTEND_UPDATES edge updates, the
    partition LRU, overlapped uploads, the slow log), launch counts set
    to 0 just before and read just after; then the replicas against the
    CPU port and the incremental=False oracle, the sampled routing, the
    query load, the slow log, one more update on r0 with its previous
    version pinned, the new launch
    shapes, and one stream's forward without the LRU, with a cold and a
    warm LRU, and overlapped."""
    import gc
    from repro_torch import obs
    from repro_torch.graphs.datasets import load_dataset
    from repro_torch.infer import NodeServer, StreamConfig, StreamingInference
    from repro_torch.infer.stream import _DeviceLRU
    from repro_torch.launch.profile_stream import timed_forward
    obs.reset()
    if SLOW_LOG.exists():
        SLOW_LOG.unlink()
    torch.cuda.reset_peak_memory_stats()
    args = serve_gnn.build_parser().parse_args(frontend_argv(scale))
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    report, fe = serve_gnn.run(args, keep_open=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    by_var = ops.launch_counts_by_variant()["bcoo_spmm"]
    run_reg = obs.get_registry()   # the frontend's threads record here
    obs.reset()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    rss_gib, rss_peak_gib = host_rss_gib()
    r0, r1 = fe.replicas
    ss = fe.sampled_server
    servers = [r0, r1, ss]
    layers, n_parts = args.layers, r0.si.n_partitions
    updates = report["updates"]
    chunks = {s.name: [u["servers"][s.name]["recompute_chunks"]
                       for u in updates] for s in servers}
    want = layers * n_parts + layers * ss.si.n_partitions + sum(
        sum(map(sum, c)) for c in chunks.values())
    say(f"[frontend] {report['n_nodes']} nodes, {n_parts} partitions; "
        f"run {wall:.2f} s; builds r0 {r0.build_seconds:.2f} s, r1 (warm) "
        f"{r1.build_seconds:.2f} s, sampled {ss.build_seconds:.2f} s; "
        f"launches {counts['bcoo_spmm']} (expected {want}: {layers}x"
        f"{n_parts} r0 build + {layers}x{ss.si.n_partitions} sampled build "
        f"+ recompute chunks {chunks}), by variant {by_var}")
    if counts["bcoo_spmm"] != want or by_var["tf32x3"] != want:
        raise AssertionError(f"frontend launches {counts} {by_var}, "
                             f"expected {want} tf32x3")
    seqs = [u["seq"] for u in updates]
    if seqs != list(range(1, FRONTEND_UPDATES + 1)) or any(
            u["min_applied"] != u["seq"] for u in updates):
        raise AssertionError(f"update log not drained in order: {updates}")
    for s in servers:
        vers = [u["servers"][s.name]["version"] for u in updates]
        if vers != seqs or s.applied_seq != FRONTEND_UPDATES:
            raise AssertionError(f"{s.name}: versions {vers}, applied "
                                 f"{s.applied_seq}")
    if fe.min_applied_seq() != fe.log.latest_seq:
        raise AssertionError("update log not drained")
    per_update = [{name: {
        "dirty_per_layer": st["dirty_per_layer"],
        "retile_ms": st["retile"]["seconds"] * 1e3,
        "partitions_rebuilt": st["retile"]["partitions_rebuilt"],
        "fallback": st["retile"]["fallback"],
        "recompute_chunks": st["recompute_chunks"],
        "recompute_ms": st["recompute_seconds"] * 1e3,
        "update_ms": st["seconds"] * 1e3}
        for name, st in u["servers"].items()} for u in updates]
    for i, u in enumerate(per_update):
        say(f"[frontend update {i + 1}] " + "; ".join(
            f"{n}: dirty {v['dirty_per_layer']}, retile "
            f"{v['retile_ms']:.1f} ms, rebuilt {v['partitions_rebuilt']}, "
            f"chunks {v['recompute_chunks']}, recompute "
            f"{v['recompute_ms']:.1f} ms, update {v['update_ms']:.1f} ms"
            for n, v in u.items()))
    hists = {k: v for k, v in report["metrics"]["histograms"].items()
             if k.split("{")[0] in QUERY_HISTS}
    say(f"[frontend queries] one client, {report['query_batches']} "
        f"requests of {FRONTEND_QUERY_BATCH} ids: "
        f"{report['queries_per_s']} ids/s; " + "; ".join(
            f"{k}: n {v['count']} p50 {v['p50']:.4f} p99 {v['p99']:.4f} "
            f"mean {v['mean']:.4f}" for k, v in sorted(hists.items()))
        + f"; host RSS {rss_gib:.2f} GiB (peak {rss_peak_gib:.2f}), device "
        f"peak {peak_gib:.2f} GiB; {smi}")

    graph = load_dataset(args.dataset, scale=args.scale, seed=args.seed)
    net = r0.si.params
    cfg = StreamConfig(block=args.block,
                       memory_budget_mb=args.memory_budget_mb,
                       device=args.device)
    log = fe.log.since(0)
    # the incremental=False oracle on the card, and the CPU port
    t1 = time.perf_counter()
    oracle = NodeServer(graph, "gcn", net, cfg, incremental=False,
                        name="oracle")
    oracle_clean = []
    for seq, add, remove, _ in log:
        prev = oracle.si.logits
        oracle.update_edges(add=add, remove=remove, seq=seq)
        clean = np.setdiff1d(np.arange(prev.shape[0]), oracle.last_dirty)
        oracle_clean.append(int(clean.size))
        if not np.array_equal(oracle.si.logits[clean], prev[clean]) or \
                (oracle.version, oracle.applied_seq) != (seq, seq):
            raise AssertionError(f"oracle update {seq}: clean rows moved "
                                 f"or version {oracle.version}")
    t2 = time.perf_counter()
    cpu = NodeServer(graph, "gcn", copy.deepcopy(net).to("cpu"),
                     dataclasses.replace(cfg, device="cpu"), name="cpu")
    for seq, add, remove, _ in log:
        cpu.update_edges(add=add, remove=remove, seq=seq)
    t3 = time.perf_counter()
    n = graph.n
    checks = {}
    for s in (r0, r1):
        checks[s.name] = {
            "vs_cpu_max_abs_err": close_to(s.si.logits[:n],
                                           cpu.si.logits[:n],
                                           f"{s.name} against the CPU"),
            "vs_oracle_max_abs_err": close_to(s.si.logits[:n],
                                              oracle.si.logits[:n],
                                              f"{s.name} against the "
                                              "oracle"),
            "oracle_bit_identical": bool(np.array_equal(s.si.logits,
                                                        oracle.si.logits))}
    replicas_bit_identical = bool(np.array_equal(r0.si.logits,
                                                 r1.si.logits))
    say(f"[frontend check] after {FRONTEND_UPDATES} updates: {checks}; "
        f"r0 == r1 bit for bit: {replicas_bit_identical}; oracle "
        f"{t2 - t1:.1f} s (clean rows per update, bit for bit: "
        f"{oracle_clean}), CPU reference {t3 - t2:.1f} s")
    del oracle, cpu
    gc.collect()

    # the sampled replica: its error, the CI and the routing
    err, (lo, hi) = fe.sampled_rel_error, fe.sampled_rel_ci
    if not (np.isfinite([err, lo, hi]).all() and lo <= err <= hi):
        raise AssertionError(f"sampled error {err} CI {(lo, hi)}")
    ids = np.random.default_rng(2).integers(0, n, 64)
    loose = fe.query(ids, error_budget=2.0 * hi, timeout=60.0)
    strict = fe.query(ids, timeout=60.0)
    if not (loose.sampled and loose.replica == "sampled") or strict.sampled:
        raise AssertionError(f"routing: budget {2 * hi} answered by "
                             f"{loose.replica}, none by {strict.replica}")
    load = query_load(fe, run_reg, n, smi)

    # the new launch shapes: a sampled partition, recompute chunks
    rows = []
    sp = max(ss.si._parts["sampled"], key=lambda q: q.n_active)
    for l in (1, 2):
        rows.append(shape_row(ss.si, sp, "sampled", l,
                              gcn.infer_pre(net, l), ops, kmod,
                              bcoo_spmm_ref, "sampled partition"))
    si0 = r0.si
    edge = serve_gnn.random_edge_updates(graph, 1,
                                         np.random.default_rng(5))
    dirty = r0._dirty_sets(si0.adj, si0.adj, si0.pos[np.asarray(edge[0])])
    for l in (0, 2):
        rbs = np.unique(dirty[l] // si0.host.bm)
        chunk = si0._chunk_blocks(rbs, "exact")[0]
        cp = si0._build_one(chunk, si0._raw_partition(chunk),
                            *si0._pads["exact"], compact=True)
        rows.append(shape_row(si0, cp, "exact", l, gcn.infer_pre(net, l),
                              ops, kmod, bcoo_spmm_ref,
                              f"recompute chunk ({len(rbs)} dirty row "
                              "blocks)"))
    fe.close()
    slow = json.loads(SLOW_LOG.read_text())
    if not (0 < slow["kept"] <= SLOW_K) or any(
            "phases" not in r for r in slow["slow"]):
        raise AssertionError(f"slow log: {slow}")
    build = {s.name: s.build_seconds for s in servers}
    lru_on_build = {s.name: (s.si.lru.hits, s.si.lru.misses)
                    for s in servers}

    # one more update on r0, its previous version pinned: clean rows keep
    # their bits, version and applied_seq rise, one launch per chunk
    old = r0.acquire_snapshot()
    ops.reset_launch_counts()
    st_p = r0.update_edges(add=edge, seq=FRONTEND_UPDATES + 1)
    n_p = ops.launch_counts()["bcoo_spmm"]
    clean = np.setdiff1d(np.arange(old.logits.shape[0]), r0.last_dirty)
    snap = r0.acquire_snapshot()
    pinned = {"edge": edge, "clean_rows": int(clean.size),
              "clean_bit_identical": bool(np.array_equal(
                  snap.logits[clean], old.logits[clean])),
              "version": snap.version, "applied_seq": snap.applied_seq,
              "chunks": st_p["recompute_chunks"], "launches": n_p,
              "update_ms": st_p["seconds"] * 1e3}
    r0.release_snapshot(snap)
    r0.release_snapshot(old)
    say(f"[frontend pinned update] r0: {pinned}")
    if not pinned["clean_bit_identical"] or \
            (snap.version, snap.applied_seq) != (old.version + 1,
                                                 FRONTEND_UPDATES + 1) or \
            n_p != sum(st_p["recompute_chunks"]):
        raise AssertionError(f"pinned update: {pinned}")
    del fe, r0, r1, ss, servers, si0, snap, old
    gc.collect()
    torch.cuda.empty_cache()

    # one stream of the same graph: no LRU, cold LRU, warm LRU, overlap
    si = StreamingInference(graph, "gcn", net, cfg)
    base, st_none = timed_forward(si)
    si.lru = _DeviceLRU(FRONTEND_RESIDENT_MB * 2 ** 20)
    cold, st_cold = timed_forward(si)
    warm, st_warm = timed_forward(si)
    d_hits = st_warm["lru"]["hits"] - st_cold["lru"]["hits"]
    d_miss = st_warm["lru"]["misses"] - st_cold["lru"]["misses"]
    si.cfg = dataclasses.replace(si.cfg, overlap=True)
    si.lru = None
    ovl, st_ovl = timed_forward(si)
    si.lru = _DeviceLRU(FRONTEND_RESIDENT_MB * 2 ** 20)
    timed_forward(si)
    ovl_warm, st_ovl_warm = timed_forward(si)
    stages = {"no_lru": st_none, "cold_lru": st_cold, "warm_lru": st_warm,
              "overlap": st_ovl, "overlap_warm_lru": st_ovl_warm}
    for k, v in stages.items():
        say(f"[frontend stages {k}] " + ", ".join(
            f"{a} {b:.1f}" for a, b in v.items() if a != "lru")
            + f"; {smi}")
    same = {k: bool(np.array_equal(v, base)) for k, v in
            (("cold_lru", cold), ("warm_lru", warm), ("overlap", ovl),
             ("overlap_warm_lru", ovl_warm))}
    if not all(same.values()) or d_miss != 0 or \
            d_hits != layers * si.n_partitions:
        raise AssertionError(f"LRU / overlap forwards: bit-identical "
                             f"{same}; warm pass hits {d_hits}, misses "
                             f"{d_miss} (expected {layers * n_parts}, 0)")
    # every row recomputed through recompute_rows' chunks against the
    # full forward (batchnorm frozen at its statistics)
    full = si.forward(store=True).copy()
    every = np.arange(si.host.n_rows)
    si.logits[:] = 0.0
    for a in si.layer_store[1:]:
        a[:] = 0.0
    rec_chunks = si.recompute_rows([every] * layers)
    chunks_bit_identical = bool(np.array_equal(si.logits, full))
    chunk_err = close_to(si.logits, full, "recompute chunks")
    say(f"[frontend chunks] every row through recompute_rows' chunks "
        f"{rec_chunks} against the full forward: bit-identical "
        f"{chunks_bit_identical} (max abs err {chunk_err:.3e})")
    del si
    gc.collect()
    torch.cuda.empty_cache()
    return {"argv": frontend_argv(scale), "run_s": wall,
            "launches": counts["bcoo_spmm"], "launches_by_variant": by_var,
            "build_s": build, "lru_hits_misses_after_run": lru_on_build,
            "updates": per_update, "pinned_update": pinned,
            "oracle_clean_rows": oracle_clean,
            "queries_per_s": report["queries_per_s"], "query_ms": hists,
            "query_load": load,
            "host_rss_gib": rss_gib, "host_rss_peak_gib": rss_peak_gib,
            "device_peak_gib": peak_gib, "checks": checks,
            "replicas_bit_identical": replicas_bit_identical,
            "sampled_rel_error": err, "sampled_rel_ci": [lo, hi],
            "slow_log_kept": slow["kept"], "slow_log_offered":
            slow["offered"], "stages_ms": stages,
            "forwards_bit_identical": same, "launch_rows": rows,
            "recompute_chunks_bit_identical": chunks_bit_identical,
            "card": smi}


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


# --------------------------------------------------- data-parallel training

def dp_small_pool():
    """MB_SMALL's graph and pool (8d's small run's)."""
    from repro_torch.graphs.synthetic import sbm_graph
    from repro_torch.pipeline import PoolConfig, build_pool
    g = sbm_graph(**GNN_GRAPH)
    return g, build_pool(g, PoolConfig(
        n_subgraphs=DP_SMALL["n_subgraphs"], roots=DP_SMALL["roots"],
        walk_length=DP_SMALL["walk_length"],
        n_buckets=DP_SMALL["n_buckets"], block=DP_SMALL["block"]))


def dp_allreduce_timings(group) -> dict:
    """The full-width GCN's gradient leaves (ogbn-products widths)
    all-reduced over the group per leaf and in DP_BUCKETS buckets, in
    turns, DP_REPS rounds each (host clock, the card synchronised on both
    sides); medians in ms."""
    from repro_torch.graphs.datasets import DATASETS
    from repro_torch.models.gnn import gcn
    from repro_torch.train.steps import GradReducer, bucketed_all_reduce
    spec = DATASETS["ogbn-products"]
    layers, hidden = GNN_WIDTHS["gcn"]
    net = gcn.init(spec.feat_dim, hidden, spec.classes, layers, True, seed=0,
                   device=group.device)
    red = GradReducer(net, group, overlap_buckets=DP_BUCKETS)
    gen = torch.Generator(device=group.device)
    gen.manual_seed(group.rank)
    grads = {n: torch.randn(dict(net.named_parameters())[n].shape,
                            generator=gen, device=group.device)
             for n in red.names}
    sync = (torch.cuda.synchronize if group.device.type == "cuda"
            else (lambda: None))
    times: dict[str, list[float]] = {"per_leaf": [], "bucketed": []}
    for _ in range(DP_REPS):
        for mode in times:
            group.barrier()
            sync()
            t0 = time.perf_counter()
            if mode == "per_leaf":
                for n in red.names:
                    group.mean_(grads[n].clone())
            else:
                bucketed_all_reduce(grads, group, DP_BUCKETS)
            sync()
            times[mode].append((time.perf_counter() - t0) * 1e3)
    return {"leaves": len(red.names), "buckets": len(red.buckets),
            "f32_bytes": red.f32_bytes, "int8_bytes": red.int8_bytes,
            **{f"{m}_ms": float(np.median(t)) for m, t in times.items()},
            **{f"{m}_ms_all": t for m, t in times.items()}}


def dp_small_rank(group, start: dict) -> dict:
    """Phase 8f (a), one rank: DP_SMALL from the parent's parameters
    (``start``, host arrays by name), each RSC step's plans and norms, the
    final parameters and the rank's launches; then the all-reduce timings
    (``dp_allreduce_timings``)."""
    from repro_torch.kernels import ops
    from repro_torch.models.gnn import gcn
    from repro_torch.pipeline import MinibatchConfig, MinibatchTrainer
    ops.reset_launch_counts()
    dev = group.device
    g, pool = dp_small_pool()
    net = gcn.init(GNN_GRAPH["feat_dim"], DP_SMALL["hidden"], 7,
                   DP_SMALL["n_layers"], True, seed=0, device=dev)
    with torch.no_grad():
        for n, p in net.named_parameters():
            p.copy_(torch.from_numpy(start[n]))
    tr = MinibatchTrainer(MinibatchConfig(**DP_SMALL, dp=DP_RANKS,
                                          device=str(dev)), g, pool,
                          model=net, group=group)
    plans, norms = capture_planner(tr.engine.planner)
    res = tr.train(eval_every=2)
    h = res["history"]
    return {"rank": group.rank,
            "history": {k: h[k] for k in ("loss", "sub_id", "mode",
                                          "compress", "val", "test")},
            "plans": plans,
            "norms": [{k: v.numpy() for k, v in n.items()} for n in norms],
            "final": {n: p.detach().cpu().numpy()
                      for n, p in net.named_parameters()},
            "launches": ops.launch_counts()["bcoo_spmm"],
            "n_partitions": (tr.engine.stream_eval.si.n_partitions
                             if tr.engine.stream_eval.si is not None
                             else None),
            "reduce_ms": tr.engine.runner.reducer.reduce_ms,
            "allreduce": dp_allreduce_timings(group)}


def dp_small_reference(ops, dev) -> dict:
    """Phase 8f (a): DP_SMALL on DP_RANKS gloo ranks on the card against a
    one-process simulation of the same schedule on the card: each rank's
    ``rsc_grads`` / ``exact_grads`` on its subgraph with the DP run's own
    plans, compressed per leaf with each rank's error feedback as the
    run's steps say, averaged on the host, Adam applied. The same tuples
    (and the schedule drawn here) and modes, ``compress`` exactly on the
    RSC steps, plans identical to a ``PlanCachePool`` per shard fed that
    rank's norms, losses within GNN_LOSS_RTOL, each parameter's change
    within TRAIN_DP_REL; launches 2 per layer per step on each rank and
    layers × partitions per evaluation on rank 0, none in this process."""
    from repro_torch.core.plan import SamplePlan
    from repro_torch.distributed import launch, plan_group
    from repro_torch.models.gnn import MODELS, gcn
    from repro_torch.pipeline import (MinibatchConfig, PlanCachePool,
                                      ShardedPoolSource, device_operands)
    from repro_torch.train.optimizer import Adam, apply_updates
    from repro_torch.train.steps import (GradReducer, init_error_feedback,
                                         make_gnn_grads)
    _, pool = dp_small_pool()
    layers = DP_SMALL["n_layers"]
    net = gcn.init(GNN_GRAPH["feat_dim"], DP_SMALL["hidden"], 7, layers,
                   True, seed=0, device="cpu")
    start = {n: p.detach().numpy().copy() for n, p in net.named_parameters()}
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    ranks = launch(dp_small_rank, (start,), plan=plan_group(
        DP_RANKS, force_host_devices=DP_RANKS, device=str(dev)))
    run_s = time.perf_counter() - t0
    here = ops.launch_counts()
    hs = [r["history"] for r in ranks]
    cfg = MinibatchConfig(**DP_SMALL, dp=DP_RANKS, device=str(dev))
    src = ShardedPoolSource(pool, cfg, SimpleNamespace(
        rank=0, world_size=DP_RANKS, device=dev))
    tags = [t for e in range(cfg.epochs) for t in src.epoch_schedule(e)]
    if any(h["sub_id"] != tags or h["mode"] != hs[0]["mode"]
           or h["loss"] != hs[0]["loss"] for h in hs):
        raise AssertionError("the ranks' subgraph tuples, modes or losses "
                             "differ from each other or from the schedule")
    if hs[0]["compress"] != [m == "rsc" for m in hs[0]["mode"]]:
        raise AssertionError(f"compress {hs[0]['compress']} is not on "
                             "exactly the RSC steps")
    parts = ranks[0]["n_partitions"]
    steps, evals = len(hs[0]["loss"]), len(hs[0]["val"])
    want = [2 * layers * steps + layers * parts * evals, 2 * layers * steps]
    got = [r["launches"] for r in ranks]
    module = MODELS["gcn"]
    names = module.spmm_names(layers)
    dims = module.spmm_dims(layers, DP_SMALL["hidden"], pool.num_classes)
    rsc_tags = [t for t, m in zip(tags, hs[0]["mode"]) if m == "rsc"]
    n_sampled = 0
    for r, rk in enumerate(ranks):
        pp = PlanCachePool(pool, names, dims, budget_frac=cfg.budget,
                           step_frac=cfg.step_frac, strategy=cfg.strategy,
                           refresh_every=cfg.refresh_every,
                           label=f"shard{r}", device="cpu")
        if len(rk["plans"]) != len(rsc_tags):
            raise AssertionError(f"rank {r} planned {len(rk['plans'])} "
                                 f"steps, expected {len(rsc_tags)}")
        for tag, got_p, nm in zip(rsc_tags, rk["plans"], rk["norms"]):
            want_p = pp.plans_for(pool.subgraphs[tag[r]])
            for k, p in want_p.items():
                arrays = (p.sel, p.row_ids, p.col_ids, p.row_ptr)
                if not (all(np.array_equal(a, b.numpy()) for a, b in
                            zip(got_p[k][0], arrays))
                        and got_p[k][1:] == (p.n_active, p.s_pad)):
                    raise AssertionError(f"rank {r}'s plan for {k} at "
                                         f"{tag} differs from shard{r}'s")
                n_sampled += p.n_active < len(
                    pool.subgraphs[tag[r]].meta.row_ids)
            pp.record_norms(tag[r], {k: torch.from_numpy(v)
                                     for k, v in nm.items()})
    # the simulation, on the card
    card = copy.deepcopy(net).to(dev)
    params = dict(card.named_parameters())
    opt = Adam(lr=cfg.lr)
    state = opt.init(params)
    rsc_grads, exact_grads, _ = make_gnn_grads(
        module, dims, names, dropout=0.0, backend="kernel")
    red = GradReducer(card, None, compress_block=cfg.compress_block)
    errs = [init_error_feedback(card) for _ in ranks]
    gen = torch.Generator(device=dev)
    plan_it = [iter(r["plans"]) for r in ranks]
    sim_loss = []
    for tag, mode, comp in zip(tags, hs[0]["mode"], hs[0]["compress"]):
        per = []
        for r in range(DP_RANKS):
            ops_r = device_operands(pool, pool.subgraphs[tag[r]], dev)
            if mode == "rsc":
                plans = {k: SamplePlan(
                    *(torch.from_numpy(a).to(dev) for a in v[0][:3]),
                    n_active=v[1], s_pad=v[2],
                    row_ptr=torch.from_numpy(v[0][3]).to(dev))
                    for k, v in next(plan_it[r]).items()}
                loss, grads, _ = rsc_grads(card, ops_r, plans, gen)
            else:
                loss, grads = exact_grads(card, ops_r, gen)
            if comp:
                for n in grads:
                    grads[n], errs[r][n] = red.compress_leaf(n, grads[n],
                                                             errs[r][n])
            per.append((loss.cpu(), {n: t.cpu() for n, t in grads.items()}))
        mean = {n: ((per[0][1][n] + per[1][1][n]) / DP_RANKS).to(dev)
                for n in params}
        sim_loss.append(float((per[0][0] + per[1][0]) / DP_RANKS))
        upd, state = opt.update(mean, state, params)
        apply_updates(params, upd)
    loss_err = float(np.max(np.abs(np.subtract(hs[0]["loss"], sim_loss))
                            / np.abs(sim_loss)))
    rel = {}
    for n, p in params.items():
        sim = p.detach().cpu().numpy()
        moved = np.linalg.norm(sim - start[n])
        rel[n] = float(np.linalg.norm(ranks[0]["final"][n] - sim)
                       / max(moved, 1e-30))
    worst = max(rel, key=rel.get)
    ar = [r["allreduce"] for r in ranks]
    say(f"[dp reference] gcn {layers}x{DP_SMALL['hidden']} on {DP_RANKS} "
        f"gloo ranks sharing the card, compressed and bucketed all-reduce: "
        f"{steps} steps ({len(rsc_tags)} rsc), tuples {tags[:4]}...; plans "
        f"identical to shard0/shard1's at every RSC step ({n_sampled} "
        f"sampled op plans); launches by rank {got}, here 0; largest loss "
        f"error against the simulation {loss_err:.3e} (limit "
        f"{GNN_LOSS_RTOL:.0e}), parameter change {rel[worst]:.3e} ({worst}, "
        f"limit {TRAIN_DP_REL:.0e}); run {run_s:.2f} s; all-reduce of the "
        f"full-width GCN's {ar[0]['leaves']} leaves ({ar[0]['f32_bytes']} "
        f"f32 bytes, int8 codes + scales {ar[0]['int8_bytes']}): per leaf "
        f"{[round(a['per_leaf_ms'], 3) for a in ar]} ms, in "
        f"{ar[0]['buckets']} buckets {[round(a['bucketed_ms'], 3) for a in ar]}"
        f" ms by rank (gloo through the host, median of {DP_REPS})")
    np.testing.assert_allclose(hs[0]["loss"], sim_loss, rtol=GNN_LOSS_RTOL)
    if rel[worst] > TRAIN_DP_REL:
        raise AssertionError(f"{worst}'s change differs from the simulation"
                             f"'s by {rel[worst]:.3e} of its norm")
    if not n_sampled:
        raise AssertionError("no sampled plan in the small DP run")
    if got != want or any(here.values()):
        raise AssertionError(f"bcoo_spmm launches by rank {got}, expected "
                             f"{want}; in this process {here}")
    return {"steps": steps, "rsc_steps": len(rsc_tags), "launches": got,
            "sampled_op_plans": int(n_sampled), "run_s": run_s,
            "max_loss_rel_err": loss_err, "max_param_change_err": rel[worst],
            "reduce_ms_median": [float(np.median(r["reduce_ms"]))
                                 for r in ranks],
            "allreduce_full_width": ar}


def dp_argv() -> list[str]:
    """8d's full-width run cut to DP_EPOCHS, on DP_RANKS gloo ranks of the
    one card, compressed and bucketed."""
    argv = mb_argv()
    argv[argv.index("--epochs") + 1] = str(DP_EPOCHS)
    return argv + ["--dp", str(DP_RANKS), "--force-host-devices",
                   str(DP_RANKS), "--compress-grads", "--overlap-allreduce"]


def dp_main_path(train, ops, autotune, smi: str) -> tuple[int, dict]:
    """Phase 8f (b): ``launch.train gnn --minibatch --dp 2
    --force-host-devices 2 --compress-grads --overlap-allreduce`` at full
    width. Each rank's launch counts start at 0 in its own process and
    come back by variant; this process launches nothing. 6 ``bcoo_spmm``
    launches per step on each rank, and 3 per subgraph per evaluation plus
    the sweeps' on rank 0, all ``tf32x3``; flops fraction within the
    budget; a finite, falling loss; ``compress`` exactly on the RSC steps;
    every shard's hit rate above 0; no autotune miss on either rank.
    Returns both ranks' launches and the slice's report."""
    if DP_AUTOTUNE_CACHE.exists():
        DP_AUTOTUNE_CACHE.unlink()
    argv = dp_argv()
    env_before = os.environ.get(autotune.ENV_VAR)
    os.environ[autotune.ENV_VAR] = str(DP_AUTOTUNE_CACHE)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        out = train.main(argv)
    finally:
        if env_before is None:
            os.environ.pop(autotune.ENV_VAR, None)
        else:
            os.environ[autotune.ENV_VAR] = env_before
    wall = time.perf_counter() - t0
    here = ops.launch_counts()
    report, ranks = out["report"], out["ranks"]
    hist = ranks[0]["result"]["history"]
    steps, evals = len(hist["loss"]), len(hist["val"])
    n_sub = report["subgraphs"]
    losses = np.asarray(hist["loss"])
    rows, problems = [], []
    for rk in ranks:
        h = rk["result"]["history"]
        sweeps = rk["autotune"]["stats"]["sweep_launches"]
        want = 6 * steps + (3 * n_sub * evals if rk["rank"] == 0 else 0) \
            + sweeps
        by_var = rk["launches_by_variant"]["bcoo_spmm"]
        if (rk["launches"]["bcoo_spmm"] != want
                or by_var.get("tf32x3", 0) != want
                or rk["launches"]["flash_attention"]
                or rk["launches"]["gather_matmul"]):
            problems.append(f"rank {rk['rank']}: launches {rk['launches']} "
                            f"by variant {by_var}, expected {want} tf32x3 "
                            f"bcoo_spmm ({sweeps} by the sweeps)")
        if h["loss"] != hist["loss"] or h["sub_id"] != hist["sub_id"]:
            problems.append(f"rank {rk['rank']}: losses or tuples differ "
                            "from rank 0's")
        if h["compress"] != [m == "rsc" for m in h["mode"]]:
            problems.append(f"rank {rk['rank']}: compress not exactly on "
                            "the RSC steps")
        at = rk["autotune"]
        if at["stats"]["defaults"] or at["missed"]:
            problems.append(f"rank {rk['rank']}: autotune missed "
                            f"{at['missed']} ({at['stats']})")
        modes = np.asarray(h["mode"])
        step_ms = np.asarray(h["step_time"]) * 1e3
        rsc_ms = step_ms[modes == "rsc"][n_sub // DP_RANKS:]  # past epoch 0
        exact_ms = step_ms[modes == "exact"][1:]
        t = rk["transfer"]["train"]
        pl = rk["planner"]
        red = rk["allreduce"]
        rows.append({
            "rank": rk["rank"], "launches": rk["launches"]["bcoo_spmm"],
            "sweep_launches": sweeps,
            "rsc_step_ms_median": float(np.median(rsc_ms)),
            "exact_step_ms_median": float(np.median(exact_ms)),
            "allreduce_ms_median": float(np.median(red["reduce_ms"])),
            "allreduce_ms_median_rsc": float(np.median(
                np.asarray(red["reduce_ms"])[modes == "rsc"])),
            "f32_bytes_per_step": red["f32_bytes"],
            "int8_bytes_per_step": red["int8_bytes"],
            "buckets": len(red["buckets"]),
            "uploads": t["uploads"],
            "upload_ms_per_step": t["upload_seconds"] * 1e3 / steps,
            "stall_ms_per_step": t["stall_seconds"] * 1e3 / steps,
            "bytes_per_upload": t["upload_bytes"] / max(t["uploads"], 1),
            "planner_ms_per_refresh": pl["host_seconds"] * 1e3
            / max(pl["refreshes"], 1),
            "plan_hit_rate": pl["hit_rate"],
            "peak_mem_gib": (None if rk["peak_mem_bytes"] is None
                             else rk["peak_mem_bytes"] / 2 ** 30),
            "rss_gib_at_end": (None if rk["rss_bytes"] is None
                               else rk["rss_bytes"] / 2 ** 30),
            "setup_s": rk["setup_s"], "run_s": rk["wall_s"]})
    hit = [s["hit_rate"] for s in report["shards"]]
    say(f"[dp train] {argv[1:]}: {steps} global steps "
        f"({int((np.asarray(hist['mode']) == 'rsc').sum())} rsc, compress on "
        f"those), {evals} pooled evaluations on rank 0, wall {wall:.2f} s; "
        f"launches by rank {[r['launches'] for r in rows]} (sweeps "
        f"{[r['sweep_launches'] for r in rows]}), here {here}; flops "
        f"fraction {report['flops_fraction']:.4f}, shard hit rates {hit}, "
        f"best test {report['best_test']:.4f}, loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}; by rank (gloo through the host on one card, "
        f"{smi}): " + "; ".join(
            f"r{r['rank']}: step median rsc {r['rsc_step_ms_median']:.3f} / "
            f"exact {r['exact_step_ms_median']:.3f} ms, all-reduce after the "
            f"backward {r['allreduce_ms_median']:.3f} ms ({r['buckets']} "
            f"buckets, {r['f32_bytes_per_step']} f32 bytes per step, int8 "
            f"codes + scales {r['int8_bytes_per_step']}), upload "
            f"{r['upload_ms_per_step']:.2f} ms and stall "
            f"{r['stall_ms_per_step']:.2f} ms per step, planner "
            f"{r['planner_ms_per_refresh']:.2f} ms per refresh, peak "
            f"{r['peak_mem_gib']} GiB, RSS at the end {r['rss_gib_at_end']} "
            f"GiB, "
            f"setup {r['setup_s']:.1f} s" for r in rows))
    if any(here.values()):
        problems.append(f"this process launched {here}")
    if not report["flops_fraction"] <= 0.1 + 1e-9:
        problems.append(f"flops fraction {report['flops_fraction']}")
    per_epoch = steps // DP_EPOCHS
    if not np.isfinite(losses).all() or \
            not losses[-per_epoch:].mean() < losses[:per_epoch].mean():
        problems.append(f"loss not finite or not falling: {losses}")
    if not all(h > 0 for h in hit):
        problems.append(f"shard hit rates {hit}")
    if problems:
        raise AssertionError("; ".join(problems))
    return sum(r["launches"] for r in rows), {
        "card": smi, "allreduce_route": "gloo through the host, one card",
        "argv": argv, "report": report, "run_s": wall, "steps": steps,
        "evaluations": evals, "ranks": rows,
        "loss_first": float(losses[0]), "loss_last": float(losses[-1])}


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


def flash_sweep(ops, fmod, flash_attention_ref, dev, heads=None,
                lengths=FLASH_LENGTHS, windows=(None, 16, 100), seed=0,
                label="flash sweep") -> dict:
    """Kernel against plain version over b in {1, 2}, ``heads`` ((nq, nkv,
    hd) triples; by default FLASH_HEADS at hd 64 and 128), f32 and bf16,
    ``lengths``, ``windows``, causal and not; each launch counted under
    its variant."""
    if heads is None:
        heads = [(nq, nkv, hd) for nq, nkv in FLASH_HEADS for hd in (64, 128)]
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    worst = {torch.float32: [0.0, 0.0], torch.bfloat16: [0.0, 0.0]}
    n, n_var = 0, {}
    for b in (1, 2):
        for nq, nkv, hd in heads:
            for dtype in (torch.float32, torch.bfloat16):
                for tq, tk in lengths:
                    q = randn(gen, (b, tq, nq, hd), dtype, dev)
                    k = randn(gen, (b, tk, nkv, hd), dtype, dev)
                    v = randn(gen, (b, tk, nkv, hd), dtype, dev)
                    for window in windows:
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
    say(f"[{label}] {n} cases agree ({n_var}); max abs err f32 "
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


def flash_row(q, k, v, fmod, flash_attention_ref, q_chunk, reps,
              window=None) -> dict:
    """Kernel vs plain version, then the times of kernel, plain version
    and SDPA (causal, GQA; with a window, given the band as an explicit
    mask) on these inputs, and the card's bound."""
    F = torch.nn.functional
    b, t, nq, hd = q.shape
    with torch.inference_mode():
        got = fmod.flash_attention(q, k, v, causal=True, window=window)
        ref = flash_attention_ref(q, k, v, causal=True, window=window,
                                  q_chunk=q_chunk)
        err, rel = flash_close(got, ref, q.dtype)
        buf = torch.empty_like(q)
        ms = cuda_ms(lambda: fmod.launch(q, k, v, buf, q_offset=0,
                                         causal=True, window=window), reps)
        plain_ms = cuda_ms(lambda: flash_attention_ref(
            q, k, v, causal=True, window=window, q_chunk=q_chunk), reps=2,
            warmup=1)
        del got
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        kw = dict(is_causal=True, enable_gqa=True)
        if window is not None:
            i = torch.arange(t, device=q.device)
            kw = dict(attn_mask=(i[None, :] <= i[:, None])
                      & (i[None, :] > i[:, None] - window), enable_gqa=True)
        lib = F.scaled_dot_product_attention(qt, kt, vt, **kw)
        lib_err = float((lib.transpose(1, 2).float() - ref.float())
                        .abs().max())
        del lib
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, **kw), reps)
    nkv = k.shape[2]
    flops = fmod.flops(q.shape, k.shape, window=window)
    es = q.element_size()
    nbytes = (2 * b * t * nq * hd + 2 * b * t * nkv * hd) * es
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[q.dtype] * 1e3
    row = dict(b=b, t=t, nq=nq, nkv=nkv, hd=hd, window=window,
               dtype=str(q.dtype), variant=fmod.variant(q.dtype, hd),
               max_abs_err=err, max_row_rel_err=rel,
               sdpa_max_abs_err=lib_err, ms=ms,
               plain_ms=plain_ms, library_ms=library_ms, flops=flops,
               bytes=nbytes, bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               tflops=flops / ms / 1e9)
    say(f"[flash {b}x{t} nq {nq} nkv {nkv} hd {hd} window {window}] "
        f"err={err:.3e} row-rel={rel:.3e} kernel {ms:.4f} "
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


# ------------------------------------------------------- LM families

def family_config(get_arch, name: str):
    """The family's published config; deepseek-v2-236b cut to its dense
    prefix layer and one attn_moe layer (FAMILY_CUT)."""
    cfg = get_arch(name)
    if name in FAMILY_CUT:
        cfg = dataclasses.replace(cfg, n_layers=FAMILY_CUT[name],
                                  n_repeats=FAMILY_CUT[name] - 1)
    cfg.validate()
    return cfg


def kernel_layers(cfg) -> list[int]:
    """Layers whose prefill attention is the flash kernel: self-attention
    without MLA (cross-attention and MLA run the plain jnp-style code, as
    in the reference)."""
    return [i for i, kind in enumerate(cfg.layer_plan())
            if kind in ("attn", "attn_moe", "local") and cfg.mla is None]


def set_gates(net, value: float = 0.5) -> None:
    """Cross layers' ``ffn_gate`` and ``gate`` (0 at init, where such a
    layer adds nothing) set to ``value``."""
    with torch.no_grad():
        for blk in net.layers:
            if blk.kind == "cross":
                blk.ffn_gate.fill_(value)
                blk.attn.gate.fill_(value)


class SectionTimer:
    """Stands in for a module function (``rglru._rg_lru_scan``,
    ``xlstm.slstm_cell``) during one prefill and adds up its time on the
    card (synchronised before and after each call)."""

    def __init__(self, module, name: str):
        self.module, self.name, self.seconds, self.calls = module, name, 0.0, 0

    def __enter__(self):
        self.inner = getattr(self.module, self.name)
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.inner)

    def __call__(self, *args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.inner(*args, **kw)
        torch.cuda.synchronize()
        self.seconds += time.perf_counter() - t0
        self.calls += 1
        return out


def family_qkv(cfg, net, prompt, i, lm):
    """Layer ``i``'s q, k, v of the served prompt: the layers before it
    run in prefill mode on the same parameters and prompt."""
    x = prompt.get("embeds", prompt.get("tokens"))
    t = x.shape[1]
    pos = torch.arange(t, dtype=torch.int32, device=x.device)
    with torch.inference_mode():
        h = x.to(net.embed.dtype) if "embeds" in prompt \
            else net.embed[x.long()]
        for j in range(i):
            h, _ = lm.backbone.layer_apply(
                net.layers[j], cfg, cfg.layer_plan()[j], h, pos,
                mode="prefill", cross_states=prompt.get("cross_states"))
        hn = lm.layers.apply_norm(net.layers[i].ln1, h, cfg.norm_eps)
        return lm.attention._project_qkv(net.layers[i].attn, cfg, hn, pos)


def family_serve(name, serve, ops, fmod, flash_attention_ref, lm, get_arch,
                 init_params, make_batch, dev) -> tuple[dict, int]:
    """Phase 10b for one family: serve it at its published widths (bf16,
    seeded random weights) through the serving entry point with the launch
    counts set to 0 just before and read just after; then a warm run, a
    prefill with the recurrences timed, and the kernel against its plain
    version (and timed) on the first kernel layer's own q/k/v. Returns the
    record and the flash launches of the counted run."""
    cfg = family_config(get_arch, name)
    argv = ["--arch", name, "--batch", str(FAMILY_BATCH), "--prompt-len",
            str(FAMILY_PROMPT), "--gen", str(FAMILY_GEN), "--device", "cuda"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    if name in FAMILY_CUT:     # serve.run builds the published depth
        params = init_params(cfg, 0, dev)
        prompt = make_batch(cfg, "prefill_32k", FAMILY_BATCH, FAMILY_PROMPT,
                            seed=0, device=dev)
        toks, stats, rec = serve.greedy_generate(
            cfg, params, prompt, FAMILY_PROMPT + FAMILY_GEN + 1, FAMILY_GEN)
        out = {"params": params, "prompt": prompt, "tokens": toks,
               "stats": stats, **rec}
    else:
        out = serve.run(serve.build_parser().parse_args(argv))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    by_var = ops.launch_counts_by_variant()["flash_attention"]
    net, prompt = out["params"], out["prompt"]
    layers = kernel_layers(cfg)
    want = len(layers)
    var = fmod.variant(torch.bfloat16, cfg.hd) if layers else None
    say(f"[family {name}] {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"run {wall:.2f} s, tokens {tuple(out['tokens'].shape)}, launches "
        f"{counts}, by phase {out['launches']}, by variant {by_var}")
    if out["launches"]["prefill"]["flash_attention"] != want or \
            out["launches"]["decode"]["flash_attention"] != 0 or \
            counts["flash_attention"] != want:
        raise AssertionError(f"{name}: flash launches {out['launches']}, "
                             f"expected {want} per prefill, 0 in decode")
    if want and (var not in ("wgmma", "wgmma_hd256") or by_var[var] != want):
        raise AssertionError(f"{name}: variants {by_var}, expected {want} "
                             f"on a tensor-core variant")
    if counts["gather_matmul"] or counts["bcoo_spmm"]:
        raise AssertionError(f"{name}: other kernels launched: {counts}")
    for phase, lg in out["logits"].items():
        if not torch.isfinite(lg).all():
            raise AssertionError(f"{name}: {phase} logits not finite")
    if tuple(out["tokens"].shape) != (FAMILY_BATCH, FAMILY_GEN):
        raise AssertionError(f"{name}: tokens {tuple(out['tokens'].shape)}")
    cold = out["stats"]
    _, warm, _ = serve.greedy_generate(cfg, net, prompt,
                                       FAMILY_PROMPT + FAMILY_GEN + 1,
                                       FAMILY_GEN)
    peak = torch.cuda.max_memory_allocated()
    rec = {"arch": name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "cut": FAMILY_CUT.get(name), "run_s": wall,
           "weights_gib": sum(p.numel() * p.element_size()
                              for p in net.parameters()) / 2 ** 30,
           "launches": out["launches"], "launches_by_variant": by_var,
           "variant": var, "cold": cold, "warm": warm,
           "peak_mem_gib": peak / 2 ** 30}
    timers = [SectionTimer(mod, fn) for kind, mod, fn in (
        ("rglru", lm.rglru, "_rg_lru_scan"),
        ("slstm", lm.xlstm, "slstm_cell")) if kind in cfg.layer_plan()]
    if timers:
        prefill = serve.make_prefill_step(cfg)
        with contextlib.ExitStack() as stack:
            for tm in timers:
                stack.enter_context(tm)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            prefill(net, prompt)
            torch.cuda.synchronize()
            t_pf = time.perf_counter() - t0
        rec["timed_prefill_s"] = t_pf
        for tm in timers:
            rec[f"{tm.name.strip('_')}_s"] = tm.seconds
            rec[f"{tm.name.strip('_')}_share_of_prefill"] = tm.seconds / t_pf
    if layers:
        q, k, v = family_qkv(cfg, net, prompt, layers[0], lm)
        window = cfg.local_window if cfg.layer_plan()[layers[0]] == "local" \
            else None
        rec["flash_row"] = flash_row(q, k, v, fmod, flash_attention_ref,
                                     1024, reps=10, window=window)
        del q, k, v
    say(f"[family {name}] cold prefill {cold['prefill_s']:.4f} s, warm "
        f"prefill {warm['prefill_s']:.4f} s, decode {warm['tok_per_s']:.1f} "
        f"tok/s, peak {rec['peak_mem_gib']:.2f} GiB"
        + "".join(f", {k} {v:.4f}" for k, v in rec.items()
                  if k.endswith("share_of_prefill")))
    del out, net, prompt
    gc.collect()
    torch.cuda.empty_cache()
    return rec, counts["flash_attention"]


def family_small_reference(name, serve, smoke_config, make_batch,
                           init_params, dev) -> dict:
    """Phase 10c for one family: prefill + 8 greedy decode steps of its
    f32 smoke config on the card against the same run on the CPU (plain
    versions), one parameter set (cross gates 0.5) on both: identical
    tokens, logits within 1e-4·max|logit| (the tolerance of
    tests/test_torch_lm_families.py), one kernel launch per kernel layer
    in the prefill and none in decode."""
    cfg = dataclasses.replace(smoke_config(name), dtype="float32")
    net = init_params(cfg, seed=0, device="cpu")
    set_gates(net)
    runs = []
    for d, params in (("cpu", net), (dev, copy.deepcopy(net).to(dev))):
        prompt = make_batch(cfg, "prefill_32k", 2, 32, seed=0, device=d)
        toks, _, rec = serve.greedy_generate(cfg, params, prompt, 42, 9)
        runs.append((toks, rec))
    (ctoks, crec), (gtoks, grec) = runs
    want = len(kernel_layers(cfg))
    if grec["launches"]["prefill"]["flash_attention"] != want or \
            grec["launches"]["decode"]["flash_attention"] != 0:
        raise AssertionError(f"{name} smoke launches {grec['launches']}, "
                             f"expected {want} per prefill")
    if not torch.equal(ctoks, gtoks):
        raise AssertionError(f"{name}: tokens differ:\n{ctoks}\n{gtoks}")
    err, scale = 0.0, 0.0
    for phase in ("prefill", "last"):
        ref = crec["logits"][phase]
        got = grec["logits"][phase].cpu()
        scale = max(scale, float(ref.abs().max()))
        torch.testing.assert_close(got, ref, rtol=0,
                                   atol=1e-4 * float(ref.abs().max()))
        err = max(err, float((got - ref).abs().max()))
    say(f"[family reference] smoke {name} f32, 8 decode steps: card = CPU, "
        f"tokens identical, max abs logit err {err:.3e} (max |logit| "
        f"{scale:.3e}), {want} kernel launches per prefill")
    return {"max_abs_logit_err": err, "max_abs_logit": scale,
            "launches": grec["launches"]}


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


def family_train_small_reference(name, ops, gmod, smoke_config,
                                 make_batch, init_params, make_train_step,
                                 Adam, dev) -> dict:
    """Phase 12b for one family: 3 RSC training steps (keep 0.5, bk 32, 2
    microbatches of 2 × 64 tokens) of its f32 smoke config on the card
    against the same steps on the CPU, from one parameter set (cross gates
    0.5): equal selected blocks, losses within 1e-5 relative, or within
    twice what the CPU run's own losses move when every weight moves by
    one unit in the last place, where that is more (the xLSTM smoke model
    is that ill-conditioned); and one gather_matmul launch per RSC'd MLP
    linear per microbatch (3 for a gated MLP, 2 for gelu's; MoE experts,
    shared experts and xLSTM's cells take no RSC)."""
    cfg = dataclasses.replace(smoke_config(name), dtype="float32")
    rsc = {"keep_frac": 0.5, "bk": 32, "backend": "kernel"}
    steps, n_mb = 3, 2
    cpu_net = init_params(cfg, seed=0, device="cpu")
    set_gates(cpu_net)
    card_net = copy.deepcopy(cpu_net).to(dev)
    nudged = copy.deepcopy(cpu_net)
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for p in nudged.parameters():
            p.mul_(1 + 2.0 ** -23 * torch.from_numpy(
                rng.choice([-1.0, 1.0], tuple(p.shape))).to(p.dtype))
    runs = []
    for d, net in (("cpu", cpu_net), (dev, card_net), ("cpu", nudged)):
        opt = Adam(lr=1e-3, clip_norm=1.0)
        state = opt.init(dict(net.named_parameters()))
        step = make_train_step(cfg, opt, n_mb, rsc=rsc)
        losses = []
        ops.reset_launch_counts()
        with GatherTap(gmod) as tap:
            for i in range(steps):
                batch = make_batch(cfg, "train_4k", 4, 64, seed=i, device=d)
                net, state, loss = step(net, state, batch)
                losses.append(float(loss))
        runs.append((losses, [t.cpu().tolist() for t in tap.idx],
                     ops.launch_counts()["gather_matmul"]))
    (closs, cidx, claunch), (gloss, gidx, glaunch), (nloss, _, _) = runs
    per_mlp = 3 if cfg.mlp in ("swiglu", "geglu") else 2
    n_mlp = sum(blk.mlp is not None for blk in cpu_net.layers)
    want = per_mlp * n_mlp * n_mb * steps
    own = max(abs(a - b) / abs(a) for a, b in zip(closs, nloss))
    rtol = max(1e-5, 2 * own)
    say(f"[family train reference] smoke {name} f32 RSC, {steps} steps: "
        f"launches CPU {claunch}, card {glaunch} of {want} ({n_mlp} RSC'd "
        f"MLPs); losses {gloss} (CPU {closs}, rtol {rtol:.0e})")
    if claunch != 0 or glaunch != want or len(gidx) != want:
        raise AssertionError(f"{name}: gather_matmul launches: CPU "
                             f"{claunch}, card {glaunch} of {want}")
    if cidx != gidx:
        raise AssertionError(f"{name}: selected blocks differ:\n{cidx}\n"
                             f"{gidx}")
    np.testing.assert_allclose(gloss, closs, rtol=rtol)
    return {"losses_card": gloss, "losses_cpu": closs, "launches": glaunch,
            "rsc_mlps": n_mlp, "loss_rtol": rtol}


def lm_train_main_path(train, ops, gmod, gather_matmul_ref, argv):
    """The full-width training run, with the launch counts set to 0 just
    before and read just after; the kernel against its plain version on
    the first (x, g, idx) of each shape the run gave it."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with GatherTap(gmod) as tap, \
            ParamSnapshot(train, MESH_FULL_STEPS, MESH_SNAPSHOT) as snap:
        out = train.main(argv)
    torch.cuda.synchronize()
    if not snap.saved:
        raise AssertionError("phase 13's parameters after "
                             f"{MESH_FULL_STEPS} steps were not saved")
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


def rsc_skipped_flops(cfg, args) -> int:
    """The FLOPs of the MLP weight-gradient products that RSC skips in
    one training step of dense ``cfg`` (``train lm`` ``args``): each
    product contracts ``keep_count`` of its microbatch's 128-token blocks
    (``core.rsc_matmul``), not all of them."""
    from repro_torch.core.rsc_matmul import keep_count
    if cfg.family != "dense" or cfg.moe is not None:
        raise ValueError(f"{cfg.family}: only a dense MLP's count is kept")
    bk = 128
    n = args.batch // args.microbatches * args.seq
    if n % bk:
        return 0                       # a ragged tail takes the exact dW
    skipped = (n // bk - keep_count(n, args.rsc_keep, bk)) * bk
    products = {"swiglu": 3, "geglu": 3, "gelu": 2}[cfg.mlp]
    return (args.microbatches * cfg.n_layers * products
            * 2 * skipped * cfg.d_model * cfg.d_ff)


def dryrun_check(dryrun, get_arch, args, warm: dict, peak: int, ops,
                 smi: str) -> dict:
    """Phase 14b (a): phase 13's step on meta tensors (no RSC) against
    the card's run of it: peaks, their ratio, and the FLOPs of the timed
    RSC step (the dry run's less ``rsc_skipped_flops``) over the measured
    warm step."""
    cfg = get_arch(args.arch)
    ops.reset_launch_counts()
    rec = dryrun.lower_step(cfg, "train", batch=args.batch,
                            seq=args.seq, n_microbatches=args.microbatches)
    launched = ops.launch_counts()
    ratio = rec["peak_bytes"] / peak
    skipped = rsc_skipped_flops(cfg, args) if args.rsc else 0
    step_flops = rec["flops"] - skipped
    tflops = step_flops / warm["warm_step_s"] / 1e12
    out = {"arch": args.arch, "batch": args.batch, "seq": args.seq,
           "microbatches": args.microbatches,
           "dryrun_peak_bytes": rec["peak_bytes"],
           "measured_peak_bytes": peak, "ratio": ratio,
           "dryrun_flops": rec["flops"], "rsc_skipped_flops": skipped,
           "step_flops": step_flops, "lower_s": rec["lower_s"],
           "warm_step_s": warm["warm_step_s"], "tflops": tflops,
           "share_of_bf16_peak": tflops * 1e12 / PEAK_FLOPS[torch.bfloat16],
           "per_rank": dryrun.per_rank_bytes(
               get_arch(args.arch), "train", args.batch, args.seq, None),
           "card_memory_bytes": torch.cuda.get_device_properties(0)
           .total_memory, "card": smi}
    say(f"[dryrun] {args.arch} batch {args.batch} x {args.seq}, "
        f"{args.microbatches} microbatches: dry-run peak "
        f"{rec['peak_bytes'] / 2 ** 30:.3f} GiB, measured "
        f"{peak / 2 ** 30:.3f} GiB (ratio {ratio:.4f}); "
        f"{rec['flops']:.4e} FLOPs without RSC, less RSC's skipped "
        f"{skipped:.4e}: {step_flops:.4e} over the warm step "
        f"{warm['warm_step_s']:.4f} s = {tflops:.2f} TFLOP/s, "
        f"{out['share_of_bf16_peak']:.4f} of the bf16 dense peak; "
        f"card memory {out['card_memory_bytes']} B ({smi}); "
        f"run {rec['lower_s']} s on the host")
    if any(launched.values()):
        raise AssertionError(f"the dry run launched kernels: {launched}")
    if ratio < 1 - DRYRUN_UNDER:
        raise AssertionError(f"the dry run's peak is {1 - ratio:.1%} below "
                             f"the measured one (limit {DRYRUN_UNDER:.0%})")
    return out


class SpmmFirstCalls:
    """Stands in for ``bcoo_spmm`` and ``bcoo_spmm_in_range`` (the GNN
    path's two SpMM entries): every call passes through unchanged (the
    wrapper still counts its own launches), and the first call of each
    signature (width, plan length, row blocks, epilogue) keeps copies of
    its inputs and of the output it returned."""

    NAMES = ("bcoo_spmm", "bcoo_spmm_in_range")

    def __init__(self, kmod):
        self.kmod, self.calls = kmod, {}

    def __enter__(self):
        self.inner = {n: getattr(self.kmod, n) for n in self.NAMES}
        for n in self.NAMES:
            setattr(self.kmod, n, functools.partial(self._call, n))
        return self

    def __exit__(self, *exc):
        for n, fn in self.inner.items():
            setattr(self.kmod, n, fn)

    def _call(self, name, *args, **kw):
        out = self.inner[name](*args, **kw)
        key = (args[4].shape[1], args[1].shape[0], kw["n_row_blocks"],
               kw.get("bias") is not None, kw.get("residual") is not None,
               kw.get("relu", False))
        if key not in self.calls:
            def keep(t):
                return t.detach().clone() if torch.is_tensor(t) else t
            self.calls[key] = ([keep(a) for a in args],
                               {k: keep(v) for k, v in kw.items()},
                               keep(out))
        return out


def quickstart_on_card(ops, kmod, bcoo_spmm_ref,
                       smi: str) -> tuple[int, dict]:
    """Phase 14b (b): the quickstart's two trainings on the card, through
    ``bcoo_spmm``; its launches; the output of each SpMM signature's
    first call against the plain version on that call's inputs."""
    import importlib.util
    spec = importlib.util.spec_from_file_location("torch_quickstart",
                                                  QUICKSTART)
    qs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(qs)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with SpmmFirstCalls(kmod) as tap:
        base, rsc = qs.run("cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    by_var = ops.launch_counts_by_variant()["bcoo_spmm"]
    errs = []
    with torch.no_grad():
        for args, kw, got in tap.calls.values():
            ref = bcoo_spmm_ref(*args, n_row_blocks=kw["n_row_blocks"],
                                bm=kw["bm"], bk=kw["bk"],
                                bias=kw.get("bias"),
                                residual=kw.get("residual"),
                                relu=kw.get("relu", False))
            if got.shape != ref.shape or got.dtype != args[0].dtype:
                raise AssertionError(f"quickstart SpMM gave {got.dtype} "
                                     f"{tuple(got.shape)}, plain "
                                     f"{tuple(ref.shape)}")
            errs.append(assert_close(got, ref, args[0].dtype))
    widths = sorted({k[0] for k in tap.calls})
    out = {"baseline_test": base["best_test"], "rsc_test": rsc["best_test"],
           "flops_fraction": rsc["flops_fraction"],
           "refreshes": rsc["cache_stats"].refreshes, "run_s": wall,
           "launches": counts["bcoo_spmm"], "by_variant": by_var,
           "signatures_checked": len(errs), "widths": widths,
           "max_abs_err": max(errs, default=0.0), "card": smi}
    say(f"[quickstart] baseline test {base['best_test']:.4f}, RSC "
        f"{rsc['best_test']:.4f}, flops kept {rsc['flops_fraction']:.4f}, "
        f"{wall:.2f} s, launches {counts}, bcoo_spmm by variant {by_var}; "
        f"{len(errs)} SpMM signatures (widths {widths}) against the plain "
        f"version: max abs err {out['max_abs_err']:.3e}")
    if counts["bcoo_spmm"] == 0 or counts["flash_attention"] \
            or counts["gather_matmul"]:
        raise AssertionError(f"quickstart launches {counts}: bcoo_spmm only")
    if not {64, 10} <= set(widths):
        raise AssertionError(f"quickstart SpMM widths {widths}: expected "
                             "the hidden 64 and the 10 classes")
    if not rsc["best_test"] > base["best_test"] - 0.05:
        raise AssertionError("the quickstart's RSC run is more than 0.05 "
                             "below its baseline")
    if not rsc["flops_fraction"] <= 0.1:
        raise AssertionError(f"flops_fraction {rsc['flops_fraction']} over "
                             "the 0.1 budget")
    return counts["bcoo_spmm"], out


class ParamSnapshot:
    """Saves a ``train lm`` run's parameters after its first ``after``
    steps to ``path`` (``{name: CPU tensor}``), outside the step timer:
    ``train.make_train_step`` is wrapped to learn the module, and
    ``train.make_batch`` saves it when the batch of step ``after`` is
    drawn, before that step's clock starts."""

    def __init__(self, train, after: int, path: Path):
        self.train, self.after, self.path = train, after, path
        self.params, self.saved = None, False

    def __enter__(self):
        self.inner = (self.train.make_train_step, self.train.make_batch)
        inner_step, inner_batch = self.inner

        def make_train_step(*a, **k):
            step = inner_step(*a, **k)

            def wrapped(params, *rest):
                self.params = params
                return step(params, *rest)
            return wrapped

        def make_batch(*a, seed=0, **k):
            if seed == self.after and self.params is not None \
                    and not self.saved:
                self.path.parent.mkdir(parents=True, exist_ok=True)
                torch.save({n: p.detach().cpu() for n, p in
                            self.params.named_parameters()}, self.path)
                self.saved = True
            return inner_batch(*a, seed=seed, **k)
        self.train.make_train_step, self.train.make_batch = (make_train_step,
                                                            make_batch)
        return self

    def __exit__(self, *exc):
        self.train.make_train_step, self.train.make_batch = self.inner
        self.params = None


def mesh_recorder():
    """Record every global block selection of the sharded RSC dW (the
    ``top_blocks`` call of ``core.rsc_matmul.sharded_xt_g``)."""
    import importlib
    mod = importlib.import_module("repro_torch.core.rsc_matmul")
    log, inner = [], mod.top_blocks

    def top_blocks(scores, keep):
        idx = inner(scores, keep)
        log.append(idx.cpu().tolist())
        return idx
    mod.top_blocks = top_blocks
    return log


def mesh_small_rank(mesh, meshes, starts: dict, log) -> dict:
    """Phase 13b (a) on one rank: each smoke arch's 3 RSC steps on the
    mesh, its blocks' shapes, and the reshard onto the smaller meshes."""
    from repro_torch import convert
    from repro_torch.configs import make_batch, smoke_config
    from repro_torch.distributed.elastic import gather_tree, reshard_tree
    from repro_torch.kernels import ops
    from repro_torch.train.lm_steps import local_batch, \
        make_sharded_train_step
    from repro_torch.train.optimizer import Adam
    dev = mesh.device
    out = {}
    for arch in MESH_SMALL:
        cfg = dataclasses.replace(smoke_config(arch), dtype="float32")
        state = convert.lm_sharded_from_numpy(cfg, starts[arch], mesh, dev)
        opt = Adam(lr=1e-3, clip_norm=1.0)
        ost = opt.init(state.shards)
        step = make_sharded_train_step(
            cfg, opt, mesh, 2, {"keep_frac": 0.5, "bk": 32,
                                "backend": "kernel"})
        ops.reset_launch_counts()
        log.clear()
        losses = []
        for i in range(MESH_SMALL_STEPS):
            batch = make_batch(cfg, "train_4k", 4, 64, seed=i, device=dev)
            state, ost, loss = step(state, ost, local_batch(batch, mesh, 2))
            losses.append(float(loss))
        full_shapes = {n: tuple(p.shape)
                       for n, p in state.skeleton.named_parameters()}
        shapes_ok = all(
            tuple(t[n].shape) == state.shardings[n].local_shape(
                full_shapes[n])
            for t in (state.shards, ost["m"], ost["v"]) for n in t)
        full = {k: gather_tree(t, state.shardings) for k, t in
                (("p", state.shards), ("m", ost["m"]), ("v", ost["v"]))}
        exact = {}
        for sizes, m2 in meshes.items():
            if sizes == MESH or not m2.member:
                continue
            sh2 = convert.lm_param_shardings(cfg, m2)
            back = {k: gather_tree(reshard_tree(t, sh2), sh2)
                    for k, t in full.items()}
            exact[sizes] = all(torch.equal(back[k][n], full[k][n])
                               for k in full for n in full[k])
        out[arch] = {"losses": losses, "sel": list(log),
                     "launches": ops.launch_counts()["gather_matmul"],
                     "skipped": ops.skipped_counts()["gather_matmul"],
                     "shapes_ok": shapes_ok, "exact": exact,
                     "params": convert.lm_sharded_to_numpy(state)}
        del state, ost, full
    return out


def mesh_full_rank(group, mesh, snapshot: str, cfg, shape: tuple,
                   steps: int) -> dict:
    """Phase 13b (b) (full-width qwen3-1.7b) and 13c (b) (deepseek cut in
    depth) on one rank: ``cfg`` at ``shape`` (batch, seq, microbatches),
    ``steps`` steps on the mesh from the seeded parameters, launch counts
    and collective statistics set to 0 just before and read just after;
    the parameters against the one-process run's after as many steps
    (``snapshot``); the kernel on the path's own operands; a MoE's
    routing of this rank's rows."""
    from repro_torch.configs import make_batch
    from repro_torch.kernels import gather_matmul as gmod
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import gather_matmul_ref
    from repro_torch.models.lm.backbone import init_sharded_params
    from repro_torch.train.lm_steps import local_batch, \
        make_sharded_train_step
    from repro_torch.train.optimizer import Adam
    dev = mesh.device
    batch_rows, seq, n_mb = shape
    state = init_sharded_params(cfg, mesh, seed=0, device=dev)
    opt = Adam(lr=3e-4, clip_norm=1.0)      # train lm's defaults
    ost = opt.init(state.shards)
    step = make_sharded_train_step(cfg, opt, mesh, n_mb,
                                   {"keep_frac": 0.5, "backend": "kernel"})
    losses, step_s = [], []
    group.barrier()
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    mesh.reset_stats()
    with GatherTap(gmod) as tap, RouteTap() as routes:
        for i in range(steps):
            batch = local_batch(make_batch(cfg, "train_4k", batch_rows, seq,
                                           seed=i, device=dev), mesh, n_mb)
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            state, ost, loss = step(state, ost, batch)
            losses.append(float(loss))
            step_s.append(time.perf_counter() - t0)
    counts = ops.launch_counts()
    by_var = ops.launch_counts_by_variant()["gather_matmul"]
    skipped = ops.skipped_counts()["gather_matmul"]
    stats = copy.deepcopy(mesh.stats)
    peak = torch.cuda.max_memory_allocated(dev)
    full_shapes = {n: tuple(p.shape)
                   for n, p in state.skeleton.named_parameters()}
    p_bytes = sum(t.numel() * t.element_size() for t in state.shards.values())
    mom_bytes = sum(t.numel() * t.element_size()
                    for k in ("m", "v") for t in ost[k].values())
    spec_bytes = sum(math.prod(state.shardings[n].local_shape(s))
                     * state.shards[n].element_size()
                     for n, s in full_shapes.items())
    full_bytes = sum(math.prod(s) * state.shards[n].element_size()
                     for n, s in full_shapes.items())
    snap = torch.load(snapshot, mmap=True)
    worst, worst_name = 0.0, None
    with torch.no_grad():
        for n, t in state.shards.items():
            ref = state.shardings[n].local(snap[n]).to(dev)
            d = float((t.float() - ref.float()).abs().max())
            if d >= worst:
                worst, worst_name = d, n
    del snap
    checks, rows = {}, []
    group.barrier()
    if group.rank == 0:    # the other ranks wait at the next barrier
        for (xs, gs), (x, g, idx, bk) in tap.first.items():
            got = gmod.gather_matmul(x, g, idx, bk=bk)
            checks[f"{xs[1]}x{gs[1]}"] = gather_close(
                got, gather_matmul_ref(x, g, idx, bk=bk), x.dtype)
            rows.append(gather_row(x, g, idx, bk, gmod, gather_matmul_ref))
    group.barrier()
    del state, ost, tap
    torch.cuda.empty_cache()
    return {"n_layers": cfg.n_layers, "losses": losses, "step_s": step_s,
            "launches": counts,
            "gather_by_variant": by_var, "skipped": skipped,
            "collectives": stats, "peak_mem_bytes": peak,
            "param_bytes": p_bytes, "moment_bytes": mom_bytes,
            "spec_param_bytes": spec_bytes, "full_param_bytes": full_bytes,
            "max_param_diff": worst, "max_param_diff_name": worst_name,
            "kernel_checks": checks, "gather_rows": rows,
            "routes": routes.log, "data_index": mesh.index(mesh.dp_axes)}


def mesh_rank(group, starts: dict, snapshot: str, family_starts: dict,
              moe_snapshot: str, serve_inputs: dict, serve_feed) -> dict:
    """Phases 13b, 13c and 13d on one of the 4 ranks: 13b (a) and (b),
    13c (a) and (b), then 13d (a) and (b)."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import Mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    meshes = {s: Mesh(s, ("data", "model")).bind(group.device)
              for s in (MESH, (2, 1), (1, 1))}
    log = mesh_recorder()
    small = mesh_small_rank(meshes[MESH], meshes, starts, log)
    torch.cuda.empty_cache()
    full = mesh_full_rank(group, meshes[MESH], snapshot,
                          get_arch(MESH_FULL[0]), MESH_FULL[1:],
                          MESH_FULL_STEPS)
    families = mesh_family_rank(meshes[MESH], family_starts, log)
    torch.cuda.empty_cache()
    moe = mesh_full_rank(group, meshes[MESH], moe_snapshot,
                         moe_full_config(), MOE_FULL[1:], MOE_FULL_STEPS)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    serve_small = mesh_serve_small_rank(meshes[MESH], serve_inputs)
    serve_small_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    serve_full = mesh_serve_full_rank(group, meshes[MESH], serve_feed)
    return {"rank": group.rank, "small": small, "full": full,
            "families": families, "moe_full": moe,
            "serve_small": serve_small, "serve_full": serve_full,
            "serve_s": {"small": serve_small_s,
                        "full": time.perf_counter() - t0}}


def mesh_small_reference(ops, gmod, dev) -> tuple[dict, dict]:
    """The one-process runs of 13b (a) on the card: each smoke arch's 3
    RSC steps from its seeded parameters (and from those parameters one
    unit in the last place away), with the selected blocks; returns the
    starting trees (numpy, for the ranks) and the runs."""
    from repro_torch import convert
    from repro_torch.configs import make_batch, smoke_config
    from repro_torch.models.lm.backbone import init_params
    from repro_torch.train.lm_steps import make_train_step
    from repro_torch.train.optimizer import Adam
    starts, runs = {}, {}
    rng = np.random.default_rng(0)
    for arch in MESH_SMALL:
        cfg = dataclasses.replace(smoke_config(arch), dtype="float32")
        starts[arch] = convert.lm_params_to_numpy(
            init_params(cfg, seed=0, device="cpu"), cfg)
        trees = [starts[arch], _nudge_tree(starts[arch], rng)]
        runs[arch] = []
        for tree in trees:
            net = convert.lm_params_from_numpy(cfg, tree, dev)
            opt = Adam(lr=1e-3, clip_norm=1.0)
            st = opt.init(dict(net.named_parameters()))
            step = make_train_step(cfg, opt, 2, rsc={
                "keep_frac": 0.5, "bk": 32, "backend": "kernel"})
            losses = []
            with GatherTap(gmod) as tap:
                for i in range(MESH_SMALL_STEPS):
                    batch = make_batch(cfg, "train_4k", 4, 64, seed=i,
                                       device=dev)
                    net, st, loss = step(net, st, batch)
                    losses.append(float(loss))
            runs[arch].append({"losses": losses,
                               "sel": [t.cpu().tolist() for t in tap.idx],
                               "params": convert.lm_params_to_numpy(net,
                                                                    cfg)})
    return starts, runs


def _nudge_tree(tree, rng):
    """Every leaf one unit in the last place of f32 up or down."""
    if isinstance(tree, dict):
        return {k: _nudge_tree(v, rng) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_nudge_tree(v, rng) for v in tree)
    a = np.asarray(tree, np.float32)
    return a * (1 + np.float32(2.0 ** -23) * rng.choice(
        np.array([-1, 1], np.float32), a.shape))


def _tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _tree_leaves(v)]
    return [np.asarray(tree, np.float32)]


def lm_mesh_phase(train_losses: list, ops, gmod, dev, smi: str,
                  family_starts: dict, serve_inputs: dict,
                  serve_feed) -> tuple[dict, list]:
    """Phase 13b: the one-process references, then the 4 ranks (which
    go on to 13c with ``family_starts`` and MOE_SNAPSHOT, and to 13d with
    ``serve_inputs`` and ``serve_feed``); every check of (a) and (b)
    against their results. Returns 13b's slice and the ranks' results."""
    from repro_torch.distributed import launch, plan_group
    starts, refs = mesh_small_reference(ops, gmod, dev)
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    ranks = launch(mesh_rank, (starts, str(MESH_SNAPSHOT), family_starts,
                               str(MOE_SNAPSHOT), serve_inputs, serve_feed),
                   plan=plan_group(4, force_host_devices=4, device=str(dev)),
                   threads=2)
    run_s = time.perf_counter() - t0
    if sum(ops.launch_counts().values()):
        raise AssertionError("this process launched kernels during 13b")
    out = {"run_s": run_s, "small": {}, "card": smi}
    # (a)
    for arch in MESH_SMALL:
        ref, nudged = refs[arch]
        got = [r["small"][arch] for r in ranks]
        want_calls = 3 * 2 * 2 * MESH_SMALL_STEPS
        for r, g in enumerate(got):
            if g["sel"] != ref["sel"]:
                raise AssertionError(f"13b {arch}: rank {r}'s selected "
                                     f"blocks differ:\n{g['sel']}\n"
                                     f"{ref['sel']}")
            if g["launches"] + g["skipped"] != want_calls:
                raise AssertionError(f"13b {arch}: rank {r} launched "
                                     f"{g['launches']} + skipped "
                                     f"{g['skipped']} of {want_calls}")
            if not g["shapes_ok"]:
                raise AssertionError(f"13b {arch}: rank {r}'s blocks are "
                                     "not its spec's share")
        for sizes in ((2, 1), (1, 1)):
            flags = [g["exact"][sizes] for g in got if sizes in g["exact"]]
            if len(flags) != math.prod(sizes) or not all(flags):
                raise AssertionError(f"13b {arch}: the reshard onto {sizes} "
                                     f"is not bit-identical ({flags})")
        np.testing.assert_allclose(got[0]["losses"], ref["losses"],
                                   rtol=1e-5)
        start = _tree_leaves(starts[arch])
        worst = 0.0
        for o, rr, r2, p0 in zip(_tree_leaves(got[0]["params"]),
                                 _tree_leaves(ref["params"]),
                                 _tree_leaves(nudged["params"]), start):
            moved = rr - p0
            norm = max(np.linalg.norm(moved), 1e-30)
            lim = max(TRAIN_DP_REL, 2 * np.linalg.norm(r2 - p0 - moved)
                      / norm)
            err = np.linalg.norm(o - p0 - moved) / norm
            if err > lim:
                raise AssertionError(f"13b {arch}: a parameter's change "
                                     f"differs by {err:.3e} of its norm "
                                     f"(limit {lim:.3e})")
            worst = max(worst, float(err))
        out["small"][arch] = {
            "losses": got[0]["losses"], "losses_one_process": ref["losses"],
            "max_param_change_err": worst,
            "launches": [g["launches"] for g in got],
            "skipped": [g["skipped"] for g in got],
            "reshard_exact": {str(k): v for g in got
                              for k, v in g["exact"].items()}}
        say(f"[mesh small] {arch} f32 smoke on {MESH}: losses "
            f"{got[0]['losses']} (one process {ref['losses']}), selected "
            f"blocks equal on every rank, largest parameter-change error "
            f"{worst:.3e}, launches {out['small'][arch]['launches']} + "
            f"skipped {out['small'][arch]['skipped']}, reshard onto (2, 1) "
            f"and (1, 1) bit-identical")
    # (b)
    fulls = [r["full"] for r in ranks]
    want = 3 * fulls[0]["n_layers"] * MESH_FULL[3] * MESH_FULL_STEPS
    for r, f in enumerate(fulls):
        calls = f["launches"]["gather_matmul"] + f["skipped"]
        if calls != want or f["launches"]["flash_attention"] != 0 \
                or f["launches"]["bcoo_spmm"] != 0:
            raise AssertionError(f"13b rank {r}: launches {f['launches']} "
                                 f"+ skipped {f['skipped']}, expected "
                                 f"{want} gather_matmul calls and nothing "
                                 "else")
        if f["gather_by_variant"].get("wgmma", 0) != \
                f["launches"]["gather_matmul"]:
            raise AssertionError(f"13b rank {r}: gather_matmul variants "
                                 f"{f['gather_by_variant']}")
        if f["losses"] != fulls[0]["losses"]:
            raise AssertionError("13b: the ranks' losses differ")
        if f["param_bytes"] != f["spec_param_bytes"]:
            raise AssertionError(f"13b rank {r}: {f['param_bytes']} "
                                 "parameter bytes, the spec's share is "
                                 f"{f['spec_param_bytes']}")
        if f["max_param_diff"] > MESH_PARAM_ATOL:
            raise AssertionError(f"13b rank {r}: {f['max_param_diff_name']} "
                                 f"differs from phase 13's by "
                                 f"{f['max_param_diff']:.3e}")
    ref_losses = train_losses[:MESH_FULL_STEPS]
    loss_err = max(abs(a - b) for a, b in zip(fulls[0]["losses"],
                                               ref_losses))
    if not loss_err < MESH_LOSS_ATOL:
        raise AssertionError(f"13b losses {fulls[0]['losses']} against "
                             f"phase 13's {ref_losses}")
    checks = fulls[0]["kernel_checks"]
    per_step = {op: {k: v / MESH_FULL_STEPS for k, v in st.items()}
                for op, st in fulls[0]["collectives"].items()}
    out["full"] = {"ranks": fulls, "losses": fulls[0]["losses"],
                   "phase13_losses": ref_losses, "loss_err": loss_err,
                   "collectives_per_step_rank0": per_step,
                   "launches": sum(f["launches"]["gather_matmul"]
                                   for f in fulls),
                   "skipped": sum(f["skipped"] for f in fulls)}
    state_gb = [round((f["param_bytes"] + f["moment_bytes"]) / 1e9, 3)
                for f in fulls]
    say(f"[mesh train] qwen3-1.7b on {MESH} ({smi}): losses "
        f"{fulls[0]['losses']} (phase 13 {ref_losses}, err {loss_err:.2e}); "
        f"largest parameter difference "
        f"{max(f['max_param_diff'] for f in fulls):.3e}; gather_matmul per "
        f"rank {[f['launches']['gather_matmul'] for f in fulls]} + skipped "
        f"{[f['skipped'] for f in fulls]}; step s "
        f"{[[round(s, 3) for s in f['step_s']] for f in fulls]} (medians "
        f"{[round(float(np.median(f['step_s'])), 3) for f in fulls]}); "
        f"peak GiB "
        f"{[round(f['peak_mem_bytes'] / 2 ** 30, 2) for f in fulls]}; "
        f"parameter + moment GB per rank {state_gb}"
        f" (parameters {fulls[0]['param_bytes'] / 1e9:.3f} of "
        f"{fulls[0]['full_param_bytes'] / 1e9:.3f}); rank 0 collectives "
        f"per step {json.dumps(per_step)}; kernel = plain version {checks}")
    return out, ranks


class RouteTap:
    """Stands in for ``models.lm.moe.route`` while a run is driven: every
    routing passes through unchanged, and the expert ids of the forward's
    (not of a backward's recomputation) are kept, on the CPU."""

    def __enter__(self):
        import importlib
        self.mod = importlib.import_module("repro_torch.models.lm.moe")
        self.inner, self.log = self.mod.route, []
        self.mod.route = self
        return self

    def __exit__(self, *exc):
        self.mod.route = self.inner

    def __call__(self, p, cfg, x):
        r = self.inner(p, cfg, x)
        if torch._C._current_graph_task_id() == -1:
            self.log.append(r["expert"].cpu())
        return r


class PlainSGD:
    """``p ← p − lr·g`` with ``train.optimizer.Adam``'s interface (13c
    (a); see MESH_FAMILY_STEPS)."""

    lr = MESH_FAMILY_LR

    def init(self, params):
        return {"count": 0}

    def update(self, grads, state, params, shardings=None):
        return ({k: -self.lr * g.float() for k, g in grads.items()},
                {"count": state["count"] + 1})


def moe_full_config():
    """deepseek-v2-lite-16b at its published widths, cut to its dense
    first layer and MOE_FULL_LAYERS - 1 MoE layers."""
    from repro_torch.configs import get_arch
    cfg = get_arch(MOE_FULL[0])
    return dataclasses.replace(cfg, n_layers=MOE_FULL_LAYERS,
                               n_repeats=MOE_FULL_LAYERS - len(cfg.prefix))


def rsc_calls(cfg) -> int:
    """The RSC'd linears of one forward: 3 per gated MLP, 2 per gelu MLP
    (MoE experts, shared experts and xLSTM's cells take no RSC)."""
    from repro_torch.models.lm.backbone import LM
    per_mlp = 3 if cfg.mlp in ("swiglu", "geglu") else 2
    return per_mlp * sum(blk.mlp is not None
                         for blk in LM(cfg, "meta").layers)


def mesh_family_reference(ops, gmod, dev) -> tuple[dict, dict]:
    """13c (a)'s one-process runs on the card: each family's f32 smoke
    config (cross gates 0.5), MESH_FAMILY_STEPS RSC steps from its seeded
    parameters and from those one unit in the last place away, with the
    selected blocks and the MoE routing; returns the starting trees
    (numpy, for the ranks) and the runs."""
    from repro_torch import convert
    from repro_torch.configs import make_batch, smoke_config
    from repro_torch.models.lm.backbone import init_params
    from repro_torch.train.lm_steps import make_train_step
    starts, runs = {}, {}
    rng = np.random.default_rng(0)
    for arch in MESH_FAMILIES:
        cfg = dataclasses.replace(smoke_config(arch), dtype="float32")
        net = init_params(cfg, seed=0, device="cpu")
        set_gates(net)
        starts[arch] = convert.lm_params_to_numpy(net, cfg)
        runs[arch] = []
        for tree in (starts[arch], _nudge_tree(starts[arch], rng)):
            net = convert.lm_params_from_numpy(cfg, tree, dev)
            opt = PlainSGD()
            st = opt.init(dict(net.named_parameters()))
            step = make_train_step(cfg, opt, 2, rsc={
                "keep_frac": 0.5, "bk": 32, "backend": "kernel"})
            losses = []
            with GatherTap(gmod) as tap, RouteTap() as routes:
                for i in range(MESH_FAMILY_STEPS):
                    batch = make_batch(cfg, "train_4k", 4, 64, seed=i,
                                       device=dev)
                    net, st, loss = step(net, st, batch)
                    losses.append(float(loss))
            runs[arch].append({"losses": losses,
                               "sel": [t.cpu().tolist() for t in tap.idx],
                               "routes": routes.log,
                               "params": convert.lm_params_to_numpy(net,
                                                                    cfg)})
    return starts, runs


def moe_full_reference(ops, dev) -> dict:
    """13c (b)'s one-process step on the card: the cut deepseek from its
    seeded parameters, MOE_FULL_STEPS steps of MOE_FULL's batch (Adam and
    clip of ``train lm``'s defaults), its routing, loss and step time;
    the parameters after it saved to MOE_SNAPSHOT for the ranks."""
    from repro_torch.configs import make_batch
    from repro_torch.models.lm.backbone import init_params
    from repro_torch.train.lm_steps import make_train_step
    from repro_torch.train.optimizer import Adam
    cfg = moe_full_config()
    _, rows, seq, n_mb = MOE_FULL
    net = init_params(cfg, seed=0, device=dev)
    opt = Adam(lr=3e-4, clip_norm=1.0)
    st = opt.init(dict(net.named_parameters()))
    step = make_train_step(cfg, opt, n_mb, rsc={"keep_frac": 0.5,
                                                "backend": "kernel"})
    losses, step_s = [], []
    torch.cuda.reset_peak_memory_stats(dev)
    with RouteTap() as routes:
        for i in range(MOE_FULL_STEPS):
            batch = make_batch(cfg, "train_4k", rows, seq, seed=i,
                               device=dev)
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            net, st, loss = step(net, st, batch)
            losses.append(float(loss))
            step_s.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated(dev)
    MOE_SNAPSHOT.parent.mkdir(parents=True, exist_ok=True)
    torch.save({n: p.detach().cpu() for n, p in net.named_parameters()},
               MOE_SNAPSHOT)
    n_params = sum(p.numel() for p in net.parameters())
    del net, st
    torch.cuda.empty_cache()
    say(f"[mesh moe reference] {cfg.name} cut to {cfg.n_layers} layers "
        f"({n_params / 1e9:.3f} B parameters), one process: losses "
        f"{losses}, step s {[round(x, 3) for x in step_s]}, peak "
        f"{peak / 2 ** 30:.2f} GiB")
    return {"losses": losses, "step_s": step_s, "routes": routes.log,
            "peak_mem_bytes": peak, "n_params": n_params}


def mesh_family_rank(mesh, starts: dict, log) -> dict:
    """13c (a) on one rank: each family's MESH_FAMILY_STEPS RSC steps on
    the mesh, launch counts set to 0 just before and read just after,
    with its selected blocks, routing and blocks' shapes."""
    from repro_torch import convert
    from repro_torch.configs import make_batch, smoke_config
    from repro_torch.kernels import ops
    from repro_torch.train.lm_steps import local_batch, \
        make_sharded_train_step
    from repro_torch.train.optimizer import Adam
    dev = mesh.device
    out = {}
    for arch in MESH_FAMILIES:
        cfg = dataclasses.replace(smoke_config(arch), dtype="float32")
        state = convert.lm_sharded_from_numpy(cfg, starts[arch], mesh, dev)
        opt = PlainSGD()
        ost = opt.init(state.shards)
        step = make_sharded_train_step(
            cfg, opt, mesh, 2, {"keep_frac": 0.5, "bk": 32,
                                "backend": "kernel"})
        ops.reset_launch_counts()
        log.clear()
        losses = []
        with RouteTap() as routes:
            for i in range(MESH_FAMILY_STEPS):
                batch = make_batch(cfg, "train_4k", 4, 64, seed=i,
                                   device=dev)
                state, ost, loss = step(state, ost,
                                        local_batch(batch, mesh, 2))
                losses.append(float(loss))
        launches = ops.launch_counts()["gather_matmul"]
        full_shapes = {n: tuple(p.shape)
                       for n, p in state.skeleton.named_parameters()}
        moments = Adam().init(state.shards)
        shapes_ok = all(
            tuple(t[n].shape) == state.shardings[n].local_shape(
                full_shapes[n])
            for t in (state.shards, moments["m"], moments["v"]) for n in t)
        out[arch] = {"losses": losses, "sel": list(log),
                     "routes": routes.log,
                     "data_index": mesh.index(mesh.dp_axes),
                     "launches": launches,
                     "skipped": ops.skipped_counts()["gather_matmul"],
                     "shapes_ok": shapes_ok,
                     "params": convert.lm_sharded_to_numpy(state)}
        del state, ost, moments
    return out


def _routes_of_rows(routes: list, k: int, i: int) -> list:
    """Rows ``[i·k, (i+1)·k)`` of each routing of a one-process run."""
    return [r[i * k:(i + 1) * k] for r in routes]


def lm_mesh_families_check(ranks: list, starts: dict, refs: dict) -> dict:
    """13c (a)'s checks: every rank's selected blocks, launches, routing
    and blocks; the losses and parameter changes of the first rank
    against the one-process run."""
    from repro_torch.configs import smoke_config
    out = {"mesh": MESH, "steps": MESH_FAMILY_STEPS, "launches": 0,
           "archs": {}}
    for arch in MESH_FAMILIES:
        cfg = dataclasses.replace(smoke_config(arch), dtype="float32")
        ref, nudged = refs[arch]
        got = [r["families"][arch] for r in ranks]
        want_calls = rsc_calls(cfg) * 2 * MESH_FAMILY_STEPS
        for r, g in enumerate(got):
            if g["sel"] != ref["sel"]:
                raise AssertionError(f"13c {arch}: rank {r}'s selected "
                                     f"blocks differ:\n{g['sel']}\n"
                                     f"{ref['sel']}")
            if g["launches"] + g["skipped"] != want_calls:
                raise AssertionError(f"13c {arch}: rank {r} launched "
                                     f"{g['launches']} + skipped "
                                     f"{g['skipped']} of {want_calls}")
            if not g["shapes_ok"]:
                raise AssertionError(f"13c {arch}: rank {r}'s blocks are "
                                     "not its spec's share")
            k = 4 // 2 // MESH[0]        # this rank's rows per microbatch
            want_routes = _routes_of_rows(ref["routes"], k,
                                          g["data_index"])
            if len(g["routes"]) != len(want_routes) or not all(
                    torch.equal(a, b) for a, b in zip(g["routes"],
                                                      want_routes)):
                raise AssertionError(f"13c {arch}: rank {r}'s MoE routing "
                                     "differs from the one-process run's")
        for i, (a, b, n) in enumerate(zip(got[0]["losses"], ref["losses"],
                                          nudged["losses"])):
            own = abs(n - b) / abs(b)
            np.testing.assert_allclose(a, b, rtol=max(1e-5, 2 * own),
                                       err_msg=f"13c {arch} step {i}")
        worst = 0.0
        for o, rr, r2, p0 in zip(_tree_leaves(got[0]["params"]),
                                 _tree_leaves(ref["params"]),
                                 _tree_leaves(nudged["params"]),
                                 _tree_leaves(starts[arch])):
            moved = rr - p0
            norm = max(np.linalg.norm(moved), 1e-30)
            lim = max(TRAIN_DP_REL, 2 * np.linalg.norm(r2 - p0 - moved)
                      / norm)
            err = np.linalg.norm(o - p0 - moved) / norm
            if err > lim:
                raise AssertionError(f"13c {arch}: a parameter's change "
                                     f"differs by {err:.3e} of its norm "
                                     f"(limit {lim:.3e})")
            worst = max(worst, float(err))
        launches = [g["launches"] for g in got]
        out["launches"] += sum(launches)
        out["archs"][arch] = {
            "losses": got[0]["losses"], "losses_one_process": ref["losses"],
            "max_param_change_err": worst, "launches": launches,
            "skipped": [g["skipped"] for g in got],
            "moe_routings": len(ref["routes"])}
        say(f"[mesh family] {arch} f32 smoke on {MESH}: losses "
            f"{got[0]['losses']} (one process {ref['losses']}), selected "
            f"blocks equal on every rank, largest parameter-change error "
            f"{worst:.3e}, launches {launches} + skipped "
            f"{out['archs'][arch]['skipped']} of {want_calls} each, MoE "
            f"routings equal on every rank and to the one process: "
            f"{len(ref['routes'])}")
    return out


def lm_mesh_moe_check(ranks: list, ref: dict, smi: str) -> dict:
    """13c (b)'s checks: launches, losses, bytes, parameters against the
    one-process step; routing identical along each ``model`` line, and
    its share of picks equal to the one-process run's."""
    fulls = [r["moe_full"] for r in ranks]
    cfg = moe_full_config()
    _, rows, seq, n_mb = MOE_FULL
    want = rsc_calls(cfg) * n_mb * MOE_FULL_STEPS
    for r, f in enumerate(fulls):
        calls = f["launches"]["gather_matmul"] + f["skipped"]
        if calls != want or f["launches"]["flash_attention"] != 0 \
                or f["launches"]["bcoo_spmm"] != 0:
            raise AssertionError(f"13c rank {r}: launches {f['launches']} "
                                 f"+ skipped {f['skipped']}, expected "
                                 f"{want} gather_matmul calls and nothing "
                                 "else")
        if f["gather_by_variant"].get("wgmma", 0) != \
                f["launches"]["gather_matmul"]:
            raise AssertionError(f"13c rank {r}: gather_matmul variants "
                                 f"{f['gather_by_variant']}")
        if f["losses"] != fulls[0]["losses"]:
            raise AssertionError("13c: the ranks' losses differ")
        if f["param_bytes"] != f["spec_param_bytes"]:
            raise AssertionError(f"13c rank {r}: {f['param_bytes']} "
                                 "parameter bytes, the spec's share is "
                                 f"{f['spec_param_bytes']}")
        if f["max_param_diff"] > MESH_PARAM_ATOL:
            raise AssertionError(f"13c rank {r}: {f['max_param_diff_name']} "
                                 f"differs from the one process's by "
                                 f"{f['max_param_diff']:.3e}")
    loss_err = max(abs(a - b) for a, b in zip(fulls[0]["losses"],
                                               ref["losses"]))
    if not loss_err < MESH_LOSS_ATOL:
        raise AssertionError(f"13c losses {fulls[0]['losses']} against the "
                             f"one process's {ref['losses']}")
    # routing: identical along each model line; picks equal to the one
    # process's (a near tie may route otherwise in bf16): in the same
    # place of the top-k, and among the token's top-k at all (the output
    # depends on the set: a token's picks never share an expert)
    k = rows // n_mb // MESH[0]
    top_k = cfg.moe.top_k
    equal, in_set, total = 0, 0, 0
    by_line: dict = {}
    for f in fulls:
        line = by_line.setdefault(f["data_index"], f["routes"])
        if len(line) != len(f["routes"]) or not all(
                torch.equal(a, b) for a, b in zip(line, f["routes"])):
            raise AssertionError("13c: the MoE routing differs between the "
                                 "ranks of a model line")
    for i, routes in by_line.items():
        want_routes = _routes_of_rows(ref["routes"], k, i)
        if len(want_routes) != len(routes):
            raise AssertionError(f"13c: {len(routes)} routings on the "
                                 f"ranks, {len(want_routes)} in one process")
        for a, b in zip(routes, want_routes):
            equal += int((a == b).sum())
            a3, b3 = a.view(-1, top_k), b.view(-1, top_k)
            in_set += int((a3[:, :, None] == b3[:, None, :]).any(-1).sum())
            total += a.numel()
    checks = fulls[0]["kernel_checks"]
    per_step = {op: {k2: v / MOE_FULL_STEPS for k2, v in st.items()}
                for op, st in fulls[0]["collectives"].items()}
    state_gb = [round((f["param_bytes"] + f["moment_bytes"]) / 1e9, 3)
                for f in fulls]
    out = {"arch": cfg.name, "n_layers": cfg.n_layers, "batch": rows,
           "seq": seq, "microbatches": n_mb, "steps": MOE_FULL_STEPS,
           "losses": fulls[0]["losses"], "one_process_losses": ref["losses"],
           "loss_err": loss_err, "one_process": {
               k2: ref[k2] for k2 in ("step_s", "peak_mem_bytes",
                                      "n_params")},
           "max_param_diff": max(f["max_param_diff"] for f in fulls),
           "equal_pick_share": equal / max(total, 1),
           "same_expert_share": in_set / max(total, 1), "picks": total,
           "launches": sum(f["launches"]["gather_matmul"] for f in fulls),
           "skipped": sum(f["skipped"] for f in fulls),
           "kernel_checks": checks, "gather_rows": fulls[0]["gather_rows"],
           "collectives_per_step_rank0": per_step, "card": smi,
           "ranks": [{k2: f[k2] for k2 in (
               "losses", "step_s", "launches", "gather_by_variant",
               "skipped", "peak_mem_bytes", "param_bytes", "moment_bytes",
               "spec_param_bytes", "full_param_bytes", "max_param_diff",
               "max_param_diff_name", "collectives")} for f in fulls]}
    say(f"[mesh moe] {cfg.name} ({cfg.n_layers} of 27 layers) on {MESH} "
        f"({smi}): losses {fulls[0]['losses']} (one process "
        f"{ref['losses']}, err {loss_err:.2e}); largest parameter "
        f"difference {out['max_param_diff']:.3e}; routing equal along each "
        f"model line; of {total} picks {out['equal_pick_share']:.6f} equal "
        f"to the one process's in place, {out['same_expert_share']:.6f} "
        f"among its token's top-{top_k}; gather_matmul per rank "
        f"{[f['launches']['gather_matmul'] for f in fulls]} + skipped "
        f"{[f['skipped'] for f in fulls]}; step s "
        f"{[[round(x, 3) for x in f['step_s']] for f in fulls]}; peak GiB "
        f"{[round(f['peak_mem_bytes'] / 2 ** 30, 2) for f in fulls]}; "
        f"parameter + moment GB per rank {state_gb} (parameters "
        f"{fulls[0]['param_bytes'] / 1e9:.3f} of "
        f"{fulls[0]['full_param_bytes'] / 1e9:.3f}); rank 0 collectives per "
        f"step {json.dumps(per_step)}; kernel = plain version {checks}")
    return out


# ------------------------------------------------------- serving on a mesh

class FlashTap:
    """Stands in for ``kernels.ops.flash_attention`` while a run is
    driven: every call passes through (and launches, and is counted, as
    before); the first call's q, k, v and window are kept."""

    def __enter__(self):
        import importlib
        self.mod = importlib.import_module("repro_torch.kernels.ops")
        self.inner, self.first, self.shapes = self.mod.flash_attention, \
            None, []
        self.mod.flash_attention = self
        return self

    def __exit__(self, *exc):
        self.mod.flash_attention = self.inner

    def __call__(self, q, k, v, **kw):
        if self.first is None:
            self.first = (q.detach().clone(), k.detach().clone(),
                          v.detach().clone(), kw.get("window"))
        self.shapes.append((tuple(q.shape), tuple(k.shape)))
        return self.inner(q, k, v, **kw)


def serve_one_process(cfg, tree, batch: dict, feed, dev) -> dict:
    """13d (a)'s one-process run on the card: prefill, graft into
    SERVE_SMALL's max_len, a decode step per column of ``feed``; every
    step's logits and the caches after the prefill and the last step
    (numpy, the reference's layout)."""
    from repro_torch import convert
    from repro_torch.launch import serve
    from repro_torch.train.lm_steps import make_decode_step, \
        make_prefill_step
    rows, max_len, _ = SERVE_SMALL
    net = convert.lm_params_from_numpy(cfg, tree, dev)
    logits, cache = make_prefill_step(cfg)(
        net, {k: torch.from_numpy(v).to(dev) for k, v in batch.items()})
    out = {"logits": [logits.cpu().numpy()],
           "caches": [convert.lm_cache_to_numpy(cache, cfg)]}
    cache = serve.graft(cfg, cache, rows, max_len, dev)
    decode = make_decode_step(cfg)
    for i in range(feed.shape[1]):
        logits, cache = decode(net, cache, {"tokens": torch.from_numpy(
            feed[:, i:i + 1]).to(dev)})
        out["logits"].append(logits.cpu().numpy())
    out["caches"].append(convert.lm_cache_to_numpy(cache, cfg))
    return out


def mesh_serve_reference(dev) -> tuple[dict, dict, dict]:
    """13d's one-process runs on the card: (a) each architecture's f32
    smoke config from its seeded parameters and from those one unit in
    the last place away; (b) SERVE_FULL's greedy_generate, every step's
    logits kept. Returns the ranks' inputs (numpy) and both records."""
    from repro_torch import convert
    from repro_torch.configs import get_arch, make_batch, smoke_config
    from repro_torch.launch import serve
    from repro_torch.models.lm.backbone import init_params
    rows, _, n_dec = SERVE_SMALL
    rng = np.random.default_rng(1)
    inputs, refs = {}, {}
    for i, arch in enumerate(SERVE_ARCHS):
        cfg = dataclasses.replace(smoke_config(arch), dtype="float32")
        net = init_params(cfg, seed=0, device="cpu")
        set_gates(net)
        tree = convert.lm_params_to_numpy(net, cfg)
        batch = {k: v.numpy() for k, v in make_batch(
            cfg, "prefill_32k", rows, 14 - i % 2, seed=i).items()}
        feed = rng.integers(0, cfg.vocab, (rows, n_dec)).astype(np.int32)
        inputs[arch] = (tree, batch, feed)
        refs[arch] = [serve_one_process(cfg, t, batch, feed, dev)
                      for t in (tree, _nudge_tree(tree, rng))]
    arch, b, t, gen = SERVE_FULL
    cfg = get_arch(arch)
    net = init_params(cfg, seed=0, device=dev)
    prompt = make_batch(cfg, "prefill_32k", b, t, seed=0, device=dev)
    toks, stats, rec = serve.greedy_generate(cfg, net, prompt, t + gen,
                                             gen, keep_logits=True)
    logits = [rec["logits"]["prefill"]] + rec["logits"]["steps"]
    full = {"tokens": toks.numpy(), "stats": stats,
            "logits": [x[:, -1].float().cpu().numpy() for x in logits]}
    del net, prompt, rec, logits
    torch.cuda.empty_cache()
    say(f"[mesh serve reference] {arch} bf16 batch {b} x {t} + {gen} "
        f"tokens, one process: prefill {stats['prefill_s']:.3f} s, decode "
        f"{stats['decode_s']:.3f} s; the f32 smoke configs of "
        f"{len(SERVE_ARCHS)} architectures")
    return inputs, refs, full


def mesh_serve_small_rank(mesh, inputs: dict) -> dict:
    """13d (a) on one rank: each architecture's sharded prefill, graft
    and decode steps, launch counts set to 0 just before and read just
    after; its logits, gathered caches (first rank), blocks against the
    spec's share and MoE routing."""
    from repro_torch import convert
    from repro_torch.configs import smoke_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import sharded_graft
    from repro_torch.train.lm_steps import abstract_cache, local_batch, \
        make_sharded_decode_step, make_sharded_prefill_step
    dev = mesh.device
    rows, max_len, _ = SERVE_SMALL
    out = {}
    for arch in SERVE_ARCHS:
        cfg = dataclasses.replace(smoke_config(arch), dtype="float32")
        tree, batch, feed = inputs[arch]
        state = convert.lm_sharded_from_numpy(cfg, tree, mesh, dev)
        mine = local_batch({k: torch.from_numpy(v).to(dev)
                            for k, v in batch.items()}, mesh)
        fed = local_batch({"f": torch.from_numpy(feed).to(dev)}, mesh)["f"]
        prefill = make_sharded_prefill_step(cfg, mesh)
        decode = make_sharded_decode_step(cfg, mesh)
        ops.reset_launch_counts()
        shapes_ok = []
        with RouteTap() as routes:
            logits, cache = prefill(state, mine)
            got = {"logits": [logits.cpu().numpy()], "caches": [
                convert.lm_sharded_cache_to_numpy(cfg, cache, mesh)]}
            whole = abstract_cache(cfg, rows, cache["max_len"],
                                   cfg.local_window)
            shapes_ok.append(cache_blocks_ok(cfg, mesh, cache, whole))
            cache = sharded_graft(cfg, cache, max_len, mesh)
            for i in range(feed.shape[1]):
                logits, cache = decode(state, cache,
                                       {"tokens": fed[:, i:i + 1]})
                got["logits"].append(logits.cpu().numpy())
        got["caches"].append(convert.lm_sharded_cache_to_numpy(cfg, cache,
                                                               mesh))
        shapes_ok.append(cache_blocks_ok(cfg, mesh, cache, abstract_cache(
            cfg, rows, max_len)))
        got.update(shapes_ok=all(shapes_ok), routes=routes.log,
                   launches=ops.launch_counts()["flash_attention"],
                   data_index=mesh.index(mesh.dp_axes))
        out[arch] = got
        del state, cache
    return out


def cache_blocks_ok(cfg, mesh, cache: dict, whole: dict) -> bool:
    """Whether every block of this rank's ``cache`` has the shape the
    sanitized cache spec gives it of the ``whole`` (abstract) cache."""
    from repro_torch.convert import lm_cache_shardings
    sh = lm_cache_shardings(cfg, mesh, whole)["layers"]
    return all(tuple(t.shape) == sh[i][k].local_shape(
        tuple(whole["layers"][i][k].shape))
        for i, c in enumerate(cache["layers"]) for k, t in c.items())


def mesh_serve_full_rank(group, mesh, feed) -> dict:
    """13d (b) on one rank: SERVE_FULL through ``sharded_generate``,
    teacher-forced with the one-process tokens ``feed``, launch counts and
    collective statistics set to 0 just before and read just after; the
    rank's cache bytes against the spec's share, peak memory, and the
    first flash call's q / k / v held against the plain version and timed
    (first rank)."""
    from repro_torch.configs import get_arch, make_batch
    from repro_torch.convert import lm_cache_shardings
    from repro_torch.kernels import flash_attention as fmod
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import flash_attention_ref
    from repro_torch.launch.serve import sharded_generate
    from repro_torch.models.lm.backbone import init_sharded_params
    from repro_torch.train.lm_steps import abstract_cache, local_batch
    arch, b, t, gen = SERVE_FULL
    cfg = get_arch(arch)
    dev = mesh.device
    state = init_sharded_params(cfg, mesh, seed=0, device=dev)
    prompt = local_batch(make_batch(cfg, "prefill_32k", b, t, seed=0,
                                    device=dev), mesh)
    fed = local_batch({"f": torch.as_tensor(feed)}, mesh)["f"]
    group.barrier()
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    with FlashTap() as tap:
        toks, stats, rec = sharded_generate(cfg, state, prompt, t + gen, gen,
                                            mesh, feed=fed, keep_logits=True)
    counts = ops.launch_counts()
    by_var = ops.launch_counts_by_variant()["flash_attention"]
    peak = torch.cuda.max_memory_allocated(dev)
    cache = rec["cache"]
    whole = abstract_cache(cfg, b, t + gen)
    sh = lm_cache_shardings(cfg, mesh, whole)["layers"]
    cache_bytes = sum(x.numel() * x.element_size()
                      for c in cache["layers"] for x in c.values())
    spec_bytes = sum(math.prod(sh[i][k].local_shape(tuple(x.shape)))
                     * x.element_size()
                     for i, c in enumerate(whole["layers"])
                     for k, x in c.items())
    full_bytes = sum(math.prod(x.shape) * x.element_size()
                     for c in whole["layers"] for x in c.values())
    logits = [rec["logits"]["prefill"]] + rec["logits"]["steps"]
    coll = {"prefill": rec["collectives"]["prefill"],
            "graft": rec["collectives"]["graft"],
            "decode_per_step": {
                op: {k: v / (gen - 1) for k, v in st.items()}
                for op, st in rec["collectives"]["decode"].items()}}
    del rec, cache, state
    torch.cuda.empty_cache()
    row = None
    group.barrier()
    if group.rank == 0:    # the other ranks wait at the next barrier
        q, k, v, window = tap.first
        row = flash_row(q, k, v, fmod, flash_attention_ref, None, reps=20,
                        window=window)
    group.barrier()
    return {"tokens": toks.numpy(), "stats": stats,
            "logits": [x[:, -1].float().cpu().numpy() for x in logits],
            "launches": counts, "flash_by_variant": by_var,
            "flash_shapes": sorted(set(tap.shapes)),
            "collectives": coll,
            "peak_mem_bytes": peak, "cache_bytes": cache_bytes,
            "spec_cache_bytes": spec_bytes, "full_cache_bytes": full_bytes,
            "flash_row": row, "data_index": mesh.index(mesh.dp_axes)}


def _within(got, want, own, tol: float) -> tuple[bool, float]:
    """Whether each row (last axis) of ``got`` is within ``tol`` of the
    row's max |value| of ``want``, or within twice ``own``'s move from
    ``want`` where that is more (``own`` None: ``tol`` alone); and the
    largest error in units of the row's max."""
    scale = np.abs(want).max(-1, keepdims=True)
    lim = np.maximum(tol * scale, 2 * np.abs(own - want).max(
        -1, keepdims=True)) if own is not None else tol * scale
    err = np.abs(got - want)
    return bool((err <= lim).all()), float((err / np.maximum(
        scale, 1e-30)).max())


def _flat_leaves(tree) -> list:
    return [x.reshape(1, -1) for x in _tree_leaves(tree)]


def lm_mesh_serve_check(ranks: list, inputs: dict, refs: dict, full: dict,
                        smi: str) -> dict:
    """13d's checks against the one-process runs on the card; returns
    the ``serve`` entry of ``lm_mesh_slice``."""
    rows, max_len, n_dec = SERVE_SMALL
    per = rows // MESH[0]
    out = {"mesh": MESH, "small": {}, "launches": 0,
           "rank_s": [r["serve_s"] for r in ranks]}
    for arch in SERVE_ARCHS:
        ref, own = refs[arch]
        got = [r["serve_small"][arch] for r in ranks]
        worst = 0.0
        for r, g in enumerate(got):
            lo = g["data_index"] * per
            if not g["shapes_ok"]:
                raise AssertionError(f"13d {arch}: rank {r}'s cache blocks "
                                     "are not its spec's share")
            for i, (x, w, o) in enumerate(zip(g["logits"], ref["logits"],
                                              own["logits"])):
                ok, err = _within(x, w[lo:lo + per], o[lo:lo + per],
                                  SERVE_TOL)
                if not ok:
                    raise AssertionError(f"13d {arch}: rank {r}'s step {i} "
                                         f"logits differ by {err:.3e} of "
                                         "the row's max")
                worst = max(worst, err)
            out["launches"] += g["launches"]
        cache_err = 0.0
        for i in range(2):
            for x, w, o in zip(_flat_leaves(got[0]["caches"][i]),
                               _flat_leaves(ref["caches"][i]),
                               _flat_leaves(own["caches"][i])):
                ok, err = _within(x, w, o, SERVE_TOL)
                if not ok:
                    raise AssertionError(f"13d {arch}: a gathered cache "
                                         f"leaf differs by {err:.3e}")
                cache_err = max(cache_err, err)
        for a, b in ((0, 1), (2, 3)):    # the ranks of each model line
            if len(got[a]["routes"]) != len(got[b]["routes"]) or not all(
                    torch.equal(x, y) for x, y in zip(got[a]["routes"],
                                                      got[b]["routes"])):
                raise AssertionError(f"13d {arch}: MoE routing differs "
                                     f"between ranks {a} and {b}")
        t = inputs[arch][1][next(iter(inputs[arch][1]))].shape[1]
        out["small"][arch] = {"prompt_len": t, "max_logit_err": worst,
                              "max_cache_err": cache_err,
                              "flash_launches": [g["launches"] for g in got],
                              "moe_routings": len(got[0]["routes"])}
        say(f"[mesh serve] {arch} f32 smoke on {MESH}: prompt {t}, max_len "
            f"{max_len}, {n_dec} decode steps; logits within {worst:.3e} of "
            f"the row's max, gathered caches within {cache_err:.3e}, blocks "
            f"of the spec's shape, flash launches "
            f"{[g['launches'] for g in got]}, MoE routings "
            f"{len(got[0]['routes'])} equal along model")
    # (b)
    arch, b, t, gen = SERVE_FULL
    fulls = [r["serve_full"] for r in ranks]
    per = b // MESH[0]
    worst, first_diff = [0.0] * (gen), None
    for r, f in enumerate(fulls):
        n = f["launches"]["flash_attention"]
        if n != 28 or f["flash_by_variant"].get("wgmma", 0) != n \
                or f["launches"]["gather_matmul"] or \
                f["launches"]["bcoo_spmm"]:
            raise AssertionError(f"13d rank {r}: launches {f['launches']}, "
                                 f"flash by variant {f['flash_by_variant']}"
                                 "; expected 28 wgmma flash launches")
        want_shapes = [((per, t, 8, 128), (per, t, 4, 128))]
        if f["flash_shapes"] != want_shapes:
            raise AssertionError(f"13d rank {r}: flash shapes "
                                 f"{f['flash_shapes']}")
        if f["cache_bytes"] != f["spec_cache_bytes"]:
            raise AssertionError(f"13d rank {r}: {f['cache_bytes']} cache "
                                 f"bytes, the spec's share is "
                                 f"{f['spec_cache_bytes']}")
        lo = f["data_index"] * per
        for i, (x, w) in enumerate(zip(f["logits"], full["logits"])):
            ok, err = _within(x, w[lo:lo + per], None, SERVE_BF16_TOL)
            if not ok:
                raise AssertionError(f"13d rank {r}: step {i}'s logits "
                                     f"differ by {err:.3e} of the row's max")
            worst[i] = max(worst[i], err)
        mine = full["tokens"][lo:lo + per]
        diff = np.nonzero((f["tokens"] != mine).any(0))[0]
        if len(diff) and (first_diff is None or diff[0] < first_diff[0]):
            i = int(diff[0])
            top2 = np.sort(full["logits"][i][lo:lo + per], -1)[:, -2:]
            first_diff = (i, float((top2[:, 1] - top2[:, 0]).min()))
    row = fulls[0]["flash_row"]
    per_step = fulls[0]["collectives"]["decode_per_step"]
    out["full"] = {
        "arch": arch, "batch": b, "prompt_len": t, "gen": gen,
        "max_len": t + gen, "card": smi, "max_logit_err_by_step": worst,
        "first_token_difference": first_diff,
        "one_process": {"prefill_s": full["stats"]["prefill_s"],
                        "decode_s": full["stats"]["decode_s"]},
        "ranks": [{k: f[k] for k in ("stats", "launches", "flash_by_variant",
                                     "collectives", "peak_mem_bytes",
                                     "cache_bytes", "spec_cache_bytes",
                                     "full_cache_bytes")} for f in fulls],
        "flash_row": row}
    out["launches"] += sum(f["launches"]["flash_attention"] for f in fulls)
    say(f"[mesh serve full] {arch} bf16 on {MESH} ({smi}): batch {b} x {t} "
        f"+ {gen} tokens, max_len {t + gen}; logits within "
        f"{max(worst):.3e} of the row's max (by step "
        f"{[round(w, 5) for w in worst]}); greedy tokens "
        f"{'equal' if first_diff is None else 'first differ at step %d (one-process top-2 margin %.3e)' % first_diff}"
        f"; flash per rank {[f['launches']['flash_attention'] for f in fulls]}"
        f" (all wgmma at 8 / 4 heads, hd 128); prefill s "
        f"{[round(f['stats']['prefill_s'], 3) for f in fulls]}, graft s "
        f"{[round(f['stats']['graft_s'], 3) for f in fulls]}, decode ms per "
        f"token {[round(f['stats']['decode_s'] / (gen - 1) * 1e3, 1) for f in fulls]}"
        f" (one process: prefill {full['stats']['prefill_s']:.3f} s, decode "
        f"{full['stats']['decode_s'] / (gen - 1) * 1e3:.1f} ms per token); "
        f"peak GiB {[round(f['peak_mem_bytes'] / 2 ** 30, 2) for f in fulls]}"
        f"; cache bytes per rank {fulls[0]['cache_bytes']} of "
        f"{fulls[0]['full_cache_bytes']}; rank 0 collectives per decode "
        f"step {json.dumps(per_step)}")
    return out


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
    from repro_torch.configs import get_arch, make_batch, smoke_config
    from repro_torch.models.lm import attention as lm_attention
    from repro_torch.models.lm import backbone as lm_backbone
    from repro_torch.models.lm import layers as lm_layers
    from repro_torch.models.lm import rglru as lm_rglru
    from repro_torch.models.lm import xlstm as lm_xlstm
    from repro_torch.configs.shapes import microbatches
    from repro_torch.kernels import flash_attention as fmod
    from repro_torch.kernels.ref import flash_attention_ref
    from repro_torch.launch import serve
    from repro_torch.models.lm.attention import _project_qkv
    from repro_torch.models.lm.backbone import init_params
    from repro_torch.models.lm.layers import apply_norm
    from repro_torch.kernels import gather_matmul as gmod
    from repro_torch.kernels.ref import gather_matmul_ref
    from repro_torch.launch import dryrun, train
    from repro_torch.launch.profile_serve import kernel_table
    from repro_torch.train.loop import GNNTrainer, TrainConfig
    from repro_torch.train.lm_steps import make_train_step
    from repro_torch.train.optimizer import Adam

    lm = SimpleNamespace(attention=lm_attention, backbone=lm_backbone,
                         layers=lm_layers, rglru=lm_rglru, xlstm=lm_xlstm)
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
    frontend = serving_frontend(serve_gnn, ops, kmod, bcoo_spmm_ref, gcn,
                                args.scale, smi)
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
    dp_small = dp_small_reference(ops, dev)
    dp_launches, dp_slice = dp_main_path(train, ops, autotune, smi)
    dp_slice["small_reference"] = dp_small
    flash_res = flash_sweep(ops, fmod, flash_attention_ref, dev)
    flash_family_res = flash_sweep(
        ops, fmod, flash_attention_ref, dev, heads=FLASH_FAMILY_HEADS,
        lengths=FLASH_FAMILY_LENGTHS, windows=FLASH_FAMILY_WINDOWS, seed=3,
        label="flash sweep families")
    lm_ref_err = lm_small_reference(serve, smoke_config, make_batch,
                                    init_params, dev)
    lm_out, flash_launches, lm_run_s = lm_main_path(serve, ops)
    flash_rows, lm_warm = lm_timings(lm_out, serve, fmod,
                                     flash_attention_ref, apply_norm,
                                     _project_qkv)
    lm_report, lm_launches = lm_out["report"], lm_out["launches"]
    del lm_out
    torch.cuda.empty_cache()
    families, family_launches = {}, 0
    for name in FAMILIES:
        families[name], n = family_serve(
            name, serve, ops, fmod, flash_attention_ref, lm, get_arch,
            init_params, make_batch, dev)
        family_launches += n
    for name in FAMILIES:
        families[name]["small_reference"] = family_small_reference(
            name, serve, smoke_config, make_batch, init_params, dev)
    gather_res = gather_sweep(ops, gmod, gather_matmul_ref, dev)
    train_ref = lm_train_small_reference(ops, gmod, smoke_config,
                                         make_batch, init_params,
                                         make_train_step, Adam, dev)
    for name in FAMILIES:
        families[name]["train_small_reference"] = \
            family_train_small_reference(name, ops, gmod, smoke_config,
                                         make_batch, init_params,
                                         make_train_step, Adam, dev)
    argv = train_argv(microbatches("qwen3-1.7b", "train_4k"))
    (train_out, train_args, tap, gather_launches, train_run_s, peak,
     path_checks) = lm_train_main_path(train, ops, gmod, gather_matmul_ref,
                                       argv)
    gather_rows, train_warm = lm_train_timings(
        train_out, train_args, tap, gmod, gather_matmul_ref, peak)
    train_losses = train_out["losses"]
    del train_out["params"], tap
    gc.collect()
    torch.cuda.empty_cache()
    dryrun_slice = {"step": dryrun_check(dryrun, get_arch, train_args,
                                         train_warm, peak, ops, smi)}
    qs_launches, dryrun_slice["quickstart"] = quickstart_on_card(
        ops, kmod, bcoo_spmm_ref, smi)
    gc.collect()
    torch.cuda.empty_cache()
    t13c = time.perf_counter()
    family_starts, family_refs = mesh_family_reference(ops, gmod, dev)
    moe_ref = moe_full_reference(ops, dev)
    t13c = time.perf_counter() - t13c
    gc.collect()
    torch.cuda.empty_cache()
    t13d = time.perf_counter()
    serve_inputs, serve_refs, serve_full = mesh_serve_reference(dev)
    t13d = time.perf_counter() - t13d
    gc.collect()
    torch.cuda.empty_cache()
    mesh_slice, mesh_ranks = lm_mesh_phase(
        train_losses, ops, gmod, dev, smi, family_starts, serve_inputs,
        serve_full["tokens"])
    mesh_slice["families"] = lm_mesh_families_check(
        mesh_ranks, family_starts, family_refs)
    mesh_slice["moe_full_width"] = lm_mesh_moe_check(mesh_ranks, moe_ref,
                                                     smi)
    mesh_slice["phase13c_reference_s"] = t13c
    mesh_slice["serve"] = lm_mesh_serve_check(mesh_ranks, serve_inputs,
                                              serve_refs, serve_full, smi)
    mesh_slice["serve"]["reference_s"] = t13d
    del mesh_ranks
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
        + obs_slice["save_serve"]["serve_launches"]
        + frontend["launches"] + dp_launches + qs_launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": hidden["ms"], "plain_ms": hidden["plain_ms"],
        "bound_ms": hidden["bound_ms"], "bound_by": hidden["bound_by"],
        "library_ms": hidden["library_ms"]}, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:31",
        "variant": flash_rows[0]["variant"],
        "launches": flash_launches + family_launches
        + mesh_slice["serve"]["launches"],
        "max_abs_err": flash_rows[0]["max_abs_err"],
        "ms": flash_rows[0]["ms"], "plain_ms": flash_rows[0]["plain_ms"],
        "bound_ms": flash_rows[0]["bound_ms"],
        "bound_by": flash_rows[0]["bound_by"],
        "library_ms": flash_rows[0]["library_ms"]}, {
        "name": "gather_matmul", "route": "cuda",
        "source": "src/repro_torch/csrc/gather_matmul.cu",
        "replaces": "src/repro/kernels/gather_matmul.py:28",
        "variant": gather_rows[0]["variant"],
        "launches": gather_launches + mesh_slice["full"]["launches"]
        + mesh_slice["families"]["launches"]
        + mesh_slice["moe_full_width"]["launches"],
        "max_abs_err": max(c[0] for c in list(path_checks.values()) + list(
            mesh_slice["full"]["ranks"][0]["kernel_checks"].values())
            + list(mesh_slice["moe_full_width"]["kernel_checks"].values())),
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
    say(json.dumps({"frontend_slice": frontend}))
    say(json.dumps({"gnn_train_slice": gnn_slice}))
    say(json.dumps({"gnn_models_slice": models_slice}))
    say(json.dumps({"minibatch_slice": mb_slice}))
    say(json.dumps({"obs_slice": obs_slice}))
    say(json.dumps({"dp_slice": dp_slice}))
    say(json.dumps({"lm_slice": {
        "report": lm_report, "run_s": lm_run_s,
        "launches": lm_launches, "warm": lm_warm,
        "flash_sweep": flash_res, "small_reference_max_abs_err": lm_ref_err,
        "flash_shapes": flash_rows}}))
    say(json.dumps({"lm_families_slice": {
        "batch": FAMILY_BATCH, "prompt_len": FAMILY_PROMPT,
        "gen": FAMILY_GEN, "cut": FAMILY_CUT, "launches": family_launches,
        "flash_sweep": flash_family_res, "families": families}}))
    say(json.dumps({"lm_train_slice": {
        "report": train_out["report"], "argv": argv,
        "run_s": train_run_s, "launches": gather_launches,
        "warm": train_warm, "gather_sweep": gather_res,
        "small_reference": train_ref, "path_checks": path_checks,
        "gather_shapes": gather_rows}}))
    say(json.dumps({"dryrun_slice": dryrun_slice}))
    say(json.dumps({"lm_mesh_slice": mesh_slice}))
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
