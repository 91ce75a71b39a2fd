"""rsc_spmm: exact forward SpMM, top-k-sampled backward SpMM (paper §3.1).

Forward:  H_pre = SpMM(Ã, J)                       — exact (Prop. 3.1 requires it)
Backward: ∇J    = SpMM_sampled(Ãᵀ, ∇H_pre; plan)   — only the plan's tiles

``spmm_apply`` is the one entry every SpMM of the port goes through:

    out[r] = epilogue(Σ_{tiles (r, c) in plan} blocks[sel] @ h[c·bk:(c+1)·bk])
    epilogue(y) = max(y + bias + residual, 0) if relu else y + bias + residual

Backends:

* ``"kernel"`` — ``repro_torch.kernels.ops.bcoo_spmm``: on a CUDA tensor
  the hand-written CUDA kernel (it launches or raises); on a CPU tensor its
  plain PyTorch version.
* ``"ref"`` — CPU tensors only: the chunked streaming schedule of the
  reference's ``spmm_stream`` (``repro/core/rsc_spmm.py``), with
  ``index_add_`` for the scatter.
* ``"dense"`` — any device: the plan's tiles scattered into the dense
  operand and one ``torch.matmul``
  (``repro_torch.kernels.dense_spmm``, the reference's dense backend).
* ``"auto"`` — the per-signature decision cached by
  ``kernels.autotune.get_or_tune_auto`` (``kernel`` or ``dense`` on the
  card, ``ref`` or ``dense`` on the CPU), read at dispatch and never
  swept; a signature nobody tuned runs ``kernel`` on the card and ``ref``
  on the CPU.

The ``ref`` schedule's ``chunk`` and the kernel's column tile come from
``kernels.autotune.lookup`` when not given.

``rsc_spmm`` and ``exact_spmm`` are ``torch.autograd.Function``s over
``spmm_apply``, the ports of the reference's ``custom_vjp``s: the forward
is exact with the fused epilogue; the backward masks the cotangent with
the ReLU mask recomputed from the fused output (``out > 0``), gives
``∂bias = Σ_rows`` and ``∂residual = masked cotangent``, and runs the
backward SpMM against the pre-transposed ``at`` under the sampled plan
(``rsc_spmm``) or ``at``'s exact plan (``exact_spmm``). Their plans come
from ``core.plan`` / ``exact_plan``, in range by construction, so the
kernel runs without the host check of the indices (no device sync).

With tracing on, each SpMM of the two directions is timed on the card as
the device span ``gpu.spmm.forward`` / ``gpu.spmm.backward`` (arguments
``d``, ``n_active``, ``s_pad`` of its plan).

Bias note (paper §3.1.2): the approximation sits strictly behind the ReLU
mask computed from exact pre-activations, so gradients stay unbiased when
the sampler is.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.plan import SamplePlan
from repro_torch.sparse.bcoo import BlockCOO, host_row_ptr

DEFAULT_CHUNK = 32


def exact_plan(a: BlockCOO) -> SamplePlan:
    """The identity plan of a BlockCOO: its own sorted id lists (no
    device work: every array is the operand's own)."""
    return SamplePlan(
        sel=a.tile_ids, row_ids=a.row_ids, col_ids=a.col_ids,
        s_pad=a.s_total, n_active=a.s_total, row_ptr=a.row_ptr)


def spmm_stream(
    blocks: torch.Tensor,   # (S+1, bm, bk) tiles incl. trailing zero sentinel
    sel: torch.Tensor,      # (s_pad,) int32
    row_ids: torch.Tensor,  # (s_pad,) int32, sorted ascending
    col_ids: torch.Tensor,  # (s_pad,) int32
    h: torch.Tensor,        # (n_cols, d)
    *,
    n_row_blocks: int,
    bm: int,
    bk: int,
    chunk: int = DEFAULT_CHUNK,
) -> torch.Tensor:
    """Streaming SpMM over ``chunk``-tile slices of the id lists.

    Each step gathers ``(chunk, bm, bk)`` tiles and ``(chunk, bk, d)``
    slabs, contracts them in f32 and ``index_add_``s into the
    ``(n_row_blocks, bm, d)`` accumulator; the ``(s_pad, bm, d)`` partial
    products are never materialized. Row ids outside ``[0, n_row_blocks)``
    are dropped, as the reference's ``mode="drop"`` scatter drops them.
    """
    d = h.shape[-1]
    s_pad = sel.shape[0]
    chunk = max(1, min(chunk, s_pad))
    hb = h.reshape(-1, bk, d)
    acc = torch.zeros((n_row_blocks, bm, d), dtype=torch.float32,
                      device=h.device)
    for lo in range(0, s_pad, chunk):
        rows = row_ids[lo:lo + chunk].long()
        part = torch.einsum("sij,sjd->sid",
                            blocks[sel[lo:lo + chunk].long()].float(),
                            hb[col_ids[lo:lo + chunk].long()].float())
        keep = (rows >= 0) & (rows < n_row_blocks)
        acc.index_add_(0, rows[keep], part[keep])
    return acc.reshape(n_row_blocks * bm, d).to(h.dtype)


def spmm_apply(
    blocks: torch.Tensor,   # (S+1, bm, bk) tiles incl. sentinel
    plan: SamplePlan,
    h: torch.Tensor,        # (n_cols, d)
    n_row_blocks: int,
    bm: int,
    bk: int,
    backend: str = "kernel",
    *,
    bias: torch.Tensor | None = None,
    residual: torch.Tensor | None = None,
    relu: bool = False,
    chunk: int | None = None,
    in_range: bool = False,
) -> torch.Tensor:
    """out[r] = epilogue(Σ_{tiles (r,c) in plan} blocks[sel] @ h[c·bk:...]).

    The epilogue contract is the same on every backend (see the module
    docstring). ``chunk`` tunes the ``"ref"`` schedule only. ``in_range``
    is for plans whose indices lie in range by construction (the
    planner's and ``exact_plan``'s): the kernel then runs without the host
    check of the indices, which synchronises with the card.
    """
    if backend == "auto":
        from repro_torch.kernels import autotune
        sig = autotune.signature(
            "auto", bm=bm, bk=bk, d=h.shape[-1], s_pad=plan.s_pad,
            n_row_blocks=n_row_blocks, n_col_blocks=h.shape[0] // bk)
        cfg = autotune.lookup(sig, d=h.shape[-1])
        on_card = h.device.type == "cuda"
        if cfg.source == "default":
            backend = "kernel" if on_card else "ref"
        elif cfg.backend == "ref" and on_card:
            raise ValueError("the cached auto decision is 'ref', timed on "
                             "the CPU; re-tune this signature on the card")
        else:
            backend = cfg.backend
        obs.get_ledger().note_backend(sig, backend)
        if chunk is None:
            chunk = cfg.chunk
    if backend == "kernel":
        from repro_torch.kernels import ops as kops
        fn = kops.bcoo_spmm_in_range if in_range else kops.bcoo_spmm
        return fn(
            blocks, plan.sel, plan.row_ids, plan.col_ids, h,
            n_row_blocks=n_row_blocks, bm=bm, bk=bk, row_ptr=plan.row_ptr,
            bias=bias, residual=residual, relu=relu)
    if backend == "dense":
        from repro_torch.kernels.dense_spmm import dense_spmm
        return dense_spmm(
            blocks, plan.sel, plan.row_ids, plan.col_ids, h,
            n_row_blocks=n_row_blocks, bm=bm, bk=bk, bias=bias,
            residual=residual, relu=relu)
    if backend != "ref":
        raise ValueError(f"unknown SpMM backend {backend!r} "
                         "(expected 'kernel', 'ref', 'dense' or 'auto')")
    if h.device.type != "cpu":
        raise ValueError(f"backend 'ref' runs CPU tensors only, got "
                         f"{h.device}; use backend 'kernel' on the card")
    if chunk is None:
        from repro_torch.kernels import autotune
        chunk = autotune.lookup(autotune.signature(
            "ref", bm=bm, bk=bk, d=h.shape[-1], s_pad=plan.s_pad,
            n_row_blocks=n_row_blocks,
            n_col_blocks=h.shape[0] // bk)).chunk
    out = spmm_stream(blocks, plan.sel, plan.row_ids, plan.col_ids, h,
                      n_row_blocks=n_row_blocks, bm=bm, bk=bk, chunk=chunk)
    if bias is not None:
        out = out + bias
    if residual is not None:
        out = out + residual
    if relu:
        out = torch.relu(out)
    return out


def _apply(a: BlockCOO, plan: SamplePlan, h: torch.Tensor, backend: str,
           bias=None, residual=None, relu: bool = False) -> torch.Tensor:
    return spmm_apply(a.blocks, plan, h.contiguous(), a.n_row_blocks, a.bm,
                      a.bk, backend, bias=bias, residual=residual, relu=relu,
                      in_range=True)


class _Spmm(torch.autograd.Function):
    """Exact forward with the fused epilogue; the backward SpMM against
    ``at`` under ``plan``, or under ``at``'s exact plan when it is None
    (the reference's ``_rsc_fwd`` / ``_rsc_bwd`` and ``_eb_fwd`` /
    ``_eb_bwd``)."""

    @staticmethod
    def forward(ctx, a, at, plan, h, bias, residual, backend, relu):
        fwd = exact_plan(a)
        with obs.get_tracer().device_span(
                "spmm.forward", h.device, d=h.shape[-1],
                n_active=fwd.n_active, s_pad=fwd.s_pad):
            out = _apply(a, fwd, h, backend, bias, residual, relu)
        # relu'(x) = 1 <=> x > 0 <=> max(x, 0) > 0: the mask recomputes
        # exactly from the fused output, so the pre-activation is not kept.
        if relu:
            ctx.save_for_backward(out)
        ctx.at, ctx.plan, ctx.backend, ctx.relu = at, plan, backend, relu
        ctx.has_bias = bias is not None
        ctx.has_residual = residual is not None
        return out

    @staticmethod
    def backward(ctx, g):
        gp = g
        if ctx.relu:
            (out,) = ctx.saved_tensors
            gp = torch.where(out > 0, g, torch.zeros((), dtype=g.dtype,
                                                      device=g.device))
        dh = None
        if ctx.needs_input_grad[3]:
            # ∇J = SpMM_sampled(Ãᵀ, ∇H_pre): only the tiles the plan kept.
            plan = ctx.plan if ctx.plan is not None else exact_plan(ctx.at)
            with obs.get_tracer().device_span(
                    "spmm.backward", gp.device, d=gp.shape[-1],
                    n_active=plan.n_active, s_pad=plan.s_pad):
                dh = _apply(ctx.at, plan, gp, ctx.backend)
        dbias = gp.sum(0) if ctx.has_bias else None
        dres = gp if ctx.has_residual else None
        return None, None, None, dh, dbias, dres, None, None


def rsc_spmm(a: BlockCOO, at: BlockCOO, bwd_plan: SamplePlan,
             h: torch.Tensor, backend: str = "kernel", *,
             bias: torch.Tensor | None = None,
             residual: torch.Tensor | None = None,
             relu: bool = False) -> torch.Tensor:
    """SpMM(a, h) (+ fused epilogue) with the sampled backward through
    ``at`` under ``bwd_plan``, which must come from ``core.plan``
    (``build_plan`` / ``full_plan``): its indices are not checked.

    ``a`` carries its own full plan implicitly (its sorted id lists are the
    exact plan); ``at`` is the pre-transposed operand for the backward op.
    The epilogue is differentiated exactly; only the SpMM against ``at``
    is sampled.
    """
    return _Spmm.apply(a, at, bwd_plan, h, bias, residual, backend, relu)


def exact_spmm(a: BlockCOO, at: BlockCOO, h: torch.Tensor,
               backend: str = "kernel", *,
               bias: torch.Tensor | None = None,
               residual: torch.Tensor | None = None,
               relu: bool = False) -> torch.Tensor:
    """Exact SpMM (+ fused epilogue) with the exact backward through
    ``at`` — the no-RSC baseline, on the same block-COO apply in both
    directions. ``at`` must be the pre-transposed operand."""
    return _Spmm.apply(a, at, None, h, bias, residual, backend, relu)


def transpose_bcoo(a: BlockCOO) -> BlockCOO:
    """Ãᵀ in BlockCOO form: transpose tiles, swap (row, col), re-sort.

    The re-sort runs on the host (one read of the id lists), so this is
    set-up work, not a training step's."""
    rows = a.row_ids.cpu().numpy()
    cols = a.col_ids.cpu().numpy()
    order = np.lexsort((rows, cols))
    dev = a.blocks.device
    blocks = torch.cat(
        [a.blocks[: a.s_total][torch.from_numpy(order).to(dev)]
         .transpose(1, 2),
         torch.zeros((1, a.bk, a.bm), dtype=a.blocks.dtype, device=dev)])
    new_rows = np.ascontiguousarray(cols[order])
    return BlockCOO(
        blocks=blocks.contiguous(),
        row_ids=torch.from_numpy(new_rows).to(dev),
        col_ids=torch.from_numpy(np.ascontiguousarray(rows[order])).to(dev),
        bm=a.bk, bk=a.bm,
        n_rows=a.n_cols, n_cols=a.n_rows,
        n_row_blocks=a.n_col_blocks, n_col_blocks=a.n_row_blocks,
        s_total=a.s_total,
        row_ptr=torch.from_numpy(host_row_ptr(new_rows, a.n_col_blocks))
        .to(dev),
        tile_ids=a.tile_ids)
