"""Plain PyTorch versions of the hand-written kernels.

They compute what the kernels compute (``bcoo_spmm_ref``,
``gather_matmul_ref``, ``flash_attention_ref``), on any device, and are
what a kernel wrapper runs for a tensor that lies on the CPU. The tests
hold them against ``repro.kernels.ref``; ``chip_smoke.py`` holds the
kernels against them on the card.
"""
from __future__ import annotations

import torch


def epilogue(acc: torch.Tensor, bias: torch.Tensor | None,
             residual: torch.Tensor | None, relu: bool,
             dtype: torch.dtype) -> torch.Tensor:
    """``relu(acc + bias + residual)`` in f32, cast to ``dtype`` — the
    fused epilogue of the SpMM kernel."""
    y = acc.float()
    if bias is not None:
        y = y + bias.float()
    if residual is not None:
        y = y + residual.float()
    if relu:
        y = torch.relu(y)
    return y.to(dtype)


def bcoo_spmm_ref(
    blocks: torch.Tensor,   # (S+1, bm, bk)
    sel: torch.Tensor,      # (s_pad,)
    row_ids: torch.Tensor,  # (s_pad,)
    col_ids: torch.Tensor,  # (s_pad,)
    h: torch.Tensor,        # (n_cols, d)
    *,
    n_row_blocks: int,
    bm: int,
    bk: int,
    bias: torch.Tensor | None = None,
    residual: torch.Tensor | None = None,
    relu: bool = False,
) -> torch.Tensor:
    """``out[r] = Σ_{s: row_ids[s]==r} blocks[sel[s]] @ h[col_ids[s]]``.

    Products and sums in f32, result in ``h``'s dtype. Entries whose row id
    lies outside ``[0, n_row_blocks)`` are dropped, as ``segment_sum`` drops
    them in the reference (``index_add_`` would raise). With any of
    ``bias``/``residual``/``relu`` the kernel's epilogue is applied to the
    f32 sums before the cast.
    """
    d = h.shape[-1]
    hb = h.reshape(-1, bk, d)
    tiles = blocks[sel.long()].float()                   # (s_pad, bm, bk)
    gathered = hb[col_ids.long()].float()                # (s_pad, bk, d)
    part = torch.einsum("sij,sjd->sid", tiles, gathered)
    rows = row_ids.long()
    keep = (rows >= 0) & (rows < n_row_blocks)
    acc = torch.zeros((n_row_blocks, bm, d), dtype=torch.float32,
                      device=h.device)
    acc.index_add_(0, rows[keep], part[keep])
    acc = acc.reshape(n_row_blocks * bm, d)
    if bias is None and residual is None and not relu:
        return acc.to(h.dtype)
    return epilogue(acc, bias, residual, relu, h.dtype)


def gather_matmul_ref(
    x: torch.Tensor,     # (n, m)
    g: torch.Tensor,     # (n, q)
    idx: torch.Tensor,   # (k_sel,) selected bk-row blocks
    *,
    bk: int,
) -> torch.Tensor:
    """``Σ_t X[idx[t]·bk : +bk]ᵀ @ G[idx[t]·bk : +bk]``: the XᵀG contraction
    over the selected ``bk``-row token blocks, summed in f32 and cast to
    x's dtype."""
    n, m = x.shape
    sel = idx.long()
    xs = x.reshape(n // bk, bk, m)[sel]
    gs = g.reshape(n // bk, bk, -1)[sel]
    return torch.einsum("kbm,kbq->mq", xs.float(), gs.float()).to(x.dtype)


NEG_INF = -1e30   # the reference's mask score (not -inf)


def flash_attention_ref(
    q: torch.Tensor,    # (b, tq, nq, hd)
    k: torch.Tensor,    # (b, tk, nkv, hd)
    v: torch.Tensor,    # (b, tk, nkv, hd)
    *,
    q_offset: int = 0,
    causal: bool = True,
    window: int | None = None,
    q_chunk: int | None = None,
) -> torch.Tensor:
    """Dense-softmax attention with the flash kernel's masks.

    Query ``i`` sits at position ``q_offset + i``, key ``j`` at ``j``.
    Causal keeps ``kpos <= qpos``; a window keeps ``kpos > qpos - window``.
    Masked scores are ``-1e30``, so a row whose every key is masked
    averages all ``tk`` values, as the reference does. Query head ``h``
    reads kv head ``h // (nq // nkv)``. Math in f32, result in q's dtype.
    ``q_chunk`` bounds the ``(b, nq, q_chunk, tk)`` score tensor held at
    once; it does not change the result.
    """
    b, tq, nq, hd = q.shape
    tk, nkv = k.shape[1], k.shape[2]
    if nq % nkv:
        raise ValueError(f"nq={nq} must be a multiple of nkv={nkv}")
    g = nq // nkv
    k32, v32 = k.float(), v.float()
    kpos = torch.arange(tk, device=q.device)[None, :]
    outs = []
    step = q_chunk or max(tq, 1)
    for i0 in range(0, tq, step):
        qc = q[:, i0:i0 + step].float() * hd ** -0.5
        c = qc.shape[1]
        s = torch.einsum("bqkgd,bskd->bkgqs",
                         qc.reshape(b, c, nkv, g, hd), k32)
        qpos = q_offset + i0 + torch.arange(c, device=q.device)[:, None]
        mask = torch.ones((c, tk), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos <= qpos
        if window is not None:
            mask &= kpos > qpos - window
        s = torch.where(mask, s, torch.full((), NEG_INF, device=q.device))
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bkgqs,bskd->bqkgd", p, v32)
        outs.append(o.reshape(b, c, nq, hd).to(q.dtype))
    return torch.cat(outs, 1) if outs else q.new_empty(q.shape)
