"""Attention of the LM stack: GQA, sliding window, gated cross-attention.

The port of ``repro.models.lm.attention``. Prefill self-attention goes
through ``kernels.ops.flash_attention``: on a CUDA tensor the hand-written
kernel (the reference's TPU branch), on a CPU tensor its plain version.
Training attention (``flash_attention`` below, kv-chunked online softmax
with each chunk step rematerialised), decode, and cross-attention in every
mode are plain tensor code, as all are jnp in the reference; training
differentiates through them with autograd.

Caches (one dict per layer):
  full  : {"k","v": (b, S, n_kv, hd)} written at absolute positions.
  local : ring buffer {"k","v": (b, W, n_kv, hd), "pos": (W,) int32} —
          "pos" holds each slot's absolute position (-1 = empty).
  cross : {"k","v": (b, S_cross, n_kv, hd)} computed once at prefill and
          read as they are in decode.
Decode writes the new token's k/v into the cache in place and returns the
same dict; the reference returns updated copies. On a mesh under
``DECODE_RULES`` each rank holds its ``kv_seq`` block of a cache's
positions (slots), and decode attention is sequence parallel
(``decode_attention`` with ``mesh``).
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops
from repro_torch.kernels.ref import NEG_INF
from repro_torch.models.lm.config import LMConfig
from repro_torch.models.lm.layers import Linear, Norm, apply_norm, \
    apply_rope, linear, row_linear
from repro_torch.models.lm.sharding import copy_to_model, current_mesh, \
    gather_heads, kv_seq_block, kv_seq_length, kv_seq_slice, shard, \
    softmax_over_model, tp_size

class Attention(nn.Module):
    """Projections ``wq, wk, wv, wo`` (``x @ w`` layout), with
    ``cfg.qk_norm`` per-head RMSNorms ``q_norm, k_norm``, and for
    cross-attention the f32 scalar ``gate`` (0 at init: tanh-gated, as in
    llama-3.2-vision)."""

    def __init__(self, cfg: LMConfig, device, gen=None, cross: bool = False):
        super().__init__()
        d, hd, dt = cfg.d_model, cfg.hd, getattr(torch, cfg.dtype)
        self.wq = Linear(d, cfg.n_heads * hd, dt, device, bias=cfg.qkv_bias,
                         gen=gen)
        self.wk = Linear(d, cfg.n_kv * hd, dt, device, bias=cfg.qkv_bias,
                         gen=gen)
        self.wv = Linear(d, cfg.n_kv * hd, dt, device, bias=cfg.qkv_bias,
                         gen=gen)
        self.wo = Linear(cfg.n_heads * hd, d, dt, device, gen=gen)
        self.q_norm = Norm(hd, device=device) if cfg.qk_norm else None
        self.k_norm = Norm(hd, device=device) if cfg.qk_norm else None
        self.gate = nn.Parameter(torch.zeros((), dtype=torch.float32,
                                             device=device)) \
            if cross else None


def attn_init(cfg: LMConfig, device, gen=None,
              kind: str = "full") -> Attention:
    """Attention parameters of ``kind`` ``"full"`` or ``"cross"``."""
    return Attention(cfg, device, gen, cross=(kind == "cross"))


def _chunk_step(m, l, acc, qg, kch, vch, pch, q_positions, window):
    """One kv chunk of the online softmax: fold ``chunk`` keys into the
    running max ``m``, sum ``l`` and accumulator ``acc`` (all f32)."""
    s = torch.einsum("btkgh,bckh->btkgc", qg, kch.float())
    mask = (pch >= 0)[None, None, None, None, :]
    if q_positions is not None:
        ok = pch[None, :] <= q_positions[:, None]            # (tq, chunk)
        if window is not None:
            ok &= pch[None, :] > q_positions[:, None] - window
        mask = mask & ok[None, :, None, None, :]
    s = torch.where(mask, s, torch.full((), NEG_INF, device=s.device))
    m_new = torch.maximum(m, s.amax(-1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    l = l * alpha + p.sum(-1)
    pv = torch.einsum("btkgc,bckh->btkgh", p, vch.float())
    acc = acc * alpha[..., None] + pv
    return m_new, l, acc


def flash_attention(
    q: torch.Tensor,                 # (b, tq, nq, hd)
    k: torch.Tensor,                 # (b, tk, nkv, hd)
    v: torch.Tensor,                 # (b, tk, nkv, hv)
    *,
    q_positions: torch.Tensor | None,   # (tq,) absolute; None = no mask
    kv_positions: torch.Tensor,         # (tk,) absolute (-1 ⇒ invalid)
    window: int | None = None,
    chunk: int = 1024,
    remat_chunks: bool = True,
) -> torch.Tensor:
    """Training attention: the reference's kv-chunked online softmax in
    f32 (scores scaled by ``hd**-0.5``, masked to ``-1e30``; kv padded to
    a multiple of ``chunk`` with position -1), differentiable by autograd.
    With ``remat_chunks`` each chunk step runs under
    ``torch.utils.checkpoint``, so its ``(tq, chunk)`` scores are
    recomputed in the backward instead of stored. Output in q's dtype."""
    b, tq, nq, hd = q.shape
    tk, nkv = k.shape[1], k.shape[2]
    hv = v.shape[-1]
    g = nq // nkv
    qg = (q.float() * hd ** -0.5).reshape(b, tq, nkv, g, hd)

    chunk = min(chunk, tk)
    if tk % chunk:   # pad kv to a chunk multiple with masked (-1) positions
        pad = chunk - tk % chunk
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        kv_positions = torch.nn.functional.pad(kv_positions, (0, pad),
                                               value=-1)
        tk += pad
    m = torch.full((b, tq, nkv, g), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, tq, nkv, g), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, tq, nkv, g, hv), dtype=torch.float32,
                      device=q.device)
    for c0 in range(0, tk, chunk):
        args = (m, l, acc, qg, k[:, c0:c0 + chunk], v[:, c0:c0 + chunk],
                kv_positions[c0:c0 + chunk], q_positions, window)
        if remat_chunks:
            m, l, acc = checkpoint(_chunk_step, *args, use_reentrant=False)
        else:
            m, l, acc = _chunk_step(*args)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, tq, nq, hv).to(q.dtype)


def decode_attention(
    q: torch.Tensor,             # (b, 1, nq, hd)
    k: torch.Tensor,             # (b, S, nkv, hd)
    v: torch.Tensor,             # (b, S, nkv, hv)
    kv_positions: torch.Tensor,  # (S,) absolute (-1 ⇒ invalid)
    q_position: int | None,
    window: int | None = None,
    mesh=None,
) -> torch.Tensor:
    """Single-token attention over the whole cache, in f32.

    With ``mesh`` it is sequence parallel, as the reference's docstring
    has it: ``q`` holds this rank's query heads, ``k`` / ``v`` /
    ``kv_positions`` this rank's block of the cache's sequence (every kv
    head); the queries are gathered over ``model``, every head is scored
    against the block, the softmax is merged over ``model``
    (``sharding.softmax_over_model``) and the rank's heads of the output
    are returned. The scores and probabilities stay on their rank: the
    only traffic is the queries, the row maxima and sums, and the f32
    partial outputs, all ``(b, heads)``-sized."""
    b, _, nq, hd = q.shape
    nkv, hv = k.shape[2], v.shape[-1]
    qf = q.float() * hd ** -0.5
    if mesh is not None:
        qf = gather_heads(qf, mesh)
    qf = qf.reshape(b, nkv, -1, hd)
    s = torch.einsum("bkgh,bskh->bkgs", qf, k.float())
    ok = kv_positions >= 0
    if q_position is not None:
        ok &= kv_positions <= q_position
        if window is not None:
            ok &= kv_positions > q_position - window
    s = torch.where(ok, s, torch.full((), NEG_INF, device=s.device))
    if mesh is None:
        p = torch.softmax(s, dim=-1)
        out = torch.einsum("bkgs,bskh->bkgh", p, v.float())
        return out.reshape(b, 1, nq, hv).to(q.dtype)
    out = softmax_over_model(
        s, lambda p: torch.einsum("bkgs,bskh->bkgh", p, v.float()), mesh)
    h0 = mesh.index("model") * nq
    return out.reshape(b, 1, -1, hv)[:, :, h0:h0 + nq].to(q.dtype)


def _project_qkv(p: Attention, cfg: LMConfig, x, positions):
    b, t, _ = x.shape
    hd = cfg.hd
    # heads from the width: under tensor parallelism wq holds this
    # rank's query heads only
    q = linear(p.wq, x).reshape(b, t, -1, hd)
    k = linear(p.wk, x).reshape(b, t, -1, hd)
    v = linear(p.wv, x).reshape(b, t, -1, hd)
    if cfg.qk_norm:
        q = apply_norm(p.q_norm, q, cfg.norm_eps)
        k = apply_norm(p.k_norm, k, cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _local_kv(cfg: LMConfig, k, v, nq_local: int, mesh):
    """The kv heads this rank's query heads read (GQA: global query head
    ``h`` reads kv head ``h // (n_heads / n_kv)``), in the grouping
    ``flash_attention`` expects: a slice when the local heads cover
    whole groups or lie in one group, else one kv head per query head."""
    g = cfg.n_heads // cfg.n_kv
    h0 = mesh.index("model") * nq_local
    if nq_local % g == 0:
        return (k[:, :, h0 // g:(h0 + nq_local) // g],
                v[:, :, h0 // g:(h0 + nq_local) // g])
    if g % nq_local == 0:
        return k[:, :, h0 // g:h0 // g + 1], v[:, :, h0 // g:h0 // g + 1]
    ids = (torch.arange(h0, h0 + nq_local, device=k.device) // g)
    return k[:, :, ids], v[:, :, ids]


def _ring(cfg: LMConfig, k, v, positions, window: int) -> dict:
    """The local cache after a prefill: the last ``min(window, t)`` keys at
    slots ``position % window``."""
    b, t = k.shape[:2]
    w = min(window, t)
    slots = (positions[-w:] % window).long()
    kr = torch.zeros((b, window, cfg.n_kv, cfg.hd), dtype=k.dtype,
                     device=k.device)
    vr = torch.zeros_like(kr)
    pos_buf = torch.full((window,), -1, dtype=torch.int32, device=k.device)
    kr[:, slots] = k[:, -w:]
    vr[:, slots] = v[:, -w:]
    pos_buf[slots] = positions[-w:].to(torch.int32)
    return {"k": kr, "v": vr, "pos": pos_buf}


def self_attention(
    p: Attention, cfg: LMConfig, x, positions, *,
    cache: dict | None = None,
    cache_len: int | None = None,
    window: int | None = None,
    mode: str = "train",
):
    """Returns (out, new_cache). Modes: train | prefill | decode.

    Under a mesh context with ``model`` > 1 the layer is tensor parallel:
    ``wq`` holds this rank's query heads, ``wk`` / ``wv`` are whole (kv
    heads replicated, ``kv_heads`` of the rules), each local query head
    reads its own kv head, and the row-parallel ``wo``'s partial output
    is summed over ``model``. Serving (``DECODE_RULES``) keeps the cache
    sequence parallel: prefill caches this rank's ``kv_seq`` block of the
    whole k/v (every kv head; the ring buffer's block of slots), decode
    writes the new token where its position (slot) falls, on that rank
    only, updates the replicated ``pos`` on every rank, and attends with
    ``decode_attention``'s sequence-parallel merge. Where ``model`` does
    not divide the axis the cache is whole on every rank and decode
    attends over it with the rank's heads alone."""
    b, t, _ = x.shape
    mesh = current_mesh()
    tp = tp_size(mesh) > 1
    if tp:
        x = copy_to_model(x)
    q, k, v = _project_qkv(p, cfg, x, positions)
    shard(q, "batch", "seq", "heads", None)
    shard(k, "batch", "seq", "kv_heads", None)

    if mode == "train":
        if tp:
            k, v = _local_kv(cfg, k, v, q.shape[2], mesh)
        out = flash_attention(q, k, v, q_positions=positions,
                              kv_positions=positions, window=window,
                              chunk=cfg.attn_chunk)
        new_cache = None
    elif mode == "prefill":
        if window is None:
            new_cache = {"k": kv_seq_block(k, t), "v": kv_seq_block(v, t)}
        else:
            new_cache = _ring(cfg, k, v, positions, window)
            for name in ("k", "v"):
                new_cache[name] = kv_seq_block(new_cache[name], window)
        if tp:
            k, v = (z.contiguous() for z in
                    _local_kv(cfg, k, v, q.shape[2], mesh))
        out = ops.flash_attention(q, k, v, causal=True, window=window)
    elif mode == "decode":  # t == 1: write into the cache, attend over it
        if cache is None or cache_len is None:
            raise ValueError("decode needs a cache and its length")
        if window is None:
            n = kv_seq_length(cache["k"]) if tp else cache["k"].shape[1]
            sl = kv_seq_slice(n)
            pos = torch.arange(sl.start, sl.stop, dtype=torch.int32,
                               device=x.device)
            kv_pos = torch.where(pos <= cache_len, pos, -1)
            at = cache_len - sl.start
        else:
            n = cache["pos"].shape[0]
            sl = kv_seq_slice(n)
            at = cache_len % window - sl.start
            cache["pos"][cache_len % window] = cache_len
            kv_pos = cache["pos"][sl]
        if 0 <= at < sl.stop - sl.start:   # the rank that holds the slot
            cache["k"][:, at] = k[:, 0]
            cache["v"][:, at] = v[:, 0]
        if not tp:
            out = decode_attention(q, cache["k"], cache["v"], kv_pos,
                                   cache_len, window=window)
        elif sl.stop - sl.start < n:
            out = decode_attention(q, cache["k"], cache["v"], kv_pos,
                                   cache_len, window=window, mesh=mesh)
        else:
            out = decode_attention(
                q, *_local_kv(cfg, cache["k"], cache["v"], q.shape[2], mesh),
                kv_pos, cache_len, window=window)
        new_cache = cache
    else:
        raise ValueError(f"unknown mode {mode!r}")

    return row_linear(p.wo, out.reshape(b, t, -1)), new_cache


def cross_attention(p: Attention, cfg: LMConfig, x, cross_states, *,
                    cache: dict | None = None, mode: str = "train"):
    """Gated cross-attention (llama-3.2-vision layers), no causal mask:
    ``tanh(gate) · wo(attention of x's queries over cross_states' k/v)``.
    Prefill computes k/v from ``cross_states`` and caches them; decode
    reads them from the cache. Returns (out, new_cache).

    Tensor parallel as ``self_attention``: ``wq`` holds this rank's query
    heads, ``wk`` / ``wv`` are whole over the replicated
    ``cross_states``, and the gate scales the output after its sum over
    ``model`` (so the gate's gradient is whole). Serving caches this
    rank's ``kv_seq`` block of the cross states' k/v, and decode merges
    the softmax over ``model`` as ``self_attention`` does, unmasked."""
    b, t, _ = x.shape
    hd = cfg.hd
    mesh = current_mesh()
    tp = tp_size(mesh) > 1
    if tp:
        x = copy_to_model(x)
    q = linear(p.wq, x).reshape(b, t, -1, hd)
    shard(q, "batch", "seq", "heads", None)
    if cfg.qk_norm:
        q = apply_norm(p.q_norm, q, cfg.norm_eps)
    if mode == "decode":
        if cache is None:
            raise ValueError("decode needs a cache")
        n = cfg.cross_seq if tp else cache["k"].shape[1]
        sl = kv_seq_slice(n)
        kv_pos = torch.arange(sl.start, sl.stop, dtype=torch.int32,
                              device=x.device)
        if tp and sl.stop - sl.start < n:
            out = decode_attention(q, cache["k"], cache["v"], kv_pos, None,
                                   mesh=mesh)
        else:
            k, v = cache["k"], cache["v"]
            if tp:
                k, v = _local_kv(cfg, k, v, q.shape[2], mesh)
            out = decode_attention(q, k, v, kv_pos, None)
        new_cache = cache
    else:
        s = cross_states.shape[1]
        k = linear(p.wk, cross_states).reshape(b, s, cfg.n_kv, hd)
        v = linear(p.wv, cross_states).reshape(b, s, cfg.n_kv, hd)
        if cfg.qk_norm:
            k = apply_norm(p.k_norm, k, cfg.norm_eps)
        new_cache = {"k": kv_seq_block(k, s), "v": kv_seq_block(v, s)} \
            if mode == "prefill" else None
        if tp:
            k, v = _local_kv(cfg, k, v, q.shape[2], mesh)
        kv_pos = torch.arange(s, dtype=torch.int32, device=x.device)
        out = flash_attention(q, k, v, q_positions=None, kv_positions=kv_pos,
                              chunk=cfg.attn_chunk,
                              remat_chunks=(mode == "train"))
    out = row_linear(p.wo, out.reshape(b, t, -1))
    return out * torch.tanh(p.gate).to(x.dtype), new_cache
