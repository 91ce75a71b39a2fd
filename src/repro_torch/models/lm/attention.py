"""Self-attention of the LM stack: GQA, sliding window, KV caches.

The port of ``repro.models.lm.attention`` for serving (prefill and
decode). Prefill attention goes through ``kernels.ops.flash_attention``:
on a CUDA tensor the hand-written kernel (the reference's TPU branch), on
a CPU tensor its plain version. Decode is plain tensor code, as it is jnp
in the reference.

Caches (one dict per layer):
  full  : {"k","v": (b, S, n_kv, hd)} written at absolute positions.
  local : ring buffer {"k","v": (b, W, n_kv, hd), "pos": (W,) int32} —
          "pos" holds each slot's absolute position (-1 = empty).
Decode writes the new token's k/v into the cache in place and returns the
same dict; the reference returns updated copies.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels import ops
from repro_torch.kernels.ref import NEG_INF
from repro_torch.models.lm.config import LMConfig
from repro_torch.models.lm.layers import Linear, Norm, apply_norm, \
    apply_rope, linear

TRAINING = "ROADMAP.md Queue 1 item 9b (LM training)"
LM_REST = "ROADMAP.md Queue 1 item 9c (LM stack: the rest)"


class Attention(nn.Module):
    """Projections ``wq, wk, wv, wo`` (``x @ w`` layout) and, with
    ``cfg.qk_norm``, per-head RMSNorms ``q_norm, k_norm``."""

    def __init__(self, cfg: LMConfig, device, gen=None):
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


def attn_init(cfg: LMConfig, device, gen=None) -> Attention:
    """Self-attention parameters (cross-attention is not ported)."""
    return Attention(cfg, device, gen)


def decode_attention(
    q: torch.Tensor,             # (b, 1, nq, hd)
    k: torch.Tensor,             # (b, S, nkv, hd)
    v: torch.Tensor,             # (b, S, nkv, hv)
    kv_positions: torch.Tensor,  # (S,) absolute (-1 ⇒ invalid)
    q_position: int | None,
    window: int | None = None,
) -> torch.Tensor:
    """Single-token attention over the whole cache, in f32."""
    b, _, nq, hd = q.shape
    nkv, hv = k.shape[2], v.shape[-1]
    g = nq // nkv
    qf = (q.float() * hd ** -0.5).reshape(b, nkv, g, hd)
    s = torch.einsum("bkgh,bskh->bkgs", qf, k.float())
    ok = kv_positions >= 0
    if q_position is not None:
        ok &= kv_positions <= q_position
        if window is not None:
            ok &= kv_positions > q_position - window
    s = torch.where(ok, s, torch.full((), NEG_INF, device=s.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskh->bkgh", p, v.float())
    return out.reshape(b, 1, nq, hv).to(q.dtype)


def _project_qkv(p: Attention, cfg: LMConfig, x, positions):
    b, t, _ = x.shape
    hd = cfg.hd
    q = linear(p.wq, x).reshape(b, t, cfg.n_heads, hd)
    k = linear(p.wk, x).reshape(b, t, cfg.n_kv, hd)
    v = linear(p.wv, x).reshape(b, t, cfg.n_kv, hd)
    if cfg.qk_norm:
        q = apply_norm(p.q_norm, q, cfg.norm_eps)
        k = apply_norm(p.k_norm, k, cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


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
    """Returns (out, new_cache). Modes: prefill | decode (train raises)."""
    if mode == "train":
        raise NotImplementedError(
            f"training attention is not ported to repro_torch yet: see "
            f"{TRAINING}")
    b, t, _ = x.shape
    q, k, v = _project_qkv(p, cfg, x, positions)

    if mode == "prefill":
        new_cache = {"k": k, "v": v} if window is None \
            else _ring(cfg, k, v, positions, window)
        out = ops.flash_attention(q, k, v, causal=True, window=window)
    elif mode == "decode":  # t == 1: write into the cache, attend over it
        if cache is None or cache_len is None:
            raise ValueError("decode needs a cache and its length")
        if window is None:
            cache["k"][:, cache_len] = k[:, 0]
            cache["v"][:, cache_len] = v[:, 0]
            kv_pos = torch.arange(cache["k"].shape[1], dtype=torch.int32,
                                  device=x.device)
            kv_pos = torch.where(kv_pos <= cache_len, kv_pos, -1)
        else:
            slot = cache_len % window
            cache["k"][:, slot] = k[:, 0]
            cache["v"][:, slot] = v[:, 0]
            cache["pos"][slot] = cache_len
            kv_pos = cache["pos"]
        out = decode_attention(q, cache["k"], cache["v"], kv_pos, cache_len,
                               window=window)
        new_cache = cache
    else:
        raise ValueError(f"unknown mode {mode!r}")

    out = out.reshape(b, t, cfg.n_heads * cfg.hd)
    return linear(p.wo, out), new_cache
