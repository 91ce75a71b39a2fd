"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory).

The port of ``repro.models.lm.xlstm``, in plain tensor code (the
reference's is jnp). mLSTM runs in chunkwise-parallel form (a Python loop
over chunks of 128 positions, dense products within a chunk), with the
step-recurrent form ``mlstm_recurrent`` as decode path and oracle.

Stabilized recurrence (xLSTM paper eq. 19-27):
    m_t = max(f̃_t + m_{t-1}, ĩ_t)
    C_t = e^{f̃_t+m_{t-1}-m_t} C_{t-1} + e^{ĩ_t-m_t} v_t k_tᵀ
    n_t = e^{f̃_t+m_{t-1}-m_t} n_{t-1} + e^{ĩ_t-m_t} k_t
    h_t = (C_t q_t) / max(|n_tᵀ q_t|, e^{-m_t})        (q scaled by dk^-1/2)

The stabiliser starts at -1e30, so the first step's old state is scaled
by ``exp(-1e30 - m) = 0``. sLSTM is a sequential loop over positions with
per-head recurrent matrices, as the reference's scan is; each step takes
its four gates' recurrent products in one batched product.

Tensor parallel over ``model``, each rank its heads:
mLSTM's ``up`` packs the cell input and the output gate ``z`` side by
side, so it is used whole and each rank takes its columns of both
halves; the conv runs on them, ``wq``, ``wk``, ``wv`` read the whole
conv output and cell input (gathered over ``model``) into the rank's
heads, ``wgate`` is whole and each rank takes its heads' gates, and the
row-parallel ``down``'s partial output is summed over ``model``. sLSTM's
gate projections and recurrent matrices serve the rank's heads (``wo`` is
stored split by rows, so it too is used whole and sliced), the cell's
output is gathered whole for ``out_norm``, and its FFN is tensor parallel
as the dense MLP. Serving keeps the cells' states replicated, as
``DECODE_RULES`` lay them out: each rank's heads' carry is gathered over
``model`` to store, and decode reads the rank's heads back; the mLSTM's
conv tail is the rank's columns.
"""
from __future__ import annotations

import math
import types

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.lm.config import LMConfig
from repro_torch.models.lm.layers import Linear, Norm, apply_norm, \
    causal_conv, linear, mlp_apply, normal, row_linear, sigmoid, silu
from repro_torch.models.lm.sharding import copy_to_model, \
    gather_from_model, model_slice, tp_size

NEG = -1e30


# ----------------------------- mLSTM cell ----------------------------------

def _init_carry(b, nh, dk, dv, device):
    return (torch.zeros((b, nh, dv, dk), dtype=torch.float32, device=device),
            torch.zeros((b, nh, dk), dtype=torch.float32, device=device),
            torch.full((b, nh), NEG, dtype=torch.float32, device=device))


def mlstm_chunkwise(q, k, v, igate, fgate, *, chunk: int = 128,
                    carry=None):
    """q, k, v: (b, t, nh, dk/dv); igate, fgate: (b, t, nh) log-space.

    Returns (h: (b, t, nh, dv) f32, carry = (C, n, m)), linear in t.
    Raises ``AssertionError`` unless t is a multiple of ``min(chunk, t)``,
    as the reference asserts (no padding)."""
    b, t, nh, dk = q.shape
    dv = v.shape[-1]
    chunk = min(chunk, t)
    if t % chunk:
        raise AssertionError(f"t = {t} is not a multiple of chunk {chunk}")
    q = q.float() * dk ** -0.5
    k, v = k.float(), v.float()
    ig = igate.float()
    fg = F.logsigmoid(fgate.float())
    C, n, m = carry if carry is not None else _init_carry(b, nh, dk, dv,
                                                          q.device)
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=q.device))[None, :, :, None]
    hs = []
    for c0 in range(0, t, chunk):
        qc, kc, vc = q[:, c0:c0 + chunk], k[:, c0:c0 + chunk], \
            v[:, c0:c0 + chunk]
        ic, fc = ig[:, c0:c0 + chunk], fg[:, c0:c0 + chunk]
        bcum = torch.cumsum(fc, dim=1)                      # (b, chunk, nh)
        B = bcum[:, -1]                                     # (b, nh)
        # stabiliser per position: max(inter, intra); the intra pair
        # log-weight source is g_s = ĩ_s − b_s
        g = ic - bcum
        g_run = torch.cummax(g, dim=1).values               # max_{s≤t} g_s
        m_t = torch.maximum(bcum + m[:, None], bcum + g_run)
        lam = torch.exp(bcum + m[:, None] - m_t)            # inter scale
        # intra weights w_ts = b_t − b_s + ĩ_s − m_t (s ≤ t)
        w = (bcum[:, :, None] - bcum[:, None, :] + ic[:, None, :]
             - m_t[:, :, None])                             # (b, tq, ts, nh)
        dmat = torch.exp(torch.where(causal, w, torch.full((), NEG,
                                                           device=w.device)))
        scores = torch.einsum("bthd,bshd->btsh", qc, kc)
        intra = torch.einsum("btsh,bshv->bthv", scores * dmat, vc)
        inter = torch.einsum("bhvd,bthd->bthv", C, qc) * lam[..., None]
        n_t = (lam[..., None] * n[:, None]
               + torch.einsum("btsh,bshd->bthd", dmat, kc))
        denom = torch.maximum(
            torch.einsum("bthd,bthd->bth", n_t, qc).abs(), torch.exp(-m_t))
        hs.append((intra + inter) / denom[..., None])
        # carry to the next chunk
        m_new = torch.maximum(B + m, B + g_run[:, -1])
        scale_old = torch.exp(B + m - m_new)                # (b, nh)
        wk = torch.exp(B[:, None] - bcum + ic - m_new[:, None])
        C = (scale_old[:, :, None, None] * C
             + torch.einsum("bshv,bsh,bshd->bhvd", vc, wk, kc))
        n = (scale_old[:, :, None] * n
             + torch.einsum("bsh,bshd->bhd", wk, kc))
        m = m_new
    return torch.cat(hs, dim=1), (C, n, m)


def mlstm_recurrent(q, k, v, igate, fgate, carry=None):
    """Step-by-step oracle (and decode path); the signature and semantics
    of ``mlstm_chunkwise``."""
    b, t, nh, dk = q.shape
    dv = v.shape[-1]
    C, n, m = carry if carry is not None else _init_carry(b, nh, dk, dv,
                                                          q.device)
    qf = q.float() * dk ** -0.5
    kf, vf = k.float(), v.float()
    ig = igate.float()
    fg = F.logsigmoid(fgate.float())
    hs = []
    for i in range(t):
        qt, kt, vt, it, ft = qf[:, i], kf[:, i], vf[:, i], ig[:, i], fg[:, i]
        m_new = torch.maximum(ft + m, it)
        fs = torch.exp(ft + m - m_new)[..., None]
        is_ = torch.exp(it - m_new)[..., None]
        C = fs[..., None] * C + is_[..., None] * \
            torch.einsum("bhv,bhd->bhvd", vt, kt)
        n = fs * n + is_ * kt
        num = torch.einsum("bhvd,bhd->bhv", C, qt)
        den = torch.maximum(torch.einsum("bhd,bhd->bh", n, qt).abs(),
                            torch.exp(-m_new))
        hs.append(num / den[..., None])
        m = m_new
    return torch.stack(hs, dim=1), (C, n, m)


# ----------------------------- mLSTM block ---------------------------------

class MLSTM(nn.Module):
    """``norm``, ``up`` (d → 2·2d: the cell input and the output gate
    ``z``), ``conv_w``, ``conv_b``, ``wq``, ``wk``, ``wv``, ``wgate`` (the
    input and forget gates per head), ``head_norm`` and ``down``."""

    def __init__(self, cfg: LMConfig, device, gen=None):
        super().__init__()
        d = cfg.d_model
        ud, nh = 2 * d, cfg.mlstm_heads
        dt = getattr(torch, cfg.dtype)

        def lin(a, b):
            return Linear(a, b, dt, device, gen=gen)

        self.norm = Norm(d, cfg.norm, device)
        self.up = lin(d, 2 * ud)
        self.conv_w = nn.Parameter(normal((cfg.conv_width, ud), 0.1, dt,
                                          device, gen))
        self.conv_b = nn.Parameter(torch.zeros(ud, dtype=dt, device=device))
        self.wq, self.wk, self.wv = lin(ud, ud), lin(ud, ud), lin(ud, ud)
        self.wgate = lin(ud, 2 * nh)
        self.head_norm = Norm(ud // nh, device=device)
        self.down = lin(ud, d)


def mlstm_block(p: MLSTM, cfg: LMConfig, x, *, cache=None, mode="train"):
    """cache = {"C", "n", "m" (f32), "conv"}; returns (y, new_cache)."""
    b, t, _ = x.shape
    nh = cfg.mlstm_heads
    ud = 2 * cfg.d_model
    dk = ud // nh
    tp = tp_size() > 1
    xn = apply_norm(p.norm, x, cfg.norm_eps)
    if tp:   # this rank's columns of the cell input and of z
        xn = copy_to_model(xn)
        cols = model_slice(ud)
        up = xn @ torch.cat([p.up.w[:, cols],
                             p.up.w[:, ud + cols.start:ud + cols.stop]], 1)
        heads = model_slice(nh)
    else:
        up = linear(p.up, xn)
        heads = slice(0, nh)
    xm, z = up.chunk(2, dim=-1)
    conv_state = cache.get("conv") if cache else None
    xc, conv_tail = causal_conv(p.conv_w, p.conv_b, xm, conv_state)
    xc = silu(xc)
    xc_all = gather_from_model(xc, partial=True) if tp else xc
    xm_all = gather_from_model(xm, partial=True) if tp else xm
    q = linear(p.wq, xc_all).reshape(b, t, -1, dk)
    k = linear(p.wk, xc_all).reshape(b, t, -1, dk)
    v = linear(p.wv, xm_all).reshape(b, t, -1, dk)
    gates = linear(p.wgate, xc_all).float()
    ig, fg = gates[..., heads], gates[..., nh + heads.start:nh + heads.stop]
    if mode == "decode":
        h, carry = mlstm_recurrent(q, k, v, ig, fg, tuple(
            cache[c][:, heads] for c in ("C", "n", "m")))
    else:
        h, carry = mlstm_chunkwise(q, k, v, ig, fg, chunk=128)
    h = apply_norm(p.head_norm, h.to(x.dtype), cfg.norm_eps)
    out = row_linear(p.down, h.reshape(b, t, -1) * silu(z))
    new_cache = None
    if mode in ("prefill", "decode"):   # the carry replicated: every head
        C, n, m = (gather_from_model(c, 1) for c in carry)
        new_cache = {"C": C, "n": n, "m": m, "conv": conv_tail}
    return out, new_cache


# ----------------------------- sLSTM block ---------------------------------

class SLSTM(nn.Module):
    """``norm``; per gate g in z, i, f, o an input projection ``w<g>`` and
    a per-head recurrent matrix ``r<g>`` (nh, dh, dh); ``out_norm`` and a
    GeGLU FFN ``ffn_gate``, ``ffn_up``, ``ffn_down``."""

    def __init__(self, cfg: LMConfig, device, gen=None):
        super().__init__()
        d, nh = cfg.d_model, cfg.slstm_heads
        dh = d // nh
        dt = getattr(torch, cfg.dtype)
        d_ff = int(d * 4 / 3 // 64 * 64) or 64
        self.norm = Norm(d, cfg.norm, device)
        for g in ("z", "i", "f", "o"):
            setattr(self, f"w{g}", Linear(d, d, dt, device, gen=gen))
            setattr(self, f"r{g}", nn.Parameter(normal(
                (nh, dh, dh), 1 / math.sqrt(dh), dt, device, gen)))
        self.out_norm = Norm(d, cfg.norm, device)
        self.ffn_gate = Linear(d, d_ff, dt, device, gen=gen)
        self.ffn_up = Linear(d, d_ff, dt, device, gen=gen)
        self.ffn_down = Linear(d_ff, d, dt, device, gen=gen)


def slstm_cell(p: SLSTM, cfg: LMConfig, x, carry=None):
    """x: (b, t, d); a sequential loop over t. carry = (c, n, h, m), each
    (b, nh, dh) f32. Returns (h (b, t, d) in x's dtype, carry). Under
    tensor parallelism ``nh`` is this rank's heads and ``h`` their
    ``nh·dh`` columns."""
    b, t, d = x.shape
    dh = d // cfg.slstm_heads
    heads = model_slice(cfg.slstm_heads)
    nh = heads.stop - heads.start
    cols = slice(heads.start * dh, heads.stop * dh)
    if carry is None:
        zero = torch.zeros((b, nh, dh), dtype=torch.float32, device=x.device)
        carry = (zero, zero, zero,
                 torch.full((b, nh, dh), NEG, dtype=torch.float32,
                            device=x.device))
    c, n, h, m = carry
    # input projections of every position, (t, b, nh, 4·dh) in gate order
    # z, i, f, o; the recurrent matrices side by side, (nh, dh, 4·dh)
    def proj(w):    # this rank's heads of a whole (stored row-split) w
        return x @ (w.w if w.w.shape[1] == nh * dh else w.w[:, cols])
    wx = torch.cat([proj(getattr(p, f"w{g}")).reshape(b, t, nh, dh)
                    .float() for g in "zifo"], dim=-1).transpose(0, 1)
    r = torch.cat([getattr(p, f"r{g}")[heads].float() for g in "zifo"],
                  dim=-1)
    hs = []
    for i in range(t):
        pre = wx[i] + torch.einsum("bhd,hde->bhe", h, r)
        xz, xi, xf, xo = pre.split(dh, dim=-1)
        zt = torch.tanh(xz)
        ft = F.logsigmoid(xf)
        ot = sigmoid(xo)
        m_new = torch.maximum(ft + m, xi)          # xi is ĩ, log-space
        fs, is_ = torch.exp(ft + m - m_new), torch.exp(xi - m_new)
        c = fs * c + is_ * zt
        n = fs * n + is_
        h = ot * c / torch.clamp(n, min=1e-6)
        m = m_new
        hs.append(h)
    out = torch.stack(hs, dim=1).reshape(b, t, nh * dh).to(x.dtype)
    return out, (c, n, h, m)


def slstm_block(p: SLSTM, cfg: LMConfig, x, *, cache=None, mode="train"):
    """cache = {"c", "n", "h", "m"} (f32); returns (y, new_cache)."""
    xn = apply_norm(p.norm, x, cfg.norm_eps)
    tp = tp_size() > 1
    if tp:
        xn = copy_to_model(xn)
    carry = None
    if cache is not None and mode == "decode":
        heads = model_slice(cfg.slstm_heads)
        carry = tuple(cache[c][:, heads] for c in ("c", "n", "h", "m"))
    h, carry = slstm_cell(p, cfg, xn, carry)
    if tp:   # out_norm and what follows it run alike on every rank
        h = gather_from_model(h)
    h = apply_norm(p.out_norm, h, cfg.norm_eps)
    ffn = types.SimpleNamespace(gate=p.ffn_gate, up=p.ffn_up,
                                down=p.ffn_down)
    out = mlp_apply(ffn, h, "geglu")
    new_cache = None
    if mode in ("prefill", "decode"):   # the carry replicated: every head
        new_cache = {c: gather_from_model(z, 1)
                     for c, z in zip(("c", "n", "h", "m"), carry)}
    return out, new_cache
