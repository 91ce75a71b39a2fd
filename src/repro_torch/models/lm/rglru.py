"""Griffin/RecurrentGemma recurrent block: conv1d + RG-LRU gated recurrence.

The port of ``repro.models.lm.rglru``.

RG-LRU:  r_t = σ(W_a x_t + b_a)          (recurrence gate)
         i_t = σ(W_x x_t + b_x)          (input gate)
         a_t = exp(−c · softplus(Λ) · r_t),  c = 8
         h_t = a_t ⊙ h_{t-1} + √(1−a_t²) ⊙ (i_t ⊙ x_t)

Train and prefill run the linear recurrence as a log-depth inclusive scan
(Hillis–Steele: ⌈log2 t⌉ rounds, each combining every position with the
one ``2^r`` before it), in plain tensor code and differentiable by
autograd; the reference's ``associative_scan`` combines in another tree
order, so the two round f32 products differently. Decode is the one-step
form carrying the ``h`` and conv-tail state. Block layout (Griffin): gate
branch (GeLU) × recurrent branch (conv → LRU), merged, then
down-projected. The parameter ``lambda`` (Λ, f32) is registered under the
reference's name, a Python keyword.

Tensor parallel over ``model``: each rank holds its share of the LRU
width (``in_gate``, ``in_rec``, ``conv_w``, ``conv_b``, ``lambda`` and the
columns of ``wa`` / ``wx``), so the conv and the scan (or decode's step),
which are per channel, run on it; ``wa`` and ``wx`` read the whole conv
output (gathered over ``model``, its gradient reduce-scattered back), and
the row-parallel ``out``'s partial output is summed over ``model``. The
cache is the rank's share of the width: ``h`` (b, w/model) and ``conv``
(b, cw-1, w/model), as ``DECODE_RULES`` lay them out.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models.lm.config import LMConfig
from repro_torch.models.lm.layers import Linear, causal_conv, gelu, \
    linear, normal, row_linear, sigmoid
from repro_torch.models.lm.sharding import copy_to_model, \
    gather_from_model, tp_size

_C = 8.0


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + e^x)`` as ``jax.nn.softplus`` computes it
    (``logaddexp(x, 0)``; ``F.softplus`` switches to ``x`` above 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


class RGLRU(nn.Module):
    """``in_gate``, ``in_rec``, ``conv_w`` (width, w), ``conv_b``, ``wa``,
    ``wx``, ``lambda`` and ``out``."""

    def __init__(self, cfg: LMConfig, device, gen=None):
        super().__init__()
        d = cfg.d_model
        w = cfg.lru_width or d
        dt = getattr(torch, cfg.dtype)
        self.in_gate = Linear(d, w, dt, device, gen=gen)
        self.in_rec = Linear(d, w, dt, device, gen=gen)
        self.conv_w = nn.Parameter(normal((cfg.conv_width, w), 0.1, dt,
                                          device, gen))
        self.conv_b = nn.Parameter(torch.zeros(w, dtype=dt, device=device))
        self.wa = Linear(w, w, dt, device, gen=gen)
        self.wx = Linear(w, w, dt, device, gen=gen)
        # Λ so that a ∈ (0.9, 0.999) at r = 1 (Griffin appendix)
        if gen is None:
            lam = torch.empty(w, dtype=torch.float32, device=device)
        else:
            u = 0.9 + 0.099 * torch.rand(w, generator=gen,
                                         dtype=torch.float32, device=device)
            lam = torch.log(torch.expm1(-torch.log(u) / _C))
        self.register_parameter("lambda", nn.Parameter(lam))
        self.out = Linear(w, d, dt, device, gen=gen)


def _gates(p: RGLRU, x, x_all=None):
    """f32 ``a`` and the gated input ``√(1−a²)·i·x`` of x (b, t, w); the
    gates read ``x_all``, the whole width under tensor parallelism (``x``
    by default)."""
    x_all = x if x_all is None else x_all
    r = sigmoid(linear(p.wa, x_all).float())
    i = sigmoid(linear(p.wx, x_all).float())
    a = torch.exp(-_C * softplus(getattr(p, "lambda")) * r)
    gated = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * x.float())
    return a, gated


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``h_t = a_t h_{t-1} + b_t`` from ``h_{-1} = 0`` along axis 1, for
    every t, in ⌈log2 t⌉ rounds: after round r each position holds the
    composition of the ``2^(r+1)`` steps ending at it."""
    t = a.shape[1]
    shift = 1
    while shift < t:
        b = torch.cat([b[:, :shift], a[:, shift:] * b[:, :-shift]
                       + b[:, shift:]], dim=1)
        if 2 * shift < t:   # the last round needs no products of a
            a = torch.cat([a[:, :shift], a[:, shift:] * a[:, :-shift]],
                          dim=1)
        shift *= 2
    return b


def _rg_lru_scan(p: RGLRU, x, x_all=None):
    """x: (b, t, w) -> (y in x's dtype, f32 h of the last position)."""
    a, gated = _gates(p, x, x_all)
    y = linear_scan(a, gated)
    return y.to(x.dtype), y[:, -1]


def _rg_lru_step(p: RGLRU, x, h_prev, x_all=None):
    """x: (b, 1, w); h_prev: (b, w); the gates read ``x_all`` as in
    ``_gates``. Returns (y (b, 1, w), f32 h)."""
    a, gated = _gates(p, x, x_all)
    h = a[:, 0] * h_prev.float() + gated[:, 0]
    return h[:, None].to(x.dtype), h


def rglru_block(p: RGLRU, cfg: LMConfig, x, *, cache=None, mode="train"):
    """Temporal-mixing block; cache = {"h": (b, w), "conv": (b, cw-1, w)},
    both in the model dtype. Returns (out, new_cache)."""
    tp = tp_size() > 1
    if tp:
        x = copy_to_model(x)
    gate = gelu(linear(p.in_gate, x))
    rec = linear(p.in_rec, x)
    if mode == "decode":
        rec_conv, conv_state = causal_conv(p.conv_w, p.conv_b, rec,
                                           cache["conv"])
        y, h_last = _rg_lru_step(
            p, rec_conv, cache["h"], gather_from_model(rec_conv, partial=True)
            if tp else None)
        new_cache = {"h": h_last.to(x.dtype), "conv": conv_state}
    else:
        rec_conv, conv_tail = causal_conv(p.conv_w, p.conv_b, rec)
        y, h_last = _rg_lru_scan(
            p, rec_conv, gather_from_model(rec_conv, partial=True)
            if tp else None)
        new_cache = {"h": h_last.to(x.dtype), "conv": conv_tail} \
            if mode == "prefill" else None
    return row_linear(p.out, gate * y), new_cache

