"""Primitive layers of the LM stack: linear, norms, RoPE, MLPs.

The port of ``repro.models.lm.layers``. Parameters keep the reference's
``x @ w`` orientation: ``Linear.w`` is ``(d_in, d_out)``, so a tree from
the reference copies in without a transpose. Norm gains stay f32 and norms
compute in f32, cast back to the input's dtype, as the reference does.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

_TRAINING = "ROADMAP.md Queue 1 item 9b (LM training: rsc_matmul)"


def he(shape, dtype, device, gen: torch.Generator | None) -> torch.Tensor:
    """``N(0, 1/shape[0])`` drawn in f32 from ``gen`` and cast to
    ``dtype``; uninitialised when ``gen`` is None (the caller copies values
    in)."""
    if gen is None:
        return torch.empty(shape, dtype=dtype, device=device)
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (x * math.sqrt(1.0 / shape[0])).to(dtype)


class Linear(nn.Module):
    """``y = x @ w (+ b)`` with ``w`` of shape ``(d_in, d_out)``."""

    def __init__(self, d_in: int, d_out: int, dtype, device, *,
                 bias: bool = False, gen: torch.Generator | None = None):
        super().__init__()
        self.w = nn.Parameter(he((d_in, d_out), dtype, device, gen),
                              requires_grad=False)
        self.b = nn.Parameter(torch.zeros(d_out, dtype=dtype, device=device),
                              requires_grad=False) if bias else None


def linear(p: Linear, x: torch.Tensor) -> torch.Tensor:
    y = x @ p.w
    if p.b is not None:
        y = y + p.b
    return y


class Norm(nn.Module):
    """RMSNorm (gain ``g``) or LayerNorm (gain ``g``, shift ``b``), f32."""

    def __init__(self, d: int, kind: str = "rmsnorm", device=None):
        super().__init__()
        self.g = nn.Parameter(torch.ones(d, dtype=torch.float32,
                                         device=device), requires_grad=False)
        self.b = nn.Parameter(torch.zeros(d, dtype=torch.float32,
                                          device=device),
                              requires_grad=False) \
            if kind == "layernorm" else None


def apply_norm(p: Norm, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    if p.b is not None:  # layernorm
        mu = x32.mean(-1, keepdim=True)
        var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
        y = (x32 - mu) * torch.rsqrt(var + eps) * p.g + p.b
    else:  # rmsnorm
        ms = (x32 * x32).mean(-1, keepdim=True)
        y = x32 * torch.rsqrt(ms + eps) * p.g
    return y.to(x.dtype)


# ------------------------------- RoPE --------------------------------------

def rope_freqs(hd: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., t, h, hd); positions: (..., t). Split halves (the first
    ``hd/2`` channels rotate with the second), not interleaved pairs."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)              # (hd/2,)
    ang = positions[..., :, None, None].float() * freqs  # (..., t, 1, hd/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x32 = x.float()
    x1, x2 = x32[..., : hd // 2], x32[..., hd // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


# ------------------------------- MLPs --------------------------------------

class MLP(nn.Module):
    """Gated (swiglu / geglu: ``gate``, ``up``, ``down``) or plain
    (gelu: ``up``, ``down``) feed-forward block."""

    def __init__(self, d: int, d_ff: int, kind: str, dtype, device,
                 gen: torch.Generator | None = None):
        super().__init__()
        if kind in ("swiglu", "geglu"):
            self.gate = Linear(d, d_ff, dtype, device, gen=gen)
        else:
            self.gate = None
        self.up = Linear(d, d_ff, dtype, device, gen=gen)
        self.down = Linear(d_ff, d, dtype, device, gen=gen)


def mlp_apply(p: MLP, x: torch.Tensor, kind: str, rsc=None) -> torch.Tensor:
    """The MLP forward. ``rsc`` (the sampled-backward matmul of training)
    is not ported yet and raises."""
    if rsc is not None:
        raise NotImplementedError(
            f"rsc_matmul is not ported to repro_torch yet: see {_TRAINING}")
    if kind == "swiglu":
        h = F.silu(linear(p.gate, x)) * linear(p.up, x)
    elif kind == "geglu":
        h = F.gelu(linear(p.gate, x), approximate="tanh") * linear(p.up, x)
    else:
        h = F.gelu(linear(p.up, x), approximate="tanh")
    return linear(p.down, h)
