"""Primitive layers of the LM stack: linear, norms, RoPE, MLPs.

The port of ``repro.models.lm.layers``. Parameters keep the reference's
``x @ w`` orientation: ``Linear.w`` is ``(d_in, d_out)``, so a tree from
the reference copies in without a transpose. Norm gains stay f32 and norms
compute in f32, cast back to the input's dtype, as the reference does.
Parameters are trainable; serving runs under ``torch.inference_mode``.
With ``rsc``, the MLP's products go through ``core.rsc_matmul`` (exact
forward and dx, top-k-sampled dW), the bias added outside it.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.rsc_matmul import rsc_matmul


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
        self.w = nn.Parameter(he((d_in, d_out), dtype, device, gen))
        self.b = nn.Parameter(torch.zeros(d_out, dtype=dtype, device=device)) \
            if bias else None


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
                                         device=device))
        self.b = nn.Parameter(torch.zeros(d, dtype=torch.float32,
                                          device=device)) \
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
    """The MLP forward. ``rsc`` (``{"keep_frac", "bk" (128), "backend"
    ("kernel")}``) routes its products through ``rsc_matmul``."""
    mm = _mm(rsc)
    if kind == "swiglu":
        h = F.silu(mm(x, p.gate)) * mm(x, p.up)
    elif kind == "geglu":
        h = F.gelu(mm(x, p.gate), approximate="tanh") * mm(x, p.up)
    else:
        h = F.gelu(mm(x, p.up), approximate="tanh")
    return mm(h, p.down)


def _mm(rsc):
    if rsc is None:
        return lambda x, p: linear(p, x)

    def mm(x, p: Linear):
        y = rsc_matmul(x, p.w, rsc["keep_frac"], rsc.get("bk", 128),
                       rsc.get("backend", "kernel"))
        if p.b is not None:
            y = y + p.b
        return y
    return mm
