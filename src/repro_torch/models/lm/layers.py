"""Primitive layers of the LM stack: linear, norms, RoPE, MLPs.

The port of ``repro.models.lm.layers``. Parameters keep the reference's
``x @ w`` orientation: ``Linear.w`` is ``(d_in, d_out)``, so a tree from
the reference copies in without a transpose. Norm gains stay f32 and norms
compute in f32, cast back to the input's dtype, as the reference does.
Parameters are trainable; serving runs under ``torch.inference_mode``.
With ``rsc``, the MLP's products go through ``core.rsc_matmul`` (exact
forward and dx, top-k-sampled dW), the bias added outside it.

The activations (``sigmoid``, ``silu``, ``gelu``) take one of two paths,
chosen from the tensor. On the CPU below f32 they evaluate ``jax.nn``'s
definitions op by op, each op rounding to bf16 (GeLU's constants too), as
the reference's op graph does; over a deep bf16 model the one-unit
differences of PyTorch's fused ops (f32 inside, one rounding) add up past
the parity tests' rule. On a CUDA tensor, and in f32, the fused ops run:
the op graph costs four more passes over each MLP activation, and the
card's kernels round at other places than the reference in any case.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.rsc_matmul import rsc_matmul
from repro_torch.models.lm.sharding import copy_to_model, reduce_from_model, \
    tp_size


def normal(shape, scale: float, dtype, device,
           gen: torch.Generator | None) -> torch.Tensor:
    """``N(0, scale²)`` drawn in f32 from ``gen`` and cast to ``dtype``;
    uninitialised when ``gen`` is None (the caller copies values in)."""
    if gen is None:
        return torch.empty(shape, dtype=dtype, device=device)
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (x * scale).to(dtype)


def he(shape, dtype, device, gen: torch.Generator | None) -> torch.Tensor:
    """``N(0, 1/shape[0])`` (see ``normal``)."""
    return normal(shape, math.sqrt(1.0 / shape[0]), dtype, device, gen)


def causal_conv(w: torch.Tensor, bias: torch.Tensor, x: torch.Tensor,
                state: torch.Tensor | None = None):
    """Causal depthwise conv over positions: ``w`` (width, c), ``x`` (b, t,
    c); ``state`` is the (b, width-1, c) tail of earlier positions (decode)
    or None (zeros). Returns the output and the new tail."""
    t = x.shape[1]
    head = torch.zeros((x.shape[0], w.shape[0] - 1, x.shape[2]),
                       dtype=x.dtype, device=x.device) if state is None \
        else state.to(x.dtype)
    xp = torch.cat([head, x], dim=1)
    out = sum(xp[:, i: i + t] * w[i] for i in range(w.shape[0]))
    return out + bias, xp[:, t:]


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


def row_linear(p: Linear, x: torch.Tensor) -> torch.Tensor:
    """``linear`` of a row-parallel product: under tensor parallelism
    ``p.w`` holds this rank's rows and ``x`` its columns, and the partial
    product is summed over ``model`` before the bias."""
    if tp_size() == 1:
        return linear(p, x)
    y = reduce_from_model(x @ p.w)
    return y if p.b is None else y + p.b


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


# ------------------------------- activations --------------------------------

_SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)


def _bf16_const(c: float) -> float:
    """``c`` rounded to bf16, as JAX casts a Python constant to the dtype
    of the array it meets."""
    return float(torch.tensor(c, dtype=torch.bfloat16))


def _op_graph(x: torch.Tensor) -> bool:
    """Whether ``x`` takes the reference's op graph: bf16 on the CPU."""
    return x.dtype == torch.bfloat16 and x.device.type == "cpu"


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid``; on the op-graph path as XLA evaluates it in
    bf16, ``1 / (1 + exp(-x))`` op by op."""
    return 1 / (1 + torch.exp(-x)) if _op_graph(x) else torch.sigmoid(x)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: ``x · sigmoid(x)``, on the op-graph path each
    rounded."""
    return x * sigmoid(x) if _op_graph(x) else F.silu(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (the tanh approximation, its default): ``x · 0.5 ·
    (1 + tanh(√(2/π) · (x + 0.044715 x³)))``, on the op-graph path op by
    op with the constants rounded to bf16."""
    if not _op_graph(x):
        return F.gelu(x, approximate="tanh")
    c0, c1 = _bf16_const(_SQRT_2_OVER_PI), _bf16_const(0.044715)
    return x * (0.5 * (1.0 + torch.tanh(c0 * (x + c1 * (x * x * x)))))


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


def mlp_apply(p: MLP, x: torch.Tensor, kind: str, rsc=None, *,
              partial: bool = False) -> torch.Tensor:
    """The MLP forward. ``rsc`` (``{"keep_frac", "bk" (128), "backend"
    ("kernel")}``) routes its products through ``rsc_matmul``.

    Under a mesh context with ``model`` > 1 (``models.lm.sharding``) the
    block is tensor parallel, Megatron's way: ``gate`` and ``up`` hold
    this rank's ffn columns (column-parallel, their input's gradient
    summed over ``model``), ``down`` its ffn rows (row-parallel, its
    partial output summed over ``model`` before the bias). With
    ``partial`` the caller has put ``x`` through ``copy_to_model`` and
    sums over ``model`` itself: the result is this rank's partial output,
    without ``down``'s bias (MoE's shared experts)."""
    tp = tp_size() > 1
    if tp and not partial:
        x = copy_to_model(x)
    mm = _mm(rsc)
    if kind == "swiglu":
        h = silu(mm(x, p.gate, "g")) * mm(x, p.up, "g")
    elif kind == "geglu":
        h = gelu(mm(x, p.gate, "g")) * mm(x, p.up, "g")
    else:
        h = gelu(mm(x, p.up, "g"))
    if not tp:
        return mm(h, p.down, "x")
    y = mm(h, p.down, "x", bias=False)
    if partial:
        return y
    y = reduce_from_model(y)
    return y if p.down.b is None else y + p.down.b


def _mm(rsc):
    """``mm(x, p, split, bias=True)``: the product of ``x`` and linear
    ``p`` (through ``rsc_matmul`` with ``rsc``; ``split`` names the
    operand split over ``model`` under tensor parallelism)."""
    def mm(x, p: Linear, split=None, bias=True):
        if rsc is None:
            y = x @ p.w
        else:
            y = rsc_matmul(x, p.w, rsc["keep_frac"], rsc.get("bk", 128),
                           rsc.get("backend", "kernel"), split)
        if bias and p.b is not None:
            y = y + p.b
        return y
    return mm
