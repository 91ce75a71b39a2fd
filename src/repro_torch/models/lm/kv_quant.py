"""int8 KV-cache quantization: the port of ``repro.models.lm.kv_quant``.

Symmetric per-(token, head) scales: ``scale = max(max|x| / 127, 1e-8)``
over the head dimension, codes ``clip(round(x / scale), -127, 127)`` as
int8, in f32 as the reference computes them (``torch.round`` rounds half
to even, as ``jnp.round`` does), so codes and scales are bit-identical to
the reference's. A library, as in the reference: no cache uses it.
"""
from __future__ import annotations

import torch


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (b, s, n, hd) -> (int8 codes, f32 scales (b, s, n))."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(-1) / 127.0, min=1e-8)
    codes = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return codes.to(torch.int8), scale


def dequantize_kv(codes: torch.Tensor, scale: torch.Tensor,
                  dtype=torch.bfloat16) -> torch.Tensor:
    return (codes.float() * scale[..., None]).to(dtype)


def cache_bytes_ratio(dtype=torch.bfloat16, hd: int = 128) -> float:
    """int8+scale wire/storage bytes vs the unquantized dtype."""
    return (hd * 1 + 4) / (hd * torch.empty((), dtype=dtype).element_size())
