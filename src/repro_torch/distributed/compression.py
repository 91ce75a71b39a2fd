"""Gradient compression for the data-parallel all-reduce, with error
feedback.

The port of ``repro.distributed.compression``. int8 block quantization
(one symmetric f32 scale per ``block`` values) cuts all-reduce bytes 4×
against f32 and 2× against bf16; the error-feedback accumulator carries
each step's quantization residual into the next, so compressed SGD stays
unbiased in the limit (Karimireddy et al. 2019). The trainer applies the
paper's switch-back (§3.3.2) to the compressor as it does to RSC.

The arithmetic is the reference's, so the codes, scales and residuals
match it bit for bit: pad to a multiple of ``block``, scale ``max|g| /
127`` in f32 clamped at 1e-12, round half to even, clip to ±127.
"""
from __future__ import annotations

import math

import torch


def compress_int8(g: torch.Tensor, block: int = 128
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """g (any shape, flattened row-major) -> (int8 codes ``(n_blocks,
    block)``, f32 scales ``(n_blocks,)``)."""
    gf = g.reshape(-1).to(torch.float32)
    pad = (-gf.numel()) % block
    if pad:
        gf = torch.nn.functional.pad(gf, (0, pad))
    gb = gf.reshape(-1, block)
    scale = gb.abs().amax(dim=1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    codes = torch.clamp(torch.round(gb / scale), -127, 127).to(torch.int8)
    return codes, scale[:, 0]


def decompress_int8(codes: torch.Tensor, scales: torch.Tensor, shape,
                    dtype=torch.float32) -> torch.Tensor:
    gb = codes.to(torch.float32) * scales[:, None]
    n = math.prod(shape)
    return gb.reshape(-1)[:n].reshape(shape).to(dtype)


class ErrorFeedbackCompressor:
    """Stateful EF21-style wrapper: compress(g + e), carry e forward.

    ``grads`` and the error state are tensors or ``{name: tensor}`` dicts
    of the same keys; the error is f32 in each gradient's shape.
    """

    def __init__(self, block: int = 128):
        self.block = block

    def init(self, grads):
        if isinstance(grads, torch.Tensor):
            return torch.zeros(grads.shape, dtype=torch.float32,
                               device=grads.device)
        return {k: self.init(g) for k, g in grads.items()}

    def compress_one(self, g: torch.Tensor, e: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
        """(quantized-and-restored g in its dtype, new f32 error)."""
        x = g.to(torch.float32) + e
        codes, scales = compress_int8(x, self.block)
        deq = decompress_int8(codes, scales, g.shape)
        return deq.to(g.dtype), x - deq

    def compress(self, grads, err):
        """Returns (quantized-and-restored grads, new error state): the
        restored grads are what the all-reduce sums, the residual goes to
        the error accumulator."""
        if isinstance(grads, torch.Tensor):
            return self.compress_one(grads, err)
        outs = {k: self.compress_one(g, err[k]) for k, g in grads.items()}
        return ({k: o[0] for k, o in outs.items()},
                {k: o[1] for k, o in outs.items()})

    @staticmethod
    def bytes_ratio(dtype=torch.bfloat16, block: int = 128) -> float:
        """Wire-bytes ratio against uncompressed (int8 codes + one f32
        scale per block)."""
        return (1.0 + 4.0 / block) / dtype.itemsize

    @staticmethod
    def wire_bytes(numel: int, block: int = 128) -> int:
        """Bytes of one leaf's int8 codes (padded to whole blocks) and
        f32 scales."""
        n_blocks = -(-numel // block)
        return n_blocks * block + 4 * n_blocks
