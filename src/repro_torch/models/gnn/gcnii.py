"""GCNII (Chen et al. 2020), the paper's deep model, full-batch.

    H⁰      = ReLU(X W_in + b_in)
    h̃       = (1−α)·SpMM(Ã, H^l) + α·H⁰
    H^{l+1} = ReLU(BN((1−β_l)·h̃ + β_l·(h̃ W^l + b^l))),  β_l = log(λ/(l+1) + 1)
    logits  = H^L W_out + b_out

with dropout on the features, on each layer's input and before the output
projection, as the reference (``repro/models/gnn/gcnii.py``) has it.
Every layer's SpMM input carries a gradient, so every layer registers a
plan.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models.gnn import common as C

ALPHA = 0.1         # initial-residual weight α (the reference's default)
LAM = 0.5           # identity-mapping strength λ (the reference's default)


def beta(l: int) -> float:
    return math.log(LAM / (l + 1) + 1.0)


class GCNII(nn.Module):
    """``proj_in`` (d_in → hidden), ``w[l]`` (hidden → hidden) and, with
    batchnorm, ``bn[str(l)]`` on every layer, ``proj_out`` (hidden →
    n_classes): the reference's ``{"proj_in", "w", "bn", "proj_out"}``."""

    def __init__(self, d_in: int, hidden: int, n_classes: int, n_layers: int,
                 batchnorm: bool, *, generator: torch.Generator | None = None,
                 device=None):
        super().__init__()
        self.proj_in = C.linear(d_in, hidden, device)
        self.w = nn.ModuleList(C.linear(hidden, hidden, device)
                               for _ in range(n_layers))
        self.bn = nn.ModuleDict(
            {str(l): C.GraphBatchNorm(hidden, device=device)
             for l in range(n_layers) if batchnorm})
        self.proj_out = C.linear(hidden, n_classes, device)
        gen = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        for lin in (self.proj_in, *self.w, self.proj_out):
            C.init_linear_(lin, gen)

    def batchnorm(self, l: int) -> C.GraphBatchNorm | None:
        return self.bn[str(l)] if str(l) in self.bn else None


def init(d_in: int, hidden: int, n_classes: int, n_layers: int,
         batchnorm: bool, *, seed: int = 0, device="cuda") -> GCNII:
    """A seeded GCNII on ``device`` (``cuda`` by default, which raises
    without a card)."""
    gen = torch.Generator().manual_seed(seed)
    return GCNII(d_in, hidden, n_classes, n_layers, batchnorm,
                 generator=gen, device=resolve_device(device))


def uses_mean_agg() -> bool:
    return False


def spmm_names(n_layers: int) -> list[str]:
    return [f"gcnii/spmm{l}" for l in range(n_layers)]


def spmm_dims(n_layers: int, hidden: int, n_classes: int) -> dict[str, int]:
    return {f"gcnii/spmm{l}": hidden for l in range(n_layers)}


def tap_shapes(n_layers: int, n_pad: int, hidden: int,
               n_classes: int) -> dict[str, tuple[int, int]]:
    return {f"gcnii/spmm{l}": (n_pad, hidden) for l in range(n_layers)}


def apply(model: GCNII, ops: C.GraphOperands, taps: dict, plans: dict | None,
          *, dropout_rate: float = 0.5, train: bool = True,
          generator: torch.Generator | None = None,
          backend: str = "kernel") -> torch.Tensor:
    """The training forward: logits ``(N_pad, n_classes)``.

    The tap rides as the SpMM's fused ``residual``; ReLU cannot fuse, since
    the (1−β)I + βW mix sits between the SpMM and the activation.
    """
    plans = plans or {}
    valid = C.valid_rows(ops)
    x = C.dropout(ops.features, dropout_rate, generator, train)
    h0 = torch.relu(C.dense(model.proj_in, x))
    h = h0
    for l in range(len(model.w)):
        h = C.dropout(h, dropout_rate, generator, train)
        name = f"gcnii/spmm{l}"
        p = C.spmm_op(ops.a, ops.at, h, plans.get(name), backend,
                      residual=taps.get(name))
        ht = (1.0 - ALPHA) * p + ALPHA * h0
        hp = (1.0 - beta(l)) * ht + beta(l) * C.dense(model.w[l], ht)
        bn = model.batchnorm(l)
        if bn is not None:
            hp = C.batchnorm(bn, hp, valid)
        h = torch.relu(hp)
    h = C.dropout(h, dropout_rate, generator, train)
    return C.dense(model.proj_out, h)


# ---------------------- streaming-inference hooks --------------------------
# (protocol in models/gnn/common.py; orchestration in infer/stream.py)

def infer_n_layers(model: GCNII) -> int:
    return len(model.w)


def infer_spmm_dims(model: GCNII, feat_dim: int) -> list[int]:
    return [model.proj_in.out_features] * len(model.w)


def infer_init(model: GCNII, feats):
    h0 = np.maximum(C.np_dense(C.host_linear(model.proj_in),
                               np.asarray(feats, np.float32)),
                    0.0).astype(np.float32)
    return h0, h0


def infer_pre(model: GCNII, l: int):
    return None         # the SpMM's input is H^l itself


def infer_post(model: GCNII, l: int, p, h, ctx, valid, bn_stats=None):
    b = beta(l)
    ht = (1.0 - ALPHA) * p + ALPHA * ctx
    hp = ((1.0 - b) * ht
          + b * C.np_dense(C.host_linear(model.w[l]), ht)).astype(np.float32)
    bn = model.batchnorm(l)
    if bn is not None:
        hp, bn_stats = C.np_batchnorm(bn.host_params(), hp, valid, bn_stats)
    return np.maximum(hp, 0.0).astype(np.float32), bn_stats


def infer_out(model: GCNII, h, ctx):
    return C.np_dense(C.host_linear(model.proj_out), h).astype(np.float32)
