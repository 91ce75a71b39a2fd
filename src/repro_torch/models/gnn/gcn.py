"""GCN (Kipf & Welling 2017) — paper Eq. 1, full-batch.

Layer l:  H^{l+1} = ReLU(BN(SpMM(Ã, H^l Θ^l + b^l)))   (no ReLU/BN on the last)

``GCN`` holds the parameters. ``apply`` is the training forward (RSC
replaces each layer's backward SpMM with its sampled version); the
streaming-inference hooks below run the forward with the SpMM on the
device and the row ops on the host, as the reference's hooks
(``repro/models/gnn/gcn.py``) do.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models.gnn import common as C


class GCN(nn.Module):
    """``lin[l]`` maps ``dims[l] → dims[l+1]``; ``bn[str(l)]`` exists for
    the hidden layers that carry batchnorm.

    ``nn.Linear.weight`` is ``(d_out, d_in)``, the transpose of the
    reference's ``w``; ``convert.gnn_params_from_numpy`` transposes once.
    """

    def __init__(self, dims: list[int], batchnorm: bool, *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        n_layers = len(dims) - 1
        self.lin = nn.ModuleList(C.linear(dims[l], dims[l + 1], device)
                                 for l in range(n_layers))
        self.bn = nn.ModuleDict(
            {str(l): C.GraphBatchNorm(dims[l + 1], device=device)
             for l in range(n_layers - 1) if batchnorm})
        gen = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        for lin in self.lin:
            C.init_linear_(lin, gen)

    def batchnorm(self, l: int) -> C.GraphBatchNorm | None:
        return self.bn[str(l)] if str(l) in self.bn else None


def init(d_in: int, hidden: int, n_classes: int, n_layers: int,
         batchnorm: bool, *, seed: int = 0, device="cuda") -> GCN:
    """A seeded GCN: ``n_layers`` layers, ``hidden`` wide, on ``device``
    (``cuda`` by default, which raises without a card)."""
    device = resolve_device(device)
    dims = [d_in] + [hidden] * (n_layers - 1) + [n_classes]
    gen = torch.Generator().manual_seed(seed)
    return GCN(dims, batchnorm, generator=gen, device=device)


def uses_mean_agg() -> bool:
    return False


def spmm_names(n_layers: int) -> list[str]:
    return [f"gcn/spmm{l}" for l in range(n_layers)]


def spmm_dims(n_layers: int, hidden: int, n_classes: int) -> dict[str, int]:
    return {f"gcn/spmm{l}": (hidden if l < n_layers - 1 else n_classes)
            for l in range(n_layers)}


def tap_shapes(n_layers: int, n_pad: int, hidden: int,
               n_classes: int) -> dict[str, tuple[int, int]]:
    return {f"gcn/spmm{l}": (n_pad, hidden if l < n_layers - 1 else n_classes)
            for l in range(n_layers)}


def apply(model: GCN, ops: C.GraphOperands, taps: dict, plans: dict | None,
          *, dropout_rate: float = 0.5, train: bool = True,
          generator: torch.Generator | None = None,
          backend: str = "kernel") -> torch.Tensor:
    """The training forward: logits ``(N_pad, n_classes)``.

    Each layer's SpMM runs ``rsc_spmm`` under ``plans[name]`` when one is
    given, else ``exact_spmm``. The tap rides as the fused ``residual``,
    and ReLU fuses into the SpMM whenever no batchnorm sits between.
    """
    plans = plans or {}
    n_layers = len(model.lin)
    h = ops.features
    valid = C.valid_rows(ops)
    for l in range(n_layers):
        h = C.dropout(h, dropout_rate, generator, train)
        j = C.dense(model.lin[l], h)
        name = f"gcn/spmm{l}"
        bn = model.batchnorm(l) if l < n_layers - 1 else None
        fuse_relu = l < n_layers - 1 and bn is None
        hp = C.spmm_op(ops.a, ops.at, j, plans.get(name), backend,
                       residual=taps.get(name), relu=fuse_relu)
        if bn is not None:
            hp = torch.relu(C.batchnorm(bn, hp, valid))
        h = hp
    return h


# ---------------------- streaming-inference hooks --------------------------
# (protocol in models/gnn/common.py; orchestration in infer/stream.py)

def infer_n_layers(model: GCN) -> int:
    return len(model.lin)


def infer_spmm_dims(model: GCN, feat_dim: int) -> list[int]:
    # layer l's SpMM consumes lin[l](h): dim = lin[l] output width
    return [lin.out_features for lin in model.lin]


def infer_init(model: GCN, feats):
    return np.asarray(feats, np.float32), None


def infer_pre(model: GCN, l: int):
    return C.dense, model.lin[l]


def infer_post(model: GCN, l: int, p, h, ctx, valid, bn_stats=None):
    if l == len(model.lin) - 1:
        return p, None
    bn = model.batchnorm(l)
    if bn is not None:
        p, bn_stats = C.np_batchnorm(bn.host_params(), p, valid, bn_stats)
    return np.maximum(p, 0.0).astype(np.float32), bn_stats


def infer_out(model: GCN, h, ctx):
    return h
