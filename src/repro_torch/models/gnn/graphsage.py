"""GraphSAGE with the MEAN aggregator (paper App. A.3), full-batch.

Layer l:  H^{l+1} = ReLU(BN(H^l W₁ + SpMM(D⁻¹A, H^l) W₂))   (no ReLU/BN on
the last)

The SpMM runs over the mean-normalised pair ``ops.am`` / ``ops.amt``, on the
same kernel as GCN's. Layer 0's SpMM acts on the features, which carry no
gradient, so its backward SpMM never runs and RSC registers plans for
layers 1..L-1 only (paper Figs. 7/8 note), as the reference
(``repro/models/gnn/graphsage.py``) does.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models.gnn import common as C


class GraphSAGE(nn.Module):
    """``self_lin[l]`` and ``neigh_lin[l]`` map ``dims[l] → dims[l+1]``;
    ``bn[str(l)]`` exists for the hidden layers that carry batchnorm.

    The reference's ``params["self"][l]`` / ``params["neigh"][l]``;
    ``convert.gnn_params_from_numpy`` transposes each ``w`` once.
    """

    def __init__(self, dims: list[int], batchnorm: bool, *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        n_layers = len(dims) - 1
        self.self_lin = nn.ModuleList(C.linear(dims[l], dims[l + 1], device)
                                      for l in range(n_layers))
        self.neigh_lin = nn.ModuleList(
            C.linear(dims[l], dims[l + 1], device) for l in range(n_layers))
        self.bn = nn.ModuleDict(
            {str(l): C.GraphBatchNorm(dims[l + 1], device=device)
             for l in range(n_layers - 1) if batchnorm})
        gen = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        for s, n in zip(self.self_lin, self.neigh_lin):
            C.init_linear_(s, gen)
            C.init_linear_(n, gen)

    def batchnorm(self, l: int) -> C.GraphBatchNorm | None:
        return self.bn[str(l)] if str(l) in self.bn else None


def init(d_in: int, hidden: int, n_classes: int, n_layers: int,
         batchnorm: bool, *, seed: int = 0, device="cuda") -> GraphSAGE:
    """A seeded GraphSAGE on ``device`` (``cuda`` by default, which raises
    without a card)."""
    device = resolve_device(device)
    dims = [d_in] + [hidden] * (n_layers - 1) + [n_classes]
    gen = torch.Generator().manual_seed(seed)
    return GraphSAGE(dims, batchnorm, generator=gen, device=device)


def uses_mean_agg() -> bool:
    return True


def spmm_names(n_layers: int) -> list[str]:
    return [f"sage/spmm{l}" for l in range(1, n_layers)]


def spmm_dims(n_layers: int, hidden: int, n_classes: int) -> dict[str, int]:
    # layer l's backward SpMM gives ∇H^l, as wide as the layer's input
    return {f"sage/spmm{l}": hidden for l in range(1, n_layers)}


def tap_shapes(n_layers: int, n_pad: int, hidden: int,
               n_classes: int) -> dict[str, tuple[int, int]]:
    return {f"sage/spmm{l}": (n_pad, hidden) for l in range(1, n_layers)}


def apply(model: GraphSAGE, ops: C.GraphOperands, taps: dict,
          plans: dict | None, *, dropout_rate: float = 0.5,
          train: bool = True, generator: torch.Generator | None = None,
          backend: str = "kernel") -> torch.Tensor:
    """The training forward: logits ``(N_pad, n_classes)``.

    The tap rides as the SpMM's fused ``residual``; ReLU stays outside the
    SpMM, since the neighbour linear sits between the two.
    """
    plans = plans or {}
    n_layers = len(model.self_lin)
    h = ops.features
    valid = C.valid_rows(ops)
    for l in range(n_layers):
        h = C.dropout(h, dropout_rate, generator, train)
        name = f"sage/spmm{l}"
        m = C.spmm_op(ops.am, ops.amt, h, plans.get(name), backend,
                      residual=taps.get(name))
        hp = C.dense(model.self_lin[l], h) + C.dense(model.neigh_lin[l], m)
        if l < n_layers - 1:
            bn = model.batchnorm(l)
            if bn is not None:
                hp = C.batchnorm(bn, hp, valid)
            hp = torch.relu(hp)
        h = hp
    return h


# ---------------------- streaming-inference hooks --------------------------
# (protocol in models/gnn/common.py; orchestration in infer/stream.py)

def infer_n_layers(model: GraphSAGE) -> int:
    return len(model.self_lin)


def infer_spmm_dims(model: GraphSAGE, feat_dim: int) -> list[int]:
    # layer l's SpMM consumes H^l itself: dim = the layer's input width
    return [lin.in_features for lin in model.self_lin]


def infer_init(model: GraphSAGE, feats):
    return np.asarray(feats, np.float32), None


def infer_pre(model: GraphSAGE, l: int):
    return None         # the SpMM's input is H^l itself


def infer_post(model: GraphSAGE, l: int, m, h, ctx, valid, bn_stats=None):
    hp = (C.np_dense(C.host_linear(model.self_lin[l]), h)
          + C.np_dense(C.host_linear(model.neigh_lin[l]), m)
          ).astype(np.float32)
    if l == len(model.self_lin) - 1:
        return hp, None
    bn = model.batchnorm(l)
    if bn is not None:
        hp, bn_stats = C.np_batchnorm(bn.host_params(), hp, valid, bn_stats)
    return np.maximum(hp, 0.0).astype(np.float32), bn_stats


def infer_out(model: GraphSAGE, h, ctx):
    return h
