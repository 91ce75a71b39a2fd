"""Shared GNN plumbing for the streaming-inference hooks.

Host (numpy) row ops carried over from ``repro/models/gnn/common.py``:
``degree_sorted_arrays``, ``pad_node_arrays``, ``np_dense`` and
``np_batchnorm`` compute on the same rows, in the same order, as the
reference's. ``GraphBatchNorm`` holds a batchnorm layer's parameters.

Streaming-inference hook protocol (orchestration in
``repro_torch/infer/stream.py``); ``model`` is the model's ``nn.Module``:

    infer_n_layers(model) -> int          number of SpMM layers
    infer_spmm_dims(model, feat_dim)      dense-operand dim of each SpMM
    infer_init(model, feats) -> (h, ctx)  host setup
    infer_pre(model, l) -> (fn, p) | None device map applied to the gathered
                                          SpMM input as ``fn(p, h)``
    infer_post(model, l, p, h, ctx, valid, bn_stats)
        -> (h_next, bn_stats)             row-wise host combine of the SpMM
                                          output ``p`` with the layer input;
                                          ``bn_stats=None`` computes fresh
                                          batch statistics (full pass), a
                                          stats tuple applies them frozen
    infer_out(model, h, ctx) -> logits    row-wise host final projection
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.sparse.bcoo import degree_sort_permutation


def degree_sorted_arrays(adj, feats, labels, tr, va, te):
    """Relabel nodes by descending degree; permuted copies + the perm."""
    perm = degree_sort_permutation(adj)
    return (adj.permute(perm), feats[perm], labels[perm],
            tr[perm], va[perm], te[perm], perm)


def pad_node_arrays(n_pad: int, feats, labels, tr, va, te,
                    multilabel: bool):
    """Pad per-node host arrays to ``n_pad`` rows (labels as f32 one-hots
    for multilabel, int32 class ids otherwise)."""
    pad = n_pad - feats.shape[0]

    def padf(x, fill=0):
        width = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
        return np.pad(x, width, constant_values=fill)

    labels_p = (padf(labels).astype(np.float32) if multilabel
                else padf(labels).astype(np.int32))
    return (padf(feats).astype(np.float32), labels_p,
            padf(tr).astype(bool), padf(va).astype(bool),
            padf(te).astype(bool))


def np_dense(p, x: np.ndarray) -> np.ndarray:
    """Host ``x @ w + b`` with ``p = {"w": (d_in, d_out), "b": (d_out,)}``."""
    return x @ np.asarray(p["w"]) + np.asarray(p["b"])


def np_batchnorm(p, x: np.ndarray, valid: np.ndarray,
                 stats: tuple | None = None):
    """Batchnorm over the valid rows, on the host.

    ``p = {"g", "b"}`` numpy arrays. ``stats=None`` computes (mu, biased
    var) over valid rows and returns them so callers can freeze them; a
    provided tuple is applied as-is (row-wise, enabling subset recompute).
    """
    if stats is None:
        m = valid.astype(np.float32)[:, None]
        cnt = max(float(m.sum()), 1.0)
        mu = (x * m).sum(axis=0) / cnt
        var = (((x - mu) ** 2) * m).sum(axis=0) / cnt
        stats = (mu, var)
    mu, var = stats
    out = ((x - mu) / np.sqrt(var + 1e-5)) * np.asarray(p["g"]) \
        + np.asarray(p["b"])
    return out.astype(np.float32), stats


class GraphBatchNorm(nn.Module):
    """Parameters of a full-graph batchnorm layer.

    Not ``nn.BatchNorm1d``: statistics are computed afresh over the valid
    rows on every full pass (biased variance, eps 1e-5) and then frozen by
    the caller; there are no running statistics.
    """

    def __init__(self, d: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d, device=device))
        self.bias = nn.Parameter(torch.zeros(d, device=device))

    def host_params(self) -> dict:
        """``{"g", "b"}`` as numpy arrays, for :func:`np_batchnorm`."""
        return {"g": self.weight.detach().cpu().numpy(),
                "b": self.bias.detach().cpu().numpy()}
