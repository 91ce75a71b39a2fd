"""Shared GNN plumbing: operands, layers, taps, and the streaming-inference
hooks.

Host (numpy) row ops carried over from ``repro/models/gnn/common.py``:
``degree_sorted_arrays``, ``pad_node_arrays``, ``np_dense`` and
``np_batchnorm`` compute on the same rows, in the same order, as the
reference's. ``GraphBatchNorm`` holds a batchnorm layer's parameters.

Training: ``build_operands`` puts the graph on the device once
(``GraphOperands``) and keeps the planner's host metadata
(``OperandMeta``); ``spmm_op`` dispatches each SpMM to ``rsc_spmm`` (a plan
given) or ``exact_spmm``; ``batchnorm`` and ``dropout`` are the training
forward's row ops. The TAP mechanism: every SpMM output gets a zero-valued
additive ``tap`` tensor (fused as the SpMM's ``residual``); the gradient
with respect to the taps is exactly the backward operand ∇H^{(l+1)} of each
sparse op, whose row norms the Eq. 4a scores need.

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

import dataclasses
import math

import numpy as np
import torch
from torch import nn

from repro_torch import obs
from repro_torch.core.plan import SamplePlan
from repro_torch.core.rsc_spmm import exact_spmm, rsc_spmm
from repro_torch.sparse.bcoo import (BlockCOO, BlockMeta, csr_to_bcoo_host,
                                     degree_sort_permutation)
from repro_torch.sparse.topology import mean_normalize, sym_normalize


@dataclasses.dataclass(frozen=True)
class GraphOperands:
    """Device-resident graph operands (padded to block multiples).

    ``am`` / ``amt`` are ``None`` when the model does not aggregate by
    mean (see ``build_operands``). ``loss_w`` (GraphSAINT pools) is the
    per-node loss weight; ``None`` (full batch) means uniform weights.
    """

    a: BlockCOO                 # sym-normalized Ã (GCN/GCNII propagation)
    at: BlockCOO                # Ãᵀ
    am: BlockCOO | None         # mean-normalized D⁻¹A (GraphSAGE)
    amt: BlockCOO | None        # (D⁻¹A)ᵀ
    features: torch.Tensor      # (N_pad, d_in) f32
    labels: torch.Tensor        # (N_pad,) int32 or (N_pad, C) f32
    train_mask: torch.Tensor    # (N_pad,) bool
    val_mask: torch.Tensor
    test_mask: torch.Tensor
    n_valid: int                # real (un-padded) node count
    num_classes: int
    multilabel: bool
    loss_w: torch.Tensor | None = None


@dataclasses.dataclass(frozen=True)
class OperandMeta:
    """Host metadata of the backward operands, for the PlanCache."""

    at_meta: BlockMeta
    amt_meta: BlockMeta | None
    a_fro: float
    am_fro: float


def _fro(val: np.ndarray) -> float:
    return float(np.sqrt(np.sum(val.astype(np.float64) ** 2)))


def build_operands(g, bm: int = 128, bk: int = 128,
                   degree_sort: bool = True, *, mean_agg: bool = True,
                   device: str | torch.device = "cuda"
                   ) -> tuple[GraphOperands, OperandMeta]:
    """The graph's training operands on ``device`` and their planner
    metadata: the reference's ``build_operands``, with the same tiles, ids,
    masks and Frobenius norms (f64).

    Each operand is built on the host, uploaded and its host tiles freed
    before the next is built. With tracing on, the stages are spans:
    ``operands.normalize`` (degree order, the normalised matrices and
    their transposes), then per operand ``operands.tile`` and
    ``operands.upload`` (``op`` names it; ``nodes`` for the node arrays).
    ``mean_agg=False`` (a model whose
    ``uses_mean_agg()`` is false, such as GCN) skips the mean-normalised
    pair: ``am``, ``amt`` and ``amt_meta`` are then ``None``; no result
    of such a model changes, and the card holds half the tiles.
    """
    tracer = obs.get_tracer()
    with tracer.span("operands.normalize"):
        adj = g.adj
        feats, labels = g.features, g.labels
        tr, va, te = g.train_mask, g.val_mask, g.test_mask
        if degree_sort:
            adj, feats, labels, tr, va, te, _ = degree_sorted_arrays(
                adj, feats, labels, tr, va, te)
        a_csr = sym_normalize(adj)
        am_csr = mean_normalize(adj)
        csrs = {"a": a_csr, "at": a_csr.transpose()}
        if mean_agg:
            csrs.update(am=am_csr, amt=am_csr.transpose())

    tiled = {}
    for name, csr in csrs.items():
        with tracer.span("operands.tile", op=name):
            host, meta = csr_to_bcoo_host(csr, bm, bk)
        with tracer.span("operands.upload", op=name):
            tiled[name] = (host.to_device(device), meta)
        del host
    (a, _), (at, at_meta) = tiled["a"], tiled["at"]
    am, _ = tiled.get("am", (None, None))
    amt, amt_meta = tiled.get("amt", (None, None))

    with tracer.span("operands.upload", op="nodes"):
        feats_p, labels_p, tr_p, va_p, te_p = pad_node_arrays(
            a.n_rows, feats, labels, tr, va, te, g.multilabel)

        def up(x):
            return torch.from_numpy(x).to(device)

        ops = GraphOperands(
            a=a, at=at, am=am, amt=amt,
            features=up(feats_p), labels=up(labels_p),
            train_mask=up(tr_p), val_mask=up(va_p), test_mask=up(te_p),
            n_valid=g.n, num_classes=g.num_classes,
            multilabel=g.multilabel)
    meta = OperandMeta(at_meta=at_meta, amt_meta=amt_meta,
                       a_fro=_fro(a_csr.val), am_fro=_fro(am_csr.val))
    return ops, meta


def spmm_op(a: BlockCOO, at: BlockCOO, h: torch.Tensor,
            plan: SamplePlan | None, backend: str, *,
            bias: torch.Tensor | None = None,
            residual: torch.Tensor | None = None,
            relu: bool = False) -> torch.Tensor:
    """Dispatch: RSC (sampled backward) if a plan is supplied, exact else.

    ``bias``/``residual``/``relu`` ride the SpMM's fused epilogue
    (``out = relu(spmm + bias + residual)``); gradients flow through the
    epilogue exactly (see ``core.rsc_spmm``). The gradient TAP of each
    SpMM output is fused as the ``residual`` term.
    """
    if plan is None:
        return exact_spmm(a, at, h, backend, bias=bias, residual=residual,
                          relu=relu)
    return rsc_spmm(a, at, plan, h, backend, bias=bias, residual=residual,
                    relu=relu)


def valid_rows(ops: GraphOperands) -> torch.Tensor:
    """(N_pad,) bool: the real (un-padded) nodes."""
    return torch.arange(ops.features.shape[0],
                        device=ops.features.device) < ops.n_valid


def batchnorm(bn: "GraphBatchNorm", x: torch.Tensor,
              mask: torch.Tensor) -> torch.Tensor:
    """BatchNorm over the valid rows (full-batch graph training): biased
    variance, eps 1e-5, statistics from this pass (no running ones)."""
    m = mask.float()[:, None]
    cnt = torch.clamp(torch.sum(m), min=1.0)
    mu = torch.sum(x * m, dim=0) / cnt
    var = torch.sum(((x - mu) ** 2) * m, dim=0) / cnt
    return ((x - mu) / torch.sqrt(var + 1e-5)) * bn.weight + bn.bias


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator | None,
            train: bool) -> torch.Tensor:
    """Inverted dropout, its keep mask drawn from ``generator`` (on ``x``'s
    device). Torch cannot draw JAX's bits: parity tests run at rate 0."""
    if not train or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) \
        < (1.0 - rate)
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), device=x.device))


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


def linear(d_in: int, d_out: int, device=None) -> nn.Linear:
    """An uninitialised ``nn.Linear`` (filled by :func:`init_linear_`)."""
    return nn.utils.skip_init(nn.Linear, d_in, d_out, device=device)


@torch.no_grad()
def init_linear_(lin: nn.Linear, generator: torch.Generator) -> None:
    """He-normal weights ``N(0, 2/d_in)`` and zero biases, drawn from
    ``generator`` (the reference's ``dense_init`` scheme; the draws
    differ from JAX's, so parity tests carry weights across with
    ``convert.gnn_params_from_numpy``)."""
    w = torch.randn(lin.in_features, lin.out_features, generator=generator)
    lin.weight.copy_(w.t() * math.sqrt(2.0 / lin.in_features))
    lin.bias.zero_()


def dense(lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``x @ w + b`` with the reference's ``w = lin.weight.t()``."""
    return torch.matmul(x, lin.weight.t()) + lin.bias


def host_linear(lin: nn.Linear) -> dict:
    """``{"w": (d_in, d_out), "b": (d_out,)}`` as numpy arrays, for
    :func:`np_dense`."""
    return {"w": lin.weight.detach().cpu().numpy().T,
            "b": lin.bias.detach().cpu().numpy()}


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
