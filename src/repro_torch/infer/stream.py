"""Partitioned layer-wise streaming inference (exact full-graph forward).

Layer ℓ is computed for all nodes one row-partition at a time, with the
activations resident on the HOST (numpy) between layers, as in the
reference (``repro/infer/stream.py``):

* the normalized propagation operand is tiled once
  (``sparse.bcoo.csr_to_bcoo_host``) and its row blocks are split into
  contiguous partitions by a device-memory budget
  (``pipeline.partition.contiguous_block_partition``);
* each partition uploads its own tiles plus the dense rows of the column
  blocks those tiles reference (a column GATHER), applies the model's
  pre-map on the device, runs the SpMM through ``core.rsc_spmm.spmm_apply``
  (the CUDA kernel on the card) and writes its output rows back to the
  host store;
* all partitions share one padded shape (``nb_pad``, ``s_pad``, ``g_pad``);
* row-wise math (batchnorm, activations — the model's ``infer_post`` /
  ``infer_out`` hooks) runs on the host over the full graph.

:class:`StreamEvaluator` is the training engine's exact full-graph
evaluator over this forward (``eval_mode="stream"``).

Still to be ported: the device-resident partition LRU, upload overlap,
RSC-sampled partitions, LDG partitioning, ``update_operand`` and
``recompute_rows`` (edge updates).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.plan import SamplePlan
from repro_torch.core.rsc_spmm import spmm_apply
from repro_torch.device import resolve_device
from repro_torch.graphs.synthetic import GraphData
from repro_torch.models.gnn import MODELS
from repro_torch.models.gnn.common import (degree_sorted_arrays,
                                           pad_node_arrays)
from repro_torch.pipeline.partition import contiguous_block_partition
from repro_torch.sparse.bcoo import (_expand_ranges, csr_to_bcoo_host,
                                     host_row_ptr)
from repro_torch.sparse.csr import CSR
from repro_torch.sparse.topology import mean_normalize, sym_normalize


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    """Knobs of the streaming engine.

    ``memory_budget_mb`` bounds the estimated device bytes of one
    partition (tiles + gathered columns + output rows); ``n_partitions``
    overrides it with an even split. ``store_layers`` keeps every layer's
    activations (and frozen batchnorm statistics) on the host for serving.
    ``backend`` is ``"kernel"`` (the CUDA kernel on the card, its plain
    version on the CPU) or ``"ref"`` (CPU only). ``device`` is where the
    SpMM and the pre-map run. Nodes are always relabelled by descending
    degree, as the reference does by default.
    """

    block: int = 64                    # bm == bk of the tiled operand
    n_partitions: int | None = None
    memory_budget_mb: float | None = 256.0
    backend: str = "kernel"
    store_layers: bool = False
    device: str = "cuda"


@dataclasses.dataclass
class _Partition:
    """Device-ready operands of one row-partition (host arrays)."""

    rbs: np.ndarray          # global row-block ids, sorted
    blocks: np.ndarray       # (s_pad + 1, bm, bk) tiles + zero sentinel
    sel: np.ndarray          # (s_pad,) int32, sentinel == s_pad
    row_ids: np.ndarray      # (s_pad,) int32 LOCAL row blocks
    col_ids: np.ndarray      # (s_pad,) int32 LOCAL gather blocks
    row_ptr: np.ndarray      # (nb_pad + 1,) int32
    gather_rows: np.ndarray  # (g_pad * bk,) int64 host rows to gather
    out_rows: np.ndarray     # (len(rbs) * bm,) int64 host rows written
    n_rows: int              # real output rows (== len(rbs) * bm)
    n_active: int            # real tiles
    n_gather: int            # real gathered column blocks


class StreamingInference:
    """Exact layer-wise full-graph forward in partitions.

    Node order is the operand order (degree-sorted); ``nodes[i]`` maps
    local row ``i`` back to the original graph id and ``pos`` is the
    inverse. ``params`` is the model's ``nn.Module``, on
    ``cfg.device``.
    """

    def __init__(self, graph: GraphData, model, params,
                 cfg: StreamConfig = StreamConfig()):
        self.module = MODELS[model] if isinstance(model, str) else model
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        self.params = params
        for t in params.parameters():
            if t.device != self.device:
                raise ValueError(f"params are on {t.device}, the stream "
                                 f"runs on {self.device}")

        adj, feats, labels, tr, va, te, perm = degree_sorted_arrays(
            graph.adj, graph.features, graph.labels, graph.train_mask,
            graph.val_mask, graph.test_mask)
        self.nodes = perm                          # local row -> original id
        self.pos = np.empty_like(perm)             # original id -> local row
        self.pos[perm] = np.arange(perm.shape[0])
        self.n_valid = graph.n
        self.num_classes = graph.num_classes
        self.multilabel = graph.multilabel

        self._set_operand(adj)
        n_pad = self.host.n_rows
        (self.features, self.labels, self.train_mask, self.val_mask,
         self.test_mask) = pad_node_arrays(n_pad, feats, labels, tr, va, te,
                                           graph.multilabel)
        self.valid = np.arange(n_pad) < self.n_valid

        self._dims = list(self.module.infer_spmm_dims(
            params, feats.shape[1]))
        self.n_layers = self.module.infer_n_layers(params)
        self._build_partitions()

        # Populated by a store_layers forward (serving).
        self.layer_store: list[np.ndarray] | None = None
        self.ctx_store = None
        self.bn_stats: dict[int, tuple | None] = {}
        self.logits: np.ndarray | None = None

    # ------------------------------------------------------------ operand
    def _set_operand(self, adj: CSR) -> None:
        """Build the normalized tiled operand from a raw adjacency."""
        normalize = (mean_normalize if self.module.uses_mean_agg()
                     else sym_normalize)
        self.adj = adj
        self.host, self.meta = csr_to_bcoo_host(
            normalize(adj), self.cfg.block, self.cfg.block)

    # --------------------------------------------------------- partitions
    def _partition_ids(self) -> list[np.ndarray]:
        cfg, hb = self.cfg, self.host
        budget = (int(cfg.memory_budget_mb * 2 ** 20)
                  if cfg.memory_budget_mb else None)
        return contiguous_block_partition(
            hb.row_ptr, bm=hb.bm, bk=hb.bk,
            d=max(self._dims) if self._dims else hb.bk,
            n_parts=cfg.n_partitions, budget_bytes=budget)

    def _raw_partition(self, rbs: np.ndarray):
        """Unpadded (tile ids, local rows, global cols, uniq col blocks)."""
        ptr = self.host.row_ptr
        idx = _expand_ranges(ptr[rbs], ptr[rbs + 1])
        counts = (ptr[rbs + 1] - ptr[rbs]).astype(np.int64)
        local = np.repeat(np.arange(rbs.shape[0]), counts)
        cols_g = self.host.col_ids[idx].astype(np.int64)
        uniq = np.unique(cols_g)
        return idx, local, cols_g, uniq

    def _build_one(self, rbs: np.ndarray, raw, nb_pad: int, s_pad: int,
                   g_pad: int) -> _Partition:
        bm, bk = self.host.bm, self.host.bk
        idx, local, cols_g, uniq = raw
        k = idx.shape[0]
        sentinel = s_pad

        sel = np.arange(k, dtype=np.int32)
        rows = local.astype(np.int32)
        cols = np.searchsorted(uniq, cols_g).astype(np.int32)
        # One sentinel entry per local row block with no tiles (including
        # the nb_pad padding rows), as the reference builds them.
        present = np.zeros(nb_pad, dtype=bool)
        present[rows] = True
        missing = np.nonzero(~present)[0].astype(np.int32)
        if missing.size:
            sel = np.concatenate([sel,
                                  np.full(missing.shape, sentinel, np.int32)])
            rows = np.concatenate([rows, missing])
            cols = np.concatenate([cols, np.zeros(missing.shape, np.int32)])
        order = np.argsort(rows, kind="stable")
        sel, rows, cols = sel[order], rows[order], cols[order]
        pad = s_pad - sel.shape[0]
        if pad < 0:
            raise ValueError(f"s_pad {s_pad} < {sel.shape[0]} entries")
        if pad:
            # Pad entries repeat the LAST row block and point at the
            # sentinel tile.
            last = rows[-1] if rows.size else 0
            sel = np.concatenate([sel, np.full(pad, sentinel, np.int32)])
            rows = np.concatenate([rows, np.full(pad, last, np.int32)])
            cols = np.concatenate([cols, np.zeros(pad, np.int32)])

        blocks = np.zeros((s_pad + 1, bm, bk), dtype=np.float32)
        blocks[:k] = self.host.blocks[idx]

        gather = np.zeros(g_pad * bk, dtype=np.int64)
        g = uniq.shape[0]
        if g:
            gather[: g * bk] = (uniq[:, None] * bk
                                + np.arange(bk)[None, :]).reshape(-1)
        out_rows = (rbs[:, None] * bm + np.arange(bm)[None, :]).reshape(-1)
        return _Partition(
            rbs=rbs, blocks=blocks, sel=sel, row_ids=rows, col_ids=cols,
            row_ptr=host_row_ptr(rows, nb_pad), gather_rows=gather,
            out_rows=out_rows, n_rows=rbs.shape[0] * bm,
            n_active=k, n_gather=g)

    def _build_partitions(self) -> None:
        """Partitions sharing one padded shape ``pads = (nb_pad, s_pad,
        g_pad)``: row blocks, tile entries and gathered column blocks."""
        ids = self._partition_ids()
        raws = [self._raw_partition(rbs) for rbs in ids]
        nb_pad = max(rbs.shape[0] for rbs in ids)
        s_pad = max(1, max(r[0].shape[0] + nb_pad for r in raws))
        g_pad = max(1, max(r[3].shape[0] for r in raws))
        self.pads = (nb_pad, s_pad, g_pad)
        self.parts = [self._build_one(rbs, raw, nb_pad, s_pad, g_pad)
                      for rbs, raw in zip(ids, raws)]

    @property
    def n_partitions(self) -> int:
        return len(self.parts)

    # -------------------------------------------------------------- spmm
    def upload(self, p: _Partition) -> tuple[torch.Tensor, SamplePlan]:
        """A partition's tiles and plan on the device."""
        blocks, sel, rows, cols, rptr = (
            torch.from_numpy(x).to(self.device)
            for x in (p.blocks, p.sel, p.row_ids, p.col_ids, p.row_ptr))
        plan = SamplePlan(sel=sel, row_ids=rows, col_ids=cols,
                          n_active=p.n_active, s_pad=self.pads[1],
                          row_ptr=rptr)
        return blocks, plan

    def gather(self, p: _Partition, h: np.ndarray, pre) -> torch.Tensor:
        """The partition's SpMM input: gathered host rows, uploaded, then
        the model's pre-map on the device."""
        slab = torch.from_numpy(np.ascontiguousarray(h[p.gather_rows]))
        slab = slab.to(self.device)
        if pre is not None:
            fn, pre_params = pre
            slab = fn(pre_params, slab)
        return slab

    def _spmm_layer(self, l: int, h: np.ndarray, pre) -> np.ndarray:
        """SpMM(operand, pre(h)) for every row, one partition at a time
        (a ``stream_partition`` span each; it closes after the result is
        read back, so it covers the upload and the device work)."""
        nb_pad = self.pads[0]
        bm, bk = self.host.bm, self.host.bk
        tracer = obs.get_tracer()
        out = None
        for i, p in enumerate(self.parts):
            with tracer.span("stream_partition", layer=l, mode="exact",
                             part=i):
                blocks, plan = self.upload(p)
                res = spmm_apply(blocks, plan, self.gather(p, h, pre),
                                 nb_pad, bm, bk, self.cfg.backend)
                res = res.cpu().numpy()
            if out is None:
                out = np.zeros((self.host.n_rows, res.shape[1]), np.float32)
            out[p.out_rows] = res[: p.n_rows]
        return out

    # ------------------------------------------------------------ forward
    def forward(self, params=None, *, store: bool | None = None
                ) -> np.ndarray:
        """Full-graph logits (padded, operand row order).

        ``store`` defaults to ``cfg.store_layers`` and retains per-layer
        activations + frozen batchnorm statistics for serving.
        """
        params = params if params is not None else self.params
        store = self.cfg.store_layers if store is None else store
        module = self.module
        tracer = obs.get_tracer()
        with torch.inference_mode():
            h, ctx = module.infer_init(params, self.features)
            layers = [h.copy()] if store else None
            bn_stats: dict[int, tuple | None] = {}
            for l in range(self.n_layers):
                with tracer.span("stream_layer", layer=l, mode="exact"):
                    pre = module.infer_pre(params, l)
                    p_out = self._spmm_layer(l, h, pre)
                    h, st = module.infer_post(params, l, p_out, h, ctx,
                                              self.valid, None)
                bn_stats[l] = st
                if store:
                    layers.append(h.copy())
            logits = np.asarray(module.infer_out(params, h, ctx),
                                dtype=np.float32)
        if store:
            self.layer_store = layers
            self.ctx_store = (np.asarray(ctx, np.float32)
                              if ctx is not None else None)
            self.bn_stats = bn_stats
            self.logits = logits
            self.params = params
        return logits


class StreamEvaluator:
    """Engine-facing adapter: streaming evaluation with the training metric.

    Built lazily — the tiled operand and partitions are constructed on the
    first evaluation (the parameters give the layer widths), then reused
    for every periodic evaluation of the run. ``params`` is the training
    model, on ``cfg.device``.
    """

    def __init__(self, graph: GraphData, model: str,
                 cfg: StreamConfig = StreamConfig()):
        self.graph = graph
        self.model = model
        self.cfg = cfg
        self.si: StreamingInference | None = None
        self.evals = 0

    def evaluate(self, params, mfn) -> tuple[float, float]:
        t0 = time.perf_counter()
        if self.si is None:
            self.si = StreamingInference(self.graph, self.model, params,
                                         self.cfg)
        logits = self.si.forward(params, store=False)
        si = self.si
        val = mfn(logits, si.labels, si.val_mask & si.valid)
        test = mfn(logits, si.labels, si.test_mask & si.valid)
        self.evals += 1
        obs.get_registry().observe("stream.eval_ms",
                                   (time.perf_counter() - t0) * 1e3)
        return val, test
