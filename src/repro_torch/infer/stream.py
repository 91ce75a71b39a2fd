"""Partitioned layer-wise streaming inference (exact full-graph forward).

Layer ℓ is computed for all nodes one row-partition at a time, with the
activations resident on the HOST (numpy) between layers, as in the
reference (``repro/infer/stream.py``):

* the normalized propagation operand is tiled once
  (``sparse.bcoo.csr_to_bcoo_host``) and its row blocks are split into
  partitions by a device-memory budget
  (``pipeline.partition.contiguous_block_partition``) or by tile
  connectivity (``pipeline.partition.ldg_block_partition``);
* each partition uploads its own tiles plus the dense rows of the column
  blocks those tiles reference (a column GATHER), applies the model's
  pre-map on the device, runs the SpMM through ``core.rsc_spmm.spmm_apply``
  (the CUDA kernel on the card) and writes its output rows back to the
  host store;
* all partitions of a mode share one padded shape (``nb_pad``, ``s_pad``,
  ``g_pad``);
* row-wise math (batchnorm, activations — the model's ``infer_post`` /
  ``infer_out`` hooks) runs on the host over the full graph.

``sample_budget`` < 1 adds the RSC-SAMPLED mode: each partition keeps only
its top-norm column blocks (static Eq. 3 column norms) covering that
fraction of its tiles, shrinking both the gather and the SpMM.

``resident_mb`` keeps partitions' static operands (tiles, id lists,
``row_ptr``) on the card in a byte-budgeted LRU (:class:`_DeviceLRU`), so
a warm forward uploads only the activation slabs. ``overlap`` uploads the
next partition's operands on a side stream (``pipeline.prefetch``'s
``Prefetcher`` with a ``fetch`` callable) while the current partition's
SpMM runs. Serving edge updates re-tile only the dirty row
blocks (``update_operand``) and recompute only the dirty rows
(``recompute_rows``).

:class:`StreamEvaluator` is the training engine's exact full-graph
evaluator over this forward (``eval_mode="stream"``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from collections import OrderedDict

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
from repro_torch.obs import context as trace_context
from repro_torch.pipeline.partition import (contiguous_block_partition,
                                            ldg_block_partition)
from repro_torch.sparse.bcoo import (csr_to_bcoo_host, host_row_ptr,
                                     retile_rows)
from repro_torch.sparse.csr import CSR
from repro_torch.sparse.topology import mean_normalize, sym_normalize


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    """Knobs of the streaming engine.

    ``memory_budget_mb`` bounds the estimated device bytes of one
    partition (tiles + gathered columns + output rows); ``n_partitions``
    overrides it with an even split (and sets the count of
    ``partition_method="ldg"``). ``sample_budget`` < 1 adds RSC-sampled
    column gathers. ``store_layers`` keeps every layer's activations (and
    frozen batchnorm statistics) on the host for serving. ``autotune``
    sweeps the SpMM's tile for each mode's shape up front.
    ``resident_mb`` enables the device-resident partition LRU;
    ``overlap`` double-buffers the partition uploads against the SpMM.
    ``backend`` is ``"kernel"`` (the CUDA kernel on the card, its plain
    version on the CPU), ``"ref"`` (CPU only) or ``"dense"``. ``device``
    is where the SpMM and the pre-map run.
    """

    block: int = 64                    # bm == bk of the tiled operand
    n_partitions: int | None = None
    memory_budget_mb: float | None = 256.0
    partition_method: str = "contiguous"   # or "ldg" (tile connectivity)
    backend: str = "kernel"
    sample_budget: float | None = None     # None / >=1 → exact only
    degree_sort: bool = True
    autotune: bool = False                 # sweep SpMM tiles up front
    store_layers: bool = False
    resident_mb: float | None = None       # device partition LRU budget
    overlap: bool = False                  # double-buffer uploads
    device: str = "cuda"


class _DeviceLRU:
    """Budget-aware LRU of device-resident partition operands.

    Values are one partition's STATIC device tensors (tiles, sel, row_ids,
    col_ids, row_ptr) keyed by ``(mode, part)``; the activation slab is
    never cached. ``resident_bytes`` counts the same bytes as the
    reference's (the same f32 and int32 arrays) and stays under
    ``budget_bytes`` (the newest entry always survives, even oversized).
    Counters and gauges (``stream.lru_*``) go to ``repro_torch.obs``;
    ``hits`` / ``misses`` / ``evictions`` stay readable on the object.
    Thread-safe: the overlap worker and the main loop share it (uploads
    run outside the lock; a racing duplicate upload is harmless). An
    evicted entry's tensors are freed only when the last reader drops
    them; the overlap path's hand-over has recorded the reading stream on
    each (``record_stream``), so a queued SpMM keeps its memory.
    """

    def __init__(self, budget_bytes: int):
        self.budget_bytes = int(budget_bytes)
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.resident_bytes = 0
        self._entries: OrderedDict[tuple, tuple] = OrderedDict()
        self._bytes: dict[tuple, int] = {}
        self._lock = threading.Lock()

    def get(self, key: tuple, build):
        with self._lock:
            ent = self._entries.get(key)
            if ent is not None:
                self._entries.move_to_end(key)
                self.hits += 1
                obs.get_registry().counter("stream.lru_hits")
                self._publish()
                return ent
        val = build()   # slow upload outside the lock
        nbytes = int(sum(t.numel() * t.element_size() for t in val))
        reg = obs.get_registry()
        with self._lock:
            self.misses += 1
            reg.counter("stream.lru_misses")
            if key not in self._entries:
                self._entries[key] = val
                self._bytes[key] = nbytes
                self.resident_bytes += nbytes
            self._entries.move_to_end(key)
            while (self.resident_bytes > self.budget_bytes
                   and len(self._entries) > 1):
                old, _ = self._entries.popitem(last=False)
                self.resident_bytes -= self._bytes.pop(old)
                self.evictions += 1
                reg.counter("stream.lru_evictions")
            self._publish()
        return val

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._bytes.clear()
            self.resident_bytes = 0
            self._publish()

    def invalidate(self, keys) -> None:
        """Drop specific entries (dirty-bounded operand updates evict only
        the partitions whose tiles changed)."""
        with self._lock:
            for key in keys:
                if key in self._entries:
                    del self._entries[key]
                    self.resident_bytes -= self._bytes.pop(key)
            self._publish()

    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def _publish(self) -> None:
        reg = obs.get_registry()
        reg.gauge("stream.lru_resident_bytes", self.resident_bytes)
        reg.gauge("stream.lru_hit_rate", self.hit_rate())


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

    def statics(self) -> tuple[np.ndarray, ...]:
        """The arrays a partition keeps on the card between layers."""
        return (self.blocks, self.sel, self.row_ids, self.col_ids,
                self.row_ptr)


class StreamingInference:
    """Exact (or RSC-sampled) layer-wise full-graph forward in partitions.

    Node order is the operand order (degree-sorted when configured);
    ``nodes[i]`` maps local row ``i`` back to the original graph id and
    ``pos`` is the inverse. ``params`` is the model's ``nn.Module``, on
    ``cfg.device``. ``parts`` and ``pads`` are the exact mode's partitions
    and padded shape.
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

        adj, feats, labels = graph.adj, graph.features, graph.labels
        tr, va, te = graph.train_mask, graph.val_mask, graph.test_mask
        perm = np.arange(graph.n, dtype=np.int64)
        if cfg.degree_sort:
            adj, feats, labels, tr, va, te, perm = degree_sorted_arrays(
                adj, feats, labels, tr, va, te)
        self.nodes = perm                          # local row -> original id
        self.pos = np.empty_like(perm)             # original id -> local row
        self.pos[perm] = np.arange(perm.shape[0])
        self.n_valid = graph.n
        self.num_classes = graph.num_classes
        self.multilabel = graph.multilabel
        self._mean_agg = self.module.uses_mean_agg()
        self.lru = (_DeviceLRU(int(cfg.resident_mb * 2 ** 20))
                    if cfg.resident_mb else None)

        self._set_operand(adj)
        n_pad = self.host.n_rows
        (self.features, self.labels, self.train_mask, self.val_mask,
         self.test_mask) = pad_node_arrays(n_pad, feats, labels, tr, va, te,
                                           graph.multilabel)
        self.valid = np.arange(n_pad) < self.n_valid

        self._dims = list(self.module.infer_spmm_dims(
            params, feats.shape[1]))
        self.n_layers = self.module.infer_n_layers(params)
        self._parts: dict[str, list[_Partition]] = {}
        self._pads: dict[str, tuple[int, int, int]] = {}
        self._build_partitions()
        if cfg.autotune:
            self._warmup_autotune()

        # Populated by a store_layers forward (serving / incremental).
        self.layer_store: list[np.ndarray] | None = None
        self.ctx_store = None
        self.bn_stats: dict[int, tuple | None] = {}
        self.logits: np.ndarray | None = None

    # ------------------------------------------------------------ operand
    def _set_operand(self, adj: CSR) -> None:
        """(Re)build the normalized tiled operand from a raw adjacency."""
        normalize = mean_normalize if self._mean_agg else sym_normalize
        self.adj = adj
        self.host, self.meta = csr_to_bcoo_host(
            normalize(adj), self.cfg.block, self.cfg.block)

    def rebuild_operand(self, adj: CSR) -> None:
        """Swap in an updated adjacency (the full re-tile oracle of serving
        edge updates): re-tiles the operand and re-plans the partitions."""
        self._set_operand(adj)
        if self.lru is not None:
            self.lru.clear()   # cached tiles belong to the old operand
        self._build_partitions()

    def update_operand(self, adj: CSR, dirty_rows: np.ndarray) -> dict:
        """Dirty-bounded operand refresh: re-tile ONLY the row blocks whose
        normalized rows changed (``sparse.bcoo.retile_rows``) and rebuild
        ONLY the partitions containing them.

        ``dirty_rows`` are the LOCAL rows whose Ã row differs between the
        old and new adjacency. If a touched partition no longer fits the
        padded shapes its mode shares (tile growth past ``s_pad``), the
        method falls back to a full partition re-plan — counted in the
        returned stats and in ``stream.update_fallbacks``, never silent.
        """
        normalize = mean_normalize if self._mean_agg else sym_normalize
        a_csr = normalize(adj)
        dirty_rows = np.asarray(dirty_rows, dtype=np.int64)
        rbs = np.unique(dirty_rows // self.host.bm)
        self.host, self.meta = retile_rows(self.host, self.meta, a_csr,
                                           dirty_rows)
        self.adj = adj
        touched = [i for i, ids in enumerate(self._partition_id_list)
                   if np.intersect1d(ids, rbs, assume_unique=True).size]
        stats = {"dirty_row_blocks": int(rbs.size),
                 "partitions_touched": len(touched),
                 "partitions_rebuilt": 0, "fallback": False}
        for mode in list(self._parts):
            sampled = mode == "sampled"
            nb_pad, s_pad, g_pad = self._pads[mode]
            for i in touched:
                ids = self._partition_id_list[i]
                raw = self._raw_partition(ids, sampled)
                if (ids.shape[0] > nb_pad
                        or raw[0].shape[0] + nb_pad > s_pad
                        or raw[3].shape[0] > g_pad):
                    # grown past the shared padded shapes: full re-plan
                    self._build_partitions()
                    if self.lru is not None:
                        self.lru.clear()
                    stats["fallback"] = True
                    stats["partitions_rebuilt"] = sum(
                        len(p) for p in self._parts.values())
                    obs.get_registry().counter("stream.update_fallbacks")
                    return stats
                self._parts[mode][i] = self._build_one(ids, raw, nb_pad,
                                                       s_pad, g_pad)
                stats["partitions_rebuilt"] += 1
        if self.lru is not None:
            self.lru.invalidate([(m, i) for m in self._parts
                                 for i in touched])
        return stats

    # --------------------------------------------------------- partitions
    def _partition_ids(self) -> list[np.ndarray]:
        cfg, hb = self.cfg, self.host
        if cfg.partition_method == "ldg":
            if not cfg.n_partitions:
                raise ValueError(
                    'partition_method="ldg" groups a FIXED number of '
                    "partitions by tile connectivity; set n_partitions "
                    "(the byte budget only drives the contiguous splitter)")
            return ldg_block_partition(hb.row_ids, hb.col_ids,
                                       hb.n_row_blocks, cfg.n_partitions)
        if cfg.partition_method != "contiguous":
            raise ValueError(
                f"unknown partition_method {cfg.partition_method!r}")
        budget = (int(cfg.memory_budget_mb * 2 ** 20)
                  if cfg.memory_budget_mb else None)
        return contiguous_block_partition(
            hb.row_ptr, bm=hb.bm, bk=hb.bk,
            d=max(self._dims) if self._dims else hb.bk,
            n_parts=cfg.n_partitions, budget_bytes=budget)

    def _tiles_of(self, rbs: np.ndarray) -> np.ndarray:
        """Indices (into the tile lists) of all tiles of the row blocks."""
        ptr = self.host.row_ptr
        starts, ends = ptr[rbs].astype(np.int64), ptr[rbs + 1].astype(np.int64)
        counts = ends - starts
        total = int(counts.sum())
        if total == 0:
            return np.empty(0, dtype=np.int64)
        offs = np.repeat(np.cumsum(counts) - counts, counts)
        return np.repeat(starts, counts) + (np.arange(total) - offs)

    def _sampled_keep(self, idx: np.ndarray) -> np.ndarray:
        """Tile mask keeping the top-norm column blocks covering
        ``sample_budget`` of this partition's tiles (static Eq. 3 half)."""
        budget = float(self.cfg.sample_budget)
        cb = self.host.col_ids[idx]
        uniq, cnt = np.unique(cb, return_counts=True)
        order = np.argsort(-self.meta.col_block_norm[uniq], kind="stable")
        cum = np.cumsum(cnt[order])
        k = int(np.searchsorted(cum, budget * cum[-1])) + 1
        return np.isin(cb, uniq[order[:k]])

    def _raw_partition(self, rbs: np.ndarray, sampled: bool = False):
        """Unpadded (tile ids, local rows, global cols, uniq col blocks)."""
        idx = self._tiles_of(rbs)
        if sampled and idx.size:
            idx = idx[self._sampled_keep(idx)]
        ptr = self.host.row_ptr
        counts = (ptr[rbs + 1] - ptr[rbs]).astype(np.int64)
        if sampled:
            rows_g = self.host.row_ids[idx].astype(np.int64)
            local = np.searchsorted(rbs, rows_g)
        else:
            local = np.repeat(np.arange(rbs.shape[0]), counts)
        cols_g = self.host.col_ids[idx].astype(np.int64)
        uniq = np.unique(cols_g)
        return idx, local, cols_g, uniq

    def _build_one(self, rbs: np.ndarray, raw, nb_pad: int, s_pad: int,
                   g_pad: int, *, compact: bool = False) -> _Partition:
        """The padded operands of the row blocks ``rbs``. ``compact`` (a
        one-shot recompute chunk) keeps only the chunk's own tiles, with
        the zero sentinel right after them: the same launch at the mode's
        plan length (``s_pad`` entries), without building and uploading
        ``s_pad`` tiles for a chunk that holds few (a sampled chunk is
        often one row block)."""
        bm, bk = self.host.bm, self.host.bk
        idx, local, cols_g, uniq = raw
        k = idx.shape[0]
        sentinel = k if compact else s_pad

        sel = np.arange(k, dtype=np.int32)
        rows = local.astype(np.int32)
        cols = np.searchsorted(uniq, cols_g).astype(np.int32)
        # One sentinel entry per local row block with no tiles (sampled-
        # away rows and the nb_pad padding rows), as the reference builds
        # them.
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

        blocks = np.zeros((sentinel + 1, bm, bk), dtype=np.float32)
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

    def _build_mode(self, ids: list[np.ndarray], sampled: bool,
                    mode: str) -> None:
        """A mode's partitions sharing one padded shape ``(nb_pad, s_pad,
        g_pad)``: row blocks, tile entries and gathered column blocks."""
        raws = [self._raw_partition(rbs, sampled) for rbs in ids]
        nb_pad = max(rbs.shape[0] for rbs in ids)
        s_pad = max(1, max(r[0].shape[0] + nb_pad for r in raws))
        g_pad = max(1, max(r[3].shape[0] for r in raws))
        self._pads[mode] = (nb_pad, s_pad, g_pad)
        self._parts[mode] = [self._build_one(rbs, raw, nb_pad, s_pad, g_pad)
                             for rbs, raw in zip(ids, raws)]

    def _build_partitions(self) -> None:
        ids = self._partition_ids()
        self._partition_id_list = ids
        self._build_mode(ids, sampled=False, mode="exact")
        sb = self.cfg.sample_budget
        if sb is not None and sb < 1.0:
            self._build_mode(ids, sampled=True, mode="sampled")

    @property
    def parts(self) -> list[_Partition]:
        return self._parts["exact"]

    @property
    def pads(self) -> tuple[int, int, int]:
        return self._pads["exact"]

    @property
    def n_partitions(self) -> int:
        return len(self._parts["exact"])

    def _warmup_autotune(self) -> None:
        """One autotuner sweep per (mode's padded shape × SpMM width); the
        backend signed is the one dispatch resolves (``kernel`` on the
        card, ``kernel_plain`` for the kernel wrapper on the CPU)."""
        from repro_torch.kernels import autotune
        backend = self.cfg.backend
        if backend == "kernel" and self.device.type != "cuda":
            backend = "kernel_plain"
        bm = bk = self.cfg.block
        for nb_pad, s_pad, g_pad in self._pads.values():
            for d in sorted(set(self._dims)):
                shape = dict(bm=bm, bk=bk, d=d, s_pad=s_pad,
                             n_row_blocks=nb_pad, n_col_blocks=g_pad)
                if backend == "auto":
                    autotune.get_or_tune_auto(**shape, device=self.device)
                else:
                    autotune.get_or_tune(backend, **shape,
                                         device=self.device)

    # -------------------------------------------------------------- spmm
    def _to_device(self, arrays) -> list[torch.Tensor]:
        """Host arrays on the device, on the current stream (from pageable
        memory: the copy has left the host buffer when this returns)."""
        return [torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                for a in arrays]

    def _statics(self, mode: str, i: int | None, p: _Partition
                 ) -> tuple[torch.Tensor, ...]:
        """The partition's static device operands, through the resident
        LRU when enabled. Ad-hoc partitions (``recompute_rows`` chunks,
        ``i is None``) never enter the cache."""
        def build():
            return tuple(self._to_device(p.statics()))
        if self.lru is not None and i is not None:
            return self.lru.get((mode, i), build)
        return build()

    def _plan(self, statics, p: _Partition, mode: str) -> SamplePlan:
        _, sel, rows, cols, rptr = statics
        return SamplePlan(sel=sel, row_ids=rows, col_ids=cols,
                          n_active=p.n_active, s_pad=self._pads[mode][1],
                          row_ptr=rptr)

    def upload(self, p: _Partition, mode: str = "exact"
               ) -> tuple[torch.Tensor, SamplePlan]:
        """A partition's tiles and plan on the device."""
        statics = self._to_device(p.statics())
        return statics[0], self._plan(statics, p, mode)

    def gather(self, p: _Partition, h: np.ndarray, pre) -> torch.Tensor:
        """The partition's SpMM input: gathered host rows, uploaded, then
        the model's pre-map on the device."""
        slab = self._to_device([h[p.gather_rows]])[0]
        return self._premap(slab, pre)

    @staticmethod
    def _premap(slab: torch.Tensor, pre) -> torch.Tensor:
        if pre is not None:
            fn, pre_params = pre
            slab = fn(pre_params, slab)
        return slab

    def _compute(self, mode: str, p: _Partition, statics, slab, pre
                 ) -> np.ndarray:
        """pre(slab), the partition's SpMM, and the rows read back."""
        nb_pad = self._pads[mode][0]
        res = spmm_apply(statics[0], self._plan(statics, p, mode),
                         self._premap(slab, pre), nb_pad, self.host.bm,
                         self.host.bk, self.cfg.backend)
        return res.cpu().numpy()

    def _device_scope(self):
        """Inference mode on the device of this stream, for whichever
        thread runs the forward (the serving frontend's updater runs
        ``recompute_rows`` on its own)."""
        scope = contextlib.ExitStack()
        scope.enter_context(torch.inference_mode())
        if self.device.type == "cuda":
            scope.enter_context(torch.cuda.device(self.device))
        return scope

    def _spmm_layer(self, l: int, h: np.ndarray, pre, mode: str,
                    parts: list[_Partition] | None = None) -> np.ndarray:
        """SpMM(operand, pre(h)) for all rows covered by ``parts`` (the
        mode's partitions by default; ``recompute_rows`` passes ad-hoc
        chunks, which never take the overlap path or the LRU)."""
        adhoc = parts is not None
        parts = parts if adhoc else self._parts[mode]
        if self.cfg.overlap and not adhoc:
            iterator = self._overlapped(l, mode, parts, h, pre)
        else:
            iterator = ((p, self._timed_partition(
                l, mode, i, p, h, pre, None if adhoc else i))
                for i, p in enumerate(parts))
        out = None
        for p, res in iterator:
            if out is None:
                out = np.zeros((self.host.n_rows, res.shape[1]), np.float32)
            out[p.out_rows] = res[: p.n_rows]
        return out

    def _overlapped(self, l: int, mode: str, parts, h: np.ndarray, pre):
        """Double-buffered partition loop: the prefetcher's worker uploads
        partition i+1's statics (through the LRU when enabled) and
        gathered slab on its side stream while this thread runs partition
        i's pre-map and SpMM — the ``pipeline.prefetch`` pattern pointed at
        inference partitions. The hand-over makes this thread's stream wait
        on the upload's event and records that stream on every uploaded
        tensor."""
        from repro_torch.pipeline.prefetch import Prefetcher

        def fetch(i):
            p = parts[i]
            with torch.inference_mode():
                statics = self._statics(mode, i, p)
                slab = self._to_device([h[p.gather_rows]])[0]
            return statics + (slab,)

        pf = Prefetcher(None, range(len(parts)), device=self.device,
                        fetch=fetch, enabled=True)
        reg, tracer = obs.get_registry(), obs.get_tracer()
        for i, ups in pf:
            p = parts[i]
            # Adopt the prefetcher's baton: the partition's compute span
            # joins the trace of its upload span.
            ictx = trace_context.take_pending() if tracer.enabled else None
            with tracer.span_in(ictx, "stream_partition", layer=l,
                                mode=mode, part=i):
                t0 = time.perf_counter()
                res = self._compute(mode, p, ups[:5], ups[5], pre)
            reg.observe("stream.compute_ms", (time.perf_counter() - t0) * 1e3,
                        layer=str(l), mode=mode)
            yield p, res

    def _timed_partition(self, l: int, mode: str, i: int, p: _Partition,
                         h: np.ndarray, pre, key_i: int | None):
        """One partition, serially: the host gather + upload (a cache read
        for the statics of a resident partition), then the pre-map, the
        SpMM and the read back of its rows, observed as
        ``stream.upload_ms`` and ``stream.compute_ms``."""
        reg, tracer = obs.get_registry(), obs.get_tracer()
        with tracer.span("stream_partition", layer=l, mode=mode, part=i):
            t0 = time.perf_counter()
            statics = self._statics(mode, key_i, p)
            slab = self._to_device([h[p.gather_rows]])[0]
            if self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()
            t1 = time.perf_counter()
            res = self._compute(mode, p, statics, slab, pre)
            t2 = time.perf_counter()
        reg.observe("stream.upload_ms", (t1 - t0) * 1e3,
                    layer=str(l), mode=mode)
        reg.observe("stream.compute_ms", (t2 - t1) * 1e3,
                    layer=str(l), mode=mode)
        return res

    # ------------------------------------------------------------ forward
    def forward(self, params=None, *, sampled: bool | None = None,
                store: bool | None = None) -> np.ndarray:
        """Full-graph logits (padded, operand row order).

        ``sampled`` defaults to whether the config carries a
        ``sample_budget``; ``store`` defaults to ``cfg.store_layers`` and
        retains per-layer activations + frozen batchnorm statistics for
        serving.
        """
        params = params if params is not None else self.params
        sampled = ("sampled" in self._parts) if sampled is None else sampled
        if sampled and "sampled" not in self._parts:
            raise ValueError("sampled forward requested but the config "
                             "has no sample_budget < 1")
        mode = "sampled" if sampled else "exact"
        store = self.cfg.store_layers if store is None else store
        module = self.module
        tracer = obs.get_tracer()
        with self._device_scope():
            h, ctx = module.infer_init(params, self.features)
            layers = [h.copy()] if store else None
            bn_stats: dict[int, tuple | None] = {}
            for l in range(self.n_layers):
                with tracer.span("stream_layer", layer=l, mode=mode):
                    pre = module.infer_pre(params, l)
                    p_out = self._spmm_layer(l, h, pre, mode)
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

    # ----------------------------------------------- incremental recompute
    def _chunk_blocks(self, rbs: np.ndarray, mode: str) -> list[np.ndarray]:
        """Split an arbitrary row-block set into groups that fit the
        mode's padded shapes."""
        nb_pad, s_pad, g_pad = self._pads[mode]
        ptr = self.host.row_ptr
        chunks, cur, tiles, cols = [], [], 0, set()
        for r in rbs:
            t = int(ptr[r + 1] - ptr[r])
            c = set(self.host.col_ids[ptr[r]: ptr[r + 1]].tolist())
            if cur and (len(cur) + 1 > nb_pad
                        or tiles + t + nb_pad > s_pad
                        or len(cols | c) > g_pad):
                chunks.append(np.asarray(cur, np.int64))
                cur, tiles, cols = [], 0, set()
            cur.append(int(r))
            tiles += t
            cols |= c
        if cur:
            chunks.append(np.asarray(cur, np.int64))
        return chunks

    def recompute_rows(self, dirty_per_layer: list[np.ndarray],
                       params=None, mode: str = "exact") -> list[int]:
        """Recompute stored activations/logits for the dirty node sets.

        ``dirty_per_layer[l]`` are the LOCAL rows whose H^{l+1} changed
        (monotone growing with l, ≤L-hop BFS — see ``infer.serve``).
        Batchnorm statistics are applied FROZEN from the last full pass.
        Only dirty node rows are written back, so clean rows stay
        bit-identical. ``mode="sampled"`` recomputes with the RSC-sampled
        column gathers (sampled serving replicas). Returns the chunks (one
        SpMM each) of every layer.
        """
        if self.layer_store is None:
            raise RuntimeError("no stored activations: run "
                               "forward(store=True) first")
        if mode not in self._parts:
            raise ValueError(f"no {mode!r} partitions built")
        params = params if params is not None else self.params
        module = self.module
        bm = self.host.bm
        n_chunks = []
        with self._device_scope():
            for l in range(self.n_layers):
                dirty = np.asarray(dirty_per_layer[l], dtype=np.int64)
                if dirty.size == 0:
                    n_chunks.append(0)
                    continue
                rbs = np.unique(dirty // bm)
                h = self.layer_store[l]
                pre = module.infer_pre(params, l)
                nb_pad, s_pad, g_pad = self._pads[mode]
                parts = [self._build_one(
                    chunk, self._raw_partition(chunk, mode == "sampled"),
                    nb_pad, s_pad, g_pad, compact=True)
                    for chunk in self._chunk_blocks(rbs, mode)]
                n_chunks.append(len(parts))
                p_out = self._spmm_layer(l, h, pre, mode, parts=parts)
                ctx_rows = (self.ctx_store[dirty]
                            if self.ctx_store is not None else None)
                h_new, _ = module.infer_post(
                    params, l, p_out[dirty], h[dirty], ctx_rows,
                    self.valid[dirty], self.bn_stats.get(l))
                self.layer_store[l + 1][dirty] = h_new
            final = np.asarray(dirty_per_layer[self.n_layers - 1],
                               dtype=np.int64)
            if final.size:
                ctx_rows = (self.ctx_store[final]
                            if self.ctx_store is not None else None)
                self.logits[final] = np.asarray(module.infer_out(
                    params, self.layer_store[self.n_layers][final],
                    ctx_rows), dtype=np.float32)
        return n_chunks


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
        tracer = obs.get_tracer()
        with tracer.span("eval.logits"):
            with tracer.device_span("eval", torch.device(self.cfg.device)):
                logits = self.si.forward(params, store=False)
        si = self.si
        with tracer.span("eval.score"):
            val = mfn(logits, si.labels, si.val_mask & si.valid)
            test = mfn(logits, si.labels, si.test_mask & si.valid)
        self.evals += 1
        obs.get_registry().observe("stream.eval_ms",
                                   (time.perf_counter() - t0) * 1e3)
        return val, test
