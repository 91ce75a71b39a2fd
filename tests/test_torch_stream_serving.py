"""The port's serving machinery against the reference: incremental
re-tiling (``retile_rows``, ``replace_row_blocks``), LDG partitioning of
row blocks, RSC-sampled partitions, dirty-bounded operand updates and
recompute (``update_operand``, ``recompute_rows``,
``NodeServer.update_edges``), and the device-resident partition LRU and
upload overlap of ``infer/stream.py``.

Graph and sizes are the reference tests' (``sbm_graph(n_nodes=500,
n_clusters=5, avg_degree=10, feat_dim=16)``, block 32, 3 partitions); the
parameters are the reference's seeded init carried over with
``convert.gnn_params_from_numpy``; the reference runs its ``jnp`` backend,
the port the kernel's plain version on the CPU. Host arrays (tiles, id
lists, planner metadata, partitions, dirty sets, update statistics, LRU
counters) must be identical. Logits: atol 1e-5·max|logit| (rtol 0) — the
two packages sum the same f32 products in different orders. Within the
port, the LRU and overlap forwards and the clean rows of an update are
held bit for bit.
"""
import copy
import dataclasses

import jax
import numpy as np
import pytest

from repro.graphs.synthetic import sbm_graph as jax_sbm_graph
from repro.infer import NodeServer as JaxNodeServer
from repro.infer import StreamConfig as JaxStreamConfig
from repro.infer import StreamingInference as JaxStreamingInference
from repro.infer.serve import _edit_csr as jax_edit_csr
from repro.infer.serve import _neighbors as jax_neighbors
from repro.models.gnn import MODELS as JAX_MODELS
from repro.pipeline.partition import \
    ldg_block_partition as jax_ldg_block_partition
from repro.sparse import bcoo as jbcoo
from repro_torch.convert import gnn_params_from_numpy
from repro_torch.graphs.synthetic import sbm_graph
from repro_torch.infer import NodeServer, StreamConfig, StreamingInference
from repro_torch.infer.serve import _edit_csr, _neighbors
from repro_torch.kernels import autotune
from repro_torch.launch import train as train_cli
from repro_torch.pipeline.partition import ldg_block_partition
from repro_torch.sparse import bcoo

from tests.test_torch_gnn_train import one_torch_thread  # noqa: F401

GRAPH = dict(n_nodes=500, n_clusters=5, avg_degree=10, feat_dim=16, seed=0)
CFG = dict(block=32, n_partitions=3, memory_budget_mb=None)


@pytest.fixture(scope="module")
def graphs():
    return sbm_graph(**GRAPH), jax_sbm_graph(**GRAPH)


def _params(layers=2, batchnorm=False, seed=0):
    """The reference's seeded GCN init (numpy) and the port's copy."""
    tree = jax.device_get(JAX_MODELS["gcn"].init(
        jax.random.PRNGKey(seed), 16, 32, 5, layers, batchnorm))
    return tree, gnn_params_from_numpy("gcn", tree, "cpu")


def _pair(graphs, layers=2, batchnorm=False, **cfg):
    g, r = graphs
    tree, net = _params(layers, batchnorm)
    kw = dict(CFG, **cfg)
    si = StreamingInference(g, "gcn", net, StreamConfig(device="cpu", **kw))
    jsi = JaxStreamingInference(r, "gcn", tree, JaxStreamConfig(**kw))
    return si, jsi


def _close(ours, ref):
    """Logits within atol 1e-5·max|logit|, rtol 0."""
    ref = np.asarray(ref)
    np.testing.assert_allclose(ours, ref, rtol=0,
                               atol=1e-5 * float(np.abs(ref).max()))


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _same_host(a, b):
    for f in ("blocks", "row_ids", "col_ids", "row_ptr"):
        _same(getattr(a, f), getattr(b, f))
    for f in ("bm", "bk", "n_rows", "n_cols", "n_row_blocks",
              "n_col_blocks", "s_total"):
        assert getattr(a, f) == getattr(b, f), f


def _same_meta(a, b):
    for f in ("row_ids", "col_ids", "col_block_tiles", "col_block_norm",
              "col_nnz", "col_norm"):
        _same(getattr(a, f), getattr(b, f))


def _dirty_rows(add, remove):
    return np.unique(np.asarray(list(add) + list(remove),
                                np.int64).reshape(-1, 2))


def _hub_and_leaf(adj):
    deg = adj.row_nnz()
    hub = int(np.argmax(deg))
    return hub, int(adj.col[adj.rowptr[hub]]), int(np.argmin(deg))


def _non_neighbor(adj, u):
    nbrs = set(adj.col[adj.rowptr[u]: adj.rowptr[u + 1]].tolist())
    return next(x for x in range(adj.n_rows) if x != u and x not in nbrs)


# ------------------------------------------------ incremental re-tiling

@pytest.mark.parametrize("kind", ["remove", "add", "mixed", "duplicate"])
@pytest.mark.parametrize("in_place", [True, False])
def test_retile_rows_matches_reference(graphs, kind, in_place):
    """``retile_rows`` gives the reference's tile arrays and planner
    metadata bit for bit (and the full re-tile's tiles), in place or not;
    ``_edit_csr`` gives the reference's CSR."""
    g, _ = graphs
    adj = g.adj
    hub, nbr, leaf = _hub_and_leaf(adj)
    far = (leaf + g.n // 2) % g.n
    add, remove = {"remove": ([], [(hub, nbr)]),
                   "add": ([(hub, far), (leaf, far)], []),
                   "mixed": ([(leaf, far)], [(hub, nbr)]),
                   "duplicate": ([(hub, nbr)], [])}[kind]
    add_a = np.asarray(add, np.int64).reshape(-1, 2)
    rem_a = np.asarray(remove, np.int64).reshape(-1, 2)
    new_csr = _edit_csr(adj, add_a, rem_a)
    ref_csr = jax_edit_csr(adj, add_a, rem_a)
    for f in ("rowptr", "col", "val"):
        _same(getattr(new_csr, f), getattr(ref_csr, f))
    dirty = _dirty_rows(add, remove)
    host, meta = bcoo.csr_to_bcoo_host(adj, bm=32, bk=32)
    jhost, jmeta = jbcoo.csr_to_bcoo_host(adj, bm=32, bk=32)
    ours = bcoo.retile_rows(host, meta, new_csr, dirty, in_place=in_place)
    ref = jbcoo.retile_rows(jhost, jmeta, ref_csr, dirty, in_place=in_place)
    _same_host(ours[0], ref[0])
    _same_meta(ours[1], ref[1])
    full, _ = bcoo.csr_to_bcoo_host(new_csr, bm=32, bk=32)
    _same_host(ours[0], full)
    assert not ours[0].blocks[-1].any()
    if not in_place:   # the source operand is untouched
        _same_host(host, bcoo.csr_to_bcoo_host(adj, bm=32, bk=32)[0])


def test_retile_rows_tile_count_change_matches_reference():
    """An edit that creates new tiles takes the splice (``s_total``
    grows) in both packages, with identical arrays."""
    g = sbm_graph(n_nodes=2000, n_clusters=8, avg_degree=3, feat_dim=8,
                  seed=1)
    adj = g.adj
    hub = int(np.argmax(adj.row_nnz()))
    host, meta = bcoo.csr_to_bcoo_host(adj, bm=32, bk=32)
    jhost, jmeta = jbcoo.csr_to_bcoo_host(adj, bm=32, bk=32)
    present = set(host.col_ids[host.row_ids == hub // 32].tolist())
    missing = next(cb for cb in range(g.n // 32) if cb not in present)
    add = np.asarray([(hub, missing * 32)], np.int64)
    new_csr = _edit_csr(adj, add, np.empty((0, 2), np.int64))
    dirty = _dirty_rows(add.tolist(), [])
    ours = bcoo.retile_rows(host, meta, new_csr, dirty)
    ref = jbcoo.retile_rows(jhost, jmeta, new_csr, dirty)
    assert ours[0].s_total == host.s_total + 2   # (hub, c) and (c, hub)
    _same_host(ours[0], ref[0])
    _same_meta(ours[1], ref[1])


def test_retile_rows_sequential_edits_match_reference(graphs):
    """A chain of edits applied incrementally ends on the reference's
    arrays and on a full re-tile of the final CSR."""
    g, _ = graphs
    adj = g.adj
    hub, nbr, leaf = _hub_and_leaf(adj)
    host, meta = bcoo.csr_to_bcoo_host(adj, bm=32, bk=32)
    jhost, jmeta = jbcoo.csr_to_bcoo_host(adj, bm=32, bk=32)
    csr = adj
    far = (leaf + 97) % g.n
    for add, remove in [([], [(hub, nbr)]), ([(leaf, far)], []),
                        ([(hub, nbr)], [(leaf, far)])]:
        csr = _edit_csr(csr, np.asarray(add, np.int64).reshape(-1, 2),
                        np.asarray(remove, np.int64).reshape(-1, 2))
        dirty = _dirty_rows(add, remove)
        host, meta = bcoo.retile_rows(host, meta, csr, dirty)
        jhost, jmeta = jbcoo.retile_rows(jhost, jmeta, csr, dirty)
        _same_host(host, jhost)
        _same_meta(meta, jmeta)
    _same_host(host, bcoo.csr_to_bcoo_host(csr, bm=32, bk=32)[0])


@pytest.mark.parametrize("change", ["same_counts", "new_counts"])
@pytest.mark.parametrize("in_place", [True, False])
def test_replace_row_blocks_matches_reference(graphs, change, in_place):
    """``replace_row_blocks`` splices replacement tiles as the reference
    does: an in-place value rewrite when every count survives, a re-sorted
    splice otherwise (or whenever ``in_place`` is off)."""
    g, _ = graphs
    host, _ = bcoo.csr_to_bcoo_host(g.adj, bm=32, bk=32)
    jhost, _ = jbcoo.csr_to_bcoo_host(g.adj, bm=32, bk=32)
    rbs = np.asarray([1, 4, 9], np.int64)
    rng = np.random.default_rng(0)
    rows, cols = [], []
    for r in rbs:
        c = host.col_ids[host.row_ptr[r]: host.row_ptr[r + 1]]
        if change == "new_counts":
            c = np.union1d(c[:-1], [host.n_col_blocks - 1 - r])
        rows.append(np.full(c.shape, r, np.int32))
        cols.append(c.astype(np.int32))
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    tiles = rng.standard_normal((rows.shape[0], 32, 32)).astype(np.float32)
    ours = host.replace_row_blocks(rbs, rows, cols, tiles.copy(),
                                   in_place=in_place)
    ref = jhost.replace_row_blocks(rbs, rows, cols, tiles.copy(),
                                   in_place=in_place)
    _same_host(ours, ref)
    assert (ours is host) == (in_place and change == "same_counts")
    with pytest.raises(ValueError, match="outside the replaced set"):
        host.replace_row_blocks(rbs[:1], rows, cols, tiles)


# ------------------------------------------------------ partitioning

@pytest.mark.parametrize("n_parts", [1, 2, 3, 5])
def test_ldg_block_partition_matches_reference(graphs, n_parts):
    g, _ = graphs
    host, _ = bcoo.csr_to_bcoo_host(g.adj, bm=32, bk=32)
    args = (host.row_ids, host.col_ids, host.n_row_blocks, n_parts)
    ours, ref = ldg_block_partition(*args), jax_ldg_block_partition(*args)
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        _same(a, b)
    assert np.array_equal(np.sort(np.concatenate(ours)),
                          np.arange(host.n_row_blocks))


def _same_parts(si, jsi, mode):
    assert si._pads[mode] == jsi._pads[mode]
    assert len(si._parts[mode]) == len(jsi._parts[mode])
    for p, jp in zip(si._parts[mode], jsi._parts[mode]):
        for f in ("rbs", "blocks", "sel", "row_ids", "col_ids", "row_ptr",
                  "gather_rows", "out_rows"):
            _same(getattr(p, f), getattr(jp, f))
        assert (p.n_rows, p.n_active, p.n_gather) == \
            (jp.n_rows, jp.n_active, jp.n_gather)


@pytest.mark.parametrize("degree_sort", [True, False])
def test_ldg_stream_partitions_and_forward_match_reference(graphs,
                                                           degree_sort):
    si, jsi = _pair(graphs, partition_method="ldg",
                    degree_sort=degree_sort)
    _same(si.nodes, jsi.nodes)
    _same_parts(si, jsi, "exact")
    assert si.parts is si._parts["exact"] and si.pads == si._pads["exact"]
    _close(si.forward()[:500], jsi.forward()[:500])
    with pytest.raises(ValueError, match="set n_partitions"):
        StreamingInference(graphs[0], "gcn", _params()[1], StreamConfig(
            block=32, partition_method="ldg", device="cpu"))
    with pytest.raises(ValueError, match="unknown partition_method"):
        StreamingInference(graphs[0], "gcn", _params()[1], StreamConfig(
            block=32, partition_method="metis", device="cpu"))


def test_stream_config_fields_match_reference():
    ours = {f.name: f.default for f in dataclasses.fields(StreamConfig)}
    ref = {f.name: f.default for f in dataclasses.fields(JaxStreamConfig)}
    assert set(ours) == set(ref) | {"device"}
    for k in set(ref) - {"backend"}:
        assert ours[k] == ref[k], k


# ------------------------------------------------- sampled partitions

@pytest.mark.parametrize("budget", [0.3, 0.7])
@pytest.mark.parametrize("layers,batchnorm", [(2, False), (3, True)])
def test_sampled_partitions_and_forward_match_reference(graphs, budget,
                                                        layers, batchnorm):
    """The sampled mode keeps the reference's column blocks: every
    partition's ``sel``, ``row_ids``, ``col_ids``, ``gather_rows`` and the
    mode's pads equal ``_parts["sampled"]``; the sampled forward is within
    1e-5·max|logit| of the reference's, and the exact one too."""
    si, jsi = _pair(graphs, layers, batchnorm, sample_budget=budget)
    _same_parts(si, jsi, "exact")
    _same_parts(si, jsi, "sampled")
    nb_e, s_e, g_e = si._pads["exact"]
    nb_s, s_s, g_s = si._pads["sampled"]
    assert s_s < s_e and g_s <= g_e and nb_s == nb_e
    # sampled-away local row blocks hold a sentinel entry each
    sentinel = s_s
    for p in si._parts["sampled"]:
        present = np.unique(p.row_ids[p.sel != sentinel])
        assert present.size <= nb_s
    ours, ref = si.forward(sampled=True), jsi.forward(sampled=True)
    _close(ours[:500], ref[:500])
    exact = si.forward(sampled=False)
    _close(exact[:500], jsi.forward(sampled=False)[:500])
    assert not np.allclose(ours[:500], exact[:500])


def test_sampled_forward_refused_without_budget(graphs):
    si, _ = _pair(graphs)
    with pytest.raises(ValueError, match="no sample_budget"):
        si.forward(sampled=True)
    with pytest.raises(ValueError, match="sampled serving needs"):
        NodeServer(graphs[0], "gcn", _params()[1],
                   StreamConfig(device="cpu", **CFG), sampled=True)


# ------------------------------------------- updates and recompute

def _edits(g, kind):
    adj = g.adj
    hub, nbr, _ = _hub_and_leaf(adj)
    u = 11
    v = _non_neighbor(adj, u)
    return {"insert": ([(u, v)], []),
            "remove": ([], [(hub, nbr)]),
            "both": ([(u, v)], [(hub, nbr)])}[kind]


def _servers(graphs, layers, batchnorm, sampled=False, incremental=True,
             **cfg):
    g, r = graphs
    tree, net = _params(layers, batchnorm)
    kw = dict(CFG, **cfg)
    srv = NodeServer(g, "gcn", net, StreamConfig(device="cpu", **kw),
                     sampled=sampled, incremental=incremental)
    jsrv = JaxNodeServer(r, "gcn", tree, JaxStreamConfig(**kw),
                         sampled=sampled, incremental=incremental)
    return srv, jsrv


def _check_update(srv, jsrv, add, remove):
    """One update in both packages: identical dirty sets and retile
    statistics, logits within tolerance, clean rows bit for bit."""
    before = srv.si.logits.copy()
    stats = srv.update_edges(add=add, remove=remove)
    jstats = jsrv.update_edges(add=add, remove=remove)
    for k in ("edges", "dirty_nodes", "dirty_per_layer", "version",
              "recomputed_row_frac", "dirty_frac"):
        assert stats[k] == jstats[k], k
    drop = lambda d: {k: v for k, v in d.items() if k != "seconds"}  # noqa
    assert drop(stats["retile"]) == drop(jstats["retile"])
    _same(srv.last_dirty, jsrv.last_dirty)
    assert len(stats["recompute_chunks"]) == srv.si.n_layers
    _same_host(srv.si.host, jsrv.si.host)
    _same_meta(srv.si.meta, jsrv.si.meta)
    for mode in srv.si._parts:
        _same_parts(srv.si, jsrv.si, mode)
    n = srv.n_nodes
    _close(srv.si.logits[:n], np.asarray(jsrv.si.logits)[:n])
    clean = np.setdiff1d(np.arange(srv.si.host.n_rows), srv.last_dirty)
    _same(srv.si.logits[clean], before[clean])
    ids = np.arange(n)
    _close(srv.query(ids), jsrv.query(ids))
    return stats


@pytest.mark.parametrize("kind", ["insert", "remove", "both"])
@pytest.mark.parametrize("batchnorm", [False, True])
def test_update_edges_matches_reference(graphs, kind, batchnorm):
    """``update_edges`` (incremental: ``update_operand`` +
    ``recompute_rows``) for insertions and removals, batchnorm frozen or
    absent, twice in a row (the second edit undoes the first): the
    reference's dirty sets, retile statistics and partitions, logits
    within 1e-5·max|logit|, clean rows untouched bit for bit."""
    g, _ = graphs
    srv, jsrv = _servers(graphs, 3, batchnorm)
    add, remove = _edits(g, kind)
    st = _check_update(srv, jsrv, add, remove)
    assert not st["retile"]["fallback"] and st["version"] == 1
    st = _check_update(srv, jsrv, remove, add)
    assert st["version"] == 2 and srv.stats()["updates"] == 2
    # chunks: the reference's split of the same row blocks
    rbs = np.unique(srv.last_dirty // 32)
    ours = srv.si._chunk_blocks(rbs, "exact")
    ref = jsrv.si._chunk_blocks(rbs, "exact")
    assert [c.tolist() for c in ours] == [c.tolist() for c in ref]
    assert st["recompute_chunks"][-1] == len(ours)


def test_update_operand_fallback_matches_reference():
    """On a graph sparse at tile granularity, a hub wired to every 4th node
    outgrows the padded shapes: both packages fall back to a full re-plan
    (counted, never silent) and keep serving the reference's logits."""
    kw = dict(n_nodes=2000, n_clusters=8, avg_degree=3, feat_dim=16,
              seed=1)
    pair = (sbm_graph(**kw), jax_sbm_graph(**kw))
    g = pair[0]
    srv, jsrv = _servers(pair, 2, False)
    hub = int(np.argmax(g.adj.row_nnz()))
    add = [(hub, v) for v in range(0, g.n, 4) if v != hub]
    st = _check_update(srv, jsrv, add, [])
    assert st["retile"]["fallback"]
    assert st["retile"]["partitions_rebuilt"] == srv.si.n_partitions


@pytest.mark.parametrize("incremental", [True, False])
def test_update_edges_oracle_and_sampled_replica(graphs, incremental):
    """The full re-tile oracle (``incremental=False``) and a sampled
    replica (recompute through the sampled gathers) follow the reference
    too; the incremental and oracle servers publish the same bits."""
    g, _ = graphs
    add, remove = _edits(g, "both")
    srv, jsrv = _servers(graphs, 2, True, incremental=incremental)
    _check_update(srv, jsrv, add, remove)
    other, _ = _servers(graphs, 2, True, incremental=not incremental)
    other.update_edges(add=add, remove=remove)
    _same(other.si.logits, srv.si.logits)
    ssrv, jssrv = _servers(graphs, 2, True, sampled=True,
                           incremental=incremental, sample_budget=0.5)
    _close(ssrv.si.logits[:500], np.asarray(jssrv.si.logits)[:500])
    st = _check_update(ssrv, jssrv, add, remove)
    assert ssrv.stats()["sampled"] and st["version"] == 1


def test_recompute_rows_chunks_equal_full_partitions(graphs):
    """Recomputing EVERY row through ``recompute_rows``' ad-hoc chunks
    reproduces the full forward bit for bit (each row sums the same tiles
    in the same order), batchnorm frozen at the same statistics."""
    tree, net = _params(3, False)
    si = StreamingInference(graphs[0], "gcn", net, StreamConfig(
        device="cpu", store_layers=True, **CFG))
    full = si.forward().copy()
    stores = [a.copy() for a in si.layer_store]
    every = np.arange(si.host.n_rows)
    si.logits[:] = 0.0
    for a in si.layer_store[1:]:
        a[:] = 0.0
    chunks = si.recompute_rows([every] * si.n_layers)
    assert chunks == [len(si._chunk_blocks(np.unique(every // 32),
                                           "exact"))] * 3
    _same(si.logits, full)
    for a, b in zip(si.layer_store, stores):
        _same(a, b)
    with pytest.raises(ValueError, match="no 'sampled' partitions"):
        si.recompute_rows([every] * 3, mode="sampled")
    bare = StreamingInference(graphs[0], "gcn", net,
                              StreamConfig(device="cpu", **CFG))
    with pytest.raises(RuntimeError, match="no stored activations"):
        bare.recompute_rows([every] * 3)


def test_rebuild_operand_matches_fresh_stream(graphs):
    """``rebuild_operand`` (the oracle path) clears the LRU and serves the
    edited graph as a fresh stream over it does (within 1e-5·max|logit|:
    the fresh stream's node order, and so its sums' order, differ)."""
    g, r = graphs
    tree, net = _params(2, False)
    cfg = StreamConfig(device="cpu", resident_mb=64.0, **CFG)
    si = StreamingInference(g, "gcn", net, cfg)
    si.forward()
    assert len(si.lru._entries) == 3
    u = 7
    v = _non_neighbor(g.adj, u)
    si.rebuild_operand(_edit_csr(si.adj, np.asarray([[si.pos[u], si.pos[v]]]),
                                 np.empty((0, 2), np.int64)))
    assert len(si.lru._entries) == 0 and si.lru.resident_bytes == 0
    g2 = copy.copy(g)
    g2.adj = _edit_csr(g.adj, np.asarray([[u, v]]),
                       np.empty((0, 2), np.int64))
    si2 = StreamingInference(g2, "gcn", net, dataclasses.replace(
        cfg, resident_mb=None))
    ids = np.arange(g.n)   # the fresh stream sorts by the new degrees
    _close(si.forward()[si.pos[ids]], si2.forward()[si2.pos[ids]])


def test_dirty_sets_match_reference(graphs):
    """``_neighbors`` and the per-layer BFS of ``_dirty_sets``."""
    g, _ = graphs
    nodes = np.asarray([0, 11, 499], np.int64)
    _same(_neighbors(g.adj, nodes), jax_neighbors(g.adj, nodes))
    _same(_neighbors(g.adj, nodes[:0]), jax_neighbors(g.adj, nodes[:0]))
    srv, jsrv = _servers(graphs, 3, False)
    add, remove = _edits(g, "both")
    new_adj = _edit_csr(srv.si.adj, srv.si.pos[np.asarray(add)],
                        srv.si.pos[np.asarray(remove)])
    seeds = srv.si.pos[np.asarray(add + remove).reshape(-1)]
    ours = srv._dirty_sets(srv.si.adj, new_adj, seeds)
    ref = jsrv._dirty_sets(jsrv.si.adj, new_adj, seeds)
    assert len(ours) == 3
    for a, b in zip(ours, ref):
        _same(a, b)
    assert all(np.isin(a, b).all() for a, b in zip(ours, ours[1:]))


# ------------------------------------------ device LRU and overlap

@pytest.mark.parametrize("resident_mb", [64.0, 0.05, 0.3])
@pytest.mark.parametrize("n_parts", [1, 3, 5])
@pytest.mark.parametrize("overlap", [False, True])
def test_lru_counters_match_reference(graphs, resident_mb, n_parts,
                                      overlap):
    """Two forwards, the LRU's ``hits`` / ``misses`` / ``evictions`` /
    ``resident_bytes`` equal the reference's after each (same budget, same
    calls, the same bytes of the same arrays); the LRU forwards, with and
    without overlap, equal the serial forward bit for bit."""
    kw = dict(n_partitions=n_parts, resident_mb=resident_mb,
              overlap=overlap)
    si, jsi = _pair(graphs, **kw)
    base, _ = _pair(graphs, n_partitions=n_parts)
    want = base.forward()
    for _ in range(2):
        _same(si.forward(), want)
        jsi.forward()
        for f in ("hits", "misses", "evictions", "resident_bytes"):
            assert getattr(si.lru, f) == getattr(jsi.lru, f), f
    if resident_mb == 64.0:   # all resident: the warm pass only hits
        assert si.lru.misses == n_parts and si.lru.evictions == 0
        assert si.lru.hits == 3 * n_parts
    if resident_mb == 0.05 and n_parts > 1:   # one entry always stays
        assert si.lru.evictions > 0
    assert si.lru.resident_bytes <= max(si.lru.budget_bytes,
                                        max(si.lru._bytes.values()))


@pytest.mark.parametrize("batchnorm", [False, True])
def test_overlap_forward_bit_identical(graphs, batchnorm):
    """The prefetch thread reorders only uploads, never the math: the
    overlapped forward (exact and sampled modes) equals the serial one bit
    for bit."""
    kw = dict(n_partitions=5, sample_budget=0.5)
    si, _ = _pair(graphs, 3, batchnorm, overlap=True, **kw)
    base, _ = _pair(graphs, 3, batchnorm, **kw)
    for sampled in (False, True, False):
        _same(si.forward(sampled=sampled), base.forward(sampled=sampled))


def test_update_with_lru_invalidates_touched_partitions(graphs):
    """After an incremental update the touched partitions leave the LRU
    (the reference's invalidation, counters equal), the next forward
    re-uploads them, and the LRU server serves the no-LRU server's bits."""
    g, _ = graphs
    srv, jsrv = _servers(graphs, 2, False, resident_mb=64.0, overlap=True)
    plain, _ = _servers(graphs, 2, False)
    add, remove = _edits(g, "insert")
    st = _check_update(srv, jsrv, add, remove)
    plain.update_edges(add=add, remove=remove)
    _same(srv.si.logits, plain.si.logits)
    lru, jlru = srv.si.lru, jsrv.si.lru
    assert len(lru._entries) == 3 - st["retile"]["partitions_touched"]
    srv.si.forward(store=False)
    jsrv.si.forward(store=False)
    for f in ("hits", "misses", "evictions", "resident_bytes"):
        assert getattr(lru, f) == getattr(jlru, f), f


def test_stream_metrics_published(graphs):
    """``stream.upload_ms`` / ``stream.compute_ms`` per (layer, mode) and
    the LRU's counters and gauges reach the registry."""
    from repro_torch import obs
    ob = obs.reset(metrics=True)
    try:
        si, _ = _pair(graphs, resident_mb=64.0)
        si.forward()
        snap = ob.registry.snapshot()
    finally:
        obs.reset()
    h = snap["histograms"]
    for l in (0, 1):
        assert h[f"stream.upload_ms{{layer={l},mode=exact}}"]["count"] == 3
        assert h[f"stream.compute_ms{{layer={l},mode=exact}}"]["count"] == 3
    assert snap["counters"]["stream.lru_misses"] == 3
    assert snap["counters"]["stream.lru_hits"] == 3
    assert snap["gauges"]["stream.lru_hit_rate"] == 0.5


def test_autotune_warmup_signs_each_mode(graphs, tmp_path):
    """``autotune=True`` sweeps one signature per (mode's padded shape ×
    SpMM width) up front, under the backend dispatch resolves on the CPU
    (``kernel_plain``), so the forward's lookups hit."""
    cache = autotune.reset(tmp_path / "tune.json")
    try:
        si, _ = _pair(graphs, sample_budget=0.5, autotune=True)
        sigs = set(cache.entries)
        assert len(sigs) == 2 * len(set(si._dims))
        assert all(s.startswith("kernel_plain|") for s in sigs)
        si.forward()
        assert cache.stats.sweeps == len(sigs)
    finally:
        autotune.reset()


def test_train_stream_eval_with_lru_and_overlap(capsys):
    """``train gnn --eval-mode stream --stream-resident-mb 8
    --stream-overlap`` evaluates as the plain streamed evaluation does."""
    base = ["gnn", "--dataset", "reddit", "--scale", "0.003", "--block",
            "32", "--hidden", "16", "--layers", "2", "--epochs", "4",
            "--eval-mode", "stream", "--device", "cpu", "--dropout", "0"]
    a = train_cli.main(base)
    b = train_cli.main(base + ["--stream-resident-mb", "8",
                               "--stream-overlap"])
    assert a["report"]["best_test"] == b["report"]["best_test"]
    se = b["trainer"].engine.stream_eval
    assert se.cfg.resident_mb == 8.0 and se.cfg.overlap
    assert se.si.lru.hits > 0


def test_lru_counts_hold_under_thread_stress():
    """Many threads hitting one LRU with a shortened switch interval: every
    call is counted once as a hit or a miss, and ``resident_bytes`` stays
    the sum of the resident entries' bytes (a lost update breaks both)."""
    import sys
    import threading

    import torch

    from repro_torch.infer.stream import _DeviceLRU

    lru = _DeviceLRU(budget_bytes=6 * 4096)
    n_threads, calls = 16, 200
    errs = []

    def work(seed):
        rng = np.random.default_rng(seed)
        try:
            for k in rng.integers(0, 10, calls):
                lru.get(("exact", int(k)),
                        lambda: (torch.zeros(1024), torch.zeros(0)))
        except BaseException as e:   # pragma: no cover
            errs.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=work, args=(i,))
              for i in range(n_threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(60)
    finally:
        sys.setswitchinterval(old)
    assert not errs and not any(t.is_alive() for t in ts)
    assert lru.hits + lru.misses == n_threads * calls
    assert lru.resident_bytes == sum(lru._bytes.values()) \
        == 4096 * len(lru._entries)
    assert lru.resident_bytes <= lru.budget_bytes


def test_profile_stream_on_cpu(capsys):
    """``launch.profile_stream`` at a tiny size on the CPU: every round
    times the six forwards (serial and overlapped; no LRU, cold, warm),
    each equal to the serial forward bit for bit (``main`` raises
    otherwise); the warm forwards only hit the LRU."""
    from repro_torch.launch import profile_stream

    out = profile_stream.main(
        ["--scale", "0.003", "--hidden", "16", "--layers", "2", "--block",
         "32", "--memory-budget-mb", "0.5", "--resident-mb", "64",
         "--rounds", "1", "--device", "cpu"])
    assert out["card"] is None and out["n_partitions"] > 1
    (rnd,) = out["rounds"]
    assert list(rnd) == [f"{o}_{m}" for o in ("serial", "overlap")
                         for m in ("none", "cold", "warm")]
    parts, layers = out["n_partitions"], 2
    for o in ("serial", "overlap"):
        assert "lru" not in rnd[f"{o}_none"]
        cold, warm = rnd[f"{o}_cold"]["lru"], rnd[f"{o}_warm"]["lru"]
        assert cold["misses"] == warm["misses"] == parts
        assert warm["hits"] - cold["hits"] == layers * parts
    assert rnd["serial_none"]["upload_ms"] > 0
    assert rnd["overlap_none"]["prefetch_upload_ms"] > 0
    assert capsys.readouterr().out.count("[stream round 0]") == 6
