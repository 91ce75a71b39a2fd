"""Host-side parity of the PyTorch port: graphs, normalized CSR, tiling,
partitions and plans must be bit-identical to ``repro``'s for the same
seed. Also holds the port to its independence rule: no ``jax`` and no
``repro`` import anywhere under ``src/repro_torch``."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.plan import plan_row_ptr as jax_plan_row_ptr
from repro.graphs.datasets import load_dataset as jax_load_dataset
from repro.graphs.synthetic import sbm_graph as jax_sbm_graph
from repro.infer import StreamConfig as JaxStreamConfig
from repro.infer import StreamingInference as JaxStreamingInference
from repro.models.gnn import MODELS as JAX_MODELS
from repro.pipeline.partition import \
    contiguous_block_partition as jax_contiguous
from repro.sparse import bcoo as jax_bcoo
from repro.sparse import topology as jax_topo
from repro_torch.core.plan import plan_row_ptr
from repro_torch.graphs.datasets import load_dataset
from repro_torch.graphs.synthetic import sbm_graph
from repro_torch.infer import StreamConfig, StreamingInference
from repro_torch.models.gnn import gcn as torch_gcn
from repro_torch.pipeline.partition import contiguous_block_partition
from repro_torch.sparse import bcoo, topology
from repro_torch.sparse.csr import CSR

PORT = Path(__file__).resolve().parents[1] / "src" / "repro_torch"


def _same(a, b):
    """Bit-identical arrays: same dtype, shape and bytes."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.array_equal(a, b), "values differ"


def _same_csr(a, b):
    assert a.shape == b.shape
    _same(a.rowptr, b.rowptr)
    _same(a.col, b.col)
    _same(a.val, b.val)


def _same_graph(g, r):
    _same_csr(g.adj, r.adj)
    for f in ("features", "labels", "train_mask", "val_mask", "test_mask"):
        _same(getattr(g, f), getattr(r, f))
    assert (g.num_classes, g.multilabel, g.name) == \
        (r.num_classes, r.multilabel, r.name)


@pytest.fixture(scope="module")
def pair():
    """The same SBM graph from both packages."""
    kw = dict(n_nodes=300, n_clusters=4, avg_degree=8, feat_dim=12, seed=3)
    return sbm_graph(**kw), jax_sbm_graph(**kw)


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("multilabel", [False, True])
def test_sbm_graph_bit_identical(seed, multilabel):
    kw = dict(n_nodes=250, n_clusters=5, avg_degree=6, feat_dim=10,
              multilabel=multilabel, seed=seed)
    _same_graph(sbm_graph(**kw), jax_sbm_graph(**kw))


@pytest.mark.parametrize("name", ["reddit", "yelp"])
def test_load_dataset_bit_identical(name):
    _same_graph(load_dataset(name, scale=0.001, seed=1),
                jax_load_dataset(name, scale=0.001, seed=1))


@pytest.mark.parametrize("fn", ["sym_normalize", "mean_normalize",
                                "add_self_loops"])
def test_normalizations_bit_identical(pair, fn):
    g, r = pair
    _same_csr(getattr(topology, fn)(g.adj), getattr(jax_topo, fn)(r.adj))


def test_csr_methods_bit_identical(pair):
    g, r = pair
    a, b = topology.sym_normalize(g.adj), jax_topo.sym_normalize(r.adj)
    perm = np.random.default_rng(0).permutation(a.n_rows)
    _same_csr(a.permute(perm), b.permute(perm))
    _same_csr(a.transpose(), b.transpose())
    _same(a.row_nnz(), b.row_nnz())
    _same(a.column_norms(), b.column_norms())
    _same(a.column_nnz(), b.column_nnz())
    _same(a.to_dense(), b.to_dense())
    rng = np.random.default_rng(1)
    rows, cols = rng.integers(0, 40, 200), rng.integers(0, 30, 200)
    vals = rng.standard_normal(200).astype(np.float32)
    from repro.sparse.csr import CSR as JaxCSR
    _same_csr(CSR.from_coo(rows, cols, vals, (40, 30)),
              JaxCSR.from_coo(rows, cols, vals, (40, 30)))


@pytest.mark.parametrize("bm,bk", [(8, 8), (16, 16), (32, 32), (16, 8)])
def test_csr_to_bcoo_host_bit_identical(pair, bm, bk):
    g, r = pair
    host, meta = bcoo.csr_to_bcoo_host(topology.sym_normalize(g.adj), bm, bk)
    jhost, jmeta = jax_bcoo.csr_to_bcoo_host(jax_topo.sym_normalize(r.adj),
                                             bm, bk)
    for f in ("blocks", "row_ids", "col_ids", "row_ptr"):
        _same(getattr(host, f), getattr(jhost, f))
    for f in ("bm", "bk", "n_rows", "n_cols", "n_row_blocks",
              "n_col_blocks", "s_total"):
        assert getattr(host, f) == getattr(jhost, f), f
    for f in ("row_ids", "col_ids", "col_block_tiles", "col_block_norm",
              "col_nnz", "col_norm"):
        _same(getattr(meta, f), getattr(jmeta, f))
    assert not host.blocks[host.s_total].any(), "sentinel tile must be 0"


def test_helpers_bit_identical(pair):
    g, r = pair
    _same(bcoo.degree_sort_permutation(g.adj),
          jax_bcoo.degree_sort_permutation(r.adj))
    rows = np.sort(np.random.default_rng(2).integers(0, 9, 40)).astype(
        np.int32)
    _same(bcoo.host_row_ptr(rows, 11), jax_bcoo.host_row_ptr(rows, 11))
    starts = np.array([0, 5, 5, 9])
    ends = np.array([3, 5, 8, 12])
    _same(bcoo._expand_ranges(starts, ends),
          jax_bcoo._expand_ranges(starts, ends))


def test_block_coo_to_device_keeps_sentinel(pair):
    g, _ = pair
    host, _ = bcoo.csr_to_bcoo_host(topology.sym_normalize(g.adj), 16, 16)
    dev = host.to_device("cpu")
    assert dev.blocks.shape == (host.s_total + 1, 16, 16)
    assert dev.row_ids.dtype == torch.int32
    assert dev.row_ptr.dtype == torch.int32
    assert not dev.blocks[dev.s_total].any()
    np.testing.assert_array_equal(dev.blocks.numpy(), host.blocks)
    assert dev.nbytes() == host.nbytes()


@pytest.mark.parametrize("n_rb", [1, 7, 12])
def test_plan_row_ptr_matches_reference(n_rb):
    rows = np.sort(np.random.default_rng(n_rb).integers(
        0, n_rb, 3 * n_rb)).astype(np.int32)
    ours = plan_row_ptr(torch.from_numpy(rows), n_rb)
    ref = jax_plan_row_ptr(jnp.asarray(rows), n_rb)
    _same(ours.numpy(), np.asarray(ref))
    _same(ours.numpy(), bcoo.host_row_ptr(rows, n_rb))


@pytest.mark.parametrize("kw", [dict(n_parts=3), dict(n_parts=50),
                                dict(budget_bytes=60_000), dict()])
def test_contiguous_block_partition_identical(pair, kw):
    g, _ = pair
    host, _ = bcoo.csr_to_bcoo_host(topology.sym_normalize(g.adj), 16, 16)
    ours = contiguous_block_partition(host.row_ptr, bm=16, bk=16, d=32, **kw)
    ref = jax_contiguous(host.row_ptr, bm=16, bk=16, d=32, **kw)
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        _same(a, b)


@pytest.mark.parametrize("cfg", [
    dict(n_partitions=1, memory_budget_mb=None),
    dict(n_partitions=3, memory_budget_mb=None),
    dict(memory_budget_mb=0.05),
])
def test_stream_partitions_bit_identical(pair, cfg):
    """Every partition's tiles, id lists, row_ptr and gather rows match the
    reference's, as do the node permutation and padded node arrays."""
    g, r = pair
    jparams = JAX_MODELS["gcn"].init(jax.random.PRNGKey(0), 12, 16, 4, 2,
                                     True)
    params = torch_gcn.init(12, 16, 4, 2, True, device="cpu")
    si = StreamingInference(g, "gcn", params,
                            StreamConfig(block=16, device="cpu", **cfg))
    jsi = JaxStreamingInference(r, "gcn", jparams,
                                JaxStreamConfig(block=16, **cfg))
    assert si.n_partitions == jsi.n_partitions
    assert si.pads == jsi._pads["exact"]
    _same(si.nodes, jsi.nodes)
    _same(si.pos, jsi.pos)
    for f in ("features", "labels", "train_mask", "val_mask", "test_mask",
              "valid"):
        _same(getattr(si, f), getattr(jsi, f))
    for p, jp in zip(si.parts, jsi._parts["exact"]):
        for f in ("rbs", "blocks", "sel", "row_ids", "col_ids", "row_ptr",
                  "gather_rows", "out_rows"):
            _same(getattr(p, f), getattr(jp, f))
        assert (p.n_rows, p.n_active, p.n_gather) == \
            (jp.n_rows, jp.n_active, jp.n_gather)


# ------------------------------------------------------------ independence

def _imports(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


def test_port_imports_neither_jax_nor_repro():
    files = sorted(PORT.rglob("*.py"))
    assert len(files) > 15
    bad = [(str(f.relative_to(PORT)), name) for f in files
           for name in _imports(f)
           if name.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad


def test_importing_port_loads_no_jax():
    code = ("import sys, importlib, pkgutil, repro_torch\n"
            "for m in pkgutil.walk_packages(repro_torch.__path__, "
            "'repro_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "print(len([k for k in sys.modules if k.startswith("
            "'repro_torch.')]), bad)\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(PORT.parent))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[0]) > 15
