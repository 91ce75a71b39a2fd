"""Shared fixtures. NOTE: no XLA_FLAGS here — tests see 1 CPU device;
only launch/dryrun.py forces 512 host devices (per spec)."""
import numpy as np
import pytest

from repro.graphs.synthetic import sbm_graph
from repro.sparse.csr import CSR

# hypothesis is an optional dev dependency: property tests skip (instead of
# erroring at collection) when it is absent.
try:
    from hypothesis import given, settings, strategies as st
    HAS_HYPOTHESIS = True
except ImportError:
    HAS_HYPOTHESIS = False

    def settings(*_a, **_k):
        return lambda f: f

    def given(*_a, **_k):
        def deco(f):
            @pytest.mark.skip(reason="hypothesis not installed")
            def stub():
                pass
            stub.__name__ = f.__name__
            stub.__doc__ = f.__doc__
            return stub
        return deco

    class _AnyStrategy:
        def __getattr__(self, name):
            return lambda *a, **k: None

    st = _AnyStrategy()


@pytest.fixture(scope="session")
def small_graph():
    return sbm_graph(n_nodes=400, n_clusters=5, avg_degree=10, feat_dim=16,
                     seed=0)


@pytest.fixture(scope="session")
def small_csr(small_graph):
    return small_graph.adj


def random_csr(n: int, density: float, seed: int = 0,
               symmetric: bool = True) -> CSR:
    rng = np.random.default_rng(seed)
    mask = rng.random((n, n)) < density
    if symmetric:
        mask |= mask.T
    np.fill_diagonal(mask, False)
    rows, cols = np.nonzero(mask)
    vals = rng.standard_normal(rows.shape[0]).astype(np.float32) \
        if not symmetric else np.ones(rows.shape[0], np.float32)
    return CSR.from_coo(rows.astype(np.int64), cols.astype(np.int64),
                        vals, (n, n))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long end-to-end subprocess runs")
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (skips without one)")
