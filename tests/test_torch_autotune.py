"""The port's SpMM autotuner against the reference's, and the minibatch
CLI.

* ``signature()`` equals ``repro.kernels.autotune.signature`` over a grid
  of statics, with the backend names mapped (``ref`` = ``stream``,
  ``kernel`` = ``pallas``, ``kernel_plain`` = ``pallas_interpret``,
  ``dense`` and ``auto`` unchanged).
* ``lookup`` on a miss answers ``default_bd`` (the reference's default
  ``bd``) without sweeping, and records the miss.
* ``get_or_tune("ref")`` / ``("dense")`` sweep once and then hit, also
  from a fresh cache object reading the same file; entries carry their
  provenance, and unknown keys survive a rewrite.
* ``ops.bcoo_spmm`` dispatches the tuned ``bd``; ``spmm_apply("auto")``
  serves the cached decision.
* A minibatch run with ``autotune`` on dispatches no signature it did not
  tune.
* ``launch.train gnn --minibatch --device cpu`` prints the reference's
  report keys; ``--eval-mode stream`` runs full batch and minibatch.

All on the CPU; every test points the process-wide cache at a temporary
file.
"""
import importlib
import json

import numpy as np
import pytest
import torch

from repro.kernels import autotune as jax_autotune
from repro_torch.core.plan import SamplePlan
from repro_torch.core.rsc_spmm import spmm_apply
from repro_torch.kernels import autotune, ops
from repro_torch.kernels import bcoo_spmm as kmod
from repro_torch.kernels.ref import bcoo_spmm_ref
from repro_torch.launch import train as train_cli
from repro_torch.sparse.bcoo import host_row_ptr

NAMES = {"ref": "stream", "kernel": "pallas",
         "kernel_plain": "pallas_interpret", "dense": "dense",
         "auto": "auto"}
SMALL = dict(bm=16, bk=16, d=24, s_pad=40, n_row_blocks=6, n_col_blocks=7)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread per module: at these sizes the threads buy
    nothing, and under the suite's parallel workers they contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def scratch_cache(tmp_path, monkeypatch):
    """The process-wide cache on a temporary file, restored after."""
    monkeypatch.setenv(autotune.ENV_VAR, str(tmp_path / "tune.json"))
    cache = autotune.reset(tmp_path / "tune.json")
    yield cache
    autotune.reset()


def test_cache_path_is_the_ports_own(tmp_path, monkeypatch):
    monkeypatch.delenv(autotune.ENV_VAR)
    path = autotune.default_cache_path()
    assert path.name == "spmm_autotune_torch.json"
    assert path != jax_autotune.AutotuneCache().path
    monkeypatch.setenv(autotune.ENV_VAR, str(tmp_path / "x.json"))
    assert autotune.AutotuneCache().path == tmp_path / "x.json"


@pytest.mark.parametrize("backend", sorted(NAMES))
def test_signature_matches_reference(backend):
    for bm, bk in ((32, 32), (128, 128), (16, 64)):
        for d in (1, 41, 47, 48, 100, 256, 602):
            for s_pad, rb, cb in ((1, 1, 1), (40, 6, 7), (4005, 67, 67),
                                  (4072, 67, 67), (30906, 182, 182),
                                  (900, 3, 3), (64, 64, 64), (50, 7, 100)):
                kw = dict(bm=bm, bk=bk, d=d, s_pad=s_pad, n_row_blocks=rb,
                          n_col_blocks=cb)
                ours = autotune.signature(backend, **kw)
                ref = jax_autotune.signature(NAMES[backend], **kw)
                assert ours.split("|", 1) == [backend, ref.split("|", 1)[1]]
                assert ref.split("|", 1)[0] == NAMES[backend]


@pytest.mark.parametrize("d", [1, 41, 47, 256, 602, 1024, 1536])
def test_lookup_miss_answers_default_bd_without_sweeping(scratch_cache, d):
    sig = autotune.signature("kernel", **dict(SMALL, d=d))
    cfg = autotune.lookup(sig, d=d)
    assert cfg.bd == ops.default_bd(d) == jax_autotune.default_config(d).bd
    assert cfg.source == "default"
    autotune.lookup(sig, d=d)
    s = scratch_cache.stats
    assert (s.lookups, s.hits, s.defaults, s.sweeps) == (2, 0, 2, 0)
    assert scratch_cache.missed == {sig}
    assert not scratch_cache.path.exists()


@pytest.mark.parametrize("backend", ["ref", "dense"])
def test_get_or_tune_sweeps_once_then_hits(scratch_cache, backend):
    cfg = autotune.get_or_tune(backend, **SMALL, device="cpu")
    assert cfg.source == "swept" and cfg.backend == backend
    if backend == "ref":
        assert cfg.chunk in autotune.CHUNK_CANDIDATES
    assert scratch_cache.stats.sweeps == 1
    again = autotune.get_or_tune(backend, **SMALL, device="cpu")
    assert scratch_cache.stats.sweeps == 1 and again.source == "cache"
    assert (again.bd, again.chunk, again.backend) == (cfg.bd, cfg.chunk,
                                                      backend)
    sig = autotune.signature(backend, **SMALL)
    entry = json.loads(scratch_cache.path.read_text())["entries"][sig]
    assert entry["platform"] == "cpu" and entry["backend"] == backend
    assert entry["plain"] is False and entry["us"] > 0
    # a fresh process reads the file: no sweep, the same decision
    fresh = autotune.reset(scratch_cache.path)
    hit = autotune.get_or_tune(backend, **SMALL, device="cpu")
    assert fresh.stats.sweeps == 0 and fresh.stats.hits == 1
    assert (hit.bd, hit.chunk) == (cfg.bd, cfg.chunk)
    assert autotune.lookup(sig, d=SMALL["d"]).chunk == cfg.chunk


def test_unknown_keys_survive_a_rewrite(scratch_cache):
    scratch_cache.path.write_text(json.dumps({"version": 1, "entries": {
        "other|sig": {"bd": 7, "chunk": 8, "us": 1.0, "note": "keep"}}}))
    autotune.get_or_tune("ref", **SMALL, device="cpu")
    raw = json.loads(scratch_cache.path.read_text())["entries"]
    assert raw["other|sig"]["note"] == "keep" and len(raw) == 2
    assert not list(scratch_cache.path.parent.glob(".*.tmp"))


def test_ref_and_kernel_refuse_the_wrong_device():
    with pytest.raises(ValueError, match="card"):
        autotune.get_or_tune("kernel", **SMALL, device="cpu")
    assert autotune.auto_backends("cpu") == ("ref", "dense")
    assert autotune.auto_backends("cuda") == ("kernel", "dense")


def test_kernel_candidates_are_the_distinct_launches():
    # a 4,005-tile bucket of 67 row blocks on 132 SMs: 128, 256 (and 512)
    # launch the same two 128-column tiles; 64 launches four 64-column ones
    shape = dict(n_row_blocks=67, s_pad=4005, n_sm=132)
    assert autotune.kernel_candidates(256, **shape) == [256, 64]
    assert autotune.kernel_candidates(47, **shape) == [47]
    assert autotune.kernel_candidates(100, **shape) == [100]
    assert autotune.kernel_candidates(48, **shape) == [48]
    assert autotune.kernel_candidates(602, **shape) == [602]
    cands = autotune.kernel_candidates(1024, **shape)
    assert cands == [1024, 64]
    keys = {(kmod._tile(b), kmod.column_tiles(1024, b),
             kmod.chunks(67, 4005, 1024, b, 132)) for b in (1024, 512, 256,
                                                           128, 64)}
    assert len(keys) == len(cands)


def test_plain_timed_entry_served_to_the_kernel_warns(scratch_cache):
    sig = autotune.signature("kernel", **SMALL)
    scratch_cache.put(sig, autotune.SpmmConfig(bd=8, chunk=32), 1.0,
                      provenance={"backend": "kernel", "plain": True})
    with pytest.warns(RuntimeWarning, match="plain version"):
        assert autotune.lookup(sig, d=24).bd == 8
    assert scratch_cache.stats.plain_served == 1


def _operands(seed=0, s=40, rb=6, cb=7, bm=16, bk=16, d=24):
    rng = np.random.default_rng(seed)
    blocks = torch.from_numpy(np.concatenate(
        [rng.standard_normal((s, bm, bk)), np.zeros((1, bm, bk))])
        .astype(np.float32))
    rows = np.sort(rng.integers(0, rb, s)).astype(np.int32)
    plan = SamplePlan(
        sel=torch.arange(s, dtype=torch.int32),
        row_ids=torch.from_numpy(rows),
        col_ids=torch.from_numpy(rng.integers(0, cb, s).astype(np.int32)),
        n_active=s, s_pad=s,
        row_ptr=torch.from_numpy(host_row_ptr(rows, rb)))
    h = torch.from_numpy(rng.standard_normal((cb * bk, d))
                         .astype(np.float32))
    return blocks, plan, h


def test_ops_dispatches_the_tuned_bd(scratch_cache, monkeypatch):
    blocks, plan, h = _operands()
    seen = []

    def spy(*a, **kw):
        seen.append(kw["bd"])
        return bcoo_spmm_ref(*a, **{k: v for k, v in kw.items()
                                    if k not in ("bd", "row_ptr")})

    monkeypatch.setattr(kmod, "bcoo_spmm", spy)
    args = (blocks, plan.sel, plan.row_ids, plan.col_ids, h)
    kw = dict(n_row_blocks=6, bm=16, bk=16)
    ops.bcoo_spmm(*args, **kw)
    sig = autotune.signature("kernel_plain", **SMALL)
    assert seen == [24] and scratch_cache.missed == {sig}
    scratch_cache.put(sig, autotune.SpmmConfig(bd=8, chunk=32), 1.0)
    ops.bcoo_spmm(*args, **kw)
    ops.bcoo_spmm(*args, **kw, bd=12)              # explicit bd wins
    assert seen == [24, 8, 12]


def test_spmm_apply_auto_serves_the_cached_decision(scratch_cache,
                                                    monkeypatch):
    blocks, plan, h = _operands(seed=4)
    want = bcoo_spmm_ref(blocks, plan.sel, plan.row_ids, plan.col_ids, h,
                         n_row_blocks=6, bm=16, bk=16)
    # untuned: the CPU default is ref
    got = spmm_apply(blocks, plan, h, 6, 16, 16, "auto")
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    cfg = autotune.get_or_tune_auto(**SMALL, device="cpu")
    assert cfg.backend in ("ref", "dense")
    assert scratch_cache.stats.sweeps == 2
    assert autotune.get_or_tune_auto(**SMALL, device="cpu").backend \
        == cfg.backend and scratch_cache.stats.sweeps == 2
    rs = importlib.import_module("repro_torch.core.rsc_spmm")
    ds = importlib.import_module("repro_torch.kernels.dense_spmm")
    ran = []
    monkeypatch.setattr(rs, "spmm_stream", lambda *a, **k: (
        ran.append(("ref", k["chunk"])), want)[1])
    real_dense = ds.dense_spmm
    monkeypatch.setattr(ds, "dense_spmm", lambda *a, **k: (
        ran.append(("dense", None)), real_dense(*a, **k))[1])
    got = spmm_apply(blocks, plan, h, 6, 16, 16, "auto")
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert ran == [(cfg.backend, cfg.chunk if cfg.backend == "ref"
                    else None)]
    # a decision timed on the CPU is refused on a card tensor
    sig = autotune.signature("auto", **SMALL)
    scratch_cache.put(sig, autotune.SpmmConfig(bd=24, chunk=16,
                                               backend="ref"), 1.0,
                      provenance={"backend": "ref"})
    with pytest.raises(ValueError, match="re-tune"):
        _auto_on_card(blocks, plan, h)


def _auto_on_card(blocks, plan, h):
    """``spmm_apply(..., "auto")`` as a CUDA tensor sees it: the device
    check is all that differs, so a stand-in with ``device.type ==
    "cuda"`` reaches it without a card."""
    class CudaLike(torch.Tensor):
        @property
        def device(self):
            return torch.device("cuda", 0)
    return spmm_apply(blocks, plan, h.as_subclass(CudaLike), 6, 16, 16,
                      "auto")


MB_ARGV = ["gnn", "--minibatch", "--device", "cpu", "--scale", "0.004",
           "--block", "32", "--hidden", "48", "--layers", "2",
           "--subgraphs", "4", "--roots", "50", "--walk-length", "2",
           "--epochs", "4", "--rsc"]
MB_KEYS = {"model", "dataset", "rsc", "budget", "best_test", "wall_s",
           "flops_fraction", "minibatch", "pool", "subgraphs", "n_buckets",
           "plan_hit_rate"}


def test_minibatch_run_dispatches_only_tuned_signatures(scratch_cache):
    out = train_cli.main(MB_ARGV)
    tuned = set(json.loads(scratch_cache.path.read_text())["entries"])
    assert tuned and all(s.startswith("kernel_plain|") for s in tuned)
    assert scratch_cache.stats.defaults == 0 and not scratch_cache.missed
    assert scratch_cache.stats.hits > 0
    assert out["result"]["n_buckets"] == 2


def test_minibatch_cli_prints_report_keys(capsys, scratch_cache):
    train_cli.main(MB_ARGV + ["--no-autotune", "--pool-method", "ldg",
                              "--no-prefetch", "--buckets", "1"])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(report) == MB_KEYS and "compiles" not in report
    assert report["minibatch"] is True and report["pool"] == "ldg"
    assert report["subgraphs"] == 4 and report["n_buckets"] == 1
    assert 0 < report["flops_fraction"] <= 1.0
    assert 0 <= report["plan_hit_rate"] <= 1.0
    assert not scratch_cache.path.exists()        # --no-autotune


@pytest.mark.parametrize("minibatch", [False, True])
def test_cli_stream_evaluation_runs(capsys, minibatch):
    argv = (MB_ARGV if minibatch else
            ["gnn", "--device", "cpu", "--scale", "0.003", "--rsc",
             "--epochs", "4", "--block", "32", "--hidden", "48",
             "--layers", "2"])
    out = train_cli.main(argv + ["--eval-mode", "stream",
                                 "--stream-partitions", "2"])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["best_test"] > 0
    se = out["trainer"].engine.stream_eval
    assert se.si.n_partitions == 2 and se.evals == len(
        out["result"]["history"]["val"])


def test_cli_auto_backend_runs(capsys):
    train_cli.main(MB_ARGV + ["--backend", "auto"])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(report) == MB_KEYS
    tuned = json.loads(autotune.get_cache().path.read_text())["entries"]
    assert tuned and all(s.startswith("auto|") for s in tuned)
    assert all(e["backend"] in ("ref", "dense") for e in tuned.values())
