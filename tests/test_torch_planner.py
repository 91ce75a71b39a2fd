"""The port's host planner against the reference: Eq. 3 scores, the
allocators (Alg. 1 greedy, uniform, the DP certificate), plans, the plan
cache and the switch-back schedule.

The planner is host numpy carried over from ``repro``, so every compared
output is bit-identical: ``sel``, ``row_ids``, ``col_ids``, ``row_ptr``,
``n_active``, ``s_pad``, ``keep``, ``k``, ``cost``, ``flops_fraction``.
The device-side score helpers (``row_norms``, ``sampling_probs``) are f32
on both sides and agree within 1e-6 relative (different summation
orders).
"""
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import allocator as jalloc
from repro.core import sampling as jsamp
from repro.core.cache import PlanCache as JaxPlanCache
from repro.core.plan import build_plan as jax_build_plan
from repro.core.plan import full_plan as jax_full_plan
from repro.core.schedule import RSCSchedule as JaxSchedule
from repro.sparse.bcoo import BlockMeta as JaxBlockMeta
from repro.sparse.bcoo import csr_to_bcoo_host as jax_csr_to_bcoo_host
from repro.sparse.csr import CSR as JaxCSR
from repro_torch.core import allocator, sampling
from repro_torch.core.cache import PlanCache
from repro_torch.core.plan import build_plan, full_plan
from repro_torch.core.schedule import RSCSchedule
from repro_torch.sparse.bcoo import BlockMeta, csr_to_bcoo_host
from repro_torch.sparse.csr import CSR

N, BLOCK, EMPTY_RB = 150, 16, 3   # 10 row blocks, the last one ragged


def _coo(seed: int):
    """A random 150×150 matrix whose row block 3 (rows 48–63) and column
    block 3 hold no entry."""
    rng = np.random.default_rng(seed)
    mask = rng.random((N, N)) < 0.06
    mask[EMPTY_RB * BLOCK:(EMPTY_RB + 1) * BLOCK, :] = False
    mask[:, EMPTY_RB * BLOCK:(EMPTY_RB + 1) * BLOCK] = False
    rows, cols = np.nonzero(mask)
    vals = rng.standard_normal(rows.shape[0]).astype(np.float32)
    return rows.astype(np.int64), cols.astype(np.int64), vals


@pytest.fixture(scope="module", params=[0, 1])
def metas(request):
    """(port host, port meta, reference host, reference meta) of one
    operand."""
    rows, cols, vals = _coo(request.param)
    ours = csr_to_bcoo_host(CSR.from_coo(rows, cols, vals, (N, N)),
                            BLOCK, BLOCK)
    ref = jax_csr_to_bcoo_host(JaxCSR.from_coo(rows, cols, vals, (N, N)),
                               BLOCK, BLOCK)
    return (*ours, *ref)


def _same_plan(ours, ref):
    for f in ("sel", "row_ids", "col_ids", "row_ptr"):
        a, b = getattr(ours, f).numpy(), np.asarray(getattr(ref, f))
        assert a.dtype == np.int32 and np.array_equal(a, b), f
    assert ours.n_active == int(ref.n_active)
    assert ours.s_pad == ref.s_pad


def _same_alloc(ours, ref):
    assert len(ours.keep) == len(ref.keep)
    for a, b in zip(ours.keep, ref.keep):
        assert np.array_equal(a, b)
    assert np.array_equal(ours.k, ref.k)
    assert ours.cost == ref.cost and ours.budget == ref.budget
    assert ours.error == ref.error
    assert np.array_equal(ours.layer_cost, ref.layer_cost)


# ------------------------------- sampling ----------------------------------

def test_block_scores_and_topk_bit_identical():
    rng = np.random.default_rng(0)
    col_norm = rng.random(150).astype(np.float32)
    g = rng.random(160).astype(np.float32)
    ours = sampling.block_scores(col_norm, g[:150], 16, 10)
    ref = jsamp.block_scores(col_norm, g[:150], 16, 10)
    assert ours.dtype == np.float64 and np.array_equal(ours, ref)
    for k in (0, 3, 10, 12):
        assert np.array_equal(sampling.topk_pairs(ours, k),
                              jsamp.topk_pairs(ref, k))
    keep = sampling.topk_pairs(ours, 4)
    assert sampling.topk_overlap_auc(ours * 0.9, keep) == \
        jsamp.topk_overlap_auc(ref * 0.9, keep)
    probs = ours / ours.sum()
    a = sampling.topk_sample_indices(probs, 7, np.random.default_rng(5))
    b = jsamp.topk_sample_indices(probs, 7, np.random.default_rng(5))
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


def test_device_scores_match_reference():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((64, 48)).astype(np.float32)
    cn = rng.random(64).astype(np.float32)
    gn = rng.random(64).astype(np.float32)
    np.testing.assert_allclose(sampling.row_norms(torch.from_numpy(x)),
                               np.asarray(jsamp.row_norms(jnp.asarray(x))),
                               rtol=1e-6)
    np.testing.assert_allclose(
        sampling.sampling_probs(torch.from_numpy(cn), torch.from_numpy(gn)),
        np.asarray(jsamp.sampling_probs(jnp.asarray(cn), jnp.asarray(gn))),
        rtol=1e-6)


# ------------------------------ allocators ---------------------------------

def _layers(mod, seed, L=3, n=50):
    rng = np.random.default_rng(seed)
    return [mod.LayerSpec(scores=rng.random(n) + 1e-3,
                          tiles=rng.integers(1, 10, n),
                          d=int(rng.integers(8, 64)),
                          norm=float(rng.random() + 0.5))
            for _ in range(L)]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("budget", [0.1, 0.3, 0.5])
@pytest.mark.parametrize("how", ["greedy", "greedy_cost_aware", "uniform",
                                 "dp"])
def test_allocations_bit_identical(seed, budget, how):
    ours, ref = _layers(allocator, seed), _layers(jalloc, seed)
    if how.startswith("greedy"):
        aware = how.endswith("aware")
        _same_alloc(allocator.greedy_allocate(ours, budget, cost_aware=aware),
                    jalloc.greedy_allocate(ref, budget, cost_aware=aware))
    elif how == "uniform":
        _same_alloc(allocator.uniform_allocate(ours, budget),
                    jalloc.uniform_allocate(ref, budget))
    else:
        _same_alloc(allocator.dp_allocate(ours, budget),
                    jalloc.dp_allocate(ref, budget))


# -------------------------------- plans ------------------------------------

@pytest.mark.parametrize("bucket", [1, 16, 40])
def test_full_plan_bit_identical(metas, bucket):
    host, meta, jhost, jmeta = metas
    assert host.n_row_blocks == 10 and host.n_rows == 160
    ours = full_plan(meta, host.n_row_blocks, host.s_total, bucket=bucket,
                     device="cpu")
    ref = jax_full_plan(jmeta, jhost.n_row_blocks, jhost.s_total,
                        bucket=bucket)
    _same_plan(ours, ref)
    # the empty row block holds one sentinel entry
    rp = ours.row_ptr.numpy()
    seg = ours.sel.numpy()[rp[EMPTY_RB]:rp[EMPTY_RB + 1]]
    assert seg.tolist() == [host.s_total]


@pytest.mark.parametrize("bucket", [1, 16, 40])
@pytest.mark.parametrize("keep_seed", [0, 1, 2])
def test_sampled_plan_bit_identical(metas, bucket, keep_seed):
    host, meta, jhost, jmeta = metas
    keep = np.random.default_rng(keep_seed).random(host.n_col_blocks) < 0.4
    ours = build_plan(meta, keep, host.n_row_blocks, host.s_total,
                      bucket=bucket, device="cpu")
    ref = jax_build_plan(jmeta, keep, jhost.n_row_blocks, jhost.s_total,
                         bucket=bucket)
    _same_plan(ours, ref)
    sel, rows = ours.sel.numpy(), ours.row_ids.numpy()
    # every row block present, sorted, padding on the last row block
    assert set(range(host.n_row_blocks)) <= set(rows.tolist())
    assert (np.diff(rows) >= 0).all()
    assert ours.s_pad % bucket == 0
    assert int((sel != host.s_total).sum()) == ours.n_active
    # the bucket's padding: sentinels appended to the last row block
    real = sel != host.s_total
    missing = host.n_row_blocks - len(np.unique(rows[real]))
    pad = ours.s_pad - ours.n_active - missing
    if pad:
        assert (sel[-pad:] == host.s_total).all()
        assert (rows[-pad:] == host.n_row_blocks - 1).all()
    # the flops / bytes bookkeeping counts only real tiles
    assert ours.flops(BLOCK, BLOCK, 8) == ref.flops(BLOCK, BLOCK, 8)
    assert ours.bytes_moved(BLOCK, BLOCK, 8) == \
        ref.bytes_moved(BLOCK, BLOCK, 8)


def test_plan_arrays_land_on_the_requested_device(metas):
    host, meta, _, _ = metas
    plan = full_plan(meta, host.n_row_blocks, host.s_total,
                     device=torch.device("meta"))
    assert all(t.device.type == "meta" for t in
               (plan.sel, plan.row_ids, plan.col_ids, plan.row_ptr))


# ------------------------------ plan cache ---------------------------------

@pytest.mark.parametrize("strategy", ["greedy", "uniform"])
def test_plan_cache_refresh_bit_identical(metas, strategy):
    """Three refreshes from the same ∇H norms: identical allocations,
    plans, k history, AUC history and flops fraction."""
    host, meta, jhost, jmeta = metas
    ours = PlanCache(budget_frac=0.3, strategy=strategy, device="cpu")
    ref = JaxPlanCache(budget_frac=0.3, strategy=strategy)
    for name, d in (("l0", 24), ("l1", 7)):
        ours.register(name, host, meta, d=d, a_fro=1.7)
        ref.register(name, jhost, jmeta, d=d, a_fro=1.7)
    for name in ("l0", "l1"):
        _same_plan(ours.plans()[name], ref.plans()[name])
    rng = np.random.default_rng(9)
    for _ in range(3):
        norms = {n: rng.random(host.n_cols).astype(np.float32)
                 for n in ("l0", "l1")}
        _same_alloc(ours.refresh(norms), ref.refresh(norms))
        for name in ("l0", "l1"):
            _same_plan(ours.plans()[name], ref.plans()[name])
        assert ours.flops_fraction() == ref.flops_fraction()
    assert all(np.array_equal(a, b) for a, b in
               zip(ours.stats.k_history, ref.stats.k_history))
    assert ours.stats.auc_history == ref.stats.auc_history
    assert ours.stats.refreshes == ref.stats.refreshes == 3
    if strategy == "greedy":
        assert ours.flops_fraction() <= 0.3


# ------------------------------- schedule ----------------------------------

@pytest.mark.parametrize("total,frac,every", [(100, 0.8, 10), (30, 0.8, 10),
                                              (20, 1.0, 1), (7, 0.5, 3)])
def test_schedule_matches_reference(total, frac, every):
    ours = RSCSchedule(total_steps=total, rsc_fraction=frac,
                       refresh_every=every, allocate_every=every)
    ref = JaxSchedule(total_steps=total, rsc_fraction=frac,
                      refresh_every=every, allocate_every=every)
    assert ours.switch_step() == ref.switch_step()
    for s in range(total + 2):
        assert (ours.use_rsc(s), ours.refresh_due(s), ours.allocate_due(s),
                ours.mode(s)) == (ref.use_rsc(s), ref.refresh_due(s),
                                  ref.allocate_due(s), ref.mode(s))


# ------------------- the main path's own refreshes -------------------------

MAIN_PATH = Path(__file__).with_name("test_torch_planner_main_path.npz")


def test_main_path_refreshes_match_reference():
    """Two consecutive refreshes of the full-width GCN training run on the
    card (synthetic Reddit at scale 0.1, 3 layers, d 256/256/41, block 128,
    RSC at budget 0.1; saved by ``chip_smoke.py``): the ∇H norms each
    refresh was given, fed to the port's and the reference's
    ``PlanCache``, give bit-identical allocations and plans, and the same
    kept column blocks and ``n_active`` the card's planner picked."""
    z = np.load(MAIN_PATH)
    bk, n_rb, n_cb, s_total = (int(v) for v in z["shape"])
    at = SimpleNamespace(bk=bk, n_row_blocks=n_rb, n_col_blocks=n_cb,
                         s_total=s_total)
    fields = ("row_ids", "col_ids", "col_block_tiles", "col_block_norm",
              "col_nnz", "col_norm")
    meta = BlockMeta(**{f: z[f] for f in fields})
    jmeta = JaxBlockMeta(**{f: z[f] for f in fields})
    kw = dict(budget_frac=float(z["budget"]),
              step_frac=float(z["step_frac"]))
    ours = PlanCache(**kw, device="cpu")
    ref = JaxPlanCache(**kw)
    names = [str(n) for n in z["names"]]
    for name, d in zip(names, z["dims"]):
        ours.register(name, at, meta, d=int(d), a_fro=float(z["a_fro"]))
        ref.register(name, at, jmeta, d=int(d), a_fro=float(z["a_fro"]))
    for i in range(2):
        norms = {n: z[f"norms_{i}_{n}"] for n in names}
        alloc = ours.refresh(norms)
        _same_alloc(alloc, ref.refresh(norms))
        assert np.array_equal(alloc.k, z[f"k_{i}"])
        for name, n_active in zip(names, z[f"n_active_{i}"]):
            _same_plan(ours.plans()[name], ref.plans()[name])
            assert ours.plans()[name].n_active == n_active
        assert ours.flops_fraction() == ref.flops_fraction()
