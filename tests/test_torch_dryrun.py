"""The dry run (``repro_torch.launch.dryrun``): FLOPs, collectives, the
flash op's abstract path, and a production cell on the CPU.

(c) For qwen3-1.7b's smoke config (dense), ``flops`` of the one-rank
    train (1, 2 and 4 microbatches), prefill and decode steps equal a
    closed-form count of their matrix products plus the flash kernel's
    formula; the four ranks' ``flops`` at (data 2, model 2) sum to the
    one-rank count plus the one product tensor parallelism replicates:
    the k / v projections (kv heads whole on every ``model`` rank).
(d) The run's ``collectives`` for that config at (2, 2), train (4
    microbatches: measured from 2 and 3), prefill and decode, equal call
    for call and byte for byte what each rank's ``Mesh.stats`` records in
    a real 4-rank gloo run of the same steps (the spawn of
    ``tests/test_torch_lm_sharded_train.py``: ``distributed.group.launch``).
(e) The flash custom op under ``FakeTensorMode`` and on ``meta`` tensors
    gives the plain version's shape and dtype, and ``FlopCounterMode``
    counts its formula; on CPU tensors it equals ``flash_attention_ref``
    bit for bit and launches nothing.
    A step of more than 3 microbatches, measured from its first 2 and 3,
    equals the whole step's run (three families, one rank and (2, 2)).
(f) The qwen3-32b ``train_4k`` cell at (data 16, model 16) runs to a
    record on the CPU (16 microbatches, 64 layers; ~30 s).

The bytes are held against the reference in
``tests/test_torch_dryrun_bytes.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import make_batch, smoke_config
from repro_torch.distributed.group import launch, plan_group
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.ref import flash_attention_ref
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.serve import sharded_graft
from repro_torch.models.lm.backbone import init_sharded_params
from repro_torch.train.lm_steps import local_batch, \
    make_sharded_decode_step, make_sharded_prefill_step, \
    make_sharded_train_step
from repro_torch.train.optimizer import Adam

B, T = 4, 64           # (c): batch rows, sequence
MESH = "data=2,model=2"
COLL = dict(batch=8, seq=32, train_mb=4)     # (d)


def _cfg(dtype="bfloat16"):
    return dataclasses.replace(smoke_config("qwen3-1.7b"), dtype=dtype)


# ------------------------------------------------------------------ (c)

def _products(cfg, rows: int) -> dict:
    """Forward FLOPs (2 per multiply-add) of one layer's projections over
    ``rows`` tokens."""
    d, hd, f = cfg.d_model, cfg.hd, cfg.d_ff
    return {"q": 2 * rows * d * cfg.n_heads * hd,
            "kv": 2 * 2 * rows * d * cfg.n_kv * hd,
            "o": 2 * rows * cfg.n_heads * hd * d,
            "gate_up": 2 * 2 * rows * d * f, "down": 2 * rows * f * d}


def closed_form(cfg, kind: str) -> int:
    """The matrix products of one step over B × T (tied embedding, no
    qkv bias, swiglu):

    train: each layer's projections run forward, again when the layer's
    checkpoint recomputes it, and twice backward (dX and dW), except the
    MLP's down projection, which the recomputation stops before (its
    output is saved by nothing); the training attention (kv-chunked, f32,
    every chunk's keys scored: 2·T·T_pad·heads·hd per product, scores
    and P·V) runs forward, in the layer's recomputation, in each chunk's
    own recomputation, and twice backward; the tied logits (2·B·T·d·V)
    forward and twice backward. Prefill: each product once, flash's
    formula (causal pairs), the last position's logits. Decode: one
    token's products, attention over the cache's T positions (scores and
    P·V), its logits."""
    layers, d, v = cfg.n_layers, cfg.d_model, cfg.vocab
    hd, nq = cfg.hd, cfg.n_heads
    if kind == "train":
        p = _products(cfg, B * T)
        t_pad = -(-T // cfg.attn_chunk) * cfg.attn_chunk
        attn = 2 * 2 * B * T * t_pad * nq * hd
        lin = 4 * (p["q"] + p["kv"] + p["o"] + p["gate_up"]) + 3 * p["down"]
        return layers * (lin + 5 * attn) + 3 * 2 * B * T * d * v
    if kind == "prefill":
        p = _products(cfg, B * T)
        flash = fa.flops((B, T, nq, hd), (B, T, cfg.n_kv, hd))
        return layers * (sum(p.values()) + flash) + 2 * B * d * v
    p = _products(cfg, B)
    return layers * (sum(p.values()) + 2 * 2 * B * nq * hd * T) \
        + 2 * B * d * v


def replicated(cfg, kind: str) -> int:
    """The FLOPs every ``model`` rank repeats: the k / v projections (4
    passes in training, as above)."""
    rows = B if kind == "decode" else B * T
    passes = 4 if kind == "train" else 1
    return cfg.n_layers * passes * _products(cfg, rows)["kv"]


@pytest.mark.parametrize("kind,mb", [("train", 1), ("train", 2),
                                     ("train", 4), ("prefill", 1),
                                     ("decode", 1)])
def test_flops_match_closed_form(kind, mb):
    cfg = _cfg()
    r = dryrun.lower_step(cfg, kind, batch=B, seq=T, n_microbatches=mb)
    assert r["flops"] == closed_form(cfg, kind)
    assert r["collectives"]["total_count"] == 0
    assert r["measured_from"] == ([2, 3] if mb == 4 else [mb])


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_ranks_flops_sum_to_one_rank(kind):
    cfg = _cfg()
    mb = 2 if kind == "train" else 1
    ranks = [dryrun.lower_step(cfg, kind, batch=B, seq=T, mesh=MESH,
                               rank=r, n_microbatches=mb)["flops"]
             for r in range(4)]
    assert len(set(ranks)) == 1         # every rank the same share
    assert sum(ranks) == closed_form(cfg, kind) + replicated(cfg, kind)


@pytest.mark.parametrize("mesh", [None, MESH])
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "deepseek-v2-lite-16b",
                                  "xlstm-125m"])
def test_microbatches_measured_from_2_and_3_equal_the_whole_step(arch,
                                                                  mesh):
    """A 4-microbatch step measured from its first 2 and 3 gives the
    whole step's peak, FLOPs and collectives exactly."""
    cfg = smoke_config(arch)
    got = dryrun.lower_step(cfg, "train", batch=16, seq=16, mesh=mesh,
                            n_microbatches=4)
    whole = dryrun._run(cfg, "train", 16, 16, dryrun.mesh_of(mesh), 4, 0)
    assert got["measured_from"] == [2, 3]
    assert (got["peak_bytes"], got["flops"], got["collectives"]) == \
        (whole["peak_bytes"], whole["flops"], whole["collectives"])


# ------------------------------------------------------------------ (d)

def rank_main(group) -> dict:
    """Rank's collectives of the three sharded steps on (2, 2), f32."""
    cfg = _cfg("float32")
    b, t, n_mb = COLL["batch"], COLL["seq"], COLL["train_mb"]
    mesh = Mesh((2, 2), ("data", "model")).bind("cpu")
    state = init_sharded_params(cfg, mesh, seed=0, device="cpu")
    opt = Adam(lr=3e-4)
    out = {}
    train = make_sharded_train_step(cfg, opt, mesh, n_mb)
    batch = local_batch(make_batch(cfg, "train_4k", b, t, seed=1), mesh,
                        n_mb)
    ost = opt.init(state.shards)
    mesh.reset_stats()
    train(state, ost, batch)
    out["train"] = mesh.collective_bytes()
    prompt = local_batch(make_batch(cfg, "prefill_32k", b, t, seed=2), mesh)
    mesh.reset_stats()
    _, cache = make_sharded_prefill_step(cfg, mesh)(state, prompt)
    out["prefill"] = mesh.collective_bytes()
    cache = sharded_graft(cfg, cache, 2 * t, mesh)
    tokens = local_batch(make_batch(cfg, "decode_32k", b, 1, seed=3), mesh)
    mesh.reset_stats()
    make_sharded_decode_step(cfg, mesh)(state, cache, tokens)
    out["decode"] = mesh.collective_bytes()
    return out


@pytest.fixture(scope="module")
def gloo_ranks():
    return launch(rank_main, (), plan=plan_group(4, force_host_devices=4,
                                                 device="cpu"), threads=1)


@pytest.mark.parametrize("rank", range(4))
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_collectives_match_a_real_gloo_run(gloo_ranks, kind, rank):
    cfg = _cfg("float32")
    seq = 2 * COLL["seq"] if kind == "decode" else COLL["seq"]
    r = dryrun.lower_step(cfg, kind, batch=COLL["batch"], seq=seq,
                          mesh=MESH, rank=rank,
                          n_microbatches=COLL["train_mb"]
                          if kind == "train" else 1)
    assert r["collectives"] == gloo_ranks[rank][kind]
    assert r["collectives"]["total_count"] > 0


# ------------------------------------------------------------------ (e)

def _qkv(seed=0, b=2, t=33, nq=4, nkv=2, hd=16, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(b, t, n, hd, generator=g).to(dtype)
            for n in (nq, nkv, nkv)]


@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_op_is_the_plain_version_on_cpu(dtype, window):
    q, k, v = _qkv(dtype=dtype)
    before = fa.launches
    got = fa.flash_attention(q, k, v, q_offset=3, window=window)
    assert torch.equal(got, flash_attention_ref(q, k, v, q_offset=3,
                                                window=window))
    assert fa.launches == before


@pytest.mark.parametrize("window", [None, 5])
def test_flash_op_abstract_shape_and_formula(window):
    q, k, v = _qkv(dtype=torch.bfloat16)
    want = flash_attention_ref(q, k, v, window=window)
    with FakeTensorMode() as mode:
        fq, fk, fv = (mode.from_tensor(x) for x in (q, k, v))
        with FlopCounterMode(display=False) as counter:
            out = fa.flash_attention(fq, fk, fv, window=window)
    assert (out.shape, out.dtype) == (want.shape, want.dtype)
    mq, mk, mv = (x.to("meta") for x in (q, k, v))
    meta = fa.flash_attention(mq, mk, mv, window=window)
    assert (meta.shape, meta.dtype, meta.device.type) == \
        (want.shape, want.dtype, "meta")
    pairs = sum(min(i, 32) + 1 - max(0, i - window + 1 if window else 0)
                for i in range(33))
    assert counter.get_total_flops() == 4 * 2 * 4 * 16 * pairs
    with pytest.raises(ValueError, match="hd in"):
        fa.flash_attention(*(x[..., :8] for x in (mq, mk, mv)))


def test_attended_pairs_counts_the_masks():
    rng = np.random.default_rng(0)
    for _ in range(50):
        tq, tk = rng.integers(1, 40, 2)
        off = int(rng.integers(-5, 40))
        window = None if rng.random() < 0.3 else int(rng.integers(1, 20))
        causal = bool(rng.random() < 0.8)
        qp = off + np.arange(tq)[:, None]
        kp = np.arange(tk)[None, :]
        keep = np.ones((tq, tk), bool)
        if causal:
            keep &= kp <= qp
        if window:
            keep &= kp > qp - window
        assert fa.attended_pairs(int(tq), int(tk), off, causal, window) == \
            int(keep.sum())


# ------------------------------------------------------------------ (f)

def test_qwen3_32b_train_cell_at_16x16_on_the_cpu():
    rec = dryrun.lower_cell("qwen3-32b", "train_4k", mesh="data=16,model=16")
    assert rec["status"] == "ok"
    assert (rec["devices"], rec["microbatches"]) == (256, 16)
    assert rec["measured_from"] == [2, 3]
    pr = rec["per_rank"]
    assert pr["total"] == pr["params"] + pr["opt"] + pr["batch"]
    assert pr["total"] < rec["peak_bytes"] < rec["card_memory_bytes"]
    assert rec["fits"] and rec["flops"] > 0
    coll = rec["collectives"]
    assert coll["total_count"] == sum(coll[k]["count"] for k in (
        "all-gather", "all-reduce", "reduce-scatter"))
    assert rec["op_histogram"][0][1] > 0
