"""Serving on a (data × model) mesh against the reference's single-device
prefill and decode.

The reference serves a mesh with its one-device ``make_prefill_step`` /
``make_decode_step`` under ``DECODE_RULES`` (``repro.launch.dryrun``):
the KV cache sequence parallel over ``model``. The port's
``make_sharded_prefill_step`` / ``launch.serve.sharded_graft`` /
``make_sharded_decode_step`` are held against those steps here. Four
gloo ranks on the CPU are spawned once and serve every case while the
reference's jitted steps compile and run in a thread beside them.

For all 10 architectures' f32 smoke configs (the reference's
``init_params`` carried by ``convert``, cross gates 0.5 / -0.7 so the
cross layers act) on meshes (data 2, model 2) and (data 1, model 4): a
numpy-seeded prompt of T = 14 positions (split 7 / 7 over ``model`` = 2;
not divisible by 4, so ``sanitize_shardings`` keeps it whole there) is
prefilled, the cache grafted into L = 32 positions, and 3 decode steps are
fed numpy-seeded tokens (the same on both sides, so a near-tie of the
argmax cannot fork the runs). They write positions 14, 15, 16: position
16 starts the next ``model`` shard on both meshes, and recurrentgemma's
16-slot ring wraps to slot 0 there (its window is 16 at smoke size).
Asserted, per architecture and mesh:

* the prefill's last-token logits and each decode step's within
  ``LOGIT_TOL`` of the row's max |logit| of the reference's, or within
  twice the reference's own move from weights one unit in the last place
  away, where that is more (the two packages sum the same f32 products
  in other orders, and the mesh sums the softmax and the row-parallel
  products in other orders again; the xLSTM smoke model's logits move
  ~4e-5 of their row's max that way, and the port's one-process run is
  1.6e-5 from the reference's);
* the caches every rank holds, gathered back to whole arrays
  (``convert.lm_sharded_cache_to_numpy``), equal the reference's after
  the prefill and after the last decode step, each leaf within
  ``LOGIT_TOL`` of its max |value| (or twice the nudged run's move);
* each rank's blocks of both caches have the shape the reference's
  ``sanitize_shardings(cache_shardings(...), abstract cache)`` gives its
  coordinates (on ``jax.sharding.AbstractMesh``).

Besides: ``decode_attention`` and MLA's ``absorbed_attention`` split
over 2 and 4 simulated ``model`` shards (threads exchanging through a
barrier), some of them holding no valid key, equal the unsplit
functions within f32 rounding; and ``sharded_generate`` picks the
reference's greedy tokens on (2, 2).
"""
import dataclasses
import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import make_batch as jax_make_batch
from repro.configs import smoke_config as jax_smoke_config
from repro.launch import shardings as jax_sh
from repro.launch.mesh import dp_axes as jax_dp_axes
from repro.launch.serve import greedy_generate as jax_greedy_generate
from repro.models.lm.backbone import init_cache as jax_init_cache
from repro.models.lm.backbone import init_params as jax_init_params
from repro.train.lm_steps import make_decode_step as jax_make_decode_step
from repro.train.lm_steps import make_prefill_step as jax_make_prefill_step
from repro_torch import convert
from repro_torch.configs import smoke_config
from repro_torch.distributed.elastic import gather_tree
from repro_torch.distributed.group import launch, plan_group
from repro_torch.launch import serve
from repro_torch.launch.mesh import Mesh
from repro_torch.models.lm.attention import decode_attention
from repro_torch.models.lm.mla import absorbed_attention
from repro_torch.train.lm_steps import abstract_cache, local_batch, \
    make_sharded_decode_step, make_sharded_prefill_step
from tests.test_torch_lm_sharded_train import _nudged

ARCHS = ["qwen3-1.7b", "qwen2-0.5b", "qwen3-32b", "internlm2-20b",
         "xlstm-125m", "recurrentgemma-9b", "llama-3.2-vision-11b",
         "deepseek-v2-lite-16b", "deepseek-v2-236b", "musicgen-medium"]
MESHES = [(2, 2), (1, 4)]
B, T, L, N_DEC = 4, 14, 32, 3
GEN = 4                 # sharded_generate's tokens (qwen3 on (2, 2))
LOGIT_TOL = 1e-5        # of the row's max |logit| (a cache leaf's max)


def _cfg(arch):
    return dataclasses.replace(smoke_config(arch), dtype="float32")


def _jcfg(arch):
    return dataclasses.replace(jax_smoke_config(arch), dtype="float32")


def _tree(arch):
    """The reference's seeded initial parameters (numpy), cross gates
    set so the cross layers act."""
    tree = jax.device_get(jax_init_params(jax.random.PRNGKey(1),
                                          _jcfg(arch)))
    for blk in tree["blocks"]:
        if "ffn_gate" in blk:
            blk["ffn_gate"] = np.full_like(blk["ffn_gate"], 0.5)
            blk["attn"]["gate"] = np.full_like(blk["attn"]["gate"], -0.7)
    return tree


def _inputs(arch):
    """The prompt batch (numpy) and the tokens fed to the decode steps."""
    batch = jax_make_batch(_jcfg(arch), "prefill_32k", B, T, seed=3)
    feed = np.random.default_rng(5).integers(
        0, _cfg(arch).vocab, (B, N_DEC)).astype(np.int32)
    return {k: np.asarray(v, np.float32 if v.dtype != np.int32
                          else np.int32) for k, v in batch.items()}, feed


def _torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


# ------------------------------------------------------------ ranks
def _shapes(cache):
    return [{k: tuple(t.shape) for k, t in c.items()}
            for c in cache["layers"]]


def _cut(cfg, mesh, grafted) -> bool:
    """Whether the sharded graft's blocks, gathered whole (every rank) as
    the reference's numpy tree and cut back by
    ``convert.lm_sharded_cache_from_numpy``, come back bit for bit (with
    their dtypes, ``len`` and ``max_len``)."""
    sh = convert.lm_cache_shardings(cfg, mesh, abstract_cache(cfg, B, L))
    whole = convert.lm_cache_to_numpy(gather_tree(
        {"layers": grafted["layers"], "len": grafted["len"]}, sh), cfg)
    blocks = convert.lm_sharded_cache_from_numpy(cfg, whole, mesh, "cpu")
    return blocks["len"] == grafted["len"] and \
        blocks["max_len"] in (None, grafted["max_len"]) and all(
            ca[k].dtype == cb[k].dtype and torch.equal(ca[k], cb[k])
            for ca, cb in zip(blocks["layers"], grafted["layers"])
            for k in cb)


def rank_main(group, trees: dict, inputs: dict) -> dict:
    torch.manual_seed(0)
    meshes = {m: Mesh(m, ("data", "model")).bind("cpu") for m in MESHES}
    out = {}
    for arch in ARCHS:
        cfg = _cfg(arch)
        batch, feed = inputs[arch]
        for m, mesh in meshes.items():
            state = convert.lm_sharded_from_numpy(cfg, trees[arch], mesh,
                                                  "cpu")
            mine = local_batch(_torch(batch), mesh)
            fed = local_batch({"f": torch.from_numpy(feed)}, mesh)["f"]
            logits, cache = make_sharded_prefill_step(cfg, mesh)(state,
                                                                 mine)
            got = {"logits": [logits.numpy()], "shapes": [_shapes(cache)],
                   "data_index": mesh.index(mesh.dp_axes),
                   "caches": [convert.lm_sharded_cache_to_numpy(cfg, cache,
                                                                mesh)]}
            cache = serve.sharded_graft(cfg, cache, L, mesh)
            got["cut"] = _cut(cfg, mesh, cache)
            decode = make_sharded_decode_step(cfg, mesh)
            for i in range(N_DEC):
                logits, cache = decode(state, cache,
                                       {"tokens": fed[:, i:i + 1]})
                got["logits"].append(logits.numpy())
            got["shapes"].append(_shapes(cache))
            got["caches"].append(convert.lm_sharded_cache_to_numpy(
                cfg, cache, mesh))
            out[(arch, m)] = got
    # the serving entry point, greedy
    arch, mesh = "qwen3-1.7b", meshes[(2, 2)]
    state = convert.lm_sharded_from_numpy(_cfg(arch), trees[arch], mesh,
                                          "cpu")
    toks, _, _ = serve.sharded_generate(
        _cfg(arch), state, local_batch(_torch(inputs[arch][0]), mesh),
        T + GEN + 1, GEN, mesh)
    out["generate"] = (mesh.index(mesh.dp_axes), toks.numpy())
    return out


# ------------------------------------------------------------ reference
def _grow(jcfg, cache, max_len):
    full = jax_init_cache(jcfg, B, max_len)
    return jax.tree.map(
        lambda d, s: s if d.shape == s.shape
        else d.at[tuple(slice(0, n) for n in s.shape)].set(s), full, cache)


def _reference(arch, trees, batch, feed) -> list[dict]:
    """The reference's jitted single-device prefill, ``greedy_generate``'s
    graft and 3 decode steps fed ``feed``, from each of ``trees`` (one
    compilation): every step's logits, the caches after the prefill and
    after the last step, and the abstract shapes of both."""
    jcfg = _jcfg(arch)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    prefill = jax.jit(jax_make_prefill_step(jcfg))
    decode = jax.jit(jax_make_decode_step(jcfg))
    runs = []
    for tree in trees:
        logits, cache = prefill(tree, jbatch)
        out = {"logits": [np.asarray(logits)],
               "caches": [jax.device_get(cache)],
               "abstract": [jax.eval_shape(prefill, tree, jbatch)[1],
                            jax.eval_shape(functools.partial(
                                jax_init_cache, jcfg, B, L))]}
        cache = _grow(jcfg, cache, L)
        for i in range(N_DEC):
            logits, cache = decode(
                tree, cache, {"tokens": jnp.asarray(feed[:, i:i + 1])})
            out["logits"].append(np.asarray(logits))
        out["caches"].append(jax.device_get(cache))
        runs.append(out)
    return runs


@pytest.fixture(scope="module")
def result():
    trees = {a: _tree(a) for a in ARCHS}
    inputs = {a: _inputs(a) for a in ARCHS}
    box: dict = {}

    def references():
        try:
            box["ref"] = {a: _reference(a, (trees[a], _nudged(trees[a])),
                                        *inputs[a]) for a in ARCHS}
            arch = "qwen3-1.7b"
            jbatch = {k: jnp.asarray(v) for k, v in inputs[arch][0].items()}
            box["generate"] = np.asarray(jax_greedy_generate(
                _jcfg(arch), trees[arch], jbatch, T + GEN + 1, GEN)[0])
        except BaseException as e:      # re-raised below
            box["error"] = e
    worker = threading.Thread(target=references)
    worker.start()
    try:
        ranks = launch(rank_main, (trees, inputs),
                       plan=plan_group(4, force_host_devices=4, device="cpu"),
                       threads=1)
    finally:
        worker.join()
    if "error" in box:
        raise box["error"]
    return {"ref": box["ref"], "generate": box["generate"], "ranks": ranks}


def _rows(got: dict, mesh) -> slice:
    rows = B // mesh[0]
    return slice(got["data_index"] * rows, (got["data_index"] + 1) * rows)


def _tol(want, own, axis=None) -> np.ndarray:
    """LOGIT_TOL of ``want``'s max |value| (per row along ``axis``), or
    twice the nudged run's own move (``own``) where that is more."""
    scale = np.abs(want).max(axis, keepdims=axis is not None)
    move = np.abs(own - want).max(axis, keepdims=axis is not None)
    return np.maximum(LOGIT_TOL * scale, 2 * move)


def _logits_close(got, want, own):
    assert got.shape == want.shape
    tol = _tol(want, own, -1)
    assert (np.abs(got - want) <= tol).all(), \
        float((np.abs(got - want) / np.abs(want).max(-1, keepdims=True))
              .max())


def _caches_close(got, want, own):
    g, w, o = (jax.tree.leaves(x) for x in (got, want, own))
    assert len(g) == len(w) == len(o)
    for a, b, c in zip(g, w, o):
        b, c = np.asarray(b, np.float32), np.asarray(c, np.float32)
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=float(_tol(b, c)))


# ------------------------------------------------------------ parity
@pytest.mark.parametrize("mesh", MESHES, ids=str)
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_prefill_matches_reference(result, arch, mesh):
    ref, own = result["ref"][arch]
    for r in result["ranks"]:
        got = r[(arch, mesh)]
        rows = _rows(got, mesh)
        _logits_close(got["logits"][0], ref["logits"][0][rows],
                      own["logits"][0][rows])
    _caches_close(result["ranks"][0][(arch, mesh)]["caches"][0],
                  ref["caches"][0], own["caches"][0])


@pytest.mark.parametrize("mesh", MESHES, ids=str)
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_decode_matches_reference(result, arch, mesh):
    ref, own = result["ref"][arch]
    for r in result["ranks"]:
        got = r[(arch, mesh)]
        rows = _rows(got, mesh)
        assert len(got["logits"]) == N_DEC + 1
        for g, w, o in zip(got["logits"][1:], ref["logits"][1:],
                           own["logits"][1:]):
            _logits_close(g, w[rows], o[rows])
    _caches_close(result["ranks"][0][(arch, mesh)]["caches"][1],
                  ref["caches"][1], own["caches"][1])


# ------------------------------------------------------------ blocks
def _sanitized(arch, mesh, abstract):
    jm = AbstractMesh(mesh, ("data", "model"))
    return jax_sh.sanitize_shardings(
        jax_sh.cache_shardings(_jcfg(arch), jm, jax_dp_axes(jm, B)),
        abstract)


def _local_shapes(arch, mesh, abstract) -> list:
    """The block shapes the reference's sanitized cache shardings of
    ``abstract`` give a rank of ``mesh`` (every rank's are alike), per
    layer in the port's order."""
    sizes = dict(zip(("data", "model"), mesh))
    parts = ("prefix", "blocks", "suffix")

    def block(s, a):
        spec = tuple(s.spec) + (None,) * (len(a.shape) - len(s.spec))
        return np.empty(tuple(
            n if e is None else n // int(np.prod(
                [sizes[x] for x in ((e,) if isinstance(e, str) else e)]))
            for n, e in zip(a.shape, spec)))
    shapes = jax.tree.map(block, {k: _sanitized(arch, mesh, abstract)[k]
                                  for k in parts},
                          {k: abstract[k] for k in parts})
    return [{k: np.shape(v) for k, v in layer.items()}
            for layer in convert._unstack(shapes, _cfg(arch))]


@pytest.mark.parametrize("mesh", MESHES, ids=str)
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_blocks_are_the_sanitized_specs_share(result, arch, mesh):
    ref = result["ref"][arch][0]
    for which in (0, 1):        # after the prefill, after the decode
        want = _local_shapes(arch, mesh, ref["abstract"][which])
        for r in result["ranks"]:
            assert r[(arch, mesh)]["shapes"][which] == want, which
    # every family's decode cache has a leaf split over model
    assert any("model" in tuple(s.spec) for s in jax.tree.leaves(
        _sanitized(arch, mesh, ref["abstract"][1])))


@pytest.mark.parametrize("mesh", MESHES, ids=str)
@pytest.mark.parametrize("arch", ARCHS)
def test_whole_cache_cut_to_blocks_is_the_sharded_layout(result, arch,
                                                          mesh):
    """``lm_sharded_cache_from_numpy`` of the grafted cache gathered whole
    gives every rank the blocks the sharded graft made, bit for bit."""
    assert all(r[(arch, mesh)]["cut"] for r in result["ranks"])


# ------------------------------------------------------------ greedy
def test_sharded_generate_picks_the_reference_tokens(result):
    want = result["generate"]
    for r in result["ranks"]:
        di, toks = r["generate"]
        np.testing.assert_array_equal(toks, want[di * 2:(di + 1) * 2])


# ------------------------------------------------------------ the merge
class _Shared:
    def __init__(self, n):
        self.n, self.slots = n, [None] * n
        self.barrier = threading.Barrier(n, timeout=60)

    def exchange(self, i, t):
        self.slots[i] = t
        self.barrier.wait()
        parts = list(self.slots)
        self.barrier.wait()
        return parts


class _ThreadMesh:
    """The ``model`` axis of a mesh whose ranks are threads."""

    def __init__(self, shared, i):
        self.shared, self.i = shared, i

    def axis_size(self, axes):
        return self.shared.n

    def index(self, axes):
        return self.i

    def all_gather(self, t, axes, dim):
        return torch.cat(self.shared.exchange(self.i, t), dim)

    def all_reduce(self, t, axes, op="sum"):
        parts = torch.stack(self.shared.exchange(self.i, t))
        return parts.amax(0) if op == "max" else parts.sum(0)

    def all_reduce_many(self, ts, axes):
        return [self.all_reduce(t, axes) for t in ts]


def _on_shards(n, fn):
    """``fn(mesh, i)`` on ``n`` threads, each a rank of a ``model`` axis
    of ``n``; their results in rank order."""
    shared, out, errors = _Shared(n), [None] * n, []

    def run(i):
        try:
            out[i] = fn(_ThreadMesh(shared, i), i)
        except BaseException as e:      # re-raised below
            errors.append(e)
            shared.barrier.abort()
    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        raise errors[0]
    return out


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("case", ["causal", "window", "ring", "cross"])
def test_split_decode_attention_equals_unsplit(n, case):
    rng = np.random.default_rng(n)
    b, nq, nkv, hd, s = 2, 8, 2, 16, 24

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32))
    q, k, v = randn(b, 1, nq, hd), randn(b, s, nkv, hd), randn(b, s, nkv, hd)
    pos = torch.arange(s, dtype=torch.int32)
    q_pos, window = 4, None       # shards past the first hold no valid key
    if case == "window":
        q_pos, window = 17, 6
    elif case == "ring":          # ring slots: some empty (-1), wrapped
        pos = torch.from_numpy(rng.permutation(40)[:s].astype(np.int32))
        pos[rng.permutation(s)[:7]] = -1
        q_pos, window = 39, 24
    elif case == "cross":
        q_pos = None
    want = decode_attention(q, k, v, pos, q_pos, window)
    per, hq = s // n, nq // n

    def shard(mesh, i):
        blk = slice(i * per, (i + 1) * per)
        return decode_attention(q[:, :, i * hq:(i + 1) * hq], k[:, blk],
                                v[:, blk], pos[blk], q_pos, window,
                                mesh=mesh)
    got = torch.cat(_on_shards(n, shard), dim=2)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n", [2, 4])
def test_split_absorbed_attention_equals_unsplit(n):
    rng = np.random.default_rng(10 + n)
    b, h, lora, rope, s = 2, 8, 32, 8, 24

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32))
    q_eff, q_rope = randn(b, 1, h, lora), randn(b, 1, h, rope)
    ckv, krope = randn(b, s, lora), randn(b, s, rope)
    pos = torch.arange(s)
    scale = (16 + rope) ** -0.5
    q_at = 9                      # the later shards hold no valid key
    want = absorbed_attention(q_eff, q_rope, ckv, krope, pos, q_at, scale)
    per, hq = s // n, h // n

    def shard(mesh, i):
        blk, hs = slice(i * per, (i + 1) * per), slice(i * hq, (i + 1) * hq)
        return absorbed_attention(q_eff[:, :, hs], q_rope[:, :, hs],
                                  ckv[:, blk], krope[:, blk], pos[blk], q_at,
                                  scale, mesh)
    got = torch.cat(_on_shards(n, shard), dim=2)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
