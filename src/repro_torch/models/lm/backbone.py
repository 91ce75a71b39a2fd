"""LM backbone: embed → layers → final norm → logits.

The port of ``repro.models.lm.backbone``. The reference stacks the
repeating super-block's params and scans over them; here the layers of
``cfg.layer_plan()`` (prefix, pattern × repeats, suffix) are one
``ModuleList``, run in a Python loop, and the cache is one dict per layer.

Layer kinds (``Block`` keeps the reference's parameter names):
  attn, local, attn_moe — ``ln1``, ``attn`` (GQA, or MLA when
      ``cfg.mla``), ``ln2`` and ``mlp`` (the dense MLP; a MoE model's
      dense ``attn`` layers are ``cfg.moe.d_ff_dense`` wide) or ``moe``;
  cross — ``ln1``, gated ``attn`` over ``cross_states``, ``ln2``, ``mlp``
      scaled by ``tanh(ffn_gate)``;
  rglru — ``ln1``, ``rec`` (RG-LRU), ``ln2``, ``mlp``;
  mlstm, slstm — ``cell``, which holds its own norm and projections.

``forward`` takes ``tokens`` or ``embeds`` (the embedding-input archs'
prefill and training), and ``cross_states`` for cross layers (prefill and
training; decode reads their k/v from the cache).

Modes: train (no cache; with ``cfg.remat`` each layer runs under
``torch.utils.checkpoint`` — the reference checkpoints each super-block,
which gives the same values) | prefill (build the cache; ``last_only``
keeps the last position's logits) | decode (one token against the cache;
attention caches are updated in place, recurrent states replaced).
"""
from __future__ import annotations

import functools
import math
import types

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models.lm.attention import attn_init, cross_attention, \
    self_attention
from repro_torch.models.lm.config import LMConfig
from repro_torch.models.lm.layers import MLP, Linear, Norm, apply_norm, \
    mlp_apply
from repro_torch.models.lm.mla import MLA, mla_attention
from repro_torch.models.lm.moe import MoE, moe_apply
from repro_torch.models.lm.rglru import RGLRU, rglru_block
from repro_torch.models.lm.sharding import copy_to_model, \
    gather_from_model, gather_params, gather_plan, reduce_from_model, \
    shard, tp_size
from repro_torch.models.lm.xlstm import MLSTM, SLSTM, mlstm_block, \
    slstm_block


class Block(nn.Module):
    """One layer of kind ``kind`` (see the module's docstring)."""

    def __init__(self, cfg: LMConfig, kind: str, device, gen=None):
        super().__init__()
        self.kind = kind
        dt = getattr(torch, cfg.dtype)
        d = cfg.d_model
        self.mlp = None
        if kind in ("attn", "attn_moe", "local", "cross"):
            self.ln1 = Norm(d, cfg.norm, device)
            self.attn = MLA(cfg, device, gen) \
                if cfg.mla is not None and kind != "cross" \
                else attn_init(cfg, device, gen, "cross" if kind == "cross"
                               else "full")
            self.ln2 = Norm(d, cfg.norm, device)
            if kind == "attn_moe":
                self.moe = MoE(cfg, device, gen)
            elif cfg.mlp != "none":
                d_ff = cfg.moe.d_ff_dense if (cfg.moe and kind == "attn") \
                    else cfg.d_ff
                self.mlp = MLP(d, d_ff, cfg.mlp, dt, device, gen)
            if kind == "cross":
                self.ffn_gate = nn.Parameter(torch.zeros(
                    (), dtype=torch.float32, device=device))
        elif kind == "rglru":
            self.ln1 = Norm(d, cfg.norm, device)
            self.rec = RGLRU(cfg, device, gen)
            self.ln2 = Norm(d, cfg.norm, device)
            self.mlp = MLP(d, cfg.d_ff, cfg.mlp, dt, device, gen)
        elif kind == "mlstm":
            self.cell = MLSTM(cfg, device, gen)
        elif kind == "slstm":
            self.cell = SLSTM(cfg, device, gen)
        else:
            raise ValueError(f"unknown layer kind {kind!r}")

    def forward(self, cfg: LMConfig, h, positions, rsc=None,
                cross_states=None, mode="train", cache=None,
                cache_len=None):
        """The layer's forward (what ``torch.func.functional_call`` runs
        with a mesh rank's gathered parameters): ``h`` in training, ``(h,
        new_cache)`` in prefill and decode."""
        if mode == "train":
            return _train_layer(self, cfg, h, positions, rsc, cross_states)
        return layer_apply(self, cfg, self.kind, h, positions, cache=cache,
                           cache_len=cache_len, cross_states=cross_states,
                           mode=mode, rsc=rsc)


class LM(nn.Module):
    """Token embedding (tied to the output unless ``unembed`` exists),
    the layers of ``cfg.layer_plan()`` and the final norm."""

    def __init__(self, cfg: LMConfig, device, gen=None):
        super().__init__()
        cfg.validate()
        self.cfg = cfg
        dt = getattr(torch, cfg.dtype)
        d = cfg.d_model
        if gen is None:
            embed = torch.empty((cfg.vocab, d), dtype=dt, device=device)
        else:
            embed = (torch.randn((cfg.vocab, d), generator=gen,
                                 dtype=torch.float32, device=device)
                     * (1.0 / math.sqrt(d))).to(dt)
        self.embed = nn.Parameter(embed)
        self.final_norm = Norm(d, cfg.norm, device)
        self.unembed = None if cfg.tie_embeddings \
            else Linear(d, cfg.vocab, dt, device, gen=gen)
        self.layers = nn.ModuleList(Block(cfg, kind, device, gen)
                                    for kind in cfg.layer_plan())


def init_params(cfg: LMConfig, seed: int = 0, device="cuda") -> LM:
    """Random parameters from a ``torch.Generator`` seeded with ``seed``
    on ``device`` (``cuda`` by default, which raises without a card): the
    reference's distributions (embed ``N(0, 1/d)``, weights
    ``N(0, 1/fan_in)``, norm gains 1, biases 0), not its numbers."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    with torch.no_grad():
        return LM(cfg, device, gen)


# ------------------------------- cache --------------------------------------

def layer_cache(cfg: LMConfig, kind: str, batch: int, max_len: int,
                device, ring: int | None = None) -> dict:
    """An empty cache of one layer, in the reference's dtypes: attention
    and RG-LRU states in the model dtype, mLSTM's ``C``, ``n``, ``m`` and
    sLSTM's states in f32 (``m`` at -1e30). A local layer's ring holds
    ``min(local_window, max_len)`` slots, or ``ring``."""
    dt = getattr(torch, cfg.dtype)

    def zeros(*shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=device)

    def neg(*shape):
        return torch.full(shape, -1e30, dtype=torch.float32, device=device)

    hd, nkv = cfg.hd, cfg.n_kv
    if kind in ("attn", "attn_moe"):
        if cfg.mla is not None:
            return {"ckv": zeros(batch, max_len, cfg.mla.kv_lora),
                    "krope": zeros(batch, max_len, cfg.mla.qk_rope)}
        return {"k": zeros(batch, max_len, nkv, hd),
                "v": zeros(batch, max_len, nkv, hd)}
    if kind == "local":
        w = ring or min(cfg.local_window, max_len)
        return {"k": zeros(batch, w, nkv, hd), "v": zeros(batch, w, nkv, hd),
                "pos": torch.full((w,), -1, dtype=torch.int32, device=device)}
    if kind == "cross":
        return {"k": zeros(batch, cfg.cross_seq, nkv, hd),
                "v": zeros(batch, cfg.cross_seq, nkv, hd)}
    if kind == "rglru":
        w = cfg.lru_width or cfg.d_model
        return {"h": zeros(batch, w), "conv": zeros(batch,
                                                     cfg.conv_width - 1, w)}
    f32 = torch.float32
    if kind == "mlstm":
        ud, nh = 2 * cfg.d_model, cfg.mlstm_heads
        return {"C": zeros(batch, nh, ud // nh, ud // nh, dtype=f32),
                "n": zeros(batch, nh, ud // nh, dtype=f32),
                "m": neg(batch, nh),
                "conv": zeros(batch, cfg.conv_width - 1, ud)}
    if kind == "slstm":
        nh = cfg.slstm_heads
        dh = cfg.d_model // nh
        return {"c": zeros(batch, nh, dh, dtype=f32),
                "n": zeros(batch, nh, dh, dtype=f32),
                "h": zeros(batch, nh, dh, dtype=f32), "m": neg(batch, nh, dh)}
    raise ValueError(f"unknown layer kind {kind!r}")


def init_cache(cfg: LMConfig, batch: int, max_len: int,
               device="cuda") -> dict:
    """Empty caches for ``max_len`` positions on ``device`` (``cuda`` by
    default, which raises without a card): ``{"layers": [one dict per
    layer], "len": 0}``."""
    device = resolve_device(device)
    return {"layers": [layer_cache(cfg, k, batch, max_len, device)
                       for k in cfg.layer_plan()],
            "len": 0}


# ------------------------------- apply --------------------------------------

def layer_apply(p: Block, cfg: LMConfig, kind: str, h, positions, *,
                cache=None, cache_len=None, cross_states=None,
                mode="prefill", rsc=None):
    if kind in ("attn", "attn_moe", "local"):
        hn = apply_norm(p.ln1, h, cfg.norm_eps)
        if cfg.mla is not None:
            a, c = mla_attention(p.attn, cfg, hn, positions, cache=cache,
                                 cache_len=cache_len, mode=mode)
        else:
            a, c = self_attention(
                p.attn, cfg, hn, positions, cache=cache, cache_len=cache_len,
                window=cfg.local_window if kind == "local" else None,
                mode=mode)
        h = h + a
        hn = apply_norm(p.ln2, h, cfg.norm_eps)
        if kind == "attn_moe":
            h = h + moe_apply(p.moe, cfg, hn)
        elif p.mlp is not None:
            h = h + mlp_apply(p.mlp, hn, cfg.mlp, rsc)
        return h, c
    if kind == "cross":
        hn = apply_norm(p.ln1, h, cfg.norm_eps)
        a, c = cross_attention(p.attn, cfg, hn, cross_states, cache=cache,
                               mode=mode)
        h = h + a
        hn = apply_norm(p.ln2, h, cfg.norm_eps)
        return h + mlp_apply(p.mlp, hn, cfg.mlp, rsc) * \
            torch.tanh(p.ffn_gate).to(h.dtype), c
    if kind == "rglru":
        hn = apply_norm(p.ln1, h, cfg.norm_eps)
        r, c = rglru_block(p.rec, cfg, hn, cache=cache, mode=mode)
        h = h + r
        hn = apply_norm(p.ln2, h, cfg.norm_eps)
        return h + mlp_apply(p.mlp, hn, cfg.mlp, rsc), c
    if kind == "mlstm":
        r, c = mlstm_block(p.cell, cfg, h, cache=cache, mode=mode)
        return h + r, c
    if kind == "slstm":
        r, c = slstm_block(p.cell, cfg, h, cache=cache, mode=mode)
        return h + r, c
    raise ValueError(f"unknown layer kind {kind!r}")


def _train_layer(blk: Block, cfg: LMConfig, h, positions, rsc,
                 cross_states):
    return layer_apply(blk, cfg, blk.kind, h, positions, mode="train",
                       rsc=rsc, cross_states=cross_states)[0]


def forward(
    params: LM, cfg: LMConfig, *,
    tokens: torch.Tensor | None = None,   # (b, t) int
    embeds: torch.Tensor | None = None,
    cross_states: torch.Tensor | None = None,
    cache: dict | None = None,
    mode: str = "train",
    rsc: dict | None = None,
    last_only: bool = False,
):
    """Returns (logits f32 (b, t or 1, vocab), new_cache); new_cache is
    None in train mode. ``embeds`` (b, t, d), cast to the model dtype,
    stand in for the embedded ``tokens``."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    if embeds is not None:
        h = embeds.to(params.embed.dtype)
    else:
        h = F.embedding(tokens.long(), params.embed)
    b, t, _ = h.shape
    cache_len = cache["len"] if cache is not None else None
    if mode == "decode":
        positions = torch.tensor([cache_len], dtype=torch.int32,
                                 device=h.device)
    else:
        positions = torch.arange(t, dtype=torch.int32, device=h.device)
    if mode == "train":
        new_cache = None
        for blk in params.layers:
            if cfg.remat:
                h = checkpoint(_train_layer, blk, cfg, h, positions, rsc,
                               cross_states, use_reentrant=False)
            else:
                h = _train_layer(blk, cfg, h, positions, rsc, cross_states)
    else:
        new_cache = {"layers": [],
                     "len": t if cache_len is None else cache_len + t}
        for i, blk in enumerate(params.layers):
            c_in = cache["layers"][i] if cache is not None else None
            h, c = layer_apply(blk, cfg, blk.kind, h, positions, cache=c_in,
                               cache_len=cache_len, cross_states=cross_states,
                               mode=mode, rsc=rsc)
            new_cache["layers"].append(c)

    h = apply_norm(params.final_norm, h, cfg.norm_eps)
    if last_only:
        h = h[:, -1:]
    if params.unembed is None:
        logits = h.float() @ params.embed.float().T
    else:
        logits = (h @ params.unembed.w).float()
    return logits, new_cache


# ------------------------------------------------------------ on a mesh
class ShardedLM:
    """One rank's share of an LM on a (bound) mesh: ``shards`` holds the
    rank's block of every parameter (``{name: tensor}``, laid out by
    ``shardings``, ``launch.shardings.Sharding`` per name: the reference's
    ``param_spec`` of its tree path, ``convert.lm_param_shardings``), and
    ``skeleton`` the module's structure on the ``meta`` device (no
    memory). ``compute(*names)`` rebuilds parameters' compute tensors
    (``models.lm.sharding.gather_params``): whole, or this rank's share
    of the heads / ffn / experts / LRU width / vocab under tensor
    parallelism."""

    def __init__(self, cfg: LMConfig, mesh, shards: dict, shardings: dict,
                 skeleton: LM | None = None):
        self.cfg, self.mesh = cfg, mesh
        self.skeleton = skeleton if skeleton is not None else LM(cfg, "meta")
        self.shards = {n: t.requires_grad_() for n, t in shards.items()}
        self.shardings = shardings
        self.plans = {n: gather_plan(n, sh) for n, sh in shardings.items()}
        for n, p in self.skeleton.named_parameters():
            want = shardings[n].local_shape(tuple(p.shape))
            if tuple(self.shards[n].shape) != want:
                raise ValueError(f"{n}: block {tuple(self.shards[n].shape)}, "
                                 f"its spec gives {want}")

    def compute(self, *names: str) -> list[torch.Tensor]:
        return gather_params([self.shards[n] for n in names],
                             [self.plans[n] for n in names], self.mesh)


def init_sharded_params(cfg: LMConfig, mesh, seed: int = 0,
                        device="cuda") -> ShardedLM:
    """This rank's ``ShardedLM`` of ``init_params(cfg, seed, device)``:
    the whole seeded model is drawn on the rank's device (every rank draws
    the same numbers) and cut to its blocks."""
    from repro_torch.convert import lm_param_shardings
    device = resolve_device(device)
    mesh.device = device
    shardings = lm_param_shardings(cfg, mesh)
    full = init_params(cfg, seed, device)
    shards = {n: shardings[n].local(p.detach()).clone(
        memory_format=torch.contiguous_format)
        for n, p in full.named_parameters()}
    del full
    return ShardedLM(cfg, mesh, shards, shardings)


def vocab_parallel_embed(tokens: torch.Tensor, emb: torch.Tensor,
                         mesh) -> torch.Tensor:
    """Embedding lookup in a table split over ``model`` by vocab rows:
    ids outside this rank's rows give 0, and the ranks' lookups are
    summed over ``model``."""
    if tp_size(mesh) == 1:
        return F.embedding(tokens.long(), emb)
    n = emb.shape[0]
    ids = tokens.long() - mesh.index("model") * n
    ok = (ids >= 0) & (ids < n)
    h = F.embedding(ids.clamp(0, n - 1), emb) * ok[..., None].to(emb.dtype)
    return reduce_from_model(h)


def _sharded_layer(state: ShardedLM, i: int, rsc, h, positions,
                   cross_states, mode="train", cache=None, cache_len=None):
    blk = state.skeleton.layers[i]
    names = [n for n, _ in blk.named_parameters()]
    params = dict(zip(names, state.compute(*(f"layers.{i}.{n}"
                                              for n in names))))
    return torch.func.functional_call(
        blk, params, (state.cfg, h, positions),
        {"rsc": rsc, "cross_states": cross_states, "mode": mode,
         "cache": cache, "cache_len": cache_len})


def forward_sharded(state: ShardedLM, *, tokens=None, embeds=None,
                    cross_states=None, rsc: dict | None = None,
                    cache: dict | None = None, mode: str = "train",
                    last_only: bool = False):
    """The forward of this rank's rows on the mesh installed by
    ``models.lm.sharding.mesh_context`` (FSDP over the batch axes, tensor
    parallelism over ``model``; each layer gathers its parameters on
    entry).

    ``mode="train"`` returns this rank's logits, f32 ``(rows, t, vocab /
    model)``, its vocab rows' share under tensor parallelism; with
    ``cfg.remat`` each layer's gather runs inside its checkpoint, so the
    backward gathers the parameters again instead of keeping them.
    ``prefill`` and ``decode`` (under ``DECODE_RULES``) return ``(logits,
    new_cache)`` as ``forward`` does: the logits gathered whole over
    ``model`` (f32 ``(rows, t or 1, vocab)``), the cache this rank's
    blocks, one dict per layer (``{"layers", "len"}``); decode embeds its
    token vocab-parallel."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    cfg = state.cfg
    emb = None
    if embeds is not None:
        h = embeds.to(getattr(torch, cfg.dtype))
    else:
        emb, = state.compute("embed")
        h = vocab_parallel_embed(tokens, emb, state.mesh)
    shard(h, "batch", "seq", "embed")
    cache_len = cache["len"] if cache is not None else None
    if mode == "decode":
        positions = torch.tensor([cache_len], dtype=torch.int32,
                                 device=h.device)
    else:
        positions = torch.arange(h.shape[1], dtype=torch.int32,
                                 device=h.device)
    new_cache = None
    if mode == "train":
        for i in range(len(state.skeleton.layers)):
            fn = functools.partial(_sharded_layer, state, i, rsc)
            if cfg.remat:
                h = checkpoint(fn, h, positions, cross_states,
                               use_reentrant=False)
            else:
                h = fn(h, positions, cross_states)
    else:
        new_cache = {"layers": [], "len": h.shape[1] if cache_len is None
                     else cache_len + h.shape[1]}
        for i in range(len(state.skeleton.layers)):
            h, c = _sharded_layer(
                state, i, rsc, h, positions, cross_states, mode,
                cache["layers"][i] if cache is not None else None,
                cache_len)
            new_cache["layers"].append(c)
    names = [n for n, _ in state.skeleton.final_norm.named_parameters()]
    norm = types.SimpleNamespace(**{"b": None, **dict(zip(names, state.compute(
        *(f"final_norm.{n}" for n in names))))})
    h = apply_norm(norm, h, cfg.norm_eps)
    if last_only:
        h = h[:, -1:]
    h = copy_to_model(h)
    if state.skeleton.unembed is None:
        emb = emb if emb is not None else state.compute("embed")[0]
        logits = h.float() @ emb.float().T
    else:
        logits = (h @ state.compute("unembed.w")[0]).float()
    logits = shard(logits, "batch", "seq", "vocab")
    if mode == "train":
        return logits
    return gather_from_model(logits), new_cache
