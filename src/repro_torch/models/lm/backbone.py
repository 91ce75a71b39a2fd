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

import math

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
                device) -> dict:
    """An empty cache of one layer, in the reference's dtypes: attention
    and RG-LRU states in the model dtype, mLSTM's ``C``, ``n``, ``m`` and
    sLSTM's states in f32 (``m`` at -1e30)."""
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
        w = min(cfg.local_window, max_len)
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
