"""LM backbone: embed → layers → final norm → logits.

The port of ``repro.models.lm.backbone``. The reference stacks the
repeating super-block's params and scans over them; here the layers of
``cfg.layer_plan()`` (prefix, pattern × repeats, suffix) are one
``ModuleList``, run in a Python loop, and the cache is one dict per layer.

Ported layer kinds: ``attn`` and ``local`` (the dense family: qwen2-0.5b,
qwen3-1.7b, qwen3-32b, internlm2-20b). Every other kind, MLA and
embedding inputs raise ``NotImplementedError`` naming the ROADMAP item
that ports them.

Modes: train (no cache; with ``cfg.remat`` each layer runs under
``torch.utils.checkpoint`` — the reference checkpoints each super-block,
which gives the same values) | prefill (build the cache; ``last_only``
keeps the last position's logits) | decode (one token against the cache,
which is updated in place).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models.lm.attention import LM_REST, attn_init, \
    self_attention
from repro_torch.models.lm.config import LMConfig
from repro_torch.models.lm.layers import MLP, Linear, Norm, apply_norm, \
    mlp_apply

PORTED_KINDS = ("attn", "local")


def check_ported(cfg: LMConfig) -> None:
    """Raise ``NotImplementedError`` if ``cfg`` needs an unported part."""
    for kind in cfg.layer_plan():
        if kind not in PORTED_KINDS:
            raise NotImplementedError(
                f"{cfg.name}: layer kind {kind!r} is not ported to "
                f"repro_torch yet: see {LM_REST}")
    if cfg.mla is not None:
        raise NotImplementedError(f"{cfg.name}: MLA attention is not ported "
                                  f"to repro_torch yet: see {LM_REST}")
    if cfg.embeds_input:
        raise NotImplementedError(f"{cfg.name}: embedding inputs are not "
                                  f"ported to repro_torch yet: see {LM_REST}")


class Block(nn.Module):
    """One ``attn`` or ``local`` layer: pre-norm attention and MLP, each
    with a residual."""

    def __init__(self, cfg: LMConfig, kind: str, device, gen=None):
        super().__init__()
        self.kind = kind
        dt = getattr(torch, cfg.dtype)
        self.ln1 = Norm(cfg.d_model, cfg.norm, device)
        self.attn = attn_init(cfg, device, gen)
        self.ln2 = Norm(cfg.d_model, cfg.norm, device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.mlp, dt, device, gen) \
            if cfg.mlp != "none" else None


class LM(nn.Module):
    """Token embedding (tied to the output unless ``unembed`` exists),
    the layers of ``cfg.layer_plan()`` and the final norm."""

    def __init__(self, cfg: LMConfig, device, gen=None):
        super().__init__()
        cfg.validate()
        check_ported(cfg)
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
    def zeros(n):
        return torch.zeros((batch, n, cfg.n_kv, cfg.hd),
                           dtype=getattr(torch, cfg.dtype), device=device)

    if kind == "attn":
        return {"k": zeros(max_len), "v": zeros(max_len)}
    if kind == "local":
        w = min(cfg.local_window, max_len)
        return {"k": zeros(w), "v": zeros(w),
                "pos": torch.full((w,), -1, dtype=torch.int32, device=device)}
    raise NotImplementedError(f"layer kind {kind!r} is not ported to "
                              f"repro_torch yet: see {LM_REST}")


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
                cache=None, cache_len=None, mode="prefill", rsc=None):
    if kind not in PORTED_KINDS:
        raise NotImplementedError(f"layer kind {kind!r} is not ported to "
                                  f"repro_torch yet: see {LM_REST}")
    hn = apply_norm(p.ln1, h, cfg.norm_eps)
    a, c = self_attention(
        p.attn, cfg, hn, positions, cache=cache, cache_len=cache_len,
        window=cfg.local_window if kind == "local" else None, mode=mode)
    h = h + a
    if p.mlp is not None:
        hn = apply_norm(p.ln2, h, cfg.norm_eps)
        h = h + mlp_apply(p.mlp, hn, cfg.mlp, rsc)
    return h, c


def _train_layer(blk: Block, cfg: LMConfig, h, positions, rsc):
    return layer_apply(blk, cfg, blk.kind, h, positions, mode="train",
                       rsc=rsc)[0]


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
    None in train mode."""
    if embeds is not None or cross_states is not None:
        raise NotImplementedError(f"embedding and cross-attention inputs are "
                                  f"not ported to repro_torch yet: see "
                                  f"{LM_REST}")
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
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
                               use_reentrant=False)
            else:
                h = _train_layer(blk, cfg, h, positions, rsc)
    else:
        new_cache = {"layers": [],
                     "len": t if cache_len is None else cache_len + t}
        for i, blk in enumerate(params.layers):
            c_in = cache["layers"][i] if cache is not None else None
            h, c = layer_apply(blk, cfg, blk.kind, h, positions, cache=c_in,
                               cache_len=cache_len, mode=mode, rsc=rsc)
            new_cache["layers"].append(c)

    h = apply_norm(params.final_norm, h, cfg.norm_eps)
    if last_only:
        h = h[:, -1:]
    if params.unembed is None:
        logits = h.float() @ params.embed.float().T
    else:
        logits = (h @ params.unembed.w).float()
    return logits, new_cache
